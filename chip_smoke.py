"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Builds the port's three CUDA kernels (speech attention K1, int8 stochastic
rounding K2, fused feed-forward K3) from ``sincformer_tpu_torch/csrc/``, one
``nvcc`` process each, and holds each against its plain PyTorch version on
the card. Then it drives the port's paths at full width and checks, from the
wrappers' launch counts, that each went through its kernels:

  * a few requests through the flagship Sincformer-metacog enhancement
    (random weights from a seeded ``torch.Generator``), held against the
    same port on the CPU, and the batch request's time;
  * serving from the committed trained artifact
    (``artifacts/r5/sincformer_v4s0_best_serving_torch``): load, ``export``
    again through K2, load that, a 60 s file through the whole-file, the
    segmented and the host path of ``StreamingEnhancer``, five files through
    ``enhance_many``, and an ``OnlineEnhancerPool`` of 8 live streams
    against 8 solo ``OnlineEnhancer``s;
  * the same long-form request through DCSE with the fused feed-forward
    (seeded random weights), held against the unfused model.

Exits non-zero on any failure, and at once when no CUDA device is present.
The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it holds the kernel table as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
KERNEL_TOL = 1e-5      # f32 on both sides, sums in another order; K3: of
                       # the output's scale
WAVE_TOL = 1e-4        # two paths or devices, relative to the waveform's peak
TIE_MARGIN = 1e-3      # MAA logit gap below which a decision flip is a tie
ATTN_TS = (50, 100, 250, 400, 601, 2100)
FFN_ROWS = (25664, 6416, 1, 7, 401, 1000)      # 64 and 16 windows of 401 frames
K2_OPS_PER_ELEMENT = 40      # Philox-4x32-10 shared by 4 elements + rounding
REPO = os.path.dirname(os.path.abspath(__file__))
ARTIFACT = os.path.join(REPO, "artifacts", "r5",
                        "sincformer_v4s0_best_serving_torch")


def say(*parts):
    print(*parts, flush=True)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of fn() in ms, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_in_turns(plain, kernel, library=None, iters: int = 50) -> dict:
    """plain, kernel, kernel, plain (and the library call, where there is
    one), each the mean of ``iters`` launches."""
    timing = {"plain_ms": cuda_ms(plain, iters), "ms": cuda_ms(kernel, iters),
              "ms_2": cuda_ms(kernel, iters),
              "plain_ms_2": cuda_ms(plain, iters)}
    timing["library_ms"] = cuda_ms(library, iters) if library else None
    return timing


def with_bound(timing: dict, flops: float, nbytes: float) -> dict:
    by_ops, by_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    timing["bound_ms"] = max(by_ops, by_bytes) * 1e3
    timing["bound_by"] = "operations" if by_ops >= by_bytes else "bytes"
    return timing


def wall_s(fn, reps: int = 3) -> float:
    """Mean wall seconds of fn() after one warm-up call; fn ends with its
    result on the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def speechlike(rng: np.random.Generator, n: int, fs: int = 8000) -> np.ndarray:
    """Harmonic voiced segments with a syllable-rate envelope in white
    noise at about 5 dB SNR, peak 0.5."""
    t = np.arange(n) / fs
    f0 = 110 + 40 * np.sin(2 * np.pi * 0.7 * t + rng.uniform(0, 6))
    phase = 2 * np.pi * np.cumsum(f0) / fs
    voiced = sum(np.sin(h * phase) / h for h in range(1, 12))
    env = np.clip(np.sin(2 * np.pi * 3.0 * t + rng.uniform(0, 6)), 0, None)
    clean = voiced * env
    noise = rng.standard_normal(n) * np.std(clean) * 10 ** (-5 / 20)
    x = clean + noise
    return (0.5 * x / np.max(np.abs(x))).astype(np.float32)


def to_pcm(x: np.ndarray) -> np.ndarray:
    return np.round(x * 32767).astype(np.int16)


class Launches:
    """The three wrappers' launch counts: set to 0 before a path is driven,
    read after it, summed per kernel over the paths."""

    def __init__(self):
        from sincformer_tpu_torch.ops.fused_ffn import fused_ffn
        from sincformer_tpu_torch.ops.quantize import quantize_int8
        from sincformer_tpu_torch.ops.speech_attention import speech_attention
        self.wrappers = {"speech_attention": speech_attention,
                         "quantize_int8": quantize_int8,
                         "fused_ffn": fused_ffn}
        self.total = dict.fromkeys(self.wrappers, 0)

    def reset(self):
        for w in self.wrappers.values():
            w.launches = 0

    def read(self) -> dict:
        return {name: w.launches for name, w in self.wrappers.items()}

    def expect(self, what: str, **want) -> dict:
        """Read the counts of the path just driven, hold them against
        ``want`` (kernels not named must be 0), add them to the totals and
        set them back to 0."""
        got = self.read()
        want = {name: want.get(name, 0) for name in got}
        if got != want:
            raise AssertionError(f"{what}: kernel launches {got}, expected "
                                 f"{want}")
        for name, n in got.items():
            self.total[name] += n
        self.reset()
        return got


def check_k1(seed: int):
    """K1 against its plain version; returns (max err, timings)."""
    from sincformer_tpu_torch.ops.speech_attention import (
        _speech_attention_plain, speech_attention)
    g = torch.Generator(device="cuda").manual_seed(seed)
    worst = 0.0
    shapes = [(4, t) for t in ATTN_TS] + [(1, 100), (1, 250), (16, 401)]
    for b, t in shapes:
        q, k, v = (torch.randn(b, t, 4, 64, device="cuda", generator=g)
                   for _ in range(3))
        lengths = torch.tensor(([t, t - 7, t // 2, 1] * 4)[:b], device="cuda")
        valid = torch.arange(t, device="cuda")[None, :] < lengths[:, None]
        bias = torch.where(valid, 0.0, -1e9).float().contiguous()
        for bb in (None, bias):
            out = speech_attention(q, k, v, bb)
            torch.cuda.synchronize()
            err = float((out - _speech_attention_plain(q, k, v, bb)).abs().max())
            worst = max(worst, err)
            say(f"[k1] B={b} T={t} H=4 dh=64 bias={bb is not None} "
                f"max|kernel-plain|={err:.3e} (limit {KERNEL_TOL:g})")
            if not err <= KERNEL_TOL:
                raise AssertionError(f"K1 disagrees with its plain version "
                                     f"at B={b} T={t}: {err}")

    # timing at the batch request's shape: B=4, T=400 (4 s), no mask
    b, t, h, dh = 4, 400, 4, 64
    q, k, v = (torch.randn(b, t, h, dh, device="cuda", generator=g)
               for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    d = h * dh
    flops = 4.0 * b * t * t * d
    nbytes = 4.0 * b * t * d * 4
    timing = with_bound(time_in_turns(
        lambda: _speech_attention_plain(q, k, v),
        lambda: speech_attention(q, k, v), lambda: sdpa(qt, kt, vt)),
        flops, nbytes)
    say(f"[k1] timing B={b} T={t} H={h} dh={dh}: kernel {timing['ms']:.4f} / "
        f"{timing['ms_2']:.4f} ms, plain {timing['plain_ms']:.4f} / "
        f"{timing['plain_ms_2']:.4f} ms, sdpa (yardstick, not used by the "
        f"port) {timing['library_ms']:.4f} ms, bound "
        f"{timing['bound_ms']:.4f} ms ({timing['bound_by']}: "
        f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)")
    return worst, timing


def check_k2(seed: int):
    """K2 against its plain version: equal int8 values and equal scales, a
    round trip within one step; returns (max |difference|, timings)."""
    from sincformer_tpu_torch.ops.quantize import (_quantize_plain,
                                                   dequantize_int8,
                                                   quantize_int8)
    g = torch.Generator(device="cuda").manual_seed(seed)
    worst = 0.0
    # leaves of the two models ((out, in) rows, a flattened conv, a memory
    # bank scaled by column), a ragged size, R*C no multiple of 4 or 256
    cases = [((1024, 256), 0), ((256, 1024), 0), ((768, 256), 0),
             ((256, 64 * 251), 0), ((64, 129), 1), ((67, 129), 0),
             ((67, 129), 1), ((4099, 3), 0), ((1, 4099), 1)]
    for (r, c), axis in cases:
        x = torch.randn(r, c, device="cuda", generator=g) * 0.1
        vals, scales = quantize_int8(x, seed=seed + 7, channel_axis=axis)
        torch.cuda.synchronize()
        amax = x.abs().amax(dim=1 - axis)
        want_scales = torch.clamp(amax, min=1e-12) / 127.0
        s = scales[:, None] if axis == 0 else scales[None, :]
        plain = _quantize_plain(x, s, seed + 7)
        diff = float((vals.int() - plain.int()).abs().max())
        worst = max(worst, diff)
        round_trip = float(((dequantize_int8(vals, scales, axis) - x).abs()
                            / s).max())
        say(f"[k2] ({r}, {c}) scales along axis {axis}: max|kernel-plain| "
            f"{diff:g} int8 steps, scales equal "
            f"{bool(torch.equal(scales, want_scales))}, round trip "
            f"{round_trip:.4f} steps (limit 1)")
        if diff != 0 or vals.dtype != torch.int8:
            raise AssertionError(f"K2 int8 output differs from its plain "
                                 f"version at ({r}, {c})")
        if not torch.equal(scales, want_scales):
            raise AssertionError(f"K2 scales differ at ({r}, {c})")
        if not round_trip <= 1.0 + 1e-6:
            raise AssertionError(f"K2 round trip {round_trip} steps")
    x = torch.randn(256, 1024, device="cuda", generator=g) * 0.1
    n = x.numel()

    def plain():
        amax = x.abs().amax(dim=1, keepdim=True)
        return _quantize_plain(x, torch.clamp(amax, min=1e-12) / 127.0, 3)

    timing = with_bound(time_in_turns(
        plain, lambda: quantize_int8(x, seed=3)),
        K2_OPS_PER_ELEMENT * n, 5.0 * n + 4.0 * x.shape[0])
    say(f"[k2] timing (256, 1024) leaf, amax included: kernel "
        f"{timing['ms']:.4f} / {timing['ms_2']:.4f} ms, plain "
        f"{timing['plain_ms']:.4f} / {timing['plain_ms_2']:.4f} ms, no "
        f"single PyTorch call computes it (library: none), bound "
        f"{timing['bound_ms']:.5f} ms ({timing['bound_by']}: "
        f"{5.0 * n / 1e6:.2f} MB)")
    return worst, timing


def check_k3(seed: int):
    """K3 against its plain version; returns (max err / scale, timings)."""
    import torch.nn.functional as F

    from sincformer_tpu_torch.ops.fused_ffn import (LN_EPS, _fused_ffn_plain,
                                                    fused_ffn)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def args(m, d, f):
        def r(*shape, scale=1.0):
            return torch.randn(*shape, device="cuda", generator=g) * scale
        return (r(m, d), 1.0 + r(d, scale=0.1), r(d, scale=0.1),
                r(d, f, scale=d ** -0.5), r(f, scale=0.1),
                r(f, d, scale=f ** -0.5), r(d, scale=0.1))

    worst = worst_abs = 0.0
    shapes = [(m, 256, 1024) for m in FFN_ROWS] + [(130, 32, 64),
                                                   (70, 64, 96),
                                                   (200, 128, 512)]
    for m, d, f in shapes:
        a = args(m, d, f)
        out = fused_ffn(*a)
        torch.cuda.synchronize()
        ref = _fused_ffn_plain(*a)
        err, scale = float((out - ref).abs().max()), float(ref.abs().max())
        worst, worst_abs = max(worst, err / scale), max(worst_abs, err)
        say(f"[k3] rows={m} d={d} d_ff={f}: max|kernel-plain|={err:.3e}, "
            f"output scale {scale:.3f}, ratio {err / scale:.3e} "
            f"(limit {KERNEL_TOL:g})")
        if not err <= KERNEL_TOL * scale:
            raise AssertionError(f"K3 disagrees with its plain version at "
                                 f"rows={m} d={d} d_ff={f}: {err}")

    m, d, f = FFN_ROWS[0], 256, 1024
    x, ln_g, ln_b, w1, b1, w2, b2 = a = args(m, d, f)
    w1_oi, w2_oi = w1.t().contiguous(), w2.t().contiguous()

    def library():
        xn = F.layer_norm(x, (d,), ln_g, ln_b, LN_EPS)
        return x + 0.5 * F.linear(F.silu(F.linear(xn, w1_oi, b1)), w2_oi, b2)

    flops = 4.0 * m * d * f
    nbytes = 4.0 * (2 * m * d + 2 * d * f + 3 * d + f)
    timing = with_bound(time_in_turns(
        lambda: _fused_ffn_plain(*a), lambda: fused_ffn(*a), library,
        iters=20), flops, nbytes)
    say(f"[k3] timing rows={m} d={d} d_ff={f}: kernel {timing['ms']:.4f} / "
        f"{timing['ms_2']:.4f} ms, plain {timing['plain_ms']:.4f} / "
        f"{timing['plain_ms_2']:.4f} ms, layer_norm + 2 linear + silu "
        f"(yardstick, not used by the port) {timing['library_ms']:.4f} ms, "
        f"bound {timing['bound_ms']:.4f} ms ({timing['bound_by']}: "
        f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
    return worst_abs, timing


def check_istft(seed: int) -> None:
    """The iSTFT on the card must not depend on the batch size: one batch of
    16 windows against four batches of 4 and against the CPU, on a spectrum
    with imaginary DC and Nyquist bins (as a mask leaves them)."""
    from sincformer_tpu_torch.dsp.stft import istft
    g = torch.Generator().manual_seed(seed)
    spec = torch.complex(torch.randn(16, 401, 129, generator=g),
                         torch.randn(16, 401, 129, generator=g))
    on_card = spec.cuda()
    whole = istft(on_card, length=32000)
    parts = torch.cat([istft(on_card[i:i + 4], length=32000)
                       for i in range(0, 16, 4)])
    split = float((whole - parts).abs().max())
    host = float((whole.cpu() - istft(spec, length=32000)).abs().max())
    say(f"[istft] (16, 401, 129) on the card: one batch vs four batches "
        f"{split:.3e}, card vs CPU {host:.3e} (limit {KERNEL_TOL:g}, "
        f"outputs of scale {float(whole.abs().max()):.3f})")
    if not max(split, host) <= KERNEL_TOL:
        raise AssertionError("the iSTFT depends on the batch size or device")


def check_paths_agree(outs: dict, what: str, pcm: bool = False) -> None:
    """Hold every path's output against the first one's."""
    names = list(outs)
    ref = outs[names[0]]
    for name in names[1:]:
        got = outs[name]
        if got.shape != ref.shape or got.dtype != ref.dtype:
            raise AssertionError(f"{what}: {name} gave {got.dtype} "
                                 f"{got.shape}, {names[0]} {ref.dtype} "
                                 f"{ref.shape}")
        if pcm:
            diff = int(np.abs(got.astype(np.int32) - ref).max())
            say(f"[{what}] {name} vs {names[0]}, int16 out: max difference "
                f"{diff} LSB (limit 1)")
            ok = diff <= 1
        else:
            peak = float(np.abs(ref).max())
            rel = float(np.abs(got - ref).max()) / peak
            say(f"[{what}] {name} vs {names[0]}: max difference {rel:.3e} of "
                f"the peak {peak:.4f} (limit {WAVE_TOL:g})")
            ok = np.all(np.isfinite(got)) and rel <= WAVE_TOL
        if not ok:
            raise AssertionError(f"{what}: {name} disagrees with {names[0]}")


def long_form(pipe, what: str, pcm60: np.ndarray, smi: str, launches,
              per_forward: dict) -> dict:
    """The 60 s request through the whole-file, the segmented and the host
    path of StreamingEnhancer: launch counts, agreement, wall times."""
    from sincformer_tpu_torch.serve import StreamingEnhancer
    enhancers = {
        "whole-file": StreamingEnhancer(pipe, pipelined=False),
        "segmented": StreamingEnhancer(pipe, pipelined=True, chunk_batch=4),
        "host": StreamingEnhancer(pipe, device_ola=False)}
    hop = 32000 - 1600
    windows = -(-len(pcm60) // hop)
    forwards = {"whole-file": 1, "segmented": -(-windows // 4), "host": 1}
    if forwards["segmented"] < 3:
        raise AssertionError("the segmented path needs at least 3 segments")
    outs, outs16 = {}, {}
    for name, se in enhancers.items():
        launches.reset()
        outs[name] = se.enhance(pcm60)
        launches.expect(f"{what} {name} path", **{
            k: n * forwards[name] for k, n in per_forward.items()})
        outs16[name] = se.enhance(pcm60, pcm16_out=True)
        launches.reset()
        if outs[name].shape != pcm60.shape or outs[name].dtype != np.float32:
            raise AssertionError(f"{what} {name}: bad output "
                                 f"{outs[name].dtype} {outs[name].shape}")
    check_paths_agree(outs, what)
    check_paths_agree(outs16, what, pcm=True)
    audio_s = len(pcm60) / 8000
    for name, se in enhancers.items():
        wall = wall_s(lambda se=se: se.enhance(pcm60))
        say(f"[perf] {what} {audio_s:.0f} s int16 file, {name} path "
            f"({windows} windows, {forwards[name]} forward passes): "
            f"{wall * 1e3:.3f} ms wall, {audio_s / wall:.1f}x real time on "
            f"{smi}")
    launches.reset()
    return outs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the GPU",
              file=sys.stderr)
        return 1

    import sincformer_tpu_torch as port
    from sincformer_tpu_torch import cli
    from sincformer_tpu_torch.dsp.stft import stft
    from sincformer_tpu_torch.ops import build
    from sincformer_tpu_torch.utils.signal import pcm_to_float

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    say(f"[card] {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ── phase 1: build every kernel, one nvcc each, all started together ──
    t0 = time.perf_counter()
    built = build.build_all()
    say(f"[build] {', '.join(f'{n}.cu' for n in built)} -> sm_90a in "
        f"{time.perf_counter() - t0:.1f} s")

    # ── phase 2: each kernel alone against its plain version ─────────────
    k1_err, k1_time = check_k1(args.seed)
    k2_err, k2_time = check_k2(args.seed)
    k3_err, k3_time = check_k3(args.seed)
    check_istft(args.seed)
    launches = Launches()

    # ── phase 3: full-width flagship, a few requests on the card ─────────
    config = port.MetacogConfig()
    model = port.SincformerMetacog(config).init_params(
        torch.Generator().manual_seed(args.seed))
    gain = port.resolve_output_gain(os.path.join(
        ARTIFACT, "sincformer_final", "step_210"))
    cpu_model = port.SincformerMetacog(config)
    cpu_model.load_state_dict(model.state_dict())
    gpu = port.SincformerPipeline(model, device="cuda", output_gain=gain)
    cpu = port.SincformerPipeline(cpu_model, device="cpu", output_gain=gain)
    n_params = sum(p.numel() for p in model.parameters())
    say(f"[model] SincformerMetacog {n_params} params, {config}, "
        f"output_gain {gain}")

    rng = np.random.default_rng(args.seed)
    signals = [speechlike(rng, n) for n in (8000, 20000, 32000)]
    batch = np.stack([speechlike(rng, 32000) for _ in range(4)])
    batch16 = to_pcm(batch)

    launches.reset()
    t0 = time.perf_counter()
    outs = []
    for s in signals:
        outs.append(gpu.enhance_signal(s))
        launches.expect("flagship enhance_signal",
                        speech_attention=config.msa_blocks)
    outs.append(gpu.enhance_batch(batch16))
    launches.expect("flagship enhance_batch",
                    speech_attention=config.msa_blocks)
    serve_s = time.perf_counter() - t0
    say(f"[serve] 4 requests (1 s, 2.5 s, 4 s, 4x4 s int16) in "
        f"{serve_s:.2f} s wall (first calls: cuDNN/cuFFT plans included); "
        f"K1 launches {launches.total['speech_attention']} = 4 forwards x "
        f"{config.msa_blocks} blocks")
    expected = [s.shape for s in signals] + [batch.shape]
    for o, shape in zip(outs, expected):
        if o.shape != shape or not np.all(np.isfinite(o)):
            raise AssertionError(f"bad output: shape {o.shape} (want {shape}),"
                                 f" finite {bool(np.all(np.isfinite(o)))}")

    # ── phase 4: the same weights and inputs on the CPU ──────────────────
    refs = [cpu.enhance_signal(s) for s in signals] + [cpu.enhance_batch(batch16)]
    with torch.inference_mode():
        wav = pcm_to_float(torch.from_numpy(batch16))
        spec = stft(wav)
        dec_cpu = cpu_model(wav, spec.real, spec.imag)
        wav_g = wav.cuda()
        spec_g = stft(wav_g)
        dec_gpu = model(wav_g, spec_g.real, spec_g.imag)
    flips = (dec_cpu["decisions"] != dec_gpu["decisions"].cpu())
    logits = dec_cpu["route_logits"].sort(dim=-1, descending=True).values
    margins = (logits[..., 0] - logits[..., 1])[flips]
    say(f"[parity] MAA decisions card vs CPU: {int(flips.sum())} of "
        f"{flips.numel()} frames differ" + (
            f", CPU logit margins {margins.tolist()}" if flips.any() else ""))
    if flips.any() and float(margins.max()) >= TIE_MARGIN:
        raise AssertionError("an MAA decision flipped away from a near tie")
    worst_rel = 0.0
    for o, r, name in zip(outs, refs, ("1 s", "2.5 s", "4 s", "batch")):
        err = float(np.max(np.abs(o - r)))
        rel = err / float(np.max(np.abs(r)))
        worst_rel = max(worst_rel, rel)
        say(f"[parity] {name}: max|card-CPU| {err:.3e}, peak "
            f"{np.max(np.abs(r)):.4f}, ratio {rel:.3e} (limit {WAVE_TOL:g})")
    if not flips.any() and not worst_rel <= WAVE_TOL:
        raise AssertionError(f"card and CPU disagree: {worst_rel}")

    # ── phase 5: batch request time after warm-up ────────────────────────
    wall = wall_s(lambda: gpu.enhance_batch(batch16), reps=20)
    audio_s = batch.size / 8000
    say(f"[perf] enhance_batch (4, 32000) int16: {wall * 1e3:.3f} ms per "
        f"request, {audio_s / wall:.1f}x real time ({audio_s:.0f} s of audio)"
        f" on {smi}")
    del gpu, cpu, model, cpu_model
    launches.reset()

    # ── phase 6: serving from the committed trained artifact ─────────────
    trained = port.SincformerPipeline(device="cuda", model_dir=ARTIFACT)
    say(f"[artifact] loaded {os.path.relpath(trained.load_model(), REPO)}, "
        f"step {trained.step}, output_gain {trained.output_gain}")
    n_leaves = sum(1 for p in trained.model.parameters()
                   if p.ndim >= 2 and p.numel() >= 4096)
    n_quantized = sum(p.numel() for p in trained.model.parameters()
                      if p.ndim >= 2 and p.numel() >= 4096)
    with tempfile.TemporaryDirectory() as exported:
        os.environ["SINCFORMER_MODEL_DIR"] = ARTIFACT
        launches.reset()
        t0 = time.perf_counter()
        if cli.main(["export", "--model", "sincformer", "--ckpt", "final",
                     "--out", exported]) != 0:
            raise AssertionError("the export verb failed")
        export_s = time.perf_counter() - t0
        launches.expect("export", quantize_int8=n_leaves)
        served = port.SincformerPipeline(device="cuda", model_dir=exported)
        served.load_model()
        size_mb = sum(os.path.getsize(os.path.join(r, f))
                      for r, _, fs in os.walk(exported) for f in fs) / 1e6
    params = dict(trained.model.named_parameters())
    tree_s = wall_s(lambda: port.quantize_tree(params))
    launches.reset()
    say(f"[export] {n_leaves} leaves ({n_quantized} elements) through K2, "
        f"{size_mb:.1f} MB written, export verb {export_s:.2f} s wall; "
        f"quantize_tree alone {tree_s * 1e3:.3f} ms wall against "
        f"{5.0 * n_quantized / PEAK_BYTES * 1e3:.4f} ms of bytes "
        f"({5.0 * n_quantized / 1e6:.1f} MB) on {smi}")
    if served.output_gain != trained.output_gain or served.step != 210:
        raise AssertionError("the exported artifact lost its gain or step")

    rng = np.random.default_rng(args.seed + 1)
    pcm60 = to_pcm(speechlike(rng, 480000))
    flagship_forward = {"speech_attention": config.msa_blocks}
    outs = long_form(served, "flagship", pcm60, smi, launches,
                     flagship_forward)
    # the first window on the CPU, from the artifact as committed: the card,
    # the export's second rounding and the cross-fade all stay small
    on_cpu = port.SincformerPipeline(device="cpu", model_dir=ARTIFACT)
    on_cpu.load_model()
    head = on_cpu.enhance_signal(pcm60[:32000])[:28000]
    for name, got in (("committed artifact", trained.enhance_signal(
            pcm60[:32000])[:28000]), ("exported artifact, 60 s request",
                                      outs["whole-file"][:28000])):
        rel = float(np.linalg.norm(got - head) / np.linalg.norm(head))
        say(f"[parity] first 3.5 s, {name} on the card vs committed "
            f"artifact on the CPU: relative L2 difference {rel:.3e}, max "
            f"{float(np.abs(got - head).max()):.3e} (limit 1e-2 in L2: an "
            f"MAA tie may flip a frame, the export rounds the weights once "
            f"more)")
        if not rel <= 1e-2:
            raise AssertionError("the served request left the CPU reference")

    from sincformer_tpu_torch.serve import (OnlineEnhancer,
                                            OnlineEnhancerPool,
                                            StreamingEnhancer)
    files = [speechlike(rng, n) for n in (8000, 12000, 20500, 32000, 70000)]
    launches.reset()
    many = StreamingEnhancer(served).enhance_many(files)
    # four padded lengths batched alone, one file of 3 windows streamed
    launches.expect("enhance_many", speech_attention=5 * config.msa_blocks)
    for f, o in zip(files, many):
        if o.shape != f.shape or not np.all(np.isfinite(o)):
            raise AssertionError("enhance_many: bad output")
    say(f"[serve] enhance_many: 5 files of "
        f"{[len(f) / 8000 for f in files]} s, shapes kept, all finite")

    streams = [speechlike(rng, 8000) for _ in range(8)]

    def run_pool():
        pool = OnlineEnhancerPool(served, n_streams=8)
        for pos in range(0, 8000, pool.chunk):
            for i, s in enumerate(streams):
                pool.push(i, s[pos:pos + pool.chunk])
            pool.step()
        return [np.concatenate([pool.take(i), pool.flush(i)])
                for i in range(8)]

    def run_solo():
        outs = []
        for s in streams:
            oe = OnlineEnhancer(served)
            parts = [oe.push(s[pos:pos + oe.chunk])
                     for pos in range(0, 8000, oe.chunk)]
            outs.append(np.concatenate(parts + [oe.flush()]))
        return outs

    launches.reset()
    pooled = run_pool()
    pool_steps = launches.read()["speech_attention"] // config.msa_blocks
    # 48 lockstep steps (the first two pushes finalize nothing), then every
    # stream's flush drains its last two chunks on its own
    launches.expect("online pool",
                    speech_attention=(48 + 8 * 2) * config.msa_blocks)
    solo = run_solo()
    launches.expect("8 solo online enhancers",
                    speech_attention=8 * 50 * config.msa_blocks)
    worst = 0.0
    for p, s, x in zip(pooled, solo, streams):
        if p.shape != x.shape or s.shape != x.shape:
            raise AssertionError("online output is not sample-aligned")
        worst = max(worst, float(np.abs(p - s).max() / np.abs(s).max()))
    say(f"[online] pool of 8 streams x 1 s ({pool_steps} batched steps) vs 8 "
        f"solo enhancers: max difference {worst:.3e} of the peak (limit "
        f"{WAVE_TOL:g})")
    if not worst <= WAVE_TOL:
        raise AssertionError("the pool disagrees with the solo enhancers")
    pool_wall, solo_wall = wall_s(run_pool, reps=2), wall_s(run_solo, reps=1)
    say(f"[perf] online, 8 streams x 1 s: pool {pool_wall * 1e3:.1f} ms wall "
        f"({8 / pool_wall:.1f}x real time aggregate, "
        f"{pool_wall / pool_steps * 1e3:.3f} ms per 20 ms step), 8 solo "
        f"enhancers {solo_wall * 1e3:.1f} ms ({8 / solo_wall:.1f}x) on {smi}")
    del trained, served, on_cpu
    launches.reset()

    # ── phase 7: DCSE with the fused feed-forward ────────────────────────
    dcfg = port.DCSEConfig(fused_ffn=True)
    fused_model = port.SpeechEnhancer(dcfg).init_params(
        torch.Generator().manual_seed(args.seed))
    plain_model = port.SpeechEnhancer(port.DCSEConfig(fused_ffn=False))
    plain_model.load_state_dict(fused_model.state_dict())
    fused = port.DCSEPipeline(fused_model, device="cuda")
    unfused = port.DCSEPipeline(plain_model, device="cuda")
    say(f"[model] SpeechEnhancer "
        f"{sum(p.numel() for p in fused_model.parameters())} params, {dcfg}")
    dcse_forward = {"speech_attention": dcfg.num_blocks,
                    "fused_ffn": 2 * dcfg.num_blocks}
    outs = long_form(fused, "dcse", pcm60, smi, launches, dcse_forward)
    launches.reset()
    group = to_pcm(np.stack([speechlike(rng, 32000) for _ in range(4)]
                            ).repeat(16, axis=0))             # (64, 32000)
    got = fused.enhance_batch(group)
    launches.expect("dcse enhance_batch (64, 32000)", **dcse_forward)
    want = unfused.enhance_batch(group)
    ref60 = StreamingEnhancer(unfused, pipelined=False).enhance(pcm60)
    launches.expect("dcse unfused", speech_attention=2 * dcfg.num_blocks)
    check_paths_agree({"unfused": want, "fused": got},
                      "dcse (64, 32000) batch")
    check_paths_agree({"unfused": ref60, "fused": outs["whole-file"]},
                      "dcse 60 s")
    for name, pipe in (("fused", fused), ("unfused", unfused)):
        wall = wall_s(lambda pipe=pipe: pipe.enhance_batch(group), reps=5)
        say(f"[perf] dcse enhance_batch (64, 32000) int16, {name}: "
            f"{wall * 1e3:.3f} ms wall, {64 * 4 / wall:.1f}x real time on "
            f"{smi}")
    launches.reset()

    def row(name, source, replaces, err, timing):
        return {"name": name, "route": "cuda",
                "source": f"sincformer_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches.total[name],
                "max_abs_err": err, "ms": timing["ms"],
                "plain_ms": timing["plain_ms"],
                "bound_ms": timing["bound_ms"],
                "bound_by": timing["bound_by"],
                "library_ms": timing["library_ms"]}
    kernels = [
        row("speech_attention", "speech_attention.cu",
            "sincformer_tpu/ops/speech_attention.py:70", k1_err, k1_time),
        row("quantize_int8", "quantize_int8.cu",
            "sincformer_tpu/ops/quantize.py:34", k2_err, k2_time),
        row("fused_ffn", "fused_ffn.cu",
            "sincformer_tpu/ops/fused_ffn.py:39", k3_err, k3_time)]
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} was never launched on the "
                                 f"driven paths")
    say(f"[card] {smi}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
