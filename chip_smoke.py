"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Builds the port's CUDA kernel (speech attention, K1) from
``sincformer_tpu_torch/csrc/`` and holds it against its plain PyTorch
version on the card; serves a few requests through the flagship
Sincformer-metacog enhancement path at full width (random weights from a
seeded ``torch.Generator``), checks that every MSA block went through K1,
holds the card's output against the same port on the CPU, and times the
kernel and the batch request. Exits non-zero on any failure, and at once
when no CUDA device is present. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it holds the kernel
table as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
KERNEL_TOL = 1e-5      # f32 on both sides, sums in another order
WAVE_TOL = 1e-4        # card vs CPU, relative to the waveform's peak
TIE_MARGIN = 1e-3      # MAA logit gap below which a decision flip is a tie
ATTN_TS = (50, 100, 250, 400, 601, 2100)


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


def check_kernel(seed: int):
    """Phase 2: K1 against its plain version; returns (max err, timings)."""
    from sincformer_tpu_torch.ops import build
    from sincformer_tpu_torch.ops.speech_attention import (
        _speech_attention_plain, speech_attention)
    t0 = time.perf_counter()
    build.build("speech_attention")
    say(f"[build] speech_attention.cu -> sm_90a in "
        f"{time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(seed)
    worst = 0.0
    shapes = [(4, t) for t in ATTN_TS] + [(1, 100), (1, 250)]
    for b, t in shapes:
        q, k, v = (torch.randn(b, t, 4, 64, device="cuda", generator=g)
                   for _ in range(3))
        lengths = torch.tensor([t, t - 7, t // 2, 1][:b], device="cuda")
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
    timing = {}
    for name, fn in (("plain_ms", lambda: _speech_attention_plain(q, k, v)),
                     ("ms", lambda: speech_attention(q, k, v)),
                     ("ms_2", lambda: speech_attention(q, k, v)),
                     ("plain_ms_2", lambda: _speech_attention_plain(q, k, v)),
                     ("library_ms", lambda: sdpa(qt, kt, vt))):
        timing[name] = cuda_ms(fn)
    d = h * dh
    flops = 4.0 * b * t * t * d
    nbytes = 4.0 * b * t * d * 4
    timing["bound_ms"] = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    timing["bound_by"] = ("operations" if flops / PEAK_F32_FLOPS
                          >= nbytes / PEAK_BYTES else "bytes")
    say(f"[k1] timing B={b} T={t} H={h} dh={dh}: kernel {timing['ms']:.4f} / "
        f"{timing['ms_2']:.4f} ms, plain {timing['plain_ms']:.4f} / "
        f"{timing['plain_ms_2']:.4f} ms, sdpa (yardstick, not used by the "
        f"port) {timing['library_ms']:.4f} ms, bound "
        f"{timing['bound_ms']:.4f} ms ({timing['bound_by']}: "
        f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)")
    return worst, timing


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the GPU",
              file=sys.stderr)
        return 1

    import sincformer_tpu_torch as port
    from sincformer_tpu_torch.dsp.stft import stft
    from sincformer_tpu_torch.ops.speech_attention import speech_attention
    from sincformer_tpu_torch.utils.signal import pcm_to_float

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    say(f"[card] {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ── phase 2: the kernel alone ────────────────────────────────────────
    k1_err, k1_time = check_kernel(args.seed)

    # ── phase 3: full-width flagship, a few requests on the card ─────────
    config = port.MetacogConfig()
    model = port.SincformerMetacog(config).init_params(
        torch.Generator().manual_seed(args.seed))
    gain = port.read_output_gain(os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "artifacts/r5/sincformer_v4s0_best_serving/sincformer_final/step_210"))
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
    batch16 = np.round(batch * 32767).astype(np.int16)

    speech_attention.launches = 0
    t0 = time.perf_counter()
    outs = []
    for s in signals:
        before = speech_attention.launches
        outs.append(gpu.enhance_signal(s))
        if speech_attention.launches - before != config.msa_blocks:
            raise AssertionError(f"{speech_attention.launches - before} K1 "
                                 f"launches in one forward, expected "
                                 f"{config.msa_blocks}")
    before = speech_attention.launches
    outs.append(gpu.enhance_batch(batch16))
    if speech_attention.launches - before != config.msa_blocks:
        raise AssertionError("the batch forward did not launch K1 once per "
                             "MSA block")
    serve_s = time.perf_counter() - t0
    launches = speech_attention.launches
    say(f"[serve] 4 requests (1 s, 2.5 s, 4 s, 4x4 s int16) in "
        f"{serve_s:.2f} s wall (first calls: cuDNN/cuFFT plans included); "
        f"K1 launches {launches} = 4 forwards x {config.msa_blocks} blocks")
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
    for _ in range(3):
        gpu.enhance_batch(batch16)
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        gpu.enhance_batch(batch16)
    wall = (time.perf_counter() - t0) / reps
    audio_s = batch.size / 8000
    say(f"[perf] enhance_batch (4, 32000) int16: {wall * 1e3:.3f} ms per "
        f"request, {audio_s / wall:.1f}x real time ({audio_s:.0f} s of audio)"
        f" on {smi}")

    kernels = [{
        "name": "speech_attention", "route": "cuda",
        "source": "sincformer_tpu_torch/csrc/speech_attention.cu",
        "replaces": "sincformer_tpu/ops/speech_attention.py:70",
        "launches": launches, "max_abs_err": k1_err,
        "ms": k1_time["ms"], "plain_ms": k1_time["plain_ms"],
        "bound_ms": k1_time["bound_ms"], "bound_by": k1_time["bound_by"],
        "library_ms": k1_time["library_ms"]}]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
