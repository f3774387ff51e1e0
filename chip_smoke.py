"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Builds the port's six CUDA kernels (speech attention K1, int8 stochastic
rounding K2, fused feed-forward K3, Meddis hair cell K4, conv + GroupNorm
K5, envelope / activation K6) from ``sincformer_tpu_torch/csrc/``, one
``nvcc`` process each, all started together, and holds each against its
plain PyTorch version on the card. Then it drives the port's paths at full
width and checks, from the wrappers' launch counts, that each went through
its kernels:

  * a few requests through the flagship Sincformer-metacog enhancement
    (random weights from a seeded ``torch.Generator``), held against the
    same port on the CPU, and the batch request's time;
  * serving from the committed trained artifact
    (``artifacts/r5/sincformer_v4s0_best_serving_torch``): load, ``export``
    again through K2 (one launch for the whole tree), load that, a 60 s
    file through the whole-file, the segmented and the host path of
    ``StreamingEnhancer``, five files through ``enhance_many``, and an
    ``OnlineEnhancerPool`` of 8 live streams against 8 solo
    ``OnlineEnhancer``s;
  * the same long-form request through DCSE with the fused feed-forward
    (seeded random weights), held against the unfused model;
  * the auditory front-end: 16 signals of 4 s through the gammatone bank and
    the Meddis hair cell (K4) to frame rates, held against the port on the
    CPU;
  * the PerceptionAgent front-end's fused building blocks through their
    entry points: the sinc filterbank output of 16 signals through
    ``env_act_auto`` (K6) and ``conv1d_gn`` (K5), held against their plain
    versions;
  * serving the original paper's mask DNN at full width (594 -> 3 x 1024 ->
    64, seeded weights): ``save_model(quantize=True)`` through K2 (one
    launch), load, a batch, a padded single request, the 60 s file through
    ``StreamingEnhancer``'s host path and through ``enhance --model pcirm``,
    held against the port on the CPU;
  * flagship training at full width: the ``train`` verb in a process of
    its own (``--synthetic 40 --epochs 2``: 8 steps of 8 x 4 s, two
    validations, best and final checkpoints, then one request served from
    them), 20 steps on one batch with every loss term on (the loss must
    fall; time, device busy time, launches and peak memory of a step), and
    one step from the committed artifact held against the same step on
    the CPU (loss, every gradient leaf, the parameters after AdamW); the
    same with the adversarial branch on (a fresh discriminator, its loss and
    its parameters after Adam held too), and 10 such steps timed;
  * evaluation: the ``evaluate`` verb in a process of its own over the
    committed artifact and a seeded mask DNN saved by the port (every cell
    full, no failure caught, the noisy row and the flagship's means held
    against the JAX package's scores in
    ``artifacts/r5/eval_grid_jax_cpu.json``), the metric sweep against the
    CPU, one cell's device time by part; the ``calibrate`` verb on copies
    of the artifact, card against CPU, persisted and read back;
  * WAV input through the native decoder (built from ``native/wavio.cpp``)
    and ``observability.trace`` around one flagship request;
  * DCSE training at full width: the ``train --pipeline conformer`` verb
    in a process of its own (``--synthetic 40 --epochs 2``, K1 counted in
    the child, its checkpoint serving one request), one dropout-0 step of
    8 x 4 s with ``conv_norm`` "layer" and "batch" held against the CPU and
    float64, the fused feed-forward (K3) in a validation pass and in a
    dropout-0 step against the unfused one, and 20 timed steps;
  * mask-DNN training: the ``train --pipeline dnn`` verb (RBM on) and
    ``enhance --model pcirm`` from its checkpoint, the preprocessing card vs
    CPU, one Adam step and one CD-1 step card vs CPU, and the OPT-PCIRM
    swarm at ``PSOConfig()`` card vs CPU;
  * a reference-format ``conformer_final.pt`` served on the card and the
    CPU through ``DCSEPipeline.from_torch_checkpoint``, and the ``demo``
    verb on the card;
  * the flagship's variants at full width with seeded weights (the BiLRU
    CPEA ``ssm``, the reference cascade PerceptionAgent, the dual fine
    stream, ``reference`` + ``ssm``) beside the default flagship: each
    request (4, 32000) on the card against the CPU, the ``export`` verb and
    one request served from its artifact, the request and a training step
    of 8 x 4 s timed (device busy time, launches, peak memory); a training
    step of ``reference`` + ``ssm`` and of ``dual`` against the CPU and
    float64, and ``train --pa reference --cpea ssm`` in a process of its
    own, its checkpoint served by ``enhance``;
  * data parallelism on the one card (``[distributed]``): the flagship's
    and DCSE's training steps on a one-rank NCCL mesh bit-equal to the
    steps without a mesh; two ranks over gloo in processes of their own,
    half of the 8 x 4 s batch each, against the one-process step with the
    whole batch (the MAA statistics, the episodic bank and the BatchNorm
    statistics among the buffers held), the ranks bit-equal; ``evaluate
    --distributed`` in two processes against ``[evaluate]``'s grid; the
    metric sweep split over devices against the unsharded one;
  * tensor and context parallelism (``[parallel]``): the DCSE and flagship
    steps on a (1, 2) ("data", "model") mesh of two gloo ranks, each with
    the whole batch and half of every split parameter, against the
    one-process steps of ``[distributed]``; a DCSE-width ConformerBlock on
    12,000 frames with ring attention and the halo-exchange conv over two
    ranks against one process with K1 (a planted hop that keeps the
    gradient must fail), the halo conv against ``F.conv1d``; the
    multi-device dry run on four processes; a one-rank NCCL model axis
    bit-equal to no mesh; a probe, in two processes of its own, of
    whether gloo gathers and sends CUDA tensors on this card.

K1, K3, K5 and K6 are also held against their plain versions under
autograd (the backward is the plain formulation's gradient: K1's and K3's
gradients are equal bit for bit, K5's and K6's within their bars, and a
wrapper that drops the ``grad_fn`` must fail the check). K1, K2, K3 and K5
are timed from CUDA-graph replays (device time), their eager calls beside
them; K2 also as the flagship's whole tree (73 leaves in one launch,
against the CPU's tree bit for bit). ``--kernels-only`` stops
after the kernels' own checks (a new kernel's first run). Exits non-zero
on any failure, and at once when no CUDA device is present.
The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it holds the kernel table as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, TF32
# on the tensor cores (dense), HBM3
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
TF32_PRODUCTS = 3      # K1, K3, K5: split TF32, three tensor-core products
                       # per product for f32-level results
KERNEL_TOL = 1e-5      # f32 on both sides, sums in another order; K3, K5:
                       # of the output's scale
WAVE_TOL = 1e-4        # two paths or devices, relative to the waveform's peak
DNN_TAIL_TOL = 1e-2    # DNN path, the 6 frames before a request's zero padding
                       # (measured 2.9e-3 on an H100; see check_dnn_wave)
TIE_MARGIN = 1e-3      # MAA logit gap below which a decision flip is a tie
ATTN_TS = (50, 100, 250, 400, 601, 2100)
ATTN_DH_TS = (1, 400, 2100)     # the other head widths (16, 32, 128)
FFN_ROWS = (25664, 6416, 1, 7, 401, 1000)      # 64 and 16 windows of 401 frames
K2_OPS_PER_ELEMENT = 40      # Philox-4x32-10 shared by 4 elements + rounding
K4_OPS_PER_STEP = 19         # f32 operations of one Euler step, the division as one
K4_CHAIN_OPS = 17            # of them on the loop-carried chain q -> c -> w -> q
F32_LATENCY_CYCLES = 4       # assumed latency of one dependent f32 operation
BOOST_HZ = 1.98e9            # H100 SXM maximum SM clock
ENVACT_TOL = 3e-6            # K6: tanh and log1p in f32 on both sides
# the five geometries of tests/test_pallas_ops.py (TestConvGN), k=9 at s=1,
# k=21 at s=2 (11 input rows per output row: outside the TPU kernel's guard;
# 5 channels per group, a group astride two channel tiles), one whose input
# mean is far from zero, and the edges of the tensor-core tiling (64 rows x
# 64 channels, 8 input channels a chunk, taps in groups): Cin % 8 != 0,
# Cout % 64 != 0, Cin and Cout % 4 != 0 (no 16-byte copies), K=1 at s=4,
# Tout under one tile, K=31 (taps in four groups):
# (T, Cin, Cout, K, s, act, skip, input mean, groups)
CONV_GN_CASES = ((1000, 64, 128, 7, 2, True, False, 0.0, 16),
                 (500, 128, 128, 3, 1, False, True, 0.0, 16),
                 (1000, 64, 128, 1, 2, False, False, 0.0, 16),
                 (512, 256, 256, 5, 2, True, False, 0.0, 16),
                 (513, 128, 256, 7, 2, True, False, 0.0, 16),
                 (300, 32, 48, 9, 1, True, True, 0.0, 16),
                 (257, 24, 80, 21, 2, True, False, 0.0, 16),
                 (1000, 64, 128, 7, 2, True, False, 4.0, 16),
                 (100, 24, 48, 1, 4, True, False, 0.0, 16),
                 (333, 12, 80, 5, 4, True, True, 0.0, 16),
                 (50, 3, 18, 3, 1, False, False, 0.0, 3),
                 (1200, 64, 128, 31, 1, True, False, 0.0, 16),
                 (400, 256, 256, 7, 1, True, True, 4.0, 16))
TRAIN_LOSS_TOL = 1e-4       # card vs CPU training step: loss, relative
TRAIN_GRAD_TOL = 1e-3       # each gradient leaf, of its largest magnitude
TRAIN_PARAM_TOL = 1e-5      # parameters after the step, of their scale
TRAIN_FLIP_SHARE = 1e-4     # where the CPU's step is float64's: the share of
                            # elements whose step on the card may leave
                            # float64's by more than that step (the MR-STFT
                            # term's rounding; measured 4.5e-6 on an H100)
DISC_GRAD_TOL = 1e-4        # each discriminator gradient leaf, card vs CPU,
                            # of its largest magnitude (floored as below)
GRAD_FLOOR = 1e-4           # a leaf's scale floored at this x the largest
                            # gradient (the SincConv cutoffs' gradients are
                            # rounding only; tests/test_torch_train_step.py)
TRAIN_BATCH = (8, 32000)    # the train verb's batches: 8 x 4 s
# evaluation: the [0, 1] metrics and SSNR (dB) of the noisy row against the
# committed JAX reference and of the metric sweep card vs CPU; the noisy
# row's P.862 is the same numpy code on the same inputs (the two machines'
# numpy and scipy may differ in the last bits); the flagship's means through
# the model on the card
EVAL_UNIT_TOL = 1e-5
EVAL_SSNR_TOL = 1e-4
EVAL_P862_TOL = 1e-6
EVAL_MEAN_TOL = {"stoi": 1e-4, "pesq": 1e-2, "ssnr": 1e-2, "csii": 1e-4,
                 "ncm": 1e-4}
GAIN_TOL = 1e-4             # calibrated gain, card vs CPU, relative
DCSE_STATS_TOL = 1e-5       # BatchNorm running statistics after a training
                            # forward, card vs CPU, of their scale (>= 1)
CLIP_TOL = 1e-4             # the DCSE step's global-norm clip factor, card
                            # vs CPU, relative
DIST_GRID_TOL = 1e-6        # evaluate --distributed and the split metric
                            # sweep vs the one-process grid, per value (the
                            # sweep's of max(1, |value|): SSNR is in dB)
# the flagship's variants beside the default ([variants]); the last two
# also take a training step against the CPU
VARIANT_CONFIGS = (("default", {}), ("ssm", {"cpea_impl": "ssm"}),
                   ("reference", {"pa_impl": "reference"}),
                   ("dual", {"pa_fine_feats": "dual"}),
                   ("reference+ssm", {"pa_impl": "reference",
                                      "cpea_impl": "ssm"}))
VARIANT_CPU_STEPS = ("reference+ssm", "dual")   # a step card vs CPU
VARIANT_REPS = 10           # timed batch requests of each variant
VARIANT_STEPS_TIMED = 5     # timed training steps of each variant
VARIANTS = ("pa_impl", "pa_fine_feats", "cpea_impl")
REPO = os.path.dirname(os.path.abspath(__file__))
ARTIFACT = os.path.join(REPO, "artifacts", "r5",
                        "sincformer_v4s0_best_serving_torch")
EVAL_REFERENCE = os.path.join(REPO, "artifacts", "r5",
                              "eval_grid_jax_cpu.json")


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


def graph_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Mean device time of fn() in ms: ``iters`` calls captured in one CUDA
    graph, one replay between CUDA events. The host's time per call (the
    wrapper's checks, the ctypes call) drops out, so a call shorter than
    its launch is timed by the device's work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_in_turns(plain, kernel, library=None, iters: int = 50,
                  graph: bool = False) -> dict:
    """plain, kernel, kernel, plain (and the library call, where there is
    one), each the mean of ``iters`` launches; with ``graph``, replayed from
    a CUDA graph (device time), and the kernel's eager time beside it as
    ``ms_eager``."""
    timer = graph_ms if graph else cuda_ms
    timing = {"plain_ms": timer(plain, iters), "ms": timer(kernel, iters),
              "ms_2": timer(kernel, iters),
              "plain_ms_2": timer(plain, iters)}
    timing["library_ms"] = timer(library, iters) if library else None
    if graph:
        timing["ms_eager"] = cuda_ms(kernel, iters)
    return timing


def with_bound(timing: dict, flops: float, nbytes: float,
               tf32x3: bool = False) -> dict:
    """The least time of the work on this card: f32 operations on the CUDA
    cores or bytes. For a split-TF32 kernel (``tf32x3``) ``bound_ms`` is
    three TF32 tensor-core products per product, the least time of
    f32-level results, and the f32 bound is kept as ``bound_f32_ms``."""
    by_ops, by_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    if tf32x3:
        timing["bound_f32_ms"] = max(by_ops, by_bytes) * 1e3
        by_ops = TF32_PRODUCTS * flops / PEAK_TF32_FLOPS
    timing["bound_ms"] = max(by_ops, by_bytes) * 1e3
    timing["bound_by"] = "operations" if by_ops >= by_bytes else "bytes"
    return timing


def profile_once(fn) -> dict:
    """One call of ``fn`` under torch.profiler: its wall ms, device busy
    ms (of which ``copy_ms`` in memory copies and sets), kernel launches,
    and its kernels as (name, ms, calls), longest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda k: -k[1])
    return {"wall_ms": wall_ms, "busy_ms": sum(k[1] for k in kernels),
            "copy_ms": sum(k[1] for k in kernels
                           if k[0].startswith(("Memcpy", "Memset"))),
            "launches": sum(k[2] for k in kernels), "kernels": kernels}


def timed_steps(step, n: int, k1_per_step: int, launches,
                what: str) -> dict:
    """``n`` training steps on the card (``step()`` returns the loss), each
    holding K1's launches to ``k1_per_step``, then one profiled step: the
    losses, the wall ms of each step and their median over steps 2 to n,
    K1's launches (the profiled step's last), the peak memory, and the
    profiled step (:func:`profile_once`)."""
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    losses, step_ms, k1 = [], [], []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step()))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        k1.append(launches.expect(f"{what} {i}", speech_attention=k1_per_step)[
            "speech_attention"])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = profile_once(step)
    k1.append(launches.expect(f"profiled {what}",
                              speech_attention=k1_per_step)[
        "speech_attention"])
    return {"losses": losses, "step_ms": step_ms,
            "median_ms": float(np.median(step_ms[1:])), "k1": k1,
            "peak_gb": peak_gb, "profiled": prof}


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
    """The six wrappers' launch counts: set to 0 before a path is driven,
    read after it, summed per kernel over the paths."""

    def __init__(self):
        from sincformer_tpu_torch.ops.conv_gn import conv1d_gn
        from sincformer_tpu_torch.ops.envact import env_act
        from sincformer_tpu_torch.ops.fused_ffn import fused_ffn
        from sincformer_tpu_torch.ops.meddis import meddis
        from sincformer_tpu_torch.ops.quantize import quantize_int8
        from sincformer_tpu_torch.ops.speech_attention import speech_attention
        self.wrappers = {"speech_attention": speech_attention,
                         "quantize_int8": quantize_int8,
                         "fused_ffn": fused_ffn, "meddis": meddis,
                         "conv1d_gn": conv1d_gn, "env_act": env_act}
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


def check_k1(seed: int, smi: str):
    """K1 against its plain version; returns (max err, timings at the
    batch request's shape, timings at the 60 s file's shape)."""
    from sincformer_tpu_torch.ops.speech_attention import (
        _speech_attention_plain, speech_attention)
    g = torch.Generator(device="cuda").manual_seed(seed)
    worst = 0.0
    shapes = ([(4, t, 64) for t in ATTN_TS] + [(1, 100, 64), (1, 250, 64),
                                               (16, 401, 64)]
              + [(4, t, dh) for dh in (16, 32, 128) for t in ATTN_DH_TS])
    for b, t, dh in shapes:
        q, k, v = (torch.randn(b, t, 4, dh, device="cuda", generator=g)
                   for _ in range(3))
        lengths = torch.tensor(([t, t - 7, t // 2, 1] * 4)[:b], device="cuda")
        valid = torch.arange(t, device="cuda")[None, :] < lengths[:, None]
        bias = torch.where(valid, 0.0, -1e9).float().contiguous()
        for bb in (None, bias):
            out = speech_attention(q, k, v, bb)
            torch.cuda.synchronize()
            err = float((out - _speech_attention_plain(q, k, v, bb)).abs().max())
            worst = max(worst, err)
            say(f"[k1] B={b} T={t} H=4 dh={dh} bias={bb is not None} "
                f"max|kernel-plain|={err:.3e} (limit {KERNEL_TOL:g})")
            if not err <= KERNEL_TOL:
                raise AssertionError(f"K1 disagrees with its plain version "
                                     f"at B={b} T={t} dh={dh}: {err}")

    # timing at the batch request's shape (B=4, T=400: 4 s) and at the 60 s
    # file's (16 windows of 401 frames), no mask, each in turns with SDPA
    timings = []
    for b, t in ((4, 400), (16, 401)):
        h, dh = 4, 64
        q, k, v = (torch.randn(b, t, h, dh, device="cuda", generator=g)
                   for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        d = h * dh
        flops = 4.0 * b * t * t * d
        nbytes = 4.0 * b * t * d * 4
        timing = with_bound(time_in_turns(
            lambda: _speech_attention_plain(q, k, v),
            lambda: speech_attention(q, k, v), lambda: sdpa(qt, kt, vt),
            graph=True), flops, nbytes, tf32x3=True)
        timings.append(timing)
        say(f"[k1] timing B={b} T={t} H={h} dh={dh}, CUDA graph replays: "
            f"kernel {timing['ms']:.4f} / {timing['ms_2']:.4f} ms (eager "
            f"calls {timing['ms_eager']:.4f} ms), plain "
            f"{timing['plain_ms']:.4f} / {timing['plain_ms_2']:.4f} ms, sdpa "
            f"(yardstick, not used by the port) {timing['library_ms']:.4f} "
            f"ms, bound {timing['bound_ms']:.5f} ms (3xTF32 at "
            f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s; f32 "
            f"{timing['bound_f32_ms']:.4f} ms; {timing['bound_by']}: "
            f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB) on {smi}")
    return worst, timings[0], timings[1]


def check_k2(seed: int, smi: str):
    """K2 against its plain version: equal int8 values, scales equal to the
    CPU's bit for bit, a round trip within one step; the flagship's tree in
    one launch equal to the CPU's tree. Returns (max |difference|, timings
    of one leaf, timings of the flagship tree)."""
    import sincformer_tpu_torch as port
    from sincformer_tpu_torch.ops import quantize as tq
    g = torch.Generator(device="cuda").manual_seed(seed)
    worst = 0.0
    # leaves of the two models ((out, in) rows, a flattened conv, a memory
    # bank scaled by column), a ragged size, R*C no multiple of 4 or 256
    cases = [((1024, 256), 0), ((256, 1024), 0), ((768, 256), 0),
             ((256, 64 * 251), 0), ((64, 129), 1), ((67, 129), 0),
             ((67, 129), 1), ((4099, 3), 0), ((1, 4099), 1),
             ((256, 20480), 0), ((129, 1026), 0), ((4099, 3), 1)]
    reciprocal = 0
    for (r, c), axis in cases:
        x = torch.randn(r, c, device="cuda", generator=g) * 0.1
        vals, scales = tq.quantize_int8(x, seed=seed + 7, channel_axis=axis)
        torch.cuda.synchronize()
        want_scales = tq._plain_scale(x.cpu(), axis).reshape(-1)
        # PyTorch's CUDA division by a Python number multiplies by its
        # reciprocal: the same expression on the card may differ by an ulp
        reciprocal += int((tq._plain_scale(x, axis).reshape(-1).cpu()
                           != want_scales).sum())
        s = scales[:, None] if axis == 0 else scales[None, :]
        plain = tq._quantize_plain(x, s, seed + 7)
        diff = float((vals.int() - plain.int()).abs().max())
        worst = max(worst, diff)
        round_trip = float(((tq.dequantize_int8(vals, scales, axis) - x).abs()
                            / s).max())
        equal = bool(torch.equal(scales.cpu(), want_scales))
        say(f"[k2] ({r}, {c}) scales along axis {axis}: max|kernel-plain| "
            f"{diff:g} int8 steps, scales equal to the CPU's {equal}, round "
            f"trip {round_trip:.4f} steps (limit 1)")
        if diff != 0 or vals.dtype != torch.int8:
            raise AssertionError(f"K2 int8 output differs from its plain "
                                 f"version at ({r}, {c})")
        if not equal:
            raise AssertionError(f"K2 scales differ at ({r}, {c})")
        if not round_trip <= 1.0 + 1e-6:
            raise AssertionError(f"K2 round trip {round_trip} steps")
    say(f"[k2] scales of torch.clamp(amax, min=1e-12) / 127.0 computed on "
        f"the card that differ from the CPU's (and the kernel's): "
        f"{reciprocal}")
    x = torch.randn(64, 300, device="cuda", generator=g)
    x[5, 7] = float("nan")
    scales = tq.quantize_int8(x, seed=1)[1].cpu()
    if not (scales[5].isnan() and scales.isnan().sum() == 1):
        raise AssertionError("K2 does not keep a NaN in its channel's scale")

    # one 256 x 1024 leaf: the launch alone from CUDA-graph replays (the
    # table already on the card), the wrapper's eager calls beside it
    x = torch.randn(256, 1024, device="cuda", generator=g) * 0.1
    n = x.numel()

    def plain():
        return tq._quantize_plain(x, tq._plain_scale(x, 0), 3)
    leaf = tq._matrix_call(x, 3, 0)
    tq._launch(leaf)
    timing = {"plain_ms": graph_ms(plain),
              "ms": graph_ms(lambda: tq._launch_on_device_table(leaf)),
              "ms_2": graph_ms(lambda: tq._launch_on_device_table(leaf)),
              "plain_ms_2": graph_ms(plain), "library_ms": None,
              "ms_eager": cuda_ms(lambda: tq.quantize_int8(x, seed=3))}
    with_bound(timing, K2_OPS_PER_ELEMENT * n, 5.0 * n + 4.0 * x.shape[0])
    say(f"[k2] timing (256, 1024) leaf, CUDA graph replays of the launch: "
        f"kernel {timing['ms']:.4f} / {timing['ms_2']:.4f} ms (eager "
        f"quantize_int8 calls, table and copy included, "
        f"{timing['ms_eager']:.4f} ms), plain {timing['plain_ms']:.4f} / "
        f"{timing['plain_ms_2']:.4f} ms, no single PyTorch call computes it "
        f"(library: none), bound {timing['bound_ms']:.5f} ms "
        f"({timing['bound_by']}: {5.0 * n / 1e6:.2f} MB) on {smi}")

    # the flagship's parameters (seeded): one launch for the tree, equal to
    # the CPU's tree bit for bit
    model = port.SincformerMetacog(port.MetacogConfig()).init_params(
        torch.Generator().manual_seed(seed))
    on_cpu = {name: p.detach() for name, p in model.named_parameters()}
    params = {name: p.cuda() for name, p in on_cpu.items()}
    before = tq.quantize_int8.launches
    tree = tq.quantize_tree(params, seed)
    torch.cuda.synchronize()
    if tq.quantize_int8.launches != before + 1:
        raise AssertionError("quantize_tree took more than one launch")
    want = tq.quantize_tree(on_cpu, seed)
    entries, n_blocks = tq.work_table(
        {name: tuple(p.shape) for name, p in params.items()}, seed)
    call = tq._card_tree([params[e.name] for e in entries], entries,
                         n_blocks)
    for e in entries:
        got, node = tree[e.name], want[e.name]
        if not (got["axis"] == node["axis"]
                and torch.equal(got["s"].cpu(), node["s"])
                and torch.equal(got["q"].cpu(), node["q"])):
            raise AssertionError(f"K2 tree differs from the CPU's at "
                                 f"{e.name}")
    n = sum(e.rows * e.cols for e in entries)
    n_scales = sum(e.rows if e.axis == 0 else e.cols for e in entries)
    tq._launch(call)

    def plain_tree():
        for e in entries:
            mat = params[e.name].reshape(e.rows, e.cols)
            tq._quantize_plain(mat, tq._plain_scale(mat, e.axis), e.key)
    tree_timing = {
        "plain_ms": graph_ms(plain_tree, iters=3),
        "ms": graph_ms(lambda: tq._launch_on_device_table(call)),
        "ms_2": graph_ms(lambda: tq._launch_on_device_table(call)),
        "plain_ms_2": graph_ms(plain_tree, iters=3), "library_ms": None,
        "wall_ms": wall_s(lambda: tq.quantize_tree(params, seed),
                          reps=20) * 1e3}
    with_bound(tree_timing, K2_OPS_PER_ELEMENT * n, 5.0 * n + 4.0 * n_scales)
    say(f"[k2] timing the flagship's tree ({len(entries)} leaves, {n} "
        f"elements, {call.n_blocks} blocks), one launch equal to the CPU's "
        f"tree: CUDA graph replays of the launch {tree_timing['ms']:.4f} / "
        f"{tree_timing['ms_2']:.4f} ms, quantize_tree wall "
        f"{tree_timing['wall_ms']:.3f} ms (table, copy, launch, outputs), "
        f"plain leaf by leaf {tree_timing['plain_ms']:.4f} / "
        f"{tree_timing['plain_ms_2']:.4f} ms, bound "
        f"{tree_timing['bound_ms']:.4f} ms ({tree_timing['bound_by']}: "
        f"{(5.0 * n + 4.0 * n_scales) / 1e6:.1f} MB) on {smi}")
    return worst, timing, tree_timing


def check_k3(seed: int, smi: str):
    """K3 against its plain version; returns (max abs err, timings at
    25,664 rows, timings at 6,416 rows)."""
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

    # timing at the (64, 32000) DCSE batch's rows and at the 60 s file's
    # (16 windows of 401 frames), each in turns with the library chain
    timings = []
    for m in FFN_ROWS[:2]:
        d, f = 256, 1024
        x, ln_g, ln_b, w1, b1, w2, b2 = a = args(m, d, f)
        w1_oi, w2_oi = w1.t().contiguous(), w2.t().contiguous()

        def library():
            xn = F.layer_norm(x, (d,), ln_g, ln_b, LN_EPS)
            return x + 0.5 * F.linear(F.silu(F.linear(xn, w1_oi, b1)), w2_oi,
                                      b2)

        flops = 4.0 * m * d * f
        nbytes = 4.0 * (2 * m * d + 2 * d * f + 3 * d + f)
        timing = with_bound(time_in_turns(
            lambda: _fused_ffn_plain(*a), lambda: fused_ffn(*a), library,
            iters=20, graph=True), flops, nbytes, tf32x3=True)
        timings.append(timing)
        say(f"[k3] timing rows={m} d={d} d_ff={f}, CUDA graph replays: "
            f"kernel {timing['ms']:.4f} / {timing['ms_2']:.4f} ms (eager "
            f"calls {timing['ms_eager']:.4f} ms), plain "
            f"{timing['plain_ms']:.4f} / {timing['plain_ms_2']:.4f} ms, "
            f"layer_norm + 2 linear + silu (yardstick, f32 without TF32, not "
            f"used by the port) {timing['library_ms']:.4f} ms, bound "
            f"{timing['bound_ms']:.4f} ms (3xTF32 at "
            f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s; f32 "
            f"{timing['bound_f32_ms']:.4f} ms; {timing['bound_by']}: "
            f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB) on {smi}")
    return worst_abs, timings[0], timings[1]


def time_chain_probe(n: int) -> float:
    """Time in ms of the Meddis chain alone (registers, constant
    permeability, no loads and no division) over ``n`` steps: the measured
    latency floor of the recurrence on this card."""
    import ctypes

    from sincformer_tpu_torch.ops import build
    from sincformer_tpu_torch.ops.meddis import _dt, steady_state
    fn = build.load("meddis").meddis_chain_probe
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_float] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    out = torch.empty(32 * 32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = fn(out.data_ptr(), 32, n, _dt(8000), 0.3, *steady_state(),
                 stream)
        if err != 0:
            raise RuntimeError(f"chain probe launch failed: CUDA error {err}")
    return cuda_ms(launch, iters=5, warmup=1)


def check_k4(seed: int, smi: str):
    """K4 against its plain per-sample loop: equal values expected. Returns
    (max |difference|, timings)."""
    from sincformer_tpu_torch.ops.meddis import (_meddis_plain, meddis,
                                                 wave_columns)
    g = torch.Generator().manual_seed(seed)

    def compare(x, ref, what):
        out = meddis(x)
        torch.cuda.synchronize()
        out = out.cpu()
        differing = int((out != ref).sum())
        err, scale = float((out - ref).abs().max()), float(ref.abs().max())
        say(f"[k4] {what}: {differing} of {ref.numel()} values differ, "
            f"max|kernel-plain|={err:.3e}, output scale {scale:.1f} (limit: "
            f"0 differing, else {KERNEL_TOL:g} of the scale)")
        if differing:
            say(f"[k4] {what}: the kernel spells every operation with a "
                f"round-to-nearest intrinsic in the plain loop's order, so "
                f"a difference means that the plain side rounded elsewhere "
                f"(another division or a fused multiply-add in its tensor "
                f"operations)")
        if not (np.isfinite(err) and err <= KERNEL_TOL * scale):
            raise AssertionError(f"K4 disagrees with its plain version, "
                                 f"{what}: {err}")
        return err

    worst = 0.0
    # more columns than one wave of blocks holds on this card
    wave = wave_columns()
    past_wave = max(8448, wave + 45)
    say(f"[k4] one wave of blocks holds {wave} columns; checking "
        f"{past_wave}")
    # both signs and large drives: every clamp of the step is exercised.
    # Edges of the kernel's tiling (128-sample tiles, 8 columns a block, a
    # ring of 4 tiles): N = 1, N under one tile, N one sample past a tile
    # (and past the earlier kernel's 64), N % 4 != 0, M not a multiple of
    # 8, a ring that wraps many times
    for m, n in (((1,), 2000), ((64,), 2000), ((45,), 1999), ((3, 33), 700),
                 ((1,), 1), ((3,), 1), ((5,), 63), ((8,), 129), ((13,), 65),
                 ((9,), 130), ((2, 3), 130), ((11,), 999), ((7,), 512),
                 ((17,), 8001), ((past_wave,), 8000)):
        x = torch.randn(*m, n, generator=g) * 30.0
        on_card = x.cuda()
        worst = max(worst, compare(on_card, _meddis_plain(on_card).cpu(),
                                   f"{(*m, n)} vs the plain loop on the card"))
    x = torch.randn(16, 64, 32000, generator=g) * 30.0
    on_card = x.cuda()
    worst = max(worst, compare(on_card, _meddis_plain(x),
                               "(16, 64, 32000) vs the plain loop on the CPU"))
    cols, n = 16 * 64, 32000
    timing = {"ms": cuda_ms(lambda: meddis(on_card), iters=10, warmup=2)}
    # the plain loop is 32,000 steps of a dozen launches: timed once
    timing["plain_ms"] = cuda_ms(lambda: _meddis_plain(on_card), iters=1,
                                 warmup=0)
    timing["ms_2"] = cuda_ms(lambda: meddis(on_card), iters=10, warmup=0)
    timing["library_ms"] = None
    with_bound(timing, K4_OPS_PER_STEP * cols * n, 8.0 * cols * n)
    chain_ms = n * K4_CHAIN_OPS * F32_LATENCY_CYCLES / BOOST_HZ * 1e3
    probe_ms = time_chain_probe(n)
    say(f"[k4] timing ({cols}, {n}): kernel {timing['ms']:.4f} / "
        f"{timing['ms_2']:.4f} ms, plain loop on the card "
        f"{timing['plain_ms']:.1f} ms (once), no single PyTorch call computes "
        f"it (library: none), bound {timing['bound_ms']:.4f} ms "
        f"({timing['bound_by']}: {8.0 * cols * n / 1e6:.0f} MB); latency "
        f"floor of the recurrence {chain_ms:.3f} ms ({n} steps x "
        f"{K4_CHAIN_OPS} dependent operations x {F32_LATENCY_CYCLES} cycles "
        f"at {BOOST_HZ / 1e9:.2f} GHz), measured {probe_ms:.4f} ms (the "
        f"chain alone in registers, 32 one-warp blocks), whatever the "
        f"number of columns; {cols} columns are {-(-cols // 8)} blocks of "
        f"four warps (one walks 8 columns, three move tiles), one request "
        f"of 64 columns 8 blocks; the earlier kernel (32 columns a block, "
        f"one block-wide barrier per 64 samples) took 2.2591 ms here on an "
        f"H100 80GB HBM3 at 700 W, on {smi}")
    one = on_card[0].contiguous()
    timing["at_64_ms"] = cuda_ms(lambda: meddis(one), iters=10, warmup=1)
    say(f"[k4] timing (64, {n}), one request: kernel "
        f"{timing['at_64_ms']:.4f} ms (the earlier kernel: 2.0683 ms) on {smi}")
    return worst, timing


def check_k5(seed: int, smi: str):
    """K5 against its plain version; returns (max err, timings at the
    JAX docstring's call site, timings at the flagship block's shape)."""
    import torch.nn.functional as F

    from sincformer_tpu_torch.ops.conv_gn import (_same_pads, conv1d_gn,
                                                  conv_gn_reference)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=g) * scale

    def inputs(bsz, t, cin, cout, k, s, with_skip, mean=0.0):
        t_out = -(-t // s)
        return (r(bsz, t, cin) + mean, r(k, cin, cout, scale=0.1),
                r(cout, scale=0.1), 1.0 + r(cout, scale=0.1),
                r(cout, scale=0.1),
                r(bsz, t_out, cout) if with_skip else None)

    worst = 0.0
    for t, cin, cout, k, s, act, with_skip, mean, groups in CONV_GN_CASES:
        a = inputs(2, t, cin, cout, k, s, with_skip, mean)
        out = conv1d_gn(*a, stride=s, groups=groups, act=act)
        torch.cuda.synchronize()
        ref = conv_gn_reference(*a, stride=s, groups=groups, act=act)
        err, scale = float((out - ref).abs().max()), float(ref.abs().max())
        worst = max(worst, err)
        say(f"[k5] T={t} {cin}->{cout} k={k} s={s} act={act} "
            f"skip={with_skip} input mean {mean:g}: max|kernel-plain|="
            f"{err:.3e}, output scale {scale:.3f}, ratio {err / scale:.3e} "
            f"(limit {KERNEL_TOL:g})")
        if out.shape != ref.shape or not err <= KERNEL_TOL * scale:
            raise AssertionError(f"K5 disagrees with its plain version at "
                                 f"T={t} {cin}->{cout} k={k} s={s}: {err}")

    timings = {}
    for name, (bsz, t, cin, cout, k, s) in (
            ("call site", (16, 32000, 64, 128, 7, 2)),
            ("flagship block", (16, 400, 256, 256, 7, 1))):
        x, w, b, gamma, beta, _ = a = inputs(bsz, t, cin, cout, k, s, False)
        t_out, pad_l, pad_r = _same_pads(t, k, s)
        w_oik = w.permute(2, 1, 0).contiguous()

        def library():
            y = F.conv1d(F.pad(x.transpose(1, 2), (pad_l, pad_r)), w_oik, b,
                         stride=s)
            return F.gelu(F.group_norm(y, 16, gamma, beta, 1e-6),
                          approximate="tanh").transpose(1, 2)

        err = float((conv1d_gn(*a, stride=s, groups=16)
                     - library()).abs().max())
        flops = 2.0 * bsz * t_out * k * cin * cout
        nbytes = 4.0 * (x.numel() + w.numel() + 3 * cout
                        + bsz * t_out * cout)
        timing = with_bound(time_in_turns(
            lambda: conv_gn_reference(*a, stride=s, groups=16),
            lambda: conv1d_gn(*a, stride=s, groups=16), library, iters=10,
            graph=True), flops, nbytes, tf32x3=True)
        timings[name] = timing
        say(f"[k5] timing {name} ({bsz}, {t}, {cin}->{cout}, k={k}, s={s}, "
            f"GELU), CUDA graph replays: kernel {timing['ms']:.4f} / "
            f"{timing['ms_2']:.4f} ms (eager calls {timing['ms_eager']:.4f} "
            f"ms), plain {timing['plain_ms']:.4f} / "
            f"{timing['plain_ms_2']:.4f} ms, conv1d + group_norm + gelu "
            f"(yardstick, f32 without TF32, not used by the port) "
            f"{timing['library_ms']:.4f} ms, max|kernel-library| {err:.3e}, "
            f"bound {timing['bound_ms']:.4f} ms (3xTF32 at "
            f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s; f32 "
            f"{timing['bound_f32_ms']:.4f} ms; {timing['bound_by']}: "
            f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB) on {smi}")
        if not err <= 1e-4:
            raise AssertionError(f"K5 left the library chain at {name}")
    return worst, timings["call site"], timings["flagship block"]


def check_k6(seed: int, smi: str):
    """K6 against its plain version; returns (max err, timings)."""
    import torch.nn.functional as F

    from sincformer_tpu_torch.ops.envact import env_act, env_act_reference
    g = torch.Generator(device="cuda").manual_seed(seed)
    worst = 0.0
    # (2, 2400, 64): a length the TPU kernel's tiling refused; (1, 8, 3):
    # the scalar path (C no multiple of 4)
    for shape in ((4, 32000, 64), (1, 8, 3), (2, 2400, 64), (3, 808, 6)):
        x = torch.randn(*shape, device="cuda", generator=g) * 3.0
        scale = torch.rand(shape[-1], device="cuda", generator=g) * 1.5 + 0.5
        y, env = env_act(x, scale)
        torch.cuda.synchronize()
        y_ref, env_ref = env_act_reference(x, scale)
        err = max(float((y - y_ref).abs().max()),
                  float((env - env_ref).abs().max()))
        worst = max(worst, err)
        say(f"[k6] {shape}: max|kernel-plain| {err:.3e} over y and env "
            f"(limit {ENVACT_TOL:g})")
        if (y.shape != y_ref.shape or env.shape != env_ref.shape
                or not err <= ENVACT_TOL):
            raise AssertionError(f"K6 disagrees with its plain version at "
                                 f"{shape}: {err}")
    b, n, c = 16, 32000, 64
    x = torch.randn(b, n, c, device="cuda", generator=g) * 3.0
    scale = torch.rand(c, device="cuda", generator=g) * 1.5 + 0.5

    def library():
        y = F.gelu(x * scale, approximate="tanh")
        env = F.avg_pool1d(x.abs().transpose(1, 2), 8).transpose(1, 2)
        return y, torch.log1p(env)

    nbytes = 4.0 * x.numel() * (2 + 1 / 8) + 4.0 * c
    timing = with_bound(time_in_turns(
        lambda: env_act_reference(x, scale), lambda: env_act(x, scale),
        library, iters=20), 30.0 * x.numel(), nbytes)
    say(f"[k6] timing ({b}, {n}, {c}): kernel {timing['ms']:.4f} / "
        f"{timing['ms_2']:.4f} ms, plain {timing['plain_ms']:.4f} / "
        f"{timing['plain_ms_2']:.4f} ms, mul + gelu + abs + avg_pool1d + "
        f"log1p (yardstick: no single PyTorch call computes both outputs; "
        f"not used by the port) {timing['library_ms']:.4f} ms, bound "
        f"{timing['bound_ms']:.4f} ms ({timing['bound_by']}: "
        f"{nbytes / 1e6:.1f} MB) on {smi}")
    return worst, timing


def check_autograd(seed: int):
    """K1, K3, K5 and K6 under autograd on the card (K5 and K6:
    :func:`check_autograd_k5_k6`). K1 and K3: the forward is the kernel, the
    backward the plain formulation's gradient on the saved inputs, so the
    gradients of a fixed cotangent equal the plain version's autograd bit
    for bit. K1 at a training step's shape (4, 400, 4, 64) with and without
    the key mask; K3 at one DCSE block's (8 x 400 rows, 256, 1024)."""
    from sincformer_tpu_torch.ops.fused_ffn import _fused_ffn_plain, fused_ffn
    from sincformer_tpu_torch.ops.speech_attention import (
        _speech_attention_plain, speech_attention)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def grads(fn, args, cot):
        leaves = [a.clone().requires_grad_(True) for a in args]
        out = fn(*leaves)
        return out.detach(), torch.autograd.grad(out, leaves, cot)

    q, k, v = (torch.randn(4, 400, 4, 64, device="cuda", generator=g)
               for _ in range(3))
    valid = torch.arange(400, device="cuda")[None] < torch.tensor(
        [[400], [393], [200], [1]], device="cuda")
    mask_bias = torch.where(valid, 0.0, -1e9).float().contiguous()
    cot = torch.randn(q.shape, device="cuda", generator=g)
    worst = 0.0
    for bias in (None, mask_bias):
        before = speech_attention.launches
        out, got = grads(lambda *x: speech_attention(*x, bias), (q, k, v), cot)
        launched = speech_attention.launches - before
        ref, want = grads(lambda *x: _speech_attention_plain(*x, bias),
                          (q, k, v), cot)
        err = float((out - ref).abs().max())
        equal = all(torch.equal(a, b) for a, b in zip(got, want))
        say(f"[autograd] K1 B=4 T=400 H=4 dh=64 mask={bias is not None}: "
            f"forward max|kernel-plain| {err:.3e} (limit {KERNEL_TOL:g}), "
            f"dq/dk/dv equal to the plain autograd: {equal}, kernel launches "
            f"{launched}")
        if not (err <= KERNEL_TOL and equal and launched == 1):
            raise AssertionError("K1 under autograd disagrees with its plain "
                                 "version")
        worst = max(worst, err)
    d, d_ff = 256, 1024
    args = (torch.randn(8, 400, d, device="cuda", generator=g),
            1.0 + 0.1 * torch.randn(d, device="cuda", generator=g),
            0.1 * torch.randn(d, device="cuda", generator=g),
            torch.randn(d, d_ff, device="cuda", generator=g) / d ** 0.5,
            0.1 * torch.randn(d_ff, device="cuda", generator=g),
            torch.randn(d_ff, d, device="cuda", generator=g) / d_ff ** 0.5,
            0.1 * torch.randn(d, device="cuda", generator=g))
    cot = torch.randn(args[0].shape, device="cuda", generator=g)
    before = fused_ffn.launches
    out, got = grads(fused_ffn, args, cot)
    launched = fused_ffn.launches - before
    ref, want = grads(_fused_ffn_plain, args, cot)
    err = float((out - ref).abs().max() / ref.abs().max())
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    say(f"[autograd] K3 (3200, 256, 1024): forward {err:.3e} of the scale "
        f"(limit {KERNEL_TOL:g}), the 7 gradients equal to the plain "
        f"autograd: {equal}, kernel launches {launched}")
    if not (err <= KERNEL_TOL and equal and launched == 1):
        raise AssertionError("K3 under autograd disagrees with its plain "
                             "version")
    check_autograd_k5_k6(g)
    return worst


def autograd_err(fn, plain, args, g) -> float:
    """The largest gradient error, of each gradient's scale, of ``fn``
    against ``plain`` on ``args`` under one fixed cotangent per output;
    infinite when an output of ``fn`` has no ``grad_fn`` (a wrapper that
    drops the gradient)."""
    leaves = [a.clone().requires_grad_(True) for a in args]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    if any(o.grad_fn is None for o in outs):
        return float("inf")
    cots = [torch.randn(o.shape, device="cuda", generator=g) for o in outs]
    got = torch.autograd.grad(outs, leaves, cots)
    ref_leaves = [a.clone().requires_grad_(True) for a in args]
    ref = plain(*ref_leaves)
    want = torch.autograd.grad(ref if isinstance(ref, tuple) else (ref,),
                               ref_leaves, cots)
    return max(float((a - b).abs().max()) / float(b.abs().max())
               for a, b in zip(got, want))


def check_autograd_k5_k6(g) -> None:
    """K5 and K6 under autograd on the card: the forward is the kernel, the
    backward the plain version's gradient, recomputed; the gradients within
    KERNEL_TOL (K5) and ENVACT_TOL (K6) of their scale of the plain
    version's autograd. K5 at a PerceptionAgent block's strided conv and at
    its residual conv with the skip; K6 through ``env_act`` and
    ``env_act_auto``. A wrapper whose output lost its ``grad_fn`` (planted
    by detaching it) must fail the same check."""
    from sincformer_tpu_torch.ops.conv_gn import conv1d_gn, conv_gn_reference
    from sincformer_tpu_torch.ops.envact import (env_act, env_act_auto,
                                                 env_act_reference)
    for t, cin, cout, k, s, act, skip in ((4000, 64, 128, 7, 2, True, False),
                                          (400, 256, 256, 7, 1, True, True)):
        t_out = -(-t // s)
        args = [torch.randn(8, t, cin, device="cuda", generator=g),
                torch.randn(k, cin, cout, device="cuda", generator=g)
                / (k * cin) ** 0.5,
                0.1 * torch.randn(cout, device="cuda", generator=g),
                1.0 + 0.1 * torch.randn(cout, device="cuda", generator=g),
                0.1 * torch.randn(cout, device="cuda", generator=g)]
        if skip:
            args.append(torch.randn(8, t_out, cout, device="cuda",
                                    generator=g))

        def kernel(*a, detach=False):
            y = conv1d_gn(*a[:5], a[5] if skip else None, s, 16, act=act)
            return y.detach() if detach else y

        def plain(*a):
            return conv_gn_reference(*a[:5], a[5] if skip else None,
                                     stride=s, groups=16, act=act)
        before = conv1d_gn.launches
        err = autograd_err(kernel, plain, args, g)
        launched = conv1d_gn.launches - before
        planted = autograd_err(lambda *a: kernel(*a, detach=True), plain,
                               args, g)
        say(f"[autograd] K5 (8, {t}, {cin}->{cout}, k={k}, s={s}, skip="
            f"{skip}): the {len(args)} gradients {err:.3e} of their scale "
            f"from the plain autograd (limit {KERNEL_TOL:g}), kernel "
            f"launches {launched}; a detached output: {planted}")
        if not (err <= KERNEL_TOL and launched == 1) or planted <= KERNEL_TOL:
            raise AssertionError("K5 under autograd disagrees with its plain "
                                 "version")
    args = [3 * torch.randn(8, 8000, 64, device="cuda", generator=g),
            0.5 + 1.5 * torch.rand(64, device="cuda", generator=g)]
    for name, fn in (("env_act", env_act), ("env_act_auto", env_act_auto)):
        before = env_act.launches
        err = autograd_err(fn, env_act_reference, args, g)
        launched = env_act.launches - before
        planted = autograd_err(lambda *a: tuple(o.detach() for o in fn(*a)),
                               env_act_reference, args, g)
        say(f"[autograd] K6 {name} (8, 8000, 64): dx, dscale {err:.3e} of "
            f"their scale from the plain autograd (limit {ENVACT_TOL:g}), "
            f"kernel launches {launched}; a detached output: {planted}")
        if not (err <= ENVACT_TOL and launched == 1) or planted <= ENVACT_TOL:
            raise AssertionError("K6 under autograd disagrees with its plain "
                                 "version")


def time_attention_in_step(seed: int, smi: str) -> dict:
    """K1's forward and the plain backward (the recompute of the plain
    formulation and its gradient, what K1's autograd function runs) at one
    MSA block's shape in the train verb's step, (8, 400, 4, 64)."""
    from sincformer_tpu_torch.ops.speech_attention import (
        _speech_attention_plain, speech_attention)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(8, 400, 4, 64, device="cuda", generator=g)
               for _ in range(3))
    cot = torch.randn(q.shape, device="cuda", generator=g)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]

    def backward():
        torch.autograd.grad(_speech_attention_plain(*leaves), leaves, cot)
    t = {"forward_ms": graph_ms(lambda: speech_attention(q, k, v)),
         "plain_backward_ms": cuda_ms(backward, iters=20)}
    say(f"[train] K1 at (8, 400, 4, 64): forward {t['forward_ms']:.4f} ms "
        f"(CUDA graph replays), plain backward {t['plain_backward_ms']:.4f} "
        f"ms (eager, CUDA events), x8 a step on {smi}")
    return t


def check_train(seed: int, smi: str, launches) -> dict:
    """Flagship training on the card: the train verb end to end, 20 steps
    on one batch with every loss term on, and one step against the CPU."""
    import sincformer_tpu_torch as port
    from sincformer_tpu_torch.cli import _synthetic_corpus
    from sincformer_tpu_torch.data.loader import batch_iterator
    from sincformer_tpu_torch.train.agent_trainer import SincformerTrainer
    from sincformer_tpu_torch.train.state import latest_step_dir
    blocks = port.MetacogConfig().msa_blocks
    result = {}

    # ── the train verb in a process of its own ──────────────────────────
    runner = ("import json, sys, torch\n"
              "from sincformer_tpu_torch import cli\n"
              "from sincformer_tpu_torch.ops.speech_attention import "
              "speech_attention\n"
              "rc = cli.main(sys.argv[1:])\n"
              "print(json.dumps({'speech_attention': "
              "speech_attention.launches, 'tf32': ["
              "torch.backends.cuda.matmul.allow_tf32, "
              "torch.backends.cudnn.allow_tf32]}))\n"
              "sys.exit(rc)\n")
    with tempfile.TemporaryDirectory() as model_dir:
        log = os.path.join(model_dir, "train.jsonl")
        env = {**os.environ, "SINCFORMER_MODEL_DIR": model_dir,
               "PYTHONPATH": REPO}
        env.pop("SINCFORMER_MAX_WAVE_SECONDS", None)
        argv = ["train", "--pipeline", "agents", "--synthetic", "40",
                "--epochs", "2", "--seed", str(seed), "--log-jsonl", log]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", runner, *argv], cwd=REPO,
                              env=env, capture_output=True, text=True,
                              timeout=900)
        verb_s = time.perf_counter() - t0
        for line in proc.stdout.strip().splitlines()[-8:]:
            say(f"[train] | {line}")
        if proc.returncode != 0:
            say(proc.stderr[-3000:])
            raise AssertionError(f"the train verb exited {proc.returncode}")
        child = json.loads(proc.stdout.strip().splitlines()[-1])
        k1 = child["speech_attention"]
        records = [json.loads(line) for line in open(log)]
        # 36 utterances in batches of 8: 4 steps an epoch, 2 MSA passes a
        # step; 4 validation utterances: one batch an epoch, one pass
        steps, evals = 2 * (36 // 8), 2
        want_k1 = blocks * (2 * steps + evals)
        say(f"[train] train --pipeline agents --synthetic 40 --epochs 2: "
            f"exit 0 in {verb_s:.1f} s wall (process start, weights, 8 steps "
            f"of {TRAIN_BATCH}, 2 validations, 3 full checkpoints); K1 "
            f"launches {k1} = {blocks} blocks x (2 passes x {steps} steps + "
            f"{evals} validation batches); TF32 in cuBLAS and cuDNN in the "
            f"process: {child['tf32']}")
        for r in records:
            say(f"[train] epoch {r['epoch']}: train loss {r['train_loss']:.4f}"
                f", val loss {r['val_loss']:.4f}, val SI-SNR "
                f"{r['val_sisnr']:+.2f} dB, nan_count {r['nan_count']}, "
                f"{r['epoch_seconds']:.2f} s")
        if (k1 != want_k1 or child["tf32"] != [False, False]
                or len(records) != 2
                or not all(np.isfinite(r["train_loss"])
                           and np.isfinite(r["val_loss"])
                           and r["nan_count"] == 0 for r in records)):
            raise AssertionError("the train verb's run is not as expected")
        launches.total["speech_attention"] += k1
        for family in ("best_sincformer", "sincformer_final"):
            if latest_step_dir(os.path.join(model_dir, family)) is None:
                raise AssertionError(f"no {family} checkpoint written")
        served = port.SincformerPipeline(device="cuda", model_dir=model_dir)
        path = served.load_model()
        launches.reset()
        rng = np.random.default_rng(seed + 5)
        out = served.enhance_signal(speechlike(rng, 20000))
        launches.expect("enhance from the trained checkpoint",
                        speech_attention=blocks)
        if out.shape != (20000,) or not np.all(np.isfinite(out)):
            raise AssertionError("serving the trained checkpoint failed")
        say(f"[train] served one 2.5 s request on the card from "
            f"{os.path.relpath(path, model_dir)} (output_gain "
            f"{served.output_gain:.4f}); best and final written")
        del served

    # ── one batch, 20 steps, every loss term on ─────────────────────────
    clean, noises = _synthetic_corpus(TRAIN_BATCH[0], "multi", "varied")
    ds = SincformerTrainer.remix_for_stage(
        clean, noises, [0, 5], TRAIN_BATCH[1], 0)
    batch = next(batch_iterator(ds, TRAIN_BATCH[0], shuffle=False))
    pipe = SincformerTrainer(device="cuda", seed=seed)
    pipe.init_state(epochs=1, steps_per_epoch=20)
    noisy, clean_t = (torch.from_numpy(batch[k]).cuda()
                      for k in ("noisy", "clean"))
    run = timed_steps(
        lambda: pipe.train_step(noisy, clean_t, 1.0, 1.0, 1.0, 1.0)[0], 20,
        2 * blocks, launches, "training step")
    losses, step_ms, k1_steps = run["losses"], run["step_ms"], run["k1"]
    prof = run["profiled"]
    kernels, busy_ms, n_kernels = (prof["kernels"], prof["busy_ms"],
                                   prof["launches"])
    median_ms, peak_gb, prof_ms = (run["median_ms"], run["peak_gb"],
                                   prof["wall_ms"])
    result.update(loss_first=losses[0], loss_last=losses[-1],
                  step_ms_median=median_ms, step_ms_first=step_ms[0],
                  device_busy_ms=busy_ms, device_busy_share=busy_ms / median_ms,
                  kernel_launches_per_step=n_kernels,
                  k1_launches_per_step=k1_steps[-1],
                  k1_launches_all_steps=sum(k1_steps), peak_memory_gb=peak_gb,
                  profiled_step_ms=prof_ms,
                  k1_device_ms=sum(k[1] for k in kernels
                                   if "speech_attention" in k[0]))
    say(f"[train] one batch {TRAIN_BATCH}, every term on, 20 steps: loss "
        f"{losses[0]:.4f} at step 1, {losses[-1]:.4f} at step 20 "
        f"(min {min(losses):.4f}); {median_ms:.2f} ms per step (median of "
        f"steps 2-20; step 1 {step_ms[0]:.1f} ms), peak memory "
        f"{peak_gb:.2f} GB; K1 launches {sum(k1_steps[:-1])} in the 20 "
        f"steps, {k1_steps[-1]} in the profiled step on {smi}")
    say(f"[train] profiled step: {prof_ms:.2f} ms wall, device busy "
        f"{busy_ms:.3f} ms ({busy_ms / median_ms:.3f} of the median step), "
        f"{n_kernels} kernel launches, K1 {result['k1_device_ms']:.4f} ms")
    for name, ms, calls in kernels[:10]:
        say(f"[train]     {ms:9.4f} ms {calls:5d}x  {name[:90]}")
    if not losses[-1] < losses[0] or not all(np.isfinite(losses)):
        raise AssertionError("the loss did not fall over 20 steps")
    del pipe
    torch.cuda.empty_cache()
    result["adversarial_step"] = time_adversarial_step(
        seed, smi, launches, noisy, clean_t, blocks)
    del noisy, clean_t
    torch.cuda.empty_cache()

    small = {k: v[:2] for k, v in batch.items()}
    result.update(check_step_vs_cpu(small))
    result["adversarial"] = check_step_vs_cpu(small, adversarial=True)
    launches.reset()
    return result


def time_adversarial_step(seed: int, smi: str, launches, noisy, clean,
                          blocks: int) -> dict:
    """The stage-3 step with the adversarial branch on (a fresh
    discriminator, ``use_adv`` = 1, its Adam step after the generator's):
    10 steps on the same batch as the 20 above, each holding K1's launches;
    wall per step (median of steps 2-10), peak memory, and one profiled
    step's device busy time and launches."""
    from sincformer_tpu_torch.train.agent_trainer import SincformerTrainer
    pipe = SincformerTrainer(device="cuda", seed=seed, use_adversarial=True)
    pipe.init_state(epochs=1, steps_per_epoch=10)
    disc_losses = []

    def step():
        loss, _ = pipe.train_step(noisy, clean, 1.0, 1.0, 1.0, 1.0, 1.0)
        disc_losses.append(float(pipe.disc_loss))
        return loss
    run = timed_steps(step, 10, 2 * blocks, launches, "adversarial step")
    losses, step_ms, k1_steps = run["losses"], run["step_ms"], run["k1"]
    disc_losses = disc_losses[:10]
    out = {"step_ms_median": run["median_ms"],
           "step_ms_first": step_ms[0],
           "device_busy_ms": run["profiled"]["busy_ms"],
           "kernel_launches_per_step": run["profiled"]["launches"],
           "k1_launches_per_step": k1_steps[-1],
           "k1_launches_all_steps": sum(k1_steps),
           "peak_memory_gb": run["peak_gb"],
           "loss_first": losses[0], "loss_last": losses[-1],
           "disc_loss_first": disc_losses[0],
           "disc_loss_last": disc_losses[-1],
           "disc_adam_count": pipe.disc_opt_state["count"]}
    peak_gb = run["peak_gb"]
    say(f"[train] adversarial step (stage 3, use_adv 1, fresh "
        f"discriminator), batch {TRAIN_BATCH}, 10 steps: "
        f"{out['step_ms_median']:.2f} ms per step (median of steps 2-10; "
        f"step 1 {step_ms[0]:.1f} ms), device busy "
        f"{out['device_busy_ms']:.3f} ms, {out['kernel_launches_per_step']} "
        f"kernel launches, K1 {k1_steps[-1]} ({sum(k1_steps[:-1])} in the 10 "
        f"steps), "
        f"peak memory {peak_gb:.2f} GB; "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, discriminator loss "
        f"{disc_losses[0]:.4f} -> {disc_losses[-1]:.4f} on {smi}")
    if not (all(np.isfinite(losses + disc_losses))
            and out["disc_adam_count"] == 11):
        raise AssertionError("the adversarial steps are not as expected")
    del pipe
    torch.cuda.empty_cache()
    return out


def check_step_vs_cpu(small: dict, adversarial: bool = False,
                      start=None, tag: str = "") -> dict:
    """One training step of the full flagship from the committed artifact
    (or, given ``start`` = (variant fields, state dict), of that variant
    from those weights), dropout 0, softmax routing, on the card, on the
    CPU and on the CPU in
    float64 (the reference that tells float32 rounding from a fault), for
    the loss without the multi-resolution STFT term and for the whole loss.
    The gradient and parameter bars are held on the loss without that term:
    its log-magnitude L1 makes the float32 gradient of a padded batch
    rounding-dominated (ROADMAP.md Queue 3; :func:`attribute_mrstft` splits
    it by source). With it, the loss is held, and where the CPU's step is
    float64's the card's step is float64's too, but for a share of at most
    TRAIN_FLIP_SHARE of those elements, each within twice its step.

    ``adversarial``: the stage-3 step with the adversarial branch on
    (``use_adv`` = 1, a fresh discriminator drawn from seed 5 on the CPU
    and copied to each device), then the discriminator's own step: its loss
    within TRAIN_LOSS_TOL, its gradients and its parameters after Adam as
    :func:`step_faults` holds them (:func:`check_disc_step`)."""
    from unittest import mock

    import sincformer_tpu_torch as port
    from sincformer_tpu_torch.train import agent_trainer
    from sincformer_tpu_torch.train.state import GRAD_CLIP, guard_nan_update
    variant, state = start if start is not None else ({}, None)
    cfg = port.MetacogConfig(dropout=0.0, routing="softmax", **variant)
    result = {}
    tag = tag or ("[train] adversarial:" if adversarial else "[train]")
    origin = ("the committed artifact" if state is None
              else "the given weights")

    def one_step(device, dtype, without_mrstft):
        p = agent_trainer.SincformerTrainer(
            port.SincformerMetacog(cfg), device=device, model_dir=ARTIFACT,
            use_adversarial=adversarial)
        if state is None:
            p.load_model()
        else:
            p.load_state(state)
        p.model.to(dtype)
        if adversarial:
            p.disc.to(dtype)
        p.init_state(epochs=1, steps_per_epoch=1)
        noisy, clean_t = (torch.from_numpy(small[k]).to(device, dtype)
                          for k in ("noisy", "clean"))
        patch = mock.patch.object(
            agent_trainer, "multi_resolution_stft_loss",
            (lambda pred, target: pred.sum() * 0.0) if without_mrstft
            else agent_trainer.multi_resolution_stft_loss)
        t0 = time.perf_counter()
        with patch:
            loss, _, grads = p.loss_and_grads(
                noisy, clean_t, 1.0, 1.0, None, 1.0,
                1.0 if adversarial else None)
        params = p.params()
        grads = dict(zip(params, grads))
        guarded, _ = guard_nan_update(list(grads.values()), loss,
                                      params.values())
        before = {k: v.detach().cpu().double() for k, v in params.items()}
        p.tx.update(params, guarded, p.opt_state)
        disc = None
        if adversarial:
            dl, dgrads = p.disc_loss_and_grads(*p.last_mags)
            d0 = {k: v.detach().cpu().double()
                  for k, v in p.disc.named_parameters()}
            p.disc_step(1.0)
            disc = (float(dl), dict(zip(d0, (g.cpu().double()
                                             for g in dgrads))), d0,
                    {k: v.detach().cpu().double()
                     for k, v in p.disc.named_parameters()})
        return (float(loss), {k: g.cpu().double() for k, g in grads.items()
                              if g is not None}, before,
                {k: v.detach().cpu().double() for k, v in params.items()},
                time.perf_counter() - t0, disc)

    def grad_rows(g_cpu, g_gpu, g_64):
        floor = GRAD_FLOOR * max(float(g.abs().max()) for g in g_64.values())
        rows = []
        for k, w in g_64.items():
            scale = max(float(w.abs().max()), floor)
            rows.append((float((g_gpu[k] - g_cpu[k]).abs().max()) / scale,
                         k, float((g_gpu[k] - w).abs().max()) / scale,
                         float((g_cpu[k] - w).abs().max()) / scale))
        return sorted(rows, reverse=True)

    def clipped(g):
        norm = float(torch.sqrt(sum((v ** 2).sum() for v in g.values())))
        clip = min(1.0, GRAD_CLIP / norm)
        return clip, {k: v * clip for k, v in g.items()}

    for without in (True, False):
        what = ("without the MR-STFT term" if without
                else "the whole loss, as trained")
        (l_cpu, g_cpu, p0, p_cpu, t_cpu, d_cpu), \
            (l_gpu, g_gpu, _, p_gpu, _, d_gpu), \
            (l_64, g_64, _, p_64, t_64, _) = (
                one_step("cpu", torch.float32, without),
                one_step("cuda", torch.float32, without),
                one_step("cpu", torch.float64, without))
        rel = abs(l_gpu - l_cpu) / abs(l_cpu)
        rows = grad_rows(g_cpu, g_gpu, g_64)
        say(f"{tag} card vs CPU, one step from {origin}, "
            f"{what}, dropout 0, softmax routing, batch (2, 32000): loss "
            f"{l_gpu:.6f} vs {l_cpu:.6f} ({l_64:.6f} in float64), "
            f"{rel:.3e} relative (limit {TRAIN_LOSS_TOL:g}); CPU step "
            f"{t_cpu:.1f} s, {t_64:.1f} s in float64")
        say(f"{tag}   gradients, of each leaf's scale (floored at "
            f"{GRAD_FLOOR:g} x the largest): card vs CPU up to {rows[0][0]:.3e}"
            f"{f' (limit {TRAIN_GRAD_TOL:g})' if without else ''}; card vs "
            f"float64 up to {max(r[2] for r in rows):.3e}, CPU vs float64 up "
            f"to {max(r[3] for r in rows):.3e}; worst: " + "; ".join(
                f"{k} {dp:.3e}" for dp, k, _, _ in rows[:3]))
        if not rel <= TRAIN_LOSS_TOL:
            raise AssertionError(f"the training loss on the card left the "
                                 f"CPU's ({what})")
        key = "without_mrstft" if without else "as_trained"
        if adversarial:
            check_disc_step(d_cpu, d_gpu, what, result, key)
        result[f"card_vs_cpu_{key}"] = {
            "loss_rel": rel, "grad": rows[0][0],
            "grad_card_vs_float64": max(r[2] for r in rows),
            "grad_cpu_vs_float64": max(r[3] for r in rows)}
        if without and not rows[0][0] <= TRAIN_GRAD_TOL:
            raise AssertionError("the training gradients on the card left "
                                 "the CPU's")
        # AdamW's first step is about lr x sign(g) for |g| well above eps
        # after the global-norm clip: where two clipped gradients agree in
        # sign and pass 1e-5, the steps agree; elsewhere they may differ by
        # the step itself
        (c_cpu, gc_all), (c_gpu, gg_all), (_, g64_all) = (
            clipped(g_cpu), clipped(g_gpu), clipped(g_64))
        p_worst, flipped, n_el = 0.0, 0, 0
        t_worst, t_n, t_missed, t_step, t_flip = 0.0, 0, 0, 0.0, 0
        flips = {}
        for k, w in p_cpu.items():
            scale = float(w.abs().max())
            zero = torch.zeros_like(w)
            gc, gg, g6 = (g.get(k, zero) for g in (gc_all, gg_all, g64_all))
            same = ((torch.sign(gc) == torch.sign(gg)) & (gc.abs() >= 1e-5)
                    & (gg.abs() >= 1e-5))
            diff = (p_gpu[k] - w).abs()
            if same.any():
                p_worst = max(p_worst, float(diff[same].max()) / scale)
            step = float((w - p0[k]).abs().max())
            if not bool((diff[~same] <= 2 * step + TRAIN_PARAM_TOL * scale
                         ).all()):
                raise AssertionError(f"{k}: a parameter moved past its step")
            flipped += int((~same).sum())
            n_el += w.numel()
            # where the CPU's step is float64's (the clipped gradients agree
            # in sign and pass 1e-5): the card against float64
            trusted = ((torch.sign(gc) == torch.sign(g6))
                       & (gc.abs() >= 1e-5) & (g6.abs() >= 1e-5))
            if trusted.any():
                off = (p_gpu[k] - p_64[k]).abs()[trusted] / scale
                t_worst = max(t_worst, float(off.max()))
                t_n += int(trusted.sum())
                t_missed += int((off > TRAIN_PARAM_TOL).sum())
                # of the element's own float64 step
                own = ((p_gpu[k] - p_64[k]).abs()
                       / (p_64[k] - p0[k]).abs().clamp_min(1e-30))[trusted]
                t_step = max(t_step, float(own.max()))
                if bool((own > 1.0).any()):
                    flips[k] = int((own > 1.0).sum())
                    t_flip += flips[k]
        say(f"{tag}   parameters after the AdamW step: {p_worst:.3e} of "
            f"the leaf's scale where the two clipped gradients agree in sign "
            f"and pass 1e-5"
            f"{f' (limit {TRAIN_PARAM_TOL:g})' if without else ''}; the "
            f"other {flipped} of {n_el} elements within twice the step; "
            f"clip factors {c_cpu:.4g} (CPU) and {c_gpu:.4g} (card)")
        say(f"{tag}   where the CPU's step is float64's ({t_n} of {n_el} "
            f"elements): the card {t_worst:.3e} of the leaf's scale from "
            f"float64, {t_missed} elements past {TRAIN_PARAM_TOL:g}; up to "
            f"{t_step:.3e} of the element's float64 step, {t_flip} elements "
            f"past one step (limit {TRAIN_FLIP_SHARE:g} of them: "
            f"{int(TRAIN_FLIP_SHARE * t_n)})" + "".join(
                f"; {k} {n}" for k, n in sorted(flips.items(),
                                                key=lambda kn: -kn[1])[:6]))
        result[f"card_vs_cpu_{key}"].update(
            param=p_worst, param_elements_sign_differs=flipped,
            param_where_cpu_is_float64=t_worst,
            param_elements_cpu_is_float64=t_n,
            param_elements_card_past_tol_there=t_missed,
            param_of_step_where_cpu_is_float64=t_step,
            param_elements_past_one_step_there=t_flip)
        if without and not p_worst <= TRAIN_PARAM_TOL:
            raise AssertionError("the parameters after the step on the card "
                                 "left the CPU's")
        if not t_flip <= TRAIN_FLIP_SHARE * t_n:
            raise AssertionError(f"the card's step left float64's where the "
                                 f"CPU's is float64's ({what})")
    if not adversarial and state is None:
        result["mrstft_attribution"] = attribute_mrstft(small, cfg)
    torch.cuda.empty_cache()
    return result


def step_faults(g_cpu, g_gpu, d0, p_cpu, p_gpu,
                grad_tol: float = DISC_GRAD_TOL) -> tuple:
    """Hold an Adam step on the card against the CPU's (the discriminator's,
    the mask DNN's): each gradient leaf within ``grad_tol`` of its largest
    magnitude (floored at GRAD_FLOOR x the largest of all); of the elements
    whose CPU gradient after the clip passes 1e-5, a share of at most
    TRAIN_FLIP_SHARE with the other sign on the card; the parameters after
    Adam within TRAIN_PARAM_TOL of their scale where the clipped gradients
    agree in sign and pass 1e-5 (Adam's first step is lr x sign(g) there),
    within twice the step elsewhere. Returns (faults, figures)."""
    from sincformer_tpu_torch.train.state import GRAD_CLIP

    def clipped(g):
        norm = float(torch.sqrt(sum((v ** 2).sum() for v in g.values())))
        return {k: v * min(1.0, GRAD_CLIP / norm) for k, v in g.items()}
    gc, gg = clipped(g_cpu), clipped(g_gpu)
    floor = GRAD_FLOOR * max(float(g.abs().max()) for g in g_cpu.values())
    faults = []
    grad, grad_at, worst, other, n_el, n_big, flipped = (0.0, "", 0.0, 0, 0,
                                                         0, 0)
    for k, w in p_cpu.items():
        off = float((g_gpu[k] - g_cpu[k]).abs().max()) / max(
            float(g_cpu[k].abs().max()), floor)
        if off >= grad:
            grad, grad_at = off, k
        big = gc[k].abs() >= 1e-5
        n_big += int(big.sum())
        flipped += int((big & (torch.sign(gc[k]) != torch.sign(gg[k]))
                        ).sum())
        scale = float(w.abs().max())
        same = ((torch.sign(gc[k]) == torch.sign(gg[k])) & big
                & (gg[k].abs() >= 1e-5))
        diff = (p_gpu[k] - w).abs()
        if same.any():
            worst = max(worst, float(diff[same].max()) / scale)
        step = float((w - d0[k]).abs().max())
        if not bool((diff[~same] <= 2 * step + TRAIN_PARAM_TOL * scale
                     ).all()):
            faults.append(f"{k}: a parameter moved past its step")
        other += int((~same).sum())
        n_el += w.numel()
    if not grad <= grad_tol:
        faults.append(f"gradient of {grad_at} {grad:.3e} of its scale")
    if not flipped <= TRAIN_FLIP_SHARE * n_big:
        faults.append(f"{flipped} of {n_big} gradient elements flipped sign")
    if not worst <= TRAIN_PARAM_TOL:
        faults.append(f"parameters {worst:.3e} of their scale")
    return faults, {"grad": grad, "grad_worst_leaf": grad_at,
                    "grad_elements_flipped": flipped,
                    "grad_elements_past_1e-5": n_big, "param": worst,
                    "param_elements_other": other, "elements": n_el}


def planted_flip_faults(g_cpu, g_gpu, d0, p_cpu, p_gpu, n_big: int,
                        grad_tol: float) -> tuple:
    """:func:`step_faults` on the card's step with sign flips planted, which
    it must refuse: twice the allowed share of the smallest CPU gradients
    past 1e-5 of the largest leaf negated and their parameter steps
    mirrored. Returns (faults, the number planted, the leaf)."""
    from sincformer_tpu_torch.train.state import GRAD_CLIP
    leaf = max(g_gpu, key=lambda k: g_gpu[k].numel())
    n = 2 * int(TRAIN_FLIP_SHARE * n_big) + 1
    norm = float(torch.sqrt(sum((v ** 2).sum() for v in g_cpu.values())))
    mags = g_cpu[leaf].abs().flatten() * min(1.0, GRAD_CLIP / norm)
    idx = torch.argsort(torch.where(mags >= 1e-5, mags,
                                    torch.full_like(mags, float("inf"))))[:n]
    g_bad, p_bad = dict(g_gpu), dict(p_gpu)
    g_bad[leaf] = g_gpu[leaf].flatten().clone()
    g_bad[leaf][idx] *= -1
    g_bad[leaf] = g_bad[leaf].view_as(g_gpu[leaf])
    p_bad[leaf] = p_gpu[leaf].flatten().clone()
    p_bad[leaf][idx] = 2 * d0[leaf].flatten()[idx] - p_bad[leaf][idx]
    p_bad[leaf] = p_bad[leaf].view_as(p_gpu[leaf])
    faults, _ = step_faults(g_cpu, g_bad, d0, p_cpu, p_bad, grad_tol)
    return faults, n, leaf


def check_disc_step(d_cpu, d_gpu, what: str, result: dict, key: str):
    """The discriminator's step, card against CPU (:func:`step_faults`),
    and its loss within TRAIN_LOSS_TOL; then the same check with sign flips
    planted (:func:`planted_flip_faults`), which it must refuse."""
    (dl_cpu, g_cpu, d0, p_cpu), (dl_gpu, g_gpu, _, p_gpu) = d_cpu, d_gpu
    rel = abs(dl_gpu - dl_cpu) / abs(dl_cpu)
    faults, figures = step_faults(g_cpu, g_gpu, d0, p_cpu, p_gpu)
    planted, n, leaf = planted_flip_faults(
        g_cpu, g_gpu, d0, p_cpu, p_gpu, figures["grad_elements_past_1e-5"],
        DISC_GRAD_TOL)
    say(f"[train] adversarial: the discriminator's step ({what}): loss "
        f"{dl_gpu:.6f} vs {dl_cpu:.6f}, {rel:.3e} relative (limit "
        f"{TRAIN_LOSS_TOL:g}); gradients up to {figures['grad']:.3e} of the "
        f"leaf's scale ({figures['grad_worst_leaf']}; limit "
        f"{DISC_GRAD_TOL:g}); {figures['grad_elements_flipped']} of "
        f"{figures['grad_elements_past_1e-5']} clipped gradients past 1e-5 "
        f"with the other sign (limit {TRAIN_FLIP_SHARE:g} of them); "
        f"parameters after Adam {figures['param']:.3e} of the leaf's scale "
        f"where the clipped gradients agree in sign and pass 1e-5 (limit "
        f"{TRAIN_PARAM_TOL:g}), the other {figures['param_elements_other']} "
        f"of {figures['elements']} elements within twice the step; "
        f"{n} planted sign flips in {leaf}: {planted}")
    result[f"disc_card_vs_cpu_{key}"] = {"loss_rel": rel, **figures,
                                         "planted_flips": n}
    if faults or not rel <= TRAIN_LOSS_TOL:
        raise AssertionError(f"the discriminator's step on the card left the "
                             f"CPU's: {faults}")
    if not any("flipped sign" in f for f in planted):
        raise AssertionError("a planted sign flip in the discriminator's "
                             "gradients went unseen")


def attribute_mrstft(small: dict, cfg) -> dict:
    """Split the error of the MR-STFT term's float32 gradient by source.
    The term is a function of the enhanced wave alone: its gradient with
    respect to the parameters is the model's backward applied to its
    gradient with respect to that wave (the cotangent). One training forward
    on the CPU, on the card, on the card with K1 swapped for its plain
    version and on the CPU in float64 keeps each run's graph. Each source is
    then taken from one float32 run with the rest in float64: the forward
    that made the wave (and, within it, the network that made the enhanced
    spectrum, that spectrum's iSTFT taken in float64), the STFT path that
    takes the cotangent, and the model's backward. Every result is held
    against float64 throughout, per leaf (scale floored as in the step)."""
    from unittest import mock

    import sincformer_tpu_torch as port
    from sincformer_tpu_torch.dsp.stft import istft
    from sincformer_tpu_torch.ops import attention
    from sincformer_tpu_torch.ops.speech_attention import (
        _speech_attention_plain)
    from sincformer_tpu_torch.train.agent_trainer import SincformerTrainer
    from sincformer_tpu_torch.train.losses import multi_resolution_stft_loss
    a = port.AudioConfig()
    runs = {}
    for run, device, dtype in (("cpu", "cpu", torch.float32),
                               ("card", "cuda", torch.float32),
                               ("card, K1 plain", "cuda", torch.float32),
                               ("float64", "cpu", torch.float64)):
        p = SincformerTrainer(port.SincformerMetacog(cfg), device=device,
                              model_dir=ARTIFACT)
        p.load_model()
        p.model.to(dtype)
        p.init_state(epochs=1, steps_per_epoch=1)
        noisy, clean = (torch.from_numpy(small[k]).to(device, dtype)
                        for k in ("noisy", "clean"))
        plain = mock.patch.object(attention, "speech_attention",
                                  _speech_attention_plain)
        with plain if "plain" in run else contextlib.nullcontext():
            _, aux = p._loss(noisy, clean, True, 1.0, 1.0, None, 1.0)
        spec = torch.complex(aux["out"]["enhanced_real"].detach().double(),
                             aux["out"]["enhanced_imag"].detach().double())
        runs[run] = (p, aux["enh_wav"], clean, istft(
            spec.cpu(), a.fft_size, a.hop_size, a.frame_size,
            length=clean.shape[-1]))
    wave = {run: r[1].detach().cpu().double() for run, r in runs.items()}

    def cotangent(run, x):
        clean = runs[run][2]
        x = x.to(clean.device, clean.dtype, copy=True).requires_grad_(True)
        g, = torch.autograd.grad(multi_resolution_stft_loss(x, clean), x)
        return g.cpu().double()

    def backward(run, cot):
        p, enh = runs[run][:2]
        params = p.params()
        gs = torch.autograd.grad(enh, list(params.values()),
                                 cot.to(enh.device, enh.dtype),
                                 retain_graph=True, allow_unused=True)
        return {k: g.cpu().double() for k, g in zip(params, gs)
                if g is not None}

    cot64 = cotangent("float64", wave["float64"])
    ref = backward("float64", cot64)
    floor = GRAD_FLOOR * max(float(g.abs().max()) for g in ref.values())

    def off(got):
        return max((float((got[k] - w).abs().max())
                    / max(float(w.abs().max()), floor), k)
                   for k, w in ref.items())

    def wave_off(x, y):
        return float((x - y).abs().max() / y.abs().max())

    out = {}
    say("[train] MR-STFT term's gradient, of each leaf's scale from float64 "
        "(one forward each from the committed artifact, batch (2, 32000)):")
    for run in ("cpu", "card", "card, K1 plain"):
        rows = {
            "all": backward(run, cotangent(run, wave[run])),
            "forward": backward("float64", cotangent("float64", wave[run])),
            "network": backward("float64", cotangent("float64",
                                                     runs[run][3])),
            "stft_path": backward("float64", cotangent(run,
                                                       wave["float64"])),
            "model_backward": backward(run, cot64)}
        r = out[run] = {what: off(g)[0] for what, g in rows.items()}
        r["wave"] = wave_off(wave[run], wave["float64"])
        r["cotangent_forward"] = wave_off(cotangent("float64", wave[run]),
                                          cot64)
        r["cotangent_stft_path"] = wave_off(cotangent(run, wave["float64"]),
                                            cot64)
        say(f"[train]   {run}: all float32 {r['all']:.3e} "
            f"({off(rows['all'])[1]}); its forward alone {r['forward']:.3e} "
            f"(its network alone, iSTFT in float64, {r['network']:.3e}), its "
            f"STFT path alone {r['stft_path']:.3e}, its model backward alone "
            f"{r['model_backward']:.3e}; enhanced wave {r['wave']:.3e} of "
            f"its peak from float64; cotangent from its wave "
            f"{r['cotangent_forward']:.3e} and from its STFT path "
            f"{r['cotangent_stft_path']:.3e} of the largest")
    del runs
    return out


def eval_models(seed: int, model_dir: str) -> None:
    """The models ``evaluate`` scores in ``[evaluate]`` and
    ``[distributed]``: the committed artifact's flagship and a seeded
    full-width mask DNN saved by the port."""
    import shutil

    import sincformer_tpu_torch as port
    shutil.copytree(os.path.join(ARTIFACT, "sincformer_final"),
                    os.path.join(model_dir, "sincformer_final"))
    dnn = port.create_dnn(port.FeatureConfig().dim).init_params(
        torch.Generator().manual_seed(seed))
    port.DNNPipeline("pcirm", device="cuda", model_dir=model_dir,
                     model=dnn).save_model()


def check_evaluate(seed: int, smi: str, launches) -> dict:
    """The ``evaluate`` verb in a process of its own on the card, over the
    committed artifact's flagship and a seeded full-width mask DNN saved by
    the port: every cell full, no failure caught, the noisy row and the
    flagship's means held against the JAX package's scores
    (``artifacts/r5/eval_grid_jax_cpu.json``); the metric sweep on the card
    against the CPU; one cell's device time split. The grid's per-cell
    values are returned under ``"grid"``."""
    from concurrent.futures import ThreadPoolExecutor

    import sincformer_tpu_torch as port
    from sincformer_tpu_torch.data.audio import add_noise_at_snr
    from sincformer_tpu_torch.data.loader import load_noise_signals
    from sincformer_tpu_torch.evaluation.batched import metrics_batch
    from sincformer_tpu_torch.evaluation.grid import (METRICS,
                                                      eval_utterances,
                                                      grid_differences)
    from sincformer_tpu_torch.evaluation.pesq import compute_pesq
    blocks = port.MetacogConfig().msa_blocks
    result = {}
    runner = ("import json, sys\n"
              "from sincformer_tpu_torch import cli\n"
              "import sincformer_tpu_torch as port\n"
              "rc = cli.main(sys.argv[1:])\n"
              "print(json.dumps({n: getattr(port, n).launches for n in ("
              "'speech_attention', 'quantize_int8', 'fused_ffn', 'meddis', "
              "'conv1d_gn', 'env_act')}))\n"
              "sys.exit(rc)\n")
    with open(EVAL_REFERENCE) as f:
        ref = json.load(f)
    with tempfile.TemporaryDirectory() as model_dir:
        eval_models(seed, model_dir)
        json_out = os.path.join(model_dir, "grid.json")
        env = {**os.environ, "SINCFORMER_MODEL_DIR": model_dir,
               "PYTHONPATH": REPO}
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", runner, "evaluate",
                               "--json-out", json_out], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=900)
        verb_s = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        for line in lines[-14:-1]:
            say(f"[evaluate] | {line}")
        if proc.returncode != 0:
            say(proc.stderr[-3000:])
            raise AssertionError(f"the evaluate verb exited "
                                 f"{proc.returncode}")
        failed = [line for line in lines if "FAILED" in line]
        child = json.loads(lines[-1])
        with open(json_out) as f:
            got = json.load(f)
        pipes = {"sincformer": port.SincformerPipeline(device="cuda",
                                                       model_dir=model_dir),
                 "pcirm": port.DNNPipeline("pcirm", device="cuda",
                                           model_dir=model_dir)}
        for pipe in pipes.values():
            pipe.load_model()
        n_snr = len(got["protocol"]["snr_levels"])
        say(f"[evaluate] evaluate --json-out: exit 0 in {verb_s:.1f} s wall "
            f"(process start, 2 models loaded, {got['protocol']['n_utterances']}"
            f" utterances x {n_snr} SNRs x 3 methods x 5 metrics); "
            f"{len(failed)} failures caught; kernel launches {child} on {smi}")
        if failed or child != {**dict.fromkeys(child, 0),
                               "speech_attention": n_snr * blocks}:
            raise AssertionError(f"the evaluate verb's run is not as "
                                 f"expected: {failed[:3]}")
        launches.total["speech_attention"] += child["speech_attention"]
        cells = got["results"]["white"]
        if list(cells) != ["noisy", "pcirm", "sincformer"] or not all(
                len(v) == 8 and np.all(np.isfinite(v))
                for by_snr in cells.values() for cell in by_snr.values()
                for v in cell.values()):
            raise AssertionError("an evaluate cell is not full")

        # the noisy row: the same mixtures, metric by metric
        worst = {}
        for k in METRICS:
            worst[k] = max(abs(a - b) for snr, cell in cells["noisy"].items()
                           for a, b in zip(cell[k],
                                           ref["results"]["white"]["noisy"]
                                           [snr][k]))
        bars = {k: {"ssnr": EVAL_SSNR_TOL,
                    "pesq": EVAL_P862_TOL}.get(k, EVAL_UNIT_TOL)
                for k in METRICS}
        say("[evaluate] noisy row vs the JAX reference on the CPU, largest "
            "difference of one utterance: " + ", ".join(
                f"{k} {worst[k]:.3e} (limit {bars[k]:g})" for k in METRICS))
        flagship = grid_differences(got, ref, "sincformer")
        say("[evaluate] sincformer (the committed artifact) on the card vs "
            "JAX on the CPU: " + "; ".join(
                f"{k} mean {got['summary'][f'sincformer.{k}'][0]:.6f} vs "
                f"{ref['summary'][f'sincformer.{k}'][0]:.6f} (|d| "
                f"{d['mean']:.3e}, limit {EVAL_MEAN_TOL[k]:g}; one utterance"
                f" up to {d['utterance']:.3e} at {d['where']})"
                for k, d in flagship.items()))
        result.update(verb_s=verb_s, k1_launches=child["speech_attention"],
                      grid=got["results"], noisy_vs_jax=worst,
                      sincformer_vs_jax=flagship,
                      means={m: {k: got["summary"][f"{m}.{k}"][0]
                                 for k in METRICS}
                             for m in ("noisy", "sincformer", "pcirm")})
        if any(worst[k] > bars[k] for k in METRICS) or any(
                d["mean"] > EVAL_MEAN_TOL[k] for k, d in flagship.items()):
            raise AssertionError("the evaluation left the JAX reference")

        # the metric sweep, card vs CPU, on the grid's pairs at 0 dB
        clean = np.stack(eval_utterances(50))
        noise = load_noise_signals(8000)["white"]
        noisy = np.stack([add_noise_at_snr(c, noise, 0) for c in clean])
        enhanced = pipes["sincformer"].enhance_batch(noisy)
        launches.reset()
        sweep = {dev: metrics_batch(clean, enhanced, device=dev)
                 for dev in ("cuda", "cpu")}
        diffs = {k: float(np.abs(sweep["cuda"][k] - sweep["cpu"][k]).max())
                 for k in METRICS}
        say("[evaluate] metrics_batch (8, 16000), sincformer at 0 dB, card "
            "vs CPU: " + ", ".join(
                f"{k} {diffs[k]:.3e}" for k in METRICS)
            + f" (limits {EVAL_UNIT_TOL:g}, SSNR {EVAL_SSNR_TOL:g} dB)")
        result["metrics_batch_card_vs_cpu"] = diffs
        if any(diffs[k] > (EVAL_SSNR_TOL if k == "ssnr" else EVAL_UNIT_TOL)
               for k in METRICS):
            raise AssertionError("the metric sweep on the card left the CPU")

        # one cell (one SNR) of the grid: device time by part, host P.862
        lengths = np.full(len(clean), clean.shape[1])
        split = {
            "sincformer_ms": profile_once(
                lambda: pipes["sincformer"].enhance_batch(noisy))["busy_ms"],
            "pcirm_ms": profile_once(
                lambda: pipes["pcirm"].enhance_batch(noisy, lengths))[
                "busy_ms"],
            "sweep_ms_per_method": profile_once(
                lambda: metrics_batch(clean, enhanced,
                                      ("stoi", "ssnr", "csii", "ncm")))[
                "busy_ms"],
        }
        launches.expect("one cell's enhancement, profiled",
                        speech_attention=blocks)
        with ThreadPoolExecutor(max_workers=8) as pool:
            t0 = time.perf_counter()
            list(pool.map(lambda ce: compute_pesq(*ce), zip(clean,
                                                             enhanced)))
            split["p862_host_ms_per_method"] = (time.perf_counter()
                                                - t0) * 1e3
        say(f"[evaluate] one cell (8 utterances x 2 s, one SNR): device busy"
            f" {split['sincformer_ms']:.3f} ms flagship enhancement, "
            f"{split['pcirm_ms']:.3f} ms DNN enhancement, "
            f"{split['sweep_ms_per_method']:.3f} ms metric sweep per method; "
            f"host P.862 {split['p862_host_ms_per_method']:.1f} ms wall per "
            f"method (8 threads); the verb has {n_snr} cells x 3 methods "
            f"on {smi}")
        result["cell_split"] = split
        del pipes
    torch.cuda.empty_cache()
    return result


def check_calibrate(launches) -> dict:
    """The ``calibrate`` verb (--model sincformer --samples 8 --synthetic)
    on a copy of the committed artifact, on the card and on the CPU: the
    gains agree, each is persisted in its copy's sidecar, and a fresh load
    on the card reads it."""
    import shutil

    import sincformer_tpu_torch as port
    from sincformer_tpu_torch import cli
    from sincformer_tpu_torch.train.state import read_train_meta
    blocks = port.MetacogConfig().msa_blocks
    before = read_train_meta(ARTIFACT, "sincformer_final")["output_gain"]
    gains, walls, k1 = {}, {}, {}
    with tempfile.TemporaryDirectory() as root:
        for device in ("cuda", "cpu"):
            model_dir = os.path.join(root, device)
            shutil.copytree(os.path.join(ARTIFACT, "sincformer_final"),
                            os.path.join(model_dir, "sincformer_final"))
            os.environ["SINCFORMER_MODEL_DIR"] = model_dir
            launches.reset()
            t0 = time.perf_counter()
            if cli.main(["calibrate", "--model", "sincformer", "--samples",
                         "8", "--synthetic", "--device", device]) != 0:
                raise AssertionError("the calibrate verb failed")
            walls[device] = time.perf_counter() - t0
            k1[device] = launches.expect(
                f"calibrate on {device}",
                speech_attention=blocks if device == "cuda" else 0
            )["speech_attention"]
            gains[device] = read_train_meta(
                model_dir, "sincformer_final")["output_gain"]
        fresh = port.SincformerPipeline(device="cuda", model_dir=os.path.join(
            root, "cuda"))
        fresh.load_model()
    rel = abs(gains["cuda"] - gains["cpu"]) / gains["cpu"]
    say(f"[calibrate] calibrate --model sincformer --samples 8 --synthetic "
        f"on a copy of the artifact: output_gain {before:.6f} -> "
        f"{gains['cuda']:.8f} on the card ({walls['cuda']:.2f} s wall, K1 "
        f"{k1['cuda']} launches), {gains['cpu']:.8f} on the CPU "
        f"({walls['cpu']:.2f} s, K1 {k1['cpu']}); {rel:.3e} relative (limit {GAIN_TOL:g}); "
        f"persisted, a fresh load reads {fresh.output_gain:.8f}")
    if not (rel <= GAIN_TOL and fresh.output_gain == gains["cuda"]
            and gains["cuda"] != before):
        raise AssertionError("the calibrated gain is not as expected")
    return {"before": before, "card": gains["cuda"], "cpu": gains["cpu"],
            "rel": rel, "wall_s": walls, "k1_launches": k1}


def check_native_and_trace(seed: int, launches) -> dict:
    """WAV input through the native decoder, built from native/wavio.cpp
    into the package's build directory, equal to scipy's read; then
    ``observability.trace`` around one flagship request from that input on
    the card, which writes a Chrome trace holding K1."""
    import sincformer_tpu_torch as port
    from sincformer_tpu_torch.data import native
    from sincformer_tpu_torch.data.audio import load_audio
    from sincformer_tpu_torch.ops.build import BUILD_DIR
    from sincformer_tpu_torch.utils.observability import trace
    from scipy.io import wavfile
    blocks = port.MetacogConfig().msa_blocks
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "in.wav")
        wavfile.write(path, 8000, to_pcm(speechlike(
            np.random.default_rng(seed + 7), 32000)))
        reads = native.reads
        t0 = time.perf_counter()
        x = load_audio(path)
        read_ms = (time.perf_counter() - t0) * 1e3
        lib = native.library_path()
        if not (native.reads == reads + 1 and os.path.exists(lib)
                and os.path.dirname(lib) == BUILD_DIR):
            raise AssertionError("the native WAV decoder did not serve the "
                                 "read")
        if not np.array_equal(x, load_audio(path, use_native=False)):
            raise AssertionError("the native decoder disagrees with scipy")
        pipe = port.SincformerPipeline(device="cuda", model_dir=ARTIFACT)
        pipe.load_model()
        pipe.enhance_signal(x)                     # plans and caches
        launches.reset()
        with trace(os.path.join(d, "prof")) as log_dir:
            pipe.enhance_signal(x)
        launches.expect("traced flagship request", speech_attention=blocks)
        files = os.listdir(log_dir)
        with open(os.path.join(log_dir, files[0])) as f:
            events = json.load(f)["traceEvents"]
        size = os.path.getsize(os.path.join(log_dir, files[0]))
    k1 = [e for e in events if e.get("cat") == "kernel"
          and "speech_attention" in e.get("name", "")]
    n_kernels = sum(1 for e in events if e.get("cat") == "kernel")
    say(f"[native] load_audio of a 4 s int16 WAV through "
        f"{os.path.relpath(lib, REPO)} ({read_ms:.2f} ms), equal to scipy's "
        f"read; [trace] one flagship request under trace(): {files[0]}, "
        f"{size} bytes, {n_kernels} kernel events, K1 {len(k1)}")
    if len(files) != 1 or len(k1) != blocks:
        raise AssertionError("the trace does not hold the request's kernels")
    return {"native_read_ms": read_ms, "trace_bytes": size,
            "trace_kernels": n_kernels, "trace_k1": len(k1)}


def run_verb(argv, env_extra: dict, what: str, timeout: int = 900):
    """``cli.main(argv)`` in a process of its own on the card; returns
    (the child's launch counts of K1 and K3, its standard output, wall s).
    A non-zero exit fails the run."""
    runner = ("import json, sys\n"
              "from sincformer_tpu_torch import cli\n"
              "from sincformer_tpu_torch.ops.fused_ffn import fused_ffn\n"
              "from sincformer_tpu_torch.ops.speech_attention import "
              "speech_attention\n"
              "rc = cli.main(sys.argv[1:])\n"
              "print(json.dumps({'speech_attention': "
              "speech_attention.launches, 'fused_ffn': fused_ffn.launches}))"
              "\nsys.exit(rc)\n")
    env = {**os.environ, "PYTHONPATH": REPO, **env_extra}
    env.pop("SINCFORMER_MAX_WAVE_SECONDS", None)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", runner, *argv], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        say(proc.stdout[-2000:])
        say(proc.stderr[-3000:])
        raise AssertionError(f"{what} exited {proc.returncode}")
    lines = proc.stdout.strip().splitlines()
    return json.loads(lines[-1]), lines[:-1], wall


def grads_vs(g_a: dict, g_b: dict, g_ref: dict, zero=()) -> list:
    """Rows (|a - b| of the leaf's scale, leaf, |a - ref|, |b - ref|), worst
    first; a leaf's scale is floored at GRAD_FLOOR x the largest reference
    gradient. Leaves in ``zero`` (a gradient of zero in exact arithmetic)
    are left out here."""
    floor = GRAD_FLOOR * max(float(g.abs().max()) for g in g_ref.values())
    rows = []
    for k, w in g_ref.items():
        if k in zero:
            continue
        scale = max(float(w.abs().max()), floor)
        rows.append((float((g_a[k] - g_b[k]).abs().max()) / scale, k,
                     float((g_a[k] - w).abs().max()) / scale,
                     float((g_b[k] - w).abs().max()) / scale))
    return sorted(rows, reverse=True)


def steps_vs_float64(p0, p_cpu, p_gpu, p_64, g_cpu, g_64, g_gpu) -> tuple:
    """``[train]``'s rule for the whole loss's step: where the CPU's step is
    float64's (the clipped gradients agree in sign and pass 1e-5, well
    above AdamW's eps of 1e-8), the count of elements, and of those whose
    step on the card leaves float64's by more than its own float64 step;
    and the three clip factors (card, CPU, float64)."""
    from sincformer_tpu_torch.train.state import GRAD_CLIP

    def clipped(g):
        norm = float(torch.sqrt(sum((v ** 2).sum() for v in g.values())))
        clip = min(1.0, GRAD_CLIP / norm)
        return clip, {k: v * clip for k, v in g.items()}
    (c_cpu, gc_all), (c_64, g6_all) = clipped(g_cpu), clipped(g_64)
    c_gpu = clipped(g_gpu)[0]
    n, past = 0, 0
    for k, w in p_64.items():
        gc, g6 = gc_all[k], g6_all[k]
        trusted = ((torch.sign(gc) == torch.sign(g6)) & (gc.abs() >= 1e-5)
                   & (g6.abs() >= 1e-5))
        own = ((p_gpu[k] - w).abs()
               / (w - p0[k]).abs().clamp_min(1e-30))[trusted]
        n += int(trusted.sum())
        past += int((own > 1.0).sum())
    return n, past, (c_gpu, c_cpu, c_64)


def dcse_batch(seed: int) -> dict:
    """8 utterances of 4 s (the train verb's batch shape) from the
    synthetic corpus, 0 and 5 dB."""
    from sincformer_tpu_torch.cli import _synthetic_corpus
    from sincformer_tpu_torch.data.loader import (batch_iterator,
                                                  remix_for_stage)
    clean, noises = _synthetic_corpus(TRAIN_BATCH[0], "multi", "varied")
    ds = remix_for_stage(clean, noises, [0, 5], TRAIN_BATCH[1], seed)
    return next(batch_iterator(ds, TRAIN_BATCH[0], shuffle=False))


def dcse_step(state: dict, cfg, device: str, dtype, batch: dict) -> dict:
    """One dropout-0 DCSE training step from ``state``: the loss, the
    gradients of the whole loss and of the loss without the MR-STFT term
    (the term's own gradients taken apart from the same forward), the
    BatchNorm statistics after the forward, and the parameters before and
    after the AdamW update; every tensor on the CPU in float64."""
    from unittest import mock

    import sincformer_tpu_torch as port
    from sincformer_tpu_torch.train import dcse_trainer
    from sincformer_tpu_torch.train.state import guard_nan_update
    model = port.SpeechEnhancer(cfg)
    model.load_state_dict(state)
    p = dcse_trainer.DCSETrainer(model, device=device)
    p.model.to(dtype)
    p.init_state(epochs=1, steps_per_epoch=1, init_params=False)
    noisy, clean = (torch.from_numpy(batch[k]).to(device, dtype)
                    for k in ("noisy", "clean"))
    terms = []
    real = dcse_trainer.multi_resolution_stft_loss

    def keep(pred, target):
        terms.append(real(pred, target))
        return terms[-1]
    t0 = time.perf_counter()
    with mock.patch.object(dcse_trainer, "multi_resolution_stft_loss", keep):
        loss, _ = p._loss(noisy, clean, True)
    params = p.params()
    g_all = torch.autograd.grad(loss, list(params.values()),
                                retain_graph=True, allow_unused=True)
    g_mr = torch.autograd.grad(terms[0], list(params.values()),
                               allow_unused=True)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    def host(g, p_):
        return (torch.zeros_like(p_) if g is None else g).detach().cpu(
        ).double()
    grads = {k: host(g, v) for (k, v), g in zip(params.items(), g_all)}
    without = {k: grads[k] - host(g, v)
               for (k, v), g in zip(params.items(), g_mr)}
    stats = {k: b.detach().cpu().double()
             for k, b in p.model.named_buffers()}
    before = {k: v.detach().cpu().double() for k, v in params.items()}
    guarded, _ = guard_nan_update(list(g_all), loss.detach(),
                                  params.values())
    p.tx.update(params, guarded, p.opt_state)
    after = {k: v.detach().cpu().double() for k, v in params.items()}
    return {"loss": float(loss.detach()), "grads": grads,
            "without": without, "stats": stats, "before": before,
            "after": after, "s": wall}


def check_train_dcse(seed: int, smi: str, launches) -> dict:
    """DCSE training on the card: the train verb end to end at full width,
    one dropout-0 step of 8 x 4 s card vs CPU vs float64 with
    ``conv_norm`` "layer" and "batch", the fused feed-forward (K3) in a
    validation pass and under autograd, and the step's time."""
    import sincformer_tpu_torch as port
    from sincformer_tpu_torch.train.dcse_trainer import DCSETrainer
    from sincformer_tpu_torch.train.state import latest_step_dir
    cfg = port.DCSEConfig()
    blocks = cfg.num_blocks
    result = {}

    # ── the train verb in a process of its own ──────────────────────────
    with tempfile.TemporaryDirectory() as model_dir:
        log = os.path.join(model_dir, "train.jsonl")
        counts, lines, wall = run_verb(
            ["train", "--pipeline", "conformer", "--synthetic", "40",
             "--epochs", "2", "--seed", str(seed), "--log-jsonl", log],
            {"SINCFORMER_MODEL_DIR": model_dir}, "train --pipeline conformer")
        for line in lines[-6:]:
            say(f"[train-dcse] | {line}")
        records = [json.loads(line) for line in open(log)]
        # 36 utterances in batches of 8: 4 steps an epoch; 4 validation
        # utterances: one batch an epoch; one forward each
        steps, evals = 2 * (36 // 8), 2
        want_k1 = blocks * (steps + evals)
        say(f"[train-dcse] train --pipeline conformer --synthetic 40 --epochs"
            f" 2: exit 0 in {wall:.1f} s wall ({steps} steps of "
            f"{TRAIN_BATCH}, {evals} validations, DCSEConfig() at 6,225,414 "
            f"parameters); K1 launches {counts['speech_attention']} = "
            f"{blocks} blocks x ({steps} steps + {evals} validation "
            f"batches), K3 {counts['fused_ffn']}")
        for r in records:
            say(f"[train-dcse] epoch {r['epoch']}: train loss "
                f"{r['train_loss']:.4f}, val loss {r['val_loss']:.4f}, val "
                f"SI-SNR {r['val_sisnr']:+.2f} dB, nan_count "
                f"{r['nan_count']}, {r['epoch_seconds']:.2f} s")
        if (counts != {"speech_attention": want_k1, "fused_ffn": 0}
                or len(records) != 2
                or not all(np.isfinite(r["train_loss"])
                           and np.isfinite(r["val_loss"])
                           and r["nan_count"] == 0 for r in records)):
            raise AssertionError("the DCSE train verb's run is not as "
                                 "expected")
        launches.total["speech_attention"] += counts["speech_attention"]
        for family in ("best_conformer", "conformer_final"):
            if latest_step_dir(os.path.join(model_dir, family)) is None:
                raise AssertionError(f"no {family} checkpoint written")
        served = port.DCSEPipeline(device="cuda", model_dir=model_dir)
        path = served.load_model()
        launches.reset()
        out = served.enhance_signal(speechlike(np.random.default_rng(seed),
                                               20000))
        launches.expect("dcse enhance from the trained checkpoint",
                        speech_attention=blocks)
        if out.shape != (20000,) or not np.all(np.isfinite(out)):
            raise AssertionError("serving the trained DCSE checkpoint failed")
        say(f"[train-dcse] served one 2.5 s request on the card from "
            f"{os.path.relpath(path, model_dir)} (output_gain "
            f"{served.output_gain:.4f})")
        result.update(verb_s=wall, verb_k1=counts["speech_attention"],
                      epoch_s=[r["epoch_seconds"] for r in records])
        del served

    # ── one step card vs CPU vs float64, "layer" and "batch" ────────────
    batch = dcse_batch(seed)
    for norm in ("layer", "batch"):
        step_cfg = port.DCSEConfig(conv_norm=norm, dropout=0.0)
        state = port.SpeechEnhancer(step_cfg).training_init(
            torch.Generator().manual_seed(seed)).state_dict()
        launches.reset()
        gpu = dcse_step(state, step_cfg, "cuda", torch.float32, batch)
        k = launches.expect(f"dcse step ({norm})", speech_attention=blocks)
        cpu = dcse_step(state, step_cfg, "cpu", torch.float32, batch)
        f64 = dcse_step(state, step_cfg, "cpu", torch.float64, batch)
        launches.expect("dcse step on the CPU")
        rel = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
        zero = ({n for n in state if n.endswith("depthwise.bias")}
                if norm == "batch" else set())
        rows = grads_vs(gpu["without"], cpu["without"], f64["without"], zero)
        floor = GRAD_FLOOR * max(float(g.abs().max())
                                 for g in f64["without"].values())
        zero_worst = max([float(r["without"][n].abs().max()) / floor
                          for r in (gpu, cpu) for n in zero] or [0.0])
        rows_all = grads_vs(gpu["grads"], cpu["grads"], f64["grads"], zero)
        n_trusted, past, clips = steps_vs_float64(
            cpu["before"], cpu["after"], gpu["after"], f64["after"],
            cpu["grads"], f64["grads"], gpu["grads"])
        clip_rel = abs(clips[0] - clips[1]) / clips[1]
        stats = max([float((gpu["stats"][n] - cpu["stats"][n]).abs().max())
                     / max(1.0, float(cpu["stats"][n].abs().max()))
                     for n in cpu["stats"]] or [0.0])
        say(f"[train-dcse] {norm}: one step of {TRAIN_BATCH}, dropout 0, "
            f"card vs CPU: loss {gpu['loss']:.6f} vs {cpu['loss']:.6f} "
            f"({f64['loss']:.6f} in float64), {rel:.3e} relative (limit "
            f"{TRAIN_LOSS_TOL:g}); gradients without the MR-STFT term up to "
            f"{rows[0][0]:.3e} of the leaf's scale (limit {TRAIN_GRAD_TOL:g};"
            f" {rows[0][1]}), card vs float64 {max(r[2] for r in rows):.3e},"
            f" CPU vs float64 {max(r[3] for r in rows):.3e}; with it "
            f"{rows_all[0][0]:.3e} card vs CPU (limit {TRAIN_GRAD_TOL:g}; "
            f"{rows_all[0][1]}); K1 {k['speech_attention']} "
            f"in the card's step; CPU step {cpu['s']:.1f} s, "
            f"{f64['s']:.1f} s in float64")
        n_el = sum(v.numel() for v in cpu["after"].values())
        say(f"[train-dcse] {norm}: the whole loss's AdamW step, where the "
            f"CPU's is float64's (the clipped gradients agree in sign and "
            f"pass 1e-5: {n_trusted} of {n_el} elements): {past} on the "
            f"card past float64's own step (limit {TRAIN_FLIP_SHARE:g} of "
            f"them); clip factors {clips[0]:.7g} card, {clips[1]:.7g} CPU "
            f"({clip_rel:.3e} relative, limit {CLIP_TOL:g}), {clips[2]:.7g} "
            f"float64"
            + (f"; BatchNorm statistics card vs CPU {stats:.3e} (limit "
               f"{DCSE_STATS_TOL:g}); the depthwise bias in front of it, "
               f"zero in exact arithmetic: {zero_worst:.3e} of the floor"
               if norm == "batch" else ""))
        result[f"card_vs_cpu_{norm}"] = {
            "loss_rel": rel, "grad_without_mrstft": rows[0][0],
            "grad_whole": rows_all[0][0], "trusted": n_trusted,
            "elements": n_el, "clip_factors": clips,
            "past_float64_step": past, "clip_rel": clip_rel,
            "batch_stats": stats}
        if not (rel <= TRAIN_LOSS_TOL and rows[0][0] <= TRAIN_GRAD_TOL
                and rows_all[0][0] <= TRAIN_GRAD_TOL and clip_rel <= CLIP_TOL
                and past <= TRAIN_FLIP_SHARE * n_trusted
                and stats <= DCSE_STATS_TOL and zero_worst <= 1e-2):
            raise AssertionError(f"the DCSE step on the card left the CPU's "
                                 f"({norm})")
        del gpu, cpu, f64
    torch.cuda.empty_cache()

    # ── the fused feed-forward: a validation pass, a dropout-0 step ─────
    state = port.SpeechEnhancer(port.DCSEConfig(dropout=0.0)).training_init(
        torch.Generator().manual_seed(seed)).state_dict()
    fused_cfg = port.DCSEConfig(dropout=0.0, fused_ffn=True)
    val = DCSETrainer(port.SpeechEnhancer(fused_cfg), device="cuda")
    val.load_state(state)
    tensors = [torch.from_numpy(batch[k]).cuda()
               for k in ("noisy", "clean", "lengths")]
    launches.reset()
    fused_eval = [float(x) for x in val.eval_step(*tensors)]
    v = launches.expect("dcse validation, fused", speech_attention=blocks,
                        fused_ffn=2 * blocks)
    plain = DCSETrainer(port.SpeechEnhancer(port.DCSEConfig(dropout=0.0)),
                        device="cuda")
    plain.load_state(state)
    plain_eval = [float(x) for x in plain.eval_step(*tensors)]
    launches.expect("dcse validation, unfused", speech_attention=blocks)
    del val, plain
    fused = dcse_step(state, fused_cfg, "cuda", torch.float32, batch)
    s = launches.expect("dcse step, fused, dropout 0",
                        speech_attention=blocks, fused_ffn=2 * blocks)
    unfused = dcse_step(state, port.DCSEConfig(dropout=0.0), "cuda",
                        torch.float32, batch)
    launches.expect("dcse step, unfused", speech_attention=blocks)
    rows = grads_vs(fused["without"], unfused["without"], unfused["without"])
    eval_rel = abs(fused_eval[0] - plain_eval[0]) / abs(plain_eval[0])
    step_rel = abs(fused["loss"] - unfused["loss"]) / abs(unfused["loss"])
    say(f"[train-dcse] fused_ffn: validation of {TRAIN_BATCH} with K1 "
        f"{v['speech_attention']} and K3 {v['fused_ffn']} launches, loss "
        f"{fused_eval[0]:.6f} vs {plain_eval[0]:.6f} unfused ({eval_rel:.3e}"
        f" relative); a dropout-0 step with K3 {s['fused_ffn']} launches "
        f"under autograd: loss {step_rel:.3e} relative, gradients without "
        f"the MR-STFT term up to {rows[0][0]:.3e} of the leaf's scale from "
        f"the unfused step's (limit {TRAIN_GRAD_TOL:g}; {rows[0][1]})")
    if not (eval_rel <= TRAIN_LOSS_TOL and step_rel <= TRAIN_LOSS_TOL
            and rows[0][0] <= TRAIN_GRAD_TOL):
        raise AssertionError("the fused DCSE step left the unfused one")
    result.update(k1_in_validation=v["speech_attention"],
                  k3_in_validation=v["fused_ffn"],
                  k1_in_step=s["speech_attention"],
                  k3_in_step_no_dropout=s["fused_ffn"],
                  fused_vs_unfused_grad=rows[0][0])
    del fused, unfused
    torch.cuda.empty_cache()

    # ── the step's time: DCSEConfig() (dropout 0.15), 20 steps ──────────
    pipe = DCSETrainer(device="cuda", seed=seed)
    pipe.init_state(epochs=1, steps_per_epoch=20)
    noisy, clean = tensors[:2]
    run = timed_steps(lambda: pipe.train_step(noisy, clean)[0], 20, blocks,
                      launches, "dcse training step")
    losses, step_ms, k1 = run["losses"], run["step_ms"], run["k1"]
    busy, n_launch = run["profiled"]["busy_ms"], run["profiled"]["launches"]
    median, peak_gb = run["median_ms"], run["peak_gb"]
    say(f"[train-dcse] DCSEConfig() (dropout 0.15), {TRAIN_BATCH}, 20 "
        f"steps: loss {losses[0]:.4f} at step 1, {losses[-1]:.4f} at step "
        f"20; {median:.2f} ms per step (median of steps 2-20; step 1 "
        f"{step_ms[0]:.1f} ms), device busy {busy:.3f} ms "
        f"({busy / median:.3f} of the step), {n_launch} kernel launches, "
        f"K1 {k1[-1]} a step, peak memory {peak_gb:.2f} GB on {smi}")
    if not losses[-1] < losses[0] or not all(np.isfinite(losses)):
        raise AssertionError("the DCSE loss did not fall over 20 steps")
    result.update(step_ms_median=median, step_ms_first=step_ms[0],
                  device_busy_ms=busy, device_busy_share=busy / median,
                  kernel_launches_per_step=n_launch,
                  k1_launches_per_step=k1[-1], peak_memory_gb=peak_gb)
    del pipe
    torch.cuda.empty_cache()
    launches.reset()
    return result


def check_train_dnn(seed: int, smi: str, launches) -> dict:
    """Training of the original paper's mask DNN on the card: the train
    verb (RBM on) and ``enhance --model pcirm`` from its checkpoint, the
    preprocessing card vs CPU, one Adam step and one CD-1 step card vs CPU,
    and the OPT-PCIRM swarm at PSOConfig() card vs CPU: its fitness on the
    same positions, and the STOI of each device's best position."""
    import sincformer_tpu_torch as port
    from sincformer_tpu_torch import cli
    from sincformer_tpu_torch.masks.opt_pcirm import (compute_opt_pcirm,
                                                      opt_pcirm_fitness)
    from sincformer_tpu_torch.models.rbm import RBM, cd_uniform_shapes
    from sincformer_tpu_torch.train.dnn_trainer import (
        DNNTrainer, process_single_utterance)
    from sincformer_tpu_torch.train.state import make_adam_plateau
    from scipy.io import wavfile
    result = {}

    # ── the train verb, then enhance --model pcirm ──────────────────────
    with tempfile.TemporaryDirectory() as d:
        model_dir = os.path.join(d, "models")
        log = os.path.join(d, "train.jsonl")
        counts, lines, wall = run_verb(
            ["train", "--pipeline", "dnn", "--synthetic", "40", "--epochs",
             "2", "--seed", str(seed), "--log-jsonl", log],
            {"SINCFORMER_MODEL_DIR": model_dir,
             "SINCFORMER_CACHE_DIR": os.path.join(d, "cache")},
            "train --pipeline dnn")
        for line in lines[-4:]:
            say(f"[train-dnn] | {line}")
        records = [json.loads(line) for line in open(log)]
        rbm_lines = [line for line in lines if "RBM Epoch" in line]
        say(f"[train-dnn] train --pipeline dnn --synthetic 40 --epochs 2 "
            f"(RBM on: {len(rbm_lines)} RBM epochs): exit 0 in {wall:.1f} s "
            f"wall; kernel launches {counts}; epochs "
            + ", ".join(f"{r['epoch']}: train {r['train_loss']:.5f}, val "
                        f"{r['val_loss']:.5f}, {r['epoch_seconds']:.3f} s"
                        for r in records))
        if (counts != {"speech_attention": 0, "fused_ffn": 0}
                or len(records) != 2 or len(rbm_lines) != 30
                or not all(np.isfinite(r["train_loss"]) for r in records)):
            raise AssertionError("the DNN train verb's run is not as "
                                 "expected")
        os.environ["SINCFORMER_MODEL_DIR"] = model_dir
        x = speechlike(np.random.default_rng(seed + 8), 26400)
        wavfile.write(os.path.join(d, "in.wav"), 8000, to_pcm(x))
        launches.reset()
        if cli.main(["enhance", os.path.join(d, "in.wav"),
                     os.path.join(d, "out.wav"), "--model", "pcirm"]) != 0:
            raise AssertionError("enhance --model pcirm from the trained "
                                 "checkpoint failed")
        launches.expect("enhance --model pcirm from the trained DNN")
        out = wavfile.read(os.path.join(d, "out.wav"))[1]
        if out.shape != x.shape or not np.all(np.isfinite(out)):
            raise AssertionError("the trained DNN's output is bad")
        result.update(verb_s=wall,
                      epoch_s=[r["epoch_seconds"] for r in records])

    # ── the preprocessing, card vs CPU ──────────────────────────────────
    rng = np.random.default_rng(seed + 9)
    clean, noise = speechlike(rng, 31000), speechlike(rng, 40000)
    fe, gfb = port.FeatureExtractor(), port.GammatoneFilterbank()
    worst = {}
    for mask_type in ("irm", "pcirm", "opt_pcirm"):
        f_g, m_g = process_single_utterance(clean, noise, 5, mask_type, fe,
                                            gfb, device="cuda")
        f_c, m_c = process_single_utterance(clean, noise, 5, mask_type, fe,
                                            gfb, device="cpu")
        t = f_c.shape[0]
        raw_g, raw_c = f_g.reshape(t, 11, 54), f_c.reshape(t, 11, 54)
        pad = (np.arange(t)[:, None] + np.arange(11)[None, :] - 5) >= t
        for name, block in (("RASTA-PLP", slice(15, 28)),
                            ("MFCC", slice(28, 41)),
                            ("GFCC", slice(41, 54))):
            scale = float(np.abs(raw_c[..., block]).max())
            err = np.abs(raw_g[..., block] - raw_c[..., block]).max(-1)
            worst[name] = max(worst.get(name, 0.0),
                              float(err[~pad].max()) / scale)
            worst[name + " (padding context)"] = max(
                worst.get(name + " (padding context)", 0.0),
                float(err[pad].max()) / scale)
        worst[f"mask {mask_type}"] = float(np.abs(m_g - m_c).max())
        worst[f"mask {mask_type} units off 1e-3"] = float(
            np.mean(np.abs(m_g - m_c) > 1e-3))
    say("[train-dnn] preprocessing of a 31,000-sample utterance at 5 dB, "
        "card vs CPU, of each block's scale: " + ", ".join(
            f"{k} {v:.3e}" for k, v in worst.items()))
    if not (worst["RASTA-PLP"] <= 1e-4 and worst["MFCC"] <= 1e-4
            and worst["GFCC"] <= 1e-3
            and worst["GFCC (padding context)"] <= DNN_TAIL_TOL
            and all(worst[f"mask {m} units off 1e-3"] <= 1e-3
                    for m in ("irm", "pcirm", "opt_pcirm"))):
        raise AssertionError("the preprocessing on the card left the CPU's")
    result["preprocessing"] = worst

    # ── one Adam step and one CD-1 step, card vs CPU ────────────────────
    g = np.random.default_rng(seed + 10)
    feats = g.standard_normal((256, 594)).astype(np.float32)
    masks = g.uniform(0, 1, (256, 64)).astype(np.float32)
    steps = {}
    for device in ("cuda", "cpu"):
        tr = DNNTrainer(device=device, use_rbm_pretrain=False, seed=seed,
                        dcfg=port.DNNConfig(dropout=0.0))
        tr._init_model_state(1e-3, seed)
        before = {k: v.detach().cpu().double()
                  for k, v in tr.params().items()}
        used, update = [], tr.tx.update

        def keep(params, grads, state, used=used, update=update):
            # the gradients the step hands its optimizer
            used.extend(g.detach().cpu().double() for g in grads)
            update(params, grads, state)
        tr.tx.update = keep
        f_t, m_t = (torch.from_numpy(a).to(device) for a in (feats, masks))
        loss = tr.train_minibatch(f_t, m_t, torch.Generator(device=device))
        steps[device] = (float(loss), before,
                         {k: v.detach().cpu().double()
                          for k, v in tr.params().items()},
                         dict(zip(tr.params(), used)))
    (l_g, b_g, a_g, gr_g), (l_c, b_c, a_c, gr_c) = steps["cuda"], steps["cpu"]
    faults, adam = step_faults(gr_c, gr_g, b_c, a_c, a_g, TRAIN_GRAD_TOL)
    planted, n_planted, leaf = planted_flip_faults(
        gr_c, gr_g, b_c, a_c, a_g, adam["grad_elements_past_1e-5"],
        TRAIN_GRAD_TOL)
    # the card's optimizer alone: Adam in float64 on the card's gradients
    exact = {k: v.clone() for k, v in b_g.items()}
    ref = make_adam_plateau(1e-3)
    ref.update(exact, [gr_g[k] for k in exact], ref.init(exact))
    opt_worst = max(float((a_g[k] - w).abs().max() / w.abs().max())
                    for k, w in exact.items())
    rbm_c = RBM(594, 1024, seed=seed, device="cpu")
    rbm_g = RBM(594, 1024, seed=seed, device="cuda")
    v = torch.from_numpy(1.0 / (1.0 + np.exp(-feats)))
    gen = torch.Generator().manual_seed(seed)
    u = [torch.rand(s, generator=gen)
         for s in cd_uniform_shapes(256, 594, 1024, 1)]
    h_c = rbm_c.sample_hidden(rbm_c.params, v, u[0])
    h_g = rbm_g.sample_hidden(rbm_g.params, v.cuda(), u[0].cuda())
    flips = (h_c[1] != h_g[1].cpu())
    ties = float((h_c[0] - u[0]).abs()[flips].max()) if flips.any() else 0.0
    # the card's Bernoulli decisions imposed on the CPU's step: u = 1 - s
    u_cpu = [1.0 - h_g[1].cpu()] + u[1:]
    (w_g, vb_g, hb_g), e_g = rbm_g.cd_step(rbm_g.params, v.cuda(),
                                           [x.cuda() for x in u])
    (w_c, vb_c, hb_c), e_c = rbm_c.cd_step(rbm_c.params, v, u_cpu)
    rbm_worst = max(float((a.cpu() - b).abs().max() / b.abs().max())
                    for a, b in ((w_g, w_c), (vb_g, vb_c), (hb_g, hb_c)))
    say(f"[train-dnn] one Adam step (256 frames, full width, dropout 0), "
        f"card vs CPU: loss {l_g:.7f} vs {l_c:.7f}; gradients up to "
        f"{adam['grad']:.3e} of the leaf's scale ({adam['grad_worst_leaf']};"
        f" limit {TRAIN_GRAD_TOL:g}); {adam['grad_elements_flipped']} of "
        f"{adam['grad_elements_past_1e-5']} clipped gradients past 1e-5 with "
        f"the other sign (limit {TRAIN_FLIP_SHARE:g} of them); parameters "
        f"{adam['param']:.3e} of the leaf's scale where the clipped "
        f"gradients agree in sign and pass 1e-5 (limit {TRAIN_PARAM_TOL:g}),"
        f" the other {adam['param_elements_other']} of {adam['elements']} "
        f"within twice the step; the card's Adam against float64 Adam on the"
        f" card's gradients {opt_worst:.3e} of the leaf's scale, every "
        f"element (limit {TRAIN_PARAM_TOL:g}); {n_planted} planted sign "
        f"flips in {leaf}: {planted}; one CD-1 step (594 -> 1024, 256 "
        f"frames) on the same uniforms: {int(flips.sum())} hidden samples "
        f"flipped (|prob - u| up to {ties:.1e}), W and biases "
        f"{rbm_worst:.3e} of their scale, reconstruction error "
        f"{float(e_g):.7f} vs {float(e_c):.7f}")
    if (faults or not opt_worst <= TRAIN_PARAM_TOL
            or not rbm_worst <= TRAIN_PARAM_TOL or not ties < 1e-6
            or not abs(l_g - l_c) <= TRAIN_LOSS_TOL * abs(l_c)):
        raise AssertionError(f"the DNN's steps on the card left the CPU's: "
                             f"{faults}")
    if not any("flipped sign" in f for f in planted):
        raise AssertionError("a planted sign flip in the DNN's gradients "
                             "went unseen")
    result.update(adam_loss_rel=abs(l_g - l_c) / abs(l_c), adam=adam,
                  adam_vs_float64_optimizer=opt_worst,
                  adam_planted_flips=n_planted, cd1=rbm_worst,
                  cd1_flips=int(flips.sum()))

    # ── OPT-PCIRM: the swarm at PSOConfig() on one 2 s utterance ────────
    from sincformer_tpu_torch.data.audio import add_noise_at_snr
    from sincformer_tpu_torch.masks.pcirm import (
        compute_correlation_coefficients, compute_pcirm,
        compute_phase_differences)
    clean2 = speechlike(np.random.default_rng(seed + 11), 16000)
    noisy2 = add_noise_at_snr(clean2, noise, 0)
    best, fitness = {}, {}
    probe = np.random.default_rng(seed + 13).uniform(0.0, 1.0, 30)
    for device in ("cuda", "cpu"):
        with torch.inference_mode():
            (cm, cp), (nm, np_), (ym, yp) = (
                gfb.get_tf_magnitudes(torch.from_numpy(s).to(device))
                for s in (clean2, noise[:16000], noisy2))
            rho_s, rho_n = compute_correlation_coefficients(ym, cm, nm)
            phi1, phi2 = compute_phase_differences(yp, cp, np_)
            pcirm = compute_pcirm(cm, nm, rho_s, rho_n, phi1, phi2)
        fitness[device] = opt_pcirm_fitness(pcirm, noisy2, clean2)
        t0 = time.perf_counter()
        _, _, mid = compute_opt_pcirm(pcirm, noisy2, clean2,
                                      rng=np.random.default_rng(seed))
        best[device] = (mid, time.perf_counter() - t0)
    probe_err = float(np.abs(fitness["cuda"](probe)
                             - fitness["cpu"](probe)).max())
    # each swarm's best, scored by the CPU's fitness
    f_card, f_cpu = fitness["cpu"](np.array([best["cuda"][0],
                                             best["cpu"][0]]))
    say(f"[train-dnn] OPT-PCIRM swarm at PSOConfig() (30 particles, up to 100"
        f" iterations, one batched STOI call each) on a 2 s utterance at "
        f"0 dB: the fitness of 30 positions card vs CPU {probe_err:.3e} "
        f"(limit 1e-5); best middle step {best['cuda'][0]:.7f} on the card "
        f"in {best['cuda'][1]:.2f} s, {best['cpu'][0]:.7f} on the CPU in "
        f"{best['cpu'][1]:.2f} s, STOI there {f_card:.7f} and {f_cpu:.7f} "
        f"(limit 1e-5 apart: the swarms part where two fitness values tie "
        f"to rounding, on a flat optimum)")
    if not (probe_err <= 1e-5 and abs(f_card - f_cpu) <= 1e-5):
        raise AssertionError("the swarm on the card left the CPU's")
    result.update(pso_best=best["cuda"][0], pso_s=best["cuda"][1])
    launches.reset()
    return result


def check_import(seed: int, launches) -> dict:
    """A reference-format ``.pt`` (a BatchNorm DCSE at DCSEConfig()'s sizes
    with moved running statistics, written by ``compat.torch_export``)
    served through ``DCSEPipeline.from_torch_checkpoint`` on the card and
    on the CPU."""
    import sincformer_tpu_torch as port
    from sincformer_tpu_torch.compat.torch_export import \
        save_reference_checkpoint
    cfg = port.DCSEConfig(conv_norm="batch")
    model = port.SpeechEnhancer(cfg).training_init(
        torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, b in model.named_buffers():
            b.copy_(torch.rand(b.shape, generator=g) * 0.5
                    + (0.75 if name.endswith("var") else -0.25))
    x = speechlike(np.random.default_rng(seed + 12), 32000)
    with tempfile.TemporaryDirectory() as d:
        pt = save_reference_checkpoint(model,
                                       os.path.join(d, "conformer_final.pt"))
        launches.reset()
        card = port.DCSEPipeline.from_torch_checkpoint(pt, device="cuda")
        got = card.enhance_signal(x)
        launches.expect("reference .pt served on the card",
                        speech_attention=cfg.num_blocks)
        want = port.DCSEPipeline.from_torch_checkpoint(
            pt, device="cpu").enhance_signal(x)
        size = os.path.getsize(pt)
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    say(f"[import] a reference-format conformer_final.pt ({size} bytes, "
        f"BatchNorm with running statistics) served through "
        f"from_torch_checkpoint: card vs CPU {rel:.3e} of the peak (limit "
        f"{WAVE_TOL:g}), K1 {cfg.num_blocks} launches")
    if not rel <= WAVE_TOL:
        raise AssertionError("the imported checkpoint's output on the card "
                             "left the CPU's")
    return {"card_vs_cpu": rel}


def check_demo(launches) -> dict:
    """The ``demo`` verb on the card."""
    from sincformer_tpu_torch import cli
    buf = io.StringIO()
    t0 = time.perf_counter()
    launches.reset()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["demo"])
    wall = time.perf_counter() - t0
    launches.expect("demo")
    out = buf.getvalue()
    stats = [line.strip() for line in out.splitlines() if "mean=" in line]
    say(f"[demo] exit {rc} in {wall:.1f} s; {out.count('Metric')} metric "
        f"tables; last mask statistics: " + " | ".join(stats[-3:]))
    if rc != 0 or out.count("Metric") != 3 or "Demo complete" not in out:
        raise AssertionError("the demo verb failed on the card")
    return {"wall_s": wall}


def check_variants(seed: int, smi: str, launches) -> dict:
    """The flagship's variants at full width with seeded weights, beside the
    default flagship: each serves ``enhance_batch`` (4, 32000) on the card
    against the CPU, is saved, exported by the ``export`` verb, loaded as
    the variant its keys show and serves one request, and is timed (the
    batch request and a training step of 8 x 4 s: wall, device busy time,
    launches, K1 launches, peak memory). ``reference`` + ``ssm`` and
    ``dual`` also take a training step against the CPU at ``[train]``'s
    bars, from ``[train]``'s start, the committed artifact, wherever the
    variant has the artifact's parameter (the variant's own modules
    seeded); ``train --pa reference --cpea ssm`` runs as a process of its
    own and ``enhance`` serves its checkpoint."""
    import sincformer_tpu_torch as port
    from sincformer_tpu_torch import cli
    from sincformer_tpu_torch.cli import _synthetic_corpus
    from sincformer_tpu_torch.data.loader import batch_iterator
    from sincformer_tpu_torch.train.agent_trainer import SincformerTrainer
    rng = np.random.default_rng(seed + 20)
    batch16 = to_pcm(np.stack([speechlike(rng, 32000) for _ in range(4)]))
    request = speechlike(rng, 20000)
    clean, noises = _synthetic_corpus(TRAIN_BATCH[0], "multi", "varied")
    ds = SincformerTrainer.remix_for_stage(clean, noises, [0, 5],
                                           TRAIN_BATCH[1], 0)
    tbatch = next(batch_iterator(ds, TRAIN_BATCH[0], shuffle=False))
    result = {}
    for name, variant in VARIANT_CONFIGS:
        config = port.MetacogConfig(**variant)
        blocks = config.msa_blocks
        model = port.SincformerMetacog(config).init_params(
            torch.Generator().manual_seed(seed))
        state = {k: v.clone() for k, v in model.state_dict().items()}
        cpu_model = port.SincformerMetacog(config)
        cpu_model.load_state_dict(state)
        gpu = port.SincformerPipeline(model, device="cuda")
        cpu = port.SincformerPipeline(cpu_model, device="cpu")
        row = {"params": sum(p.numel() for p in model.parameters())}
        launches.reset()
        # each device's routing, read off its enhance_batch forward
        routed = {}
        hooks = [m.register_forward_hook(
            lambda _m, _i, out, dev=dev: routed.__setitem__(
                dev, {k: out[k].cpu() for k in ("decisions",
                                                 "route_logits")}))
            for m, dev in ((model, "card"), (cpu_model, "cpu"))]
        got = gpu.enhance_batch(batch16)
        launches.expect(f"[variants] {name} enhance_batch",
                        speech_attention=blocks)
        want = cpu.enhance_batch(batch16)
        for h in hooks:
            h.remove()
        flips = routed["cpu"]["decisions"] != routed["card"]["decisions"]
        logits = routed["cpu"]["route_logits"].sort(dim=-1,
                                                    descending=True).values
        margins = (logits[..., 0] - logits[..., 1])[flips]
        rel = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
        row.update(card_vs_cpu=rel, decision_flips=int(flips.sum()))
        say(f"[variants] {name} ({row['params']} params): enhance_batch "
            f"(4, 32000) card vs CPU {rel:.3e} of the peak (limit "
            f"{WAVE_TOL:g}), {int(flips.sum())} of {flips.numel()} MAA "
            f"decisions differ" + (f" at CPU logit margins "
                                   f"{margins.tolist()}" if flips.any()
                                   else ""))
        if not (got.shape == batch16.shape and np.all(np.isfinite(got))):
            raise AssertionError(f"{name}: bad enhance_batch output")
        if flips.any() and float(margins.max()) >= TIE_MARGIN:
            raise AssertionError(f"{name}: an MAA decision flipped away "
                                 f"from a near tie")
        if not flips.any() and not rel <= WAVE_TOL:
            raise AssertionError(f"{name}: card and CPU disagree: {rel}")

        # export: save, the export verb, load as the keys show, serve
        with tempfile.TemporaryDirectory() as d:
            src, out = os.path.join(d, "src"), os.path.join(d, "serving")
            gpu.model_dir = src
            gpu.save_model()
            os.environ["SINCFORMER_MODEL_DIR"] = src
            launches.reset()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main(["export", "--model", "sincformer", "--ckpt",
                               "final", "--out", out])
            if rc != 0:
                raise AssertionError(f"{name}: the export verb failed")
            launches.expect(f"[variants] {name} export", quantize_int8=1)
            served = port.SincformerPipeline(device="cuda", model_dir=out)
            served.load_model()
            shown = {k: getattr(served.model.config, k) for k in VARIANTS}
            one = served.enhance_signal(request)
            launches.expect(f"[variants] {name} served request",
                            speech_attention=blocks)
            if (shown != {k: getattr(config, k) for k in VARIANTS}
                    or one.shape != request.shape
                    or not np.all(np.isfinite(one))):
                raise AssertionError(f"{name}: the exported artifact did "
                                     f"not serve as its variant: {shown}")
            del served

        # time: the batch request, and a training step of 8 x 4 s
        torch.cuda.reset_peak_memory_stats()
        launches.reset()
        wall = wall_s(lambda: gpu.enhance_batch(batch16), reps=VARIANT_REPS)
        prof = profile_once(lambda: gpu.enhance_batch(batch16))
        calls = 1 + VARIANT_REPS + 1        # warm-up, timed, profiled
        k1 = launches.expect(f"[variants] {name} timed requests",
                             speech_attention=calls * blocks)
        row["enhance_batch"] = {
            "wall_ms": wall * 1e3, "device_busy_ms": prof["busy_ms"],
            "busy_share": prof["busy_ms"] / (wall * 1e3),
            "launches": prof["launches"],
            "k1_launches": k1["speech_attention"] // calls,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del gpu, cpu, cpu_model, model, got, want, routed
        torch.cuda.empty_cache()
        trainer = SincformerTrainer(port.SincformerMetacog(config),
                                    device="cuda", seed=seed)
        trainer.init_state(epochs=1, steps_per_epoch=VARIANT_STEPS_TIMED)
        noisy, clean_t = (torch.from_numpy(tbatch[k]).cuda()
                          for k in ("noisy", "clean"))
        run = timed_steps(
            lambda: trainer.train_step(noisy, clean_t, 1.0, 1.0, 1.0, 1.0)[0],
            VARIANT_STEPS_TIMED, 2 * blocks, launches,
            f"[variants] {name} training step")
        losses, median = run["losses"], run["median_ms"]
        busy = run["profiled"]["busy_ms"]
        row["train_step"] = {
            "wall_ms": median, "wall_ms_first": run["step_ms"][0],
            "device_busy_ms": busy, "busy_share": busy / median,
            "launches": run["profiled"]["launches"],
            "k1_launches": run["k1"][-1], "peak_gb": run["peak_gb"],
            "loss_first": losses[0], "loss_last": losses[-1]}
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{name}: a training loss is not finite")
        for what, r in (("enhance_batch (4, 32000)", row["enhance_batch"]),
                        (f"training step {TRAIN_BATCH}", row["train_step"])):
            say(f"[variants] {name} {what}: {r['wall_ms']:.3f} ms wall, "
                f"device busy {r['device_busy_ms']:.3f} ms (share "
                f"{r['busy_share']:.3f}), {r['launches']} launches, K1 "
                f"{r['k1_launches']}, peak {r['peak_gb']:.2f} GB on {smi}")
        del trainer, noisy, clean_t
        torch.cuda.empty_cache()
        if name in VARIANT_CPU_STEPS:
            # [train]'s step starts from the committed artifact: so does
            # the variant's, where it has the artifact's parameter (name and
            # shape); its own modules keep their seeded weights
            small = {k: v[:2] for k, v in tbatch.items()}
            trained = port.SincformerPipeline(device="cpu",
                                              model_dir=ARTIFACT)
            trained.load_model()
            art = trained.model.state_dict()
            warm = {k: (art[k].clone() if k in art
                        and art[k].shape == v.shape else v)
                    for k, v in state.items()}
            row["step_vs_cpu"] = check_step_vs_cpu(
                small, start=(variant, warm), tag=f"[variants] {name}:")
            row["step_vs_cpu"]["from_artifact"] = sum(
                v.numel() for k, v in state.items()
                if k in art and art[k].shape == v.shape)
            del trained, art, warm
        launches.reset()
        result[name] = row

    # the train verb with --pa reference --cpea ssm, then enhance
    with tempfile.TemporaryDirectory() as d:
        argv = ["train", "--pipeline", "agents", "--pa", "reference",
                "--cpea", "ssm", "--synthetic", "40", "--epochs", "2",
                "--seed", str(seed)]
        child, lines, wall = run_verb(argv, {"SINCFORMER_MODEL_DIR": d},
                                      "train --pa reference --cpea ssm")
        blocks = port.MetacogConfig().msa_blocks
        want_k1 = blocks * (2 * 2 * (36 // 8) + 2)
        for line in lines[-4:]:
            say(f"[variants] | {line}")
        say(f"[variants] {' '.join(argv)}: exit 0 in {wall:.1f} s wall; K1 "
            f"launches {child['speech_attention']} (expected {want_k1})")
        if child["speech_attention"] != want_k1:
            raise AssertionError("the variant's train verb did not launch K1 "
                                 "as expected")
        launches.total["speech_attention"] += child["speech_attention"]
        from scipy.io import wavfile
        wav_in, wav_out = os.path.join(d, "in.wav"), os.path.join(d, "out.wav")
        wavfile.write(wav_in, 8000, to_pcm(request))
        os.environ["SINCFORMER_MODEL_DIR"] = d
        launches.reset()
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            rc = cli.main(["enhance", wav_in, wav_out])
        k1 = launches.read()["speech_attention"]
        if rc != 0 or k1 < blocks or k1 % blocks:
            raise AssertionError(f"enhance from the variant's checkpoint: "
                                 f"exit {rc}, K1 {k1}")
        launches.expect("[variants] enhance verb", speech_attention=k1)
        out = wavfile.read(wav_out)[1]
        served = port.SincformerPipeline(device="cuda", model_dir=d)
        served.load_model()
        c = served.model.config
        say(f"[variants] enhance from its checkpoint ({c.pa_impl}, "
            f"{c.cpea_impl}): exit 0, {len(out)} samples, K1 {k1}; "
            + buf.getvalue().strip().splitlines()[0].strip())
        if ((c.pa_impl, c.cpea_impl) != ("reference", "ssm")
                or len(out) != len(request) or not np.all(np.isfinite(out))):
            raise AssertionError("the variant's checkpoint did not serve")
        result["train_verb"] = {"wall_s": wall,
                                "k1_launches": child["speech_attention"],
                                "enhance_k1": k1}
    launches.reset()
    return result


def dp_case(kind: str, mesh, batch: dict, seed: int) -> dict:
    """One dropout-0 training step on the card of the full flagship (from
    the committed artifact, softmax routing) or of DCSE at ``DCSEConfig()``
    sizes ("batch" norm, the fused feed-forward, seeded weights), on this
    rank's block of ``batch`` (all of it without a mesh). First the whole
    loss, its gradients and their global-norm clip factor (the buffers
    restored after), then the step on the loss without the MR-STFT term
    (its float32 gradient is rounding-dominated on either device:
    ROADMAP.md Queue 3), profiled, with the all-reduces counted and timed
    (the device synchronised around each). Returns host copies: the
    losses, the whole loss's gradients and clip factor, the gradients the
    optimizer was given, the parameters and buffers after, and the step's
    measurements. On a mesh with a model axis (tensor parallelism) the
    gradients and parameters are gathered whole, the all-gathers are
    counted and timed too, and the parameter bytes this rank holds are
    returned."""
    from unittest import mock

    import torch.distributed as dist

    import sincformer_tpu_torch as port
    from sincformer_tpu_torch.ops.fused_ffn import fused_ffn
    from sincformer_tpu_torch.ops.speech_attention import speech_attention
    from sincformer_tpu_torch.parallel import collectives, shard_batch
    from sincformer_tpu_torch.parallel.sharding import gathered
    from sincformer_tpu_torch.train import agent_trainer, dcse_trainer
    if kind == "flagship":
        cfg = port.MetacogConfig(dropout=0.0, routing="softmax")
        p = agent_trainer.SincformerTrainer(
            port.SincformerMetacog(cfg), device="cuda", model_dir=ARTIFACT,
            mesh=mesh)
        p.load_model()
        p.init_state(epochs=1, steps_per_epoch=1)
        module = agent_trainer
        terms = (1.0, 1.0, None, 1.0)    # every term on, Gumbel unused

        def whole(n, c):
            return p.loss_and_grads(n, c, *terms)

        def step(n, c):
            return p.train_step(n, c, *terms)[0]
    else:
        cfg = port.DCSEConfig(dropout=0.0, conv_norm="batch", fused_ffn=True)
        p = dcse_trainer.DCSETrainer(port.SpeechEnhancer(cfg), device="cuda",
                                     seed=seed, mesh=mesh)
        p.init_state(epochs=1, steps_per_epoch=1)
        module = dcse_trainer

        def whole(n, c):
            return p.loss_and_grads(n, c)

        def step(n, c):
            return p.train_step(n, c)[0]
    def whole_of(named: dict) -> dict:
        return {k: t.detach().cpu() for k, t in gathered(
            named, p.model, mesh).items()}
    param_bytes = sum(t.numel() * t.element_size()
                      for t in p.model.parameters())
    part = shard_batch(mesh, batch)
    noisy, clean = (torch.from_numpy(part[k]).cuda()
                    for k in ("noisy", "clean"))
    saved = {k: b.clone() for k, b in p.model.named_buffers()}
    speech_attention.launches = fused_ffn.launches = 0
    loss_whole, _, grads_whole = whole(noisy, clean)
    grads_whole = whole_of({k: g for k, g in zip(p.params(), grads_whole)
                            if g is not None})
    norm = float(torch.sqrt(sum((g.double() ** 2).sum()
                                for g in grads_whole.values())))
    clip_whole = min(1.0, p.tx.grad_clip / norm)
    before = (speech_attention.launches, fused_ffn.launches)
    for k, b in p.model.named_buffers():
        b.copy_(saved[k])
    seen = {}
    counted = {name: {"n": 0, "s": 0.0} for name in ("all_reduce",
                                                     "all_gather")}
    update = p.tx.update

    def record(params, grads, state, **norm):
        seen["grads"] = {k: g.detach() for k, g in zip(params, grads)}
        return update(params, grads, state, **norm)

    def timed(name):
        call = getattr(dist, name)

        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = call(*args, **kwargs)
            torch.cuda.synchronize()
            counted[name]["n"] += 1
            counted[name]["s"] += time.perf_counter() - t0
            return out
        return run
    p.tx.update = record
    before_step = whole_of(dict(p.model.named_parameters()))
    speech_attention.launches = fused_ffn.launches = 0
    staged = collectives.COUNTS["host_staged"]
    loss = []
    with mock.patch.object(module, "multi_resolution_stft_loss",
                           lambda pred, target: pred.sum() * 0.0), \
            mock.patch.object(dist, "all_reduce", timed("all_reduce")), \
            mock.patch.object(dist, "all_gather", timed("all_gather")):
        prof = profile_once(lambda: loss.append(float(step(noisy, clean))))
    staged = collectives.COUNTS["host_staged"] - staged
    seen["grads"] = whole_of(seen["grads"])
    host = lambda named: {k: t.detach().cpu() for k, t in named}  # noqa
    out = {"loss_whole": float(loss_whole), "loss": loss[0],
           "grads_whole": grads_whole, "norm_whole": norm,
           "clip_whole": clip_whole, "buffers_before": host(saved.items()),
           "grads": seen["grads"], "before": before_step,
           "params": whole_of(dict(p.model.named_parameters())),
           "buffers": host(p.model.named_buffers()),
           "param_bytes": param_bytes,
           "wall_ms": prof["wall_ms"], "busy_ms": prof["busy_ms"],
           "copy_ms": prof["copy_ms"],
           "launches": prof["launches"], "k1": speech_attention.launches,
           "k3": fused_ffn.launches,
           "k1_total": before[0] + speech_attention.launches,
           "k3_total": before[1] + fused_ffn.launches,
           "all_reduces": counted["all_reduce"]["n"],
           "all_reduce_ms": counted["all_reduce"]["s"] * 1e3,
           "all_gathers": counted["all_gather"]["n"],
           "all_gather_ms": counted["all_gather"]["s"] * 1e3,
           "host_staged": staged}
    speech_attention.launches = fused_ffn.launches = 0
    del p
    torch.cuda.empty_cache()
    return out


def stft_loss_rows(mesh, seed: int) -> tuple:
    """The MR-STFT loss of seeded (8, 32000) waveforms on the card, inside
    ``data_parallel(mesh)`` as the trainers compute it, and its gradient
    with respect to this rank's rows of the prediction (every row without
    a mesh), on the host. The halves differ (the second's target 4 times
    louder, its error 4 times smaller), so the spectral convergence of a
    half is not the batch's: its two norms must be global, and their
    all-reduced backward must carry the other rank's share. On noise no
    magnitude bin sits near zero, so the log-magnitude term's gradient is
    well conditioned here, unlike in a training step's whole loss."""
    from sincformer_tpu_torch.parallel import collectives, shard_batch
    from sincformer_tpu_torch.train import losses
    rng = np.random.default_rng(seed + 7)
    rows = TRAIN_BATCH[0]
    loud = np.where(np.arange(rows) < rows // 2, 1.0, 4.0)[:, None]
    target = 0.1 * rng.standard_normal(TRAIN_BATCH) * loud
    pred = target + 0.05 * rng.standard_normal(TRAIN_BATCH) / loud
    part = shard_batch(mesh, {"pred": pred.astype(np.float32),
                              "target": target.astype(np.float32)})
    p = torch.from_numpy(part["pred"]).cuda().requires_grad_(True)
    t = torch.from_numpy(part["target"]).cuda()
    with collectives.data_parallel(mesh):
        loss = losses.multi_resolution_stft_loss(p, t)
    (grad,) = torch.autograd.grad(loss, p)
    return float(loss.detach()), grad.cpu()


def dp_child(rank: int, world: int, port_: int, batch_path: str,
             out_path: str, seed: int) -> None:
    """One rank of ``[distributed]`` (b): join a gloo group on the one
    card, take this rank's block of the batch, run :func:`dp_case` for
    the flagship and DCSE and :func:`stft_loss_rows`, also with the
    spectral convergence's norms planted local, and save the results."""
    from types import SimpleNamespace
    from unittest import mock

    import torch.distributed as dist

    from sincformer_tpu_torch.parallel import init_distributed, make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not init_distributed(f"tcp://127.0.0.1:{port_}", world, rank,
                            backend="gloo", device="cuda"):
        raise AssertionError("no process group")
    mesh = make_mesh()
    batch = dict(np.load(batch_path))
    out = {kind: dp_case(kind, mesh, batch, seed)
           for kind in ("flagship", "dcse")}
    out["stft"] = stft_loss_rows(mesh, seed)
    from sincformer_tpu_torch.train import losses
    local = SimpleNamespace(norm=torch.linalg.vector_norm)
    with mock.patch.object(losses, "collectives", local):
        out["stft_fault"] = stft_loss_rows(mesh, seed)
    torch.save(out, out_path)
    dist.destroy_process_group()


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(argvs: list, what: str, env_of=lambda rank: {},
              timeout: int = 600) -> list:
    """``python -c code args`` for each rank's ``[code, *args]`` in
    ``argvs``, all started together, each with the environment
    ``env_of(rank)`` adds; waits for all (killing every one still running
    when one fails or outlives ``timeout``) and returns each one's standard
    output. A rank that exits non-zero fails the run."""
    procs = [subprocess.Popen([sys.executable, "-c", *argv], cwd=REPO,
                              env={**os.environ, "PYTHONPATH": REPO,
                                   **env_of(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r, argv in enumerate(argvs)]
    outs = []
    try:
        for r, proc in enumerate(procs):
            out, err = proc.communicate(timeout=timeout)
            if proc.returncode != 0:
                say(out[-2000:])
                say(err[-3000:])
                raise AssertionError(f"{what}: rank {r} exited "
                                     f"{proc.returncode}")
            outs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


def dcse_norm_float64(case: dict, batch: dict, seed: int) -> float:
    """The global norm of the DCSE whole loss's gradients on the whole
    batch in float64 on the CPU, from the state :func:`dp_case` started
    from (``case`` without a mesh): the measure of the batch's float32
    conditioning that ``tests/test_torch_dcse_train.py`` takes."""
    import sincformer_tpu_torch as port
    from sincformer_tpu_torch.train import dcse_trainer
    cfg = port.DCSEConfig(dropout=0.0, conv_norm="batch", fused_ffn=True)
    p = dcse_trainer.DCSETrainer(port.SpeechEnhancer(cfg), device="cpu",
                                 seed=seed)
    p.model.load_state_dict({**case["before"], **case["buffers_before"]})
    p.model.to(torch.float64)
    noisy, clean = (torch.from_numpy(batch[k]).double()
                    for k in ("noisy", "clean"))
    grads = p.loss_and_grads(noisy, clean)[2]
    return float(torch.sqrt(sum((g ** 2).sum() for g in grads
                                if g is not None)))


def dp_faults(got: dict, ref: dict, what: str,
              norm64=None, tag: str = "[distributed]") -> list:
    """A data-parallel step against the one-process step on the card with
    the whole batch, at the card-vs-CPU training bars: the losses
    TRAIN_LOSS_TOL relative; for DCSE, as ``[train-dcse]`` holds them, the
    whole loss's gradients (each leaf TRAIN_GRAD_TOL of its largest
    magnitude); its clip factor is printed beside the gradient norms and
    ``norm64``, the one-process norm in float64: the MR-STFT term's
    float32 gradient norm is rounding-dominated (ROADMAP.md Queue 3), so
    :func:`stft_loss_rows` holds that term's global reductions on
    well-conditioned inputs instead; the flagship's whole-loss figures
    are printed, ``[train]`` holds no bar on them; the
    gradients and the AdamW step as :func:`step_faults` holds a step
    against another (each leaf TRAIN_GRAD_TOL of its largest magnitude,
    the parameters TRAIN_PARAM_TOL of their scale where the clipped
    gradients agree in sign and pass 1e-5); the buffers (the MAA
    statistics, the episodic bank and its counts, the BatchNorm
    statistics) DCSE_STATS_TOL of their scale (at least 1). Returns the
    faults and prints the largest error of each kind."""
    faults, worst = [], {}
    for key in ("loss_whole", "loss"):
        worst[key] = abs(got[key] - ref[key]) / abs(ref[key])
        if worst[key] > TRAIN_LOSS_TOL:
            faults.append(f"{key} {got[key]} vs {ref[key]}")
    rows = grads_vs(got["grads_whole"], ref["grads_whole"],
                    ref["grads_whole"])
    worst["grads_whole"] = rows[0][0]
    worst["clip"] = abs(got["clip_whole"] - ref["clip_whole"]) / ref[
        "clip_whole"]
    if norm64 is not None:
        off64 = [abs(r["norm_whole"] - norm64) / norm64 for r in (ref, got)]
        if worst["grads_whole"] > TRAIN_GRAD_TOL:
            faults.append(f"whole loss's gradient of {rows[0][1]} "
                          f"{rows[0][0]:.3e} of its scale")
    step, figures = step_faults(ref["grads"], got["grads"], ref["before"],
                                ref["params"], got["params"],
                                grad_tol=TRAIN_GRAD_TOL)
    faults += step
    worst["grads"], worst["params"] = figures["grad"], figures["param"]
    worst["buffers"] = {}
    for k, b in ref["buffers"].items():
        b64, g64 = b.double(), got["buffers"][k].double()
        err = float((g64 - b64).abs().max()) / max(1.0, float(
            b64.abs().max()))
        worst["buffers"][k] = err
        if err > DCSE_STATS_TOL:
            faults.append(f"buffer {k}: {err:.3e}")
    top = sorted(worst["buffers"].items(), key=lambda kv: -kv[1])[:4]
    say(f"{tag} {what} vs one process with the whole batch: loss "
        f"{worst['loss_whole']:.3e}, without the MR-STFT term "
        f"{worst['loss']:.3e} (limit {TRAIN_LOSS_TOL:g}); the whole loss's "
        f"gradients {worst['grads_whole']:.3e} ({rows[0][1]}) and clip "
        f"factor {got['clip_whole']:.7g} vs {ref['clip_whole']:.7g}, "
        f"{worst['clip']:.3e} relative"
        + (f" (gradients: limit {TRAIN_GRAD_TOL:g}; the clip factor "
           f"unbarred: the gradient norms {ref['norm_whole']:.7g} one "
           f"process, {got['norm_whole']:.7g} two ranks, {norm64:.7g} in "
           f"float64, {off64[0]:.3e} and {off64[1]:.3e} from it)"
           if norm64 is not None else " (no bar in [train])")
        + f"; gradients without the term "
        f"{worst['grads']:.3e} (limit {TRAIN_GRAD_TOL:g}); parameters "
        f"after AdamW {worst['params']:.3e} (limit {TRAIN_PARAM_TOL:g}; "
        f"{figures['param_elements_other']} of {figures['elements']} "
        f"elements held to twice the step, "
        f"{figures['grad_elements_flipped']} flipped signs); "
        f"buffers, largest {', '.join(f'{k} {e:.3e}' for k, e in top)} "
        f"(limit {DCSE_STATS_TOL:g})")
    return faults


def bit_equal(a: dict, b: dict) -> list:
    """The entries of two :func:`dp_case` results that differ in any
    bit."""
    diff = [k for k in ("loss_whole", "clip_whole", "loss") if a[k] != b[k]]
    for key in ("grads_whole", "grads", "params", "buffers"):
        diff += [f"{key} {k}" for k in b[key]
                 if not torch.equal(a[key][k], b[key][k])]
    return diff


def check_distributed(seed: int, smi: str, launches, eval_grid: dict
                      ) -> dict:
    """Data parallelism on the one card: (a) the flagship and DCSE steps
    on a one-rank NCCL mesh bit-equal to the steps without a mesh; (b) two
    ranks over gloo in processes of their own, half the batch each, against
    the one-process step with the whole batch, their parameters and
    buffers bit-equal; (c) ``evaluate --distributed`` in two processes
    against ``[evaluate]``'s grid; (d) the metric sweep split over three
    and over two devices (the cyclic pad) against the unsharded one."""
    import torch.distributed as dist

    import sincformer_tpu_torch as port
    from sincformer_tpu_torch.data.loader import load_noise_signals
    from sincformer_tpu_torch.evaluation.grid import (eval_utterances,
                                                      evaluate_grid)
    from sincformer_tpu_torch.parallel import make_mesh
    t_phase = time.perf_counter()
    result = {}
    batch = dcse_batch(seed)
    blocks = port.MetacogConfig().msa_blocks
    dcse_blocks = port.DCSEConfig().num_blocks

    # (a) one rank over NCCL against no mesh, with cuDNN's deterministic
    # algorithms (its default weight gradients add by atomics, so two runs
    # of one step differ in the last bits without a mesh too)
    import warnings
    launches.reset()
    faults = []
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ref = {kind: dp_case(kind, None, batch, seed)
                   for kind in ("flagship", "dcse")}
            dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                                    f"{free_port()}", world_size=1, rank=0)
            try:
                one = {kind: dp_case(kind, make_mesh(), batch, seed)
                       for kind in ("flagship", "dcse")}
            finally:
                dist.destroy_process_group()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    loose = sorted({str(w.message).split(".")[0][:120] for w in caught
                    if "deterministic" in str(w.message)})
    say(f"[distributed] (a) operations without a deterministic "
        f"implementation on this path: {loose or 'none'}")
    for kind in ("flagship", "dcse"):
        diff = bit_equal(one[kind], ref[kind])
        n = 3 + sum(len(ref[kind][k]) for k in ("grads_whole", "grads",
                                                "params", "buffers"))
        say(f"[distributed] (a) {kind} step {TRAIN_BATCH}, one-rank NCCL "
            f"mesh vs no mesh: {len(diff)} of {n} entries differ in any bit "
            f"{diff[:4]}")
        faults += [f"one rank vs no mesh, {kind}: {d}" for d in diff[:5]]
    # K1 and K3 in the step (its forward; the backward is the plain
    # recompute): the flagship's MSA runs twice a forward
    for kind, k1, k3 in (("flagship", 2 * blocks, 0),
                         ("dcse", dcse_blocks, 2 * dcse_blocks)):
        for r in (ref[kind], one[kind]):
            if (r["k1"], r["k3"]) != (k1, k3):
                faults.append(f"{kind}: K1, K3 launches {r['k1']}, "
                              f"{r['k3']} in a step, expected {k1}, {k3}")
    for r in (*ref.values(), *one.values()):
        launches.total["speech_attention"] += r["k1_total"]
        launches.total["fused_ffn"] += r["k3_total"]
    for kind in ("flagship", "dcse"):
        r = ref[kind]
        say(f"[distributed] one process, {kind} step {TRAIN_BATCH} (cuDNN "
            f"deterministic): "
            f"{r['wall_ms']:.2f} ms wall (profiled), device busy "
            f"{r['busy_ms']:.3f} ms, {r['launches']} launches, K1 {r['k1']},"
            f" K3 {r['k3']} on {smi}")

    # (b) two ranks over gloo on the one card, half the batch each
    with tempfile.TemporaryDirectory() as tmp:
        batch_path = os.path.join(tmp, "batch.npz")
        np.savez(batch_path, noisy=batch["noisy"], clean=batch["clean"])
        port_ = free_port()
        t0 = time.perf_counter()
        run_ranks(
            [["import sys, chip_smoke\n"
              "chip_smoke.dp_child(int(sys.argv[1]), int(sys.argv[2]), "
              "int(sys.argv[3]), sys.argv[4], sys.argv[5], "
              "int(sys.argv[6]))\n", str(r), "2", str(port_), batch_path,
              os.path.join(tmp, f"rank{r}.pt"), str(seed)] for r in range(2)],
            "[distributed] (b)")
        ranks_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(2)]
    norm64 = dcse_norm_float64(ref["dcse"], batch, seed)
    ONE_PROCESS_STEPS["dcse_norm64"] = norm64
    for kind in ("flagship", "dcse"):
        diff = bit_equal(ranks[0][kind], ranks[1][kind])
        say(f"[distributed] (b) {kind}: the two ranks' losses, gradients, "
            f"parameters and buffers differ in {len(diff)} entries")
        faults += [f"{kind} ranks differ: {d}" for d in diff[:5]]
        faults += [f"{kind}: {f}" for f in dp_faults(
            ranks[0][kind], ref[kind], kind,
            norm64 if kind == "dcse" else None)]
        maa = {k: (float(ranks[0][kind]["buffers"][k]),
                   float(ref[kind]["buffers"][k]))
               for k in ("maa.running_mean", "maa.running_var")
               if k in ref[kind]["buffers"]}
        if maa:
            bank = max(float((ranks[0][kind]["buffers"][k]
                              - ref[kind]["buffers"][k]).abs().max())
                       for k in ref[kind]["buffers"] if "bank_" in k)
            say(f"[distributed] (b) flagship: MAA statistics (two ranks, one "
                f"process) {maa}; episodic bank largest |delta| {bank:.3e}")
        for r, out in enumerate(ranks):
            o = out[kind]
            say(f"[distributed] (b) rank {r} {kind} step on "
                f"{TRAIN_BATCH[0] // 2} x 4 s: {o['wall_ms']:.2f} ms wall "
                f"(profiled, the device synchronised around each "
                f"all-reduce), device busy {o['busy_ms']:.3f} ms, "
                f"{o['launches']} launches, K1 {o['k1']}, K3 {o['k3']}, "
                f"{o['all_reduces']} all-reduces taking "
                f"{o['all_reduce_ms']:.2f} ms")
            want = ((2 * blocks, 0) if kind == "flagship"
                    else (dcse_blocks, 2 * dcse_blocks))
            if (o["k1"], o["k3"]) != want:
                faults.append(f"{kind} rank {r}: K1, K3 launches "
                              f"{o['k1']}, {o['k3']}, expected {want}")
            launches.total["speech_attention"] += o["k1_total"]
            launches.total["fused_ffn"] += o["k3_total"]
    result["two_ranks"] = {
        kind: [{k: ranks[r][kind][k] for k in (
            "wall_ms", "busy_ms", "launches", "k1", "k3", "all_reduces",
            "all_reduce_ms")} for r in range(2)]
        for kind in ("flagship", "dcse")}
    result["one_process"] = {kind: {k: ref[kind][k] for k in (
        "wall_ms", "busy_ms", "launches", "k1", "k3")}
        for kind in ("flagship", "dcse")}
    # the MR-STFT loss alone, well conditioned: its spectral convergence's
    # global norms and their all-reduced backward (stft_loss_rows); the
    # ranks' losses average to the batch's, and each rank's gradient over
    # the world size is the batch's at its rows
    one_loss, one_grad = stft_loss_rows(None, seed)
    stft = {}
    for key in ("stft", "stft_fault"):
        loss = sum(r[key][0] for r in ranks) / len(ranks)
        grad = torch.cat([r[key][1] for r in ranks]) / len(ranks)
        stft[key] = (abs(loss - one_loss) / abs(one_loss),
                     float((grad - one_grad).abs().max())
                     / float(one_grad.abs().max()))
    say(f"[distributed] (b) the MR-STFT loss of {TRAIN_BATCH} seeded noise "
        f"(halves 4x apart in level), two ranks vs one process on the "
        f"card: loss {stft['stft'][0]:.3e} relative (limit "
        f"{TRAIN_LOSS_TOL:g}), gradient {stft['stft'][1]:.3e} of its scale "
        f"(limit {TRAIN_GRAD_TOL:g}); with the spectral convergence's norms "
        f"planted local: {stft['stft_fault'][0]:.3e} and "
        f"{stft['stft_fault'][1]:.3e} (must fail)")
    if stft["stft"][0] > TRAIN_LOSS_TOL or stft["stft"][1] > TRAIN_GRAD_TOL:
        faults.append("the MR-STFT loss over two ranks left one process's")
    if (stft["stft_fault"][0] <= TRAIN_LOSS_TOL
            and stft["stft_fault"][1] <= TRAIN_GRAD_TOL):
        faults.append("the planted local spectral convergence passed")
    result["stft_loss"] = stft
    result["two_ranks_s"] = ranks_s
    say(f"[distributed] (b) two processes over gloo: {ranks_s:.1f} s wall "
        f"(process start, the model, two steps each)")
    torch.cuda.empty_cache()

    # (c) evaluate --distributed in two processes on the card
    runner = ("import json, sys\n"
              "from sincformer_tpu_torch import cli\n"
              "from sincformer_tpu_torch.ops.speech_attention import "
              "speech_attention\n"
              "rc = cli.main(sys.argv[1:])\n"
              "print(json.dumps({'speech_attention': "
              "speech_attention.launches}))\n"
              "sys.exit(rc)\n")
    with tempfile.TemporaryDirectory() as model_dir:
        eval_models(seed, model_dir)
        port_ = free_port()
        t0 = time.perf_counter()
        outs = run_ranks(
            [[runner, "evaluate", "--distributed", "--json-out",
              os.path.join(model_dir, f"grid_{r}.json")] for r in range(2)],
            "[distributed] (c) evaluate --distributed",
            env_of=lambda r: {"RANK": str(r), "WORLD_SIZE": "2",
                              "LOCAL_RANK": "0",
                              "MASTER_ADDR": "127.0.0.1",
                              "MASTER_PORT": str(port_),
                              "SINCFORMER_MODEL_DIR": model_dir})
        verb_s = time.perf_counter() - t0
        wrote = [os.path.exists(os.path.join(model_dir, f"grid_{r}.json"))
                 for r in range(2)]
        with open(os.path.join(model_dir, "grid_0.json")) as f:
            got = json.load(f)["results"]
    k1 = [json.loads(o.strip().splitlines()[-1])["speech_attention"]
          for o in outs]
    tables = ["GRAND SUMMARY" in o for o in outs]
    worst, cells = 0.0, 0
    for noise, methods in eval_grid.items():
        for method, by_snr in methods.items():
            for snr, metric_vals in by_snr.items():
                for k, vals in metric_vals.items():
                    other = got[noise][method][snr][k]
                    if len(other) != len(vals):
                        raise AssertionError(f"cell {method} {snr} {k} has "
                                             f"{len(other)} values")
                    worst = max(worst, max(abs(a - b) for a, b in
                                           zip(other, vals)))
                    cells += 1
    say(f"[distributed] (c) evaluate --distributed, 2 processes on the card "
        f"over gloo: exit 0 in {verb_s:.1f} s wall; K1 launches per rank "
        f"{k1}; tables printed by {sum(tables)} of 2; --json-out written by "
        f"rank(s) {[r for r in range(2) if wrote[r]]}; {cells} cell x "
        f"metric lists vs [evaluate]'s one-process grid: largest |delta| "
        f"{worst:.3e} (limit {DIST_GRID_TOL:g})")
    if (worst > DIST_GRID_TOL or wrote != [True, False] or not all(tables)
            or sum(k1) != len(eval_grid["white"]["noisy"]) * blocks):
        faults.append("evaluate --distributed left the one-process grid")
    launches.total["speech_attention"] += sum(k1)
    result["evaluate"] = {"verb_s": verb_s, "k1_per_rank": k1,
                          "max_abs_delta": worst}

    # (d) the metric sweep split over devices, a 3-utterance bucket
    cleans = eval_utterances(3)
    noises = load_noise_signals(8000)
    pipe = port.SincformerPipeline(device="cuda", model_dir=ARTIFACT)
    pipe.load_model()
    pipes = {"sincformer": pipe}
    launches.reset()
    # the device metrics: P.862 runs on host threads row by row whatever
    # the split
    metrics = ("stoi", "ssnr", "csii", "ncm")
    want = evaluate_grid(cleans, noises, pipes, [0.0], metrics,
                         verbose=False)
    sweep = {}
    for n_dev in (3, 2):
        got = evaluate_grid(cleans, noises, pipes, [0.0], metrics,
                            verbose=False,
                            mesh=[torch.device("cuda", 0)] * n_dev)
        sweep[n_dev] = max(
            abs(a - b) / max(1.0, abs(b)) for m, cell in want["white"].items()
            for k, vals in cell[0.0].items()
            for a, b in zip(got["white"][m][0.0][k], vals))
        if any(len(v) != 3 for cell in got["white"].values()
               for v in cell[0.0].values()):
            raise AssertionError("a padded row reached the results")
    launches.expect("[distributed] (d) three grids of one cell",
                    speech_attention=3 * blocks)
    say(f"[distributed] (d) evaluate_grid, 3 utterances at 0 dB, the device "
        f"metrics' sweep "
        f"split over [cuda:0] x 3 and x 2 (one padded row) vs unsharded: "
        f"largest |delta| / max(1, |value|) {sweep[3]:.3e} and "
        f"{sweep[2]:.3e} (limit {DIST_GRID_TOL:g})")
    if max(sweep.values()) > DIST_GRID_TOL:
        faults.append("the split sweep left the unsharded one")
    result["sweep_split_max_abs_delta"] = sweep
    del pipe, pipes
    torch.cuda.empty_cache()
    result["phase_s"] = time.perf_counter() - t_phase
    say(f"[distributed] phase wall {result['phase_s']:.1f} s on {smi}")
    if faults:
        raise AssertionError("[distributed]: " + "; ".join(faults[:10]))
    ONE_PROCESS_STEPS.update(ref)
    return result


# the one-process steps of [distributed] (a), cuDNN deterministic, which
# [parallel] (a) and (d) hold their steps against
ONE_PROCESS_STEPS: dict = {}
CP_FRAMES = 12000           # [parallel] (b): 120 s of 8 kHz audio at hop 80
CP_BLOCK = dict(d_model=256, num_heads=4, d_ff=1024, kernel_size=31)
CP_LOSS_TOL = 1e-5          # the ring block against one process: the loss,
CP_X_GRAD_TOL = 3e-5        # relative; the input gradient and each
CP_P_GRAD_TOL = 5e-4        # parameter's, of their scale (JAX's bars)
CP_CONV_TOL = 1e-5          # the halo conv against F.conv1d, of the scale


def cp_block(seed: int):
    """The DCSE-width ConformerBlock of ``[parallel]`` (b) with seeded
    weights (norm scales off 1, biases off 0), its input and the loss's
    cotangent, on the card; ``attn_impl`` "speech" (K1)."""
    from sincformer_tpu_torch.models.conformer import ConformerBlock
    g = torch.Generator().manual_seed(seed + 11)
    blk = ConformerBlock(**CP_BLOCK, attn_impl="speech")
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if p.ndim >= 2:
                p.copy_(torch.randn(p.shape, generator=g)
                        / float(p[0].numel()) ** 0.5)
            elif name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
            else:
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=g))
    x = torch.randn((1, CP_FRAMES, CP_BLOCK["d_model"]), generator=g)
    cot = torch.randn(x.shape, generator=g)
    return blk.cuda(), x.cuda(), cot.cuda()


def cp_step(blk, x, cot, rows=slice(None)) -> dict:
    """sum(block(x[:, rows]) · cot[:, rows]) and its gradients with respect
    to the whole input and every parameter (a rank's shares of the
    sums), timed (ms of the forward and backward) with the peak memory of
    this process."""
    x = x.detach().requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    loss = torch.sum(blk(x[:, rows]) * cot[:, rows])
    gx, *gp = torch.autograd.grad(loss, [x, *blk.parameters()])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return {"loss": float(loss.detach()), "x_grad": gx.cpu(),
            "grads": {k: g.cpu() for (k, _), g in
                      zip(blk.named_parameters(), gp)},
            "ms": ms, "peak_gb": (torch.cuda.max_memory_allocated() - base)
            / 1e9}


def cp_case(mesh, seed: int) -> dict:
    """``[parallel]`` (b) on this rank: the ring block on its half of the
    frames (``attn_impl="ring"`` and the halo conv under ``ring_mesh``),
    twice (the second timed), then with a hop whose backward keeps the
    gradient on the rank it reached (planted); the halo conv alone."""
    from unittest import mock

    from sincformer_tpu_torch.ops.attention import ring_mesh
    from sincformer_tpu_torch.ops.cp_conv import cp_depthwise_conv
    from sincformer_tpu_torch.parallel import collectives
    blk, x, cot = cp_block(seed)
    blk.MultiHeadSelfAttention_0.attn_impl = "ring"
    n, r = mesh.size(0), mesh.get_local_rank("data")
    tl = CP_FRAMES // n
    rows = slice(r * tl, (r + 1) * tl)
    with ring_mesh(mesh, "data"):
        cp_step(blk, x, cot, rows)
        hops = collectives.COUNTS["hop"]
        out = {"ring": cp_step(blk, x, cot, rows)}
        out["hops"] = collectives.COUNTS["hop"] - hops
        with mock.patch.object(collectives._Hop, "backward",
                               staticmethod(lambda ctx, g: (g, None, None))):
            out["kept_hop"] = cp_step(blk, x, cot, rows)["x_grad"]
    w = blk.ConvolutionModule_0.depthwise
    out["conv"] = cp_depthwise_conv(x, w.weight, w.bias, mesh).detach().cpu()
    return out


def tp_cp_child(rank: int, world: int, port_: int, batch_path: str,
                out_path: str, seed: int) -> None:
    """One rank of ``[parallel]`` (a) and (b): join a gloo group on the one
    card; (a) the DCSE and flagship steps of :func:`dp_case` on a (1, 2)
    ("data", "model") mesh, each rank with the whole batch and half of
    every split parameter; (b) :func:`cp_case` on the two-rank sequence
    axis. Saves the results."""
    import torch.distributed as dist

    from sincformer_tpu_torch.parallel import (collectives, init_distributed,
                                               make_mesh)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not init_distributed(f"tcp://127.0.0.1:{port_}", world, rank,
                            backend="gloo", device="cuda"):
        raise AssertionError("no process group")
    batch = dict(np.load(batch_path))
    mesh = make_mesh(axis_names=("data", "model"), shape=(1, world))
    out = {}
    for kind in ("dcse", "flagship"):
        collectives.COUNTS.clear()
        out[kind] = dp_case(kind, mesh, batch, seed)
        out[kind]["counts"] = dict(collectives.COUNTS)
    collectives.COUNTS.clear()
    out["cp"] = cp_case(make_mesh(axis_names=("data",)), seed)
    out["cp"]["counts"] = dict(collectives.COUNTS)
    torch.save(out, out_path)
    dist.destroy_process_group()


def gloo_cuda_probe(rank: int, port_: int) -> None:
    """One of two ranks of a gloo group on the one card, with a 20 s
    timeout: does gloo gather CUDA tensors itself, and does its
    ``send``/``recv`` carry them (the hop, ``parallel/collectives.py``)?
    Prints a JSON line as each is answered; a refusal is an answer, not a
    failure (gloo may abort the process from its transport's thread:
    :func:`probe_gloo_cuda` reads that from the standard error)."""
    import datetime

    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port_}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=20))
    want = torch.arange(4, dtype=torch.float32, device="cuda")
    answers = {}
    try:
        parts = [torch.zeros_like(want) for _ in range(2)]
        dist.all_gather(parts, want + rank)
        ok = all(torch.equal(p, want + r) for r, p in enumerate(parts))
        answers["all_gather"] = "yes" if ok else "no: wrong values"
    except (RuntimeError, ValueError) as e:
        answers["all_gather"] = f"no: {str(e).splitlines()[0][:100]}"
    print(json.dumps(answers), flush=True)
    answers = {}
    try:
        if rank == 0:
            dist.send(want + 5, dst=1)
            got = want + 5
        else:
            got = torch.zeros_like(want)
            dist.recv(got, src=0)
        ok = torch.equal(got, want + 5)
        answers["send_recv"] = "yes" if ok else "no: wrong values"
    except (RuntimeError, ValueError) as e:
        answers["send_recv"] = f"no: {str(e).splitlines()[0][:100]}"
    print(json.dumps(answers), flush=True)
    os._exit(0)       # the group may be broken: no teardown


def probe_gloo_cuda() -> dict:
    """:func:`gloo_cuda_probe` in two processes of their own: each
    question's answers on the two ranks; a rank that died before it
    answered gives its exit code and the last line of its standard
    error."""
    port_ = free_port()
    code = ("import sys, chip_smoke\n"
            "chip_smoke.gloo_cuda_probe(int(sys.argv[1]), int(sys.argv[2]))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(port_)],
                              cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    answers = {"all_gather": set(), "send_recv": set()}
    try:
        for r, proc in enumerate(procs):
            try:
                out, err = proc.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, err = proc.communicate()
            got = {}
            for line in out.splitlines():
                if line.startswith("{"):
                    got.update(json.loads(line))
            why = next((line.strip() for line in reversed(err.splitlines())
                        if line.strip()), "")
            for k, seen in answers.items():
                seen.add(got.get(k, f"no: rank {r} exited {proc.returncode}"
                                    f": {why[:120]}"))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {k: " / ".join(sorted(v)) for k, v in answers.items()}


def check_parallel(seed: int, smi: str, launches) -> dict:
    """Tensor and context parallelism on the one card: (a) two gloo ranks on
    a (1, 2) model axis, each with the whole batch, against the
    one-process steps of ``[distributed]`` at its bars, each rank's
    parameter bytes against one process's; (b) a DCSE-width ConformerBlock
    on 12,000 frames, two ranks of 6,000 with ring attention and the halo
    conv against the one-process block with K1, and the halo conv against
    ``F.conv1d``, a planted hop that keeps the gradient failing;
    ``impl="flash"`` through K1; (c) the dry run on four processes; (d) a
    one-rank NCCL model axis bit-equal to no mesh. First, what gloo does
    with CUDA tensors here (:func:`gloo_cuda_probe`), printed."""
    import torch.distributed as dist

    import sincformer_tpu_torch as port
    import torch.nn.functional as F
    from sincformer_tpu_torch.models.conformer import same_pad
    from sincformer_tpu_torch.parallel import make_mesh
    from sincformer_tpu_torch.parallel.dryrun import dryrun_multichip
    t_phase = time.perf_counter()
    result, faults = {}, []
    batch = dcse_batch(seed)
    blocks = port.MetacogConfig().msa_blocks
    dcse_blocks = port.DCSEConfig().num_blocks
    if not ONE_PROCESS_STEPS:         # [parallel] run without [distributed]
        torch.backends.cudnn.deterministic = True
        try:
            ONE_PROCESS_STEPS.update({kind: dp_case(kind, None, batch, seed)
                                      for kind in ("flagship", "dcse")})
        finally:
            torch.backends.cudnn.deterministic = False
    ref = ONE_PROCESS_STEPS

    # (b)'s one-process block first, with K1, in this process
    launches.reset()
    blk, x, cot = cp_block(seed)
    cp_step(blk, x, cot)
    one = cp_step(blk, x, cot)
    launches.expect("[parallel] (b) one-process block, two steps",
                    speech_attention=2)
    w = blk.ConvolutionModule_0.depthwise
    with torch.no_grad():
        conv_ref = F.conv1d(same_pad(x.transpose(1, 2), w.kernel_size),
                            w.weight, w.bias, groups=w.weight.shape[0]
                            ).transpose(1, 2).cpu()
    del blk, x, cot
    torch.cuda.empty_cache()

    # what gloo does with CUDA tensors on this card, in two processes of
    # their own (a refused send can break its group)
    gloo = probe_gloo_cuda()
    say(f"[parallel] gloo with CUDA tensors on this card: all_gather "
        f"{gloo['all_gather']}; send/recv {gloo['send_recv']} (the port "
        f"gathers CUDA tensors through gloo itself and stages the hop's "
        f"send/recv through host memory)")
    result["gloo_cuda"] = gloo

    # (a) and (b) in two processes of their own
    with tempfile.TemporaryDirectory() as tmp:
        batch_path = os.path.join(tmp, "batch.npz")
        np.savez(batch_path, noisy=batch["noisy"], clean=batch["clean"])
        port_ = free_port()
        t0 = time.perf_counter()
        run_ranks(
            [["import sys, chip_smoke\n"
              "chip_smoke.tp_cp_child(int(sys.argv[1]), int(sys.argv[2]), "
              "int(sys.argv[3]), sys.argv[4], sys.argv[5], "
              "int(sys.argv[6]))\n", str(r), "2", str(port_), batch_path,
              os.path.join(tmp, f"rank{r}.pt"), str(seed)] for r in range(2)],
            "[parallel] (a), (b)")
        ranks_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(2)]
    result["two_ranks_s"] = ranks_s
    result["tp"] = {}
    for kind in ("dcse", "flagship"):
        diff = bit_equal(ranks[0][kind], ranks[1][kind])
        say(f"[parallel] (a) {kind}: the two model ranks' gathered "
            f"gradients, parameters and buffers differ in {len(diff)} "
            f"entries")
        faults += [f"TP {kind} ranks differ: {d}" for d in diff[:5]]
        if kind == "dcse" and "dcse_norm64" not in ref:
            ref["dcse_norm64"] = dcse_norm_float64(ref["dcse"], batch, seed)
        faults += [f"TP {kind}: {f}" for f in dp_faults(
            ranks[0][kind], ref[kind], f"{kind} on the (1, 2) model axis",
            ref["dcse_norm64"] if kind == "dcse" else None, "[parallel] (a)")]
        want = ((2 * blocks, 0) if kind == "flagship"
                else (dcse_blocks, 2 * dcse_blocks))
        one_bytes = sum(t.numel() * 4 for t in ref[kind]["params"].values())
        for r, out in enumerate(ranks):
            o = out[kind]
            say(f"[parallel] (a) rank {r} {kind} step {TRAIN_BATCH} on the "
                f"(1, 2) mesh: parameters {o['param_bytes'] / 1e6:.3f} MB "
                f"held (one process {one_bytes / 1e6:.3f} MB, "
                f"{o['param_bytes'] / one_bytes:.3f}); {o['wall_ms']:.2f} ms "
                f"wall (profiled, the device synchronised around each "
                f"collective), device busy {o['busy_ms']:.3f} ms (memory "
                f"copies {o['copy_ms']:.3f}), {o['launches']} launches, K1 "
                f"{o['k1']}, K3 {o['k3']}; "
                f"{o['all_gathers']} all-gathers {o['all_gather_ms']:.2f} ms, "
                f"{o['all_reduces']} all-reduces {o['all_reduce_ms']:.2f} ms, "
                f"{o['host_staged']} staged through the host; model-axis "
                f"collectives of the whole run {o['counts']}")
            if (o["k1"], o["k3"]) != want:
                faults.append(f"TP {kind} rank {r}: K1, K3 launches "
                              f"{o['k1']}, {o['k3']}, expected {want}")
            if not o["param_bytes"] < one_bytes:
                faults.append(f"TP {kind} rank {r} holds every parameter")
            launches.total["speech_attention"] += o["k1_total"]
            launches.total["fused_ffn"] += o["k3_total"]
        result["tp"][kind] = [{k: out[kind][k] for k in (
            "wall_ms", "busy_ms", "copy_ms", "launches", "k1", "k3",
            "all_reduces",
            "all_reduce_ms", "all_gathers", "all_gather_ms", "host_staged",
            "param_bytes")} for out in ranks]
        result["tp"][kind + "_one_process"] = {
            "param_bytes": one_bytes, **{k: ref[kind][k] for k in (
                "wall_ms", "busy_ms", "copy_ms", "launches")}}

    # (b) against the one-process block
    got = [r["cp"] for r in ranks]
    loss = sum(g["ring"]["loss"] for g in got)
    x_grad = sum(g["ring"]["x_grad"] for g in got)
    kept = sum(g["kept_hop"] for g in got)
    scale = lambda t: float(t.abs().max())  # noqa: E731
    errs = {"loss": abs(loss - one["loss"]) / abs(one["loss"]),
            "x_grad": scale(x_grad - one["x_grad"]) / scale(one["x_grad"]),
            "grads": max(scale(sum(g["ring"]["grads"][k] for g in got) - w)
                         / scale(w) for k, w in one["grads"].items()),
            "conv": scale(torch.cat([g["conv"] for g in got], dim=1)
                          - conv_ref) / scale(conv_ref),
            "kept_hop_x_grad": scale(kept - one["x_grad"])
            / scale(one["x_grad"])}
    say(f"[parallel] (b) ConformerBlock {CP_BLOCK} on 1 x {CP_FRAMES} frames,"
        f" two ranks of {CP_FRAMES // 2} (ring attention, halo conv) vs one "
        f"process with K1: loss {errs['loss']:.3e} relative (limit "
        f"{CP_LOSS_TOL:g}), input gradient {errs['x_grad']:.3e} of its scale "
        f"(limit {CP_X_GRAD_TOL:g}), parameter gradients {errs['grads']:.3e} "
        f"(limit {CP_P_GRAD_TOL:g}); the halo conv vs F.conv1d "
        f"{errs['conv']:.3e} (limit {CP_CONV_TOL:g}); a hop whose backward "
        f"keeps the gradient: input gradient {errs['kept_hop_x_grad']:.3e} "
        f"(must fail)")
    for r, g in enumerate(got):
        say(f"[parallel] (b) rank {r}: forward and backward "
            f"{g['ring']['ms']:.2f} ms, peak {g['ring']['peak_gb']:.3f} GB "
            f"over its start ({g['hops']} hops); one process "
            f"{one['ms']:.2f} ms, peak {one['peak_gb']:.3f} GB, on {smi}")
    if (errs["loss"] > CP_LOSS_TOL or errs["x_grad"] > CP_X_GRAD_TOL
            or errs["grads"] > CP_P_GRAD_TOL or errs["conv"] > CP_CONV_TOL):
        faults.append(f"the ring block left one process's: {errs}")
    if errs["kept_hop_x_grad"] <= CP_X_GRAD_TOL:
        faults.append("the planted hop that keeps the gradient passed")
    result["cp"] = {"errors": errs, "one_process": {
        k: one[k] for k in ("ms", "peak_gb")}, "ranks": [
        {"ms": g["ring"]["ms"], "peak_gb": g["ring"]["peak_gb"],
         "hops": g["hops"]} for g in got]}

    # impl="flash": what JAX runs off a TPU, K1 here
    from sincformer_tpu_torch.ops.attention import dot_product_attention
    g = torch.Generator().manual_seed(seed + 13)
    q, k, v = (torch.randn((4, 400, 4, 64), generator=g).cuda()
               for _ in range(3))
    launches.reset()
    flash = dot_product_attention(q, k, v, impl="flash")
    launches.expect("[parallel] impl='flash'", speech_attention=1)
    same = torch.equal(flash, dot_product_attention(q, k, v, impl="speech"))
    launches.expect("[parallel] impl='speech'", speech_attention=1)
    say(f"[parallel] impl='flash' at (4, 400, 4, 64): one K1 launch, equal "
        f"to impl='speech' bit for bit: {same}")
    if not same:
        faults.append("impl='flash' left impl='speech'")

    # (c) the dry run on four processes on the card
    t0 = time.perf_counter()
    tail = dryrun_multichip(4, device="cuda")
    result["dryrun"] = {"tail": tail, "s": time.perf_counter() - t0}
    say(f"[parallel] (c) {tail} ({result['dryrun']['s']:.1f} s wall)")

    # (d) a one-rank NCCL model axis against no mesh
    launches.reset()
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                                f"{free_port()}", world_size=1, rank=0)
        try:
            single = dp_case("dcse", make_mesh(
                axis_names=("data", "model"), shape=(1, 1)), batch, seed)
        finally:
            dist.destroy_process_group()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    diff = bit_equal(single, ref["dcse"])
    say(f"[parallel] (d) DCSE step {TRAIN_BATCH} on a one-rank NCCL "
        f"(data, model) mesh vs no mesh: {len(diff)} entries differ in any "
        f"bit {diff[:4]}")
    faults += [f"one-rank model axis vs no mesh: {d}" for d in diff[:5]]
    launches.total["speech_attention"] += single["k1_total"]
    launches.total["fused_ffn"] += single["k3_total"]
    launches.reset()
    torch.cuda.empty_cache()
    result["phase_s"] = time.perf_counter() - t_phase
    say(f"[parallel] phase wall {result['phase_s']:.1f} s on {smi}")
    if faults:
        raise AssertionError("[parallel]: " + "; ".join(faults[:10]))
    return result


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


def check_dnn_wave(what: str, got: np.ndarray, want: np.ndarray,
                   valid_end: int, tail: int = 0, edge: int = 16) -> None:
    """Two outputs of the DNN path, card and CPU.

    Body: within WAVE_TOL of the peak. Edges: at the first and last ``edge``
    samples of the span that the valid frames cover, one frame is divided by
    a symmetric-Hann value under 0.1 (down to 3.9e-4), which amplifies the
    inverse FFT's float32 noise by up to 2,560 on either side; those samples
    are held to 1e-3 of their own magnitude and do not set the peak. Tail:
    where the request is zero-padded (``tail`` > 0), the last 6 frames of
    the span see, through the +-5 frames of context, GFCC features of frames
    astride the padding: a small energy as a difference of two float32
    running sums of ~7,000, cube-rooted. The card's and the CPU's ``cumsum``
    add in another order, so those frames' masks differ more: the tail is
    held to DNN_TAIL_TOL of (its magnitude + the peak)."""
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        raise AssertionError(f"{what}: shapes {got.shape} and {want.shape}, "
                             f"or a value that is not finite")
    diff = np.abs(got - want)
    body = slice(edge, valid_end - max(edge, tail))
    peak = float(np.abs(want[..., body]).max())
    rel = float(diff[..., body].max()) / peak
    ends = np.arange(edge)
    if not tail:
        ends = np.concatenate([ends, np.arange(valid_end - edge, valid_end)])
    edge_ok = bool(np.all(diff[..., ends] <= 1e-3 * np.abs(want[..., ends])
                          + WAVE_TOL * peak))
    last = slice(valid_end - tail, valid_end)
    tail_rel = float((diff[..., last] / (np.abs(want[..., last]) + peak)
                      ).max()) if tail else 0.0
    past_ok = not got[..., valid_end:].any()
    say(f"[dnn] {what}: max difference {rel:.3e} of the peak {peak:.4f} "
        f"(limit {WAVE_TOL:g}), {len(ends)} edge samples within 1e-3 of "
        f"their magnitude: {edge_ok}, zero past the valid span: {past_ok}"
        + (f", last {tail} samples before the padding: {tail_rel:.3e} of "
           f"magnitude + peak (limit {DNN_TAIL_TOL:g})" if tail else ""))
    if not (rel <= WAVE_TOL and edge_ok and past_ok
            and tail_rel <= DNN_TAIL_TOL):
        raise AssertionError(f"{what}: card and CPU disagree")


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
    ap.add_argument("--kernels-only", action="store_true",
                    help="build the kernels, hold each against its plain "
                         "version and stop (a new kernel's first run); "
                         "prints no result line")
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
    t_start = time.perf_counter()

    def phase_done(what: str) -> None:
        say(f"[time] {what} done at {time.perf_counter() - t_start:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ── phase 1: build every kernel, one nvcc each, all started together ──
    t0 = time.perf_counter()
    built = build.build_all()
    say(f"[build] {', '.join(f'{n}.cu' for n in built)} -> sm_90a in "
        f"{time.perf_counter() - t0:.1f} s")

    # ── phase 2: each kernel alone against its plain version ─────────────
    k1_err, k1_time, k1_time_60s = check_k1(args.seed, smi)
    k2_err, k2_time, k2_time_tree = check_k2(args.seed, smi)
    k3_err, k3_time, k3_time_60s = check_k3(args.seed, smi)
    k4_err, k4_time = check_k4(args.seed, smi)
    k5_err, k5_time, k5_time_block = check_k5(args.seed, smi)
    k6_err, k6_time = check_k6(args.seed, smi)
    check_autograd(args.seed)
    if args.kernels_only:
        for name in built:
            with open(built[name] + ".log") as f:
                say(f"[build] {name}.cu: " + " | ".join(
                    line.strip() for line in f if "registers" in line
                    or "spill" in line))
        return 0
    check_istft(args.seed)
    launches = Launches()

    phase_done("build and kernel checks")

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
        launches.expect("export", quantize_int8=1)
        served = port.SincformerPipeline(device="cuda", model_dir=exported)
        served.load_model()
        size_mb = sum(os.path.getsize(os.path.join(r, f))
                      for r, _, fs in os.walk(exported) for f in fs) / 1e6
    params = dict(trained.model.named_parameters())
    tree_s = wall_s(lambda: port.quantize_tree(params))
    launches.reset()

    def saved_bytes(tree) -> int:
        buf = io.BytesIO()
        torch.save(tree, buf)
        return buf.tell()
    # each leaf's int8 values and scales are tensors of their own: saved,
    # the card's tree takes the bytes of the CPU's (views into one buffer
    # would write the whole buffer with every leaf)
    card_bytes = saved_bytes(port.quantize_tree(params))
    cpu_bytes = saved_bytes(port.quantize_tree(
        {name: p.detach().cpu() for name, p in params.items()}))
    launches.reset()
    say(f"[export] the tree saved: {card_bytes} bytes from the card, "
        f"{cpu_bytes} from the CPU (limit 1 % apart)")
    if abs(card_bytes / cpu_bytes - 1.0) > 0.01:
        raise AssertionError("the card's quantized tree saves to another size")
    say(f"[export] {n_leaves} leaves ({n_quantized} elements) through K2 "
        f"in one launch, "
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

    # ── phase 8: the auditory front-end (gammatone bank, hair cell K4) ───
    from sincformer_tpu_torch.ops.conv_gn import conv_gn_reference
    from sincformer_tpu_torch.ops.envact import env_act_reference
    rng = np.random.default_rng(args.seed + 2)
    speech16 = np.stack([speechlike(rng, 32000) for _ in range(16)])
    gfb, hair = port.GammatoneFilterbank(), port.MeddisHairCell()
    # the hair cell works in the model's pressure units (A = 5, B = 300):
    # a drive of peak 100 works the compression k = s / (s + B)
    drive = speech16 * 200.0

    def front_end(x: torch.Tensor) -> torch.Tensor:
        return hair.process_to_frames(gfb.filter(x))

    launches.reset()
    rates = front_end(torch.from_numpy(drive).cuda()).cpu()
    launches.expect("auditory front-end", meddis=1)
    rates_cpu = front_end(torch.from_numpy(drive[:2]))
    launches.expect("auditory front-end on the CPU")
    if rates.shape != (16, 64, 399) or not bool(torch.isfinite(rates).all()):
        raise AssertionError(f"front-end: bad output {tuple(rates.shape)}")
    err = float((rates[:2] - rates_cpu).abs().max() / rates_cpu.abs().max())
    say(f"[front-end] 16 signals x 4 s -> gammatone (16, 64, 32000) -> "
        f"Meddis -> frame rates {tuple(rates.shape)}, mean rate "
        f"{float(rates.mean()):.2f}, peak {float(rates.max()):.2f}; card vs "
        f"CPU on 2 signals: {err:.3e} of the peak (limit {WAVE_TOL:g}: the "
        f"filterbank is a library convolution on either side, the "
        f"recurrence is the same bits for the same input)")
    if not err <= WAVE_TOL:
        raise AssertionError("the front-end on the card left the CPU port")
    wall = wall_s(lambda: front_end(torch.from_numpy(drive).cuda()).cpu())
    say(f"[perf] auditory front-end, 16 x 4 s, host to host: "
        f"{wall * 1e3:.3f} ms wall, {64 / wall:.1f}x real time on {smi}")
    launches.reset()

    # ── phase 9: the PerceptionAgent front-end's fused building blocks ───
    # through their entry points (no model calls them, as in the JAX
    # package): sinc filterbank output -> env_act_auto (K6) -> conv1d_gn (K5)
    from sincformer_tpu_torch.agents.sincnet import SincConv1d
    g = torch.Generator().manual_seed(args.seed + 3)
    with torch.inference_mode():
        sinc_out = SincConv1d(64, config.sinc_kernel_size,
                              channels_last=True).cuda()(
            torch.from_numpy(speech16).cuda()).contiguous() * 40.0
    act_scale = (torch.rand(64, generator=g) * 1.5 + 0.5).cuda()
    conv_args = [t.cuda() for t in (
        torch.randn(7, 64, 128, generator=g) * (7 * 64) ** -0.5,
        torch.randn(128, generator=g) * 0.1,
        1.0 + torch.randn(128, generator=g) * 0.1,
        torch.randn(128, generator=g) * 0.1)]
    launches.reset()
    fine, env = port.env_act_auto(sinc_out, act_scale)
    block = port.conv1d_gn(fine, *conv_args, None, 2, 16)
    torch.cuda.synchronize()
    launches.expect("PA front-end entry points", env_act=1, conv1d_gn=1)
    fine_ref, env_ref = env_act_reference(sinc_out, act_scale)
    block_ref = conv_gn_reference(fine, *conv_args, None, stride=2, groups=16)
    errs = {"env_act y": (fine, fine_ref, ENVACT_TOL),
            "env_act env": (env, env_ref, ENVACT_TOL),
            "conv1d_gn": (block, block_ref,
                          KERNEL_TOL * float(block_ref.abs().max()))}
    for name, (got, ref, limit) in errs.items():
        err = float((got - ref).abs().max())
        say(f"[pa-blocks] {name} {tuple(got.shape)} on the sinc output of "
            f"16 x 4 s: max|kernel-plain| {err:.3e} (limit {limit:.3e})")
        if got.shape != ref.shape or not err <= limit:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on the driven path")
    del sinc_out, fine, env, block, fine_ref, env_ref, block_ref
    launches.reset()

    # ── phase 10: serving the original paper's mask DNN ──────────────────
    dnn = port.create_dnn(port.FeatureConfig().dim).init_params(
        torch.Generator().manual_seed(args.seed))
    fe = port.FeatureExtractor()
    with torch.inference_mode():
        feats = fe.add_context(fe.extract_frame_features(
            torch.from_numpy(speech16[:4]).cuda())).reshape(-1, fe.feature_dim)
    feat_std = feats.std(dim=0)
    feat_std[feat_std < 1e-6] = 1.0          # the AMS block is all zeros
    pcm16 = to_pcm(speech16)
    pcm_33 = pcm16[0, :26400]                # 3.3 s: padded to 28,000
    n_dnn_leaves = sum(1 for p in dnn.parameters() if p.ndim == 2)
    with tempfile.TemporaryDirectory() as dnn_dir:
        fresh = port.DNNPipeline("pcirm", device="cuda", model_dir=dnn_dir,
                                 model=dnn)
        fresh.feat_mean = feats.mean(dim=0).cpu().numpy()
        fresh.feat_std = feat_std.cpu().numpy()
        launches.reset()
        fresh.save_model(quantize=True)
        launches.expect("dnn save_model(quantize=True)", quantize_int8=1)
        served = port.DNNPipeline("pcirm", device="cuda", model_dir=dnn_dir)
        on_cpu = port.DNNPipeline("pcirm", device="cpu", model_dir=dnn_dir)
        say(f"[model] SpeechEnhancementDNN "
            f"{sum(p.numel() for p in dnn.parameters())} params "
            f"{dnn.sizes}, {n_dnn_leaves} weight matrices through K2 in one "
            f"launch; "
            f"loaded {os.path.basename(served.load_model())} on the card "
            f"and {os.path.basename(on_cpu.load_model())} on the CPU")

        launches.reset()
        got_batch = served.enhance_batch(pcm16)
        got_one = served.enhance_signal(pcm_33)
        host_path = StreamingEnhancer(served)
        if host_path._has_device_path():
            raise AssertionError("the DNN pipeline has no device path")
        got_60 = host_path.enhance(pcm60)
        # the DNN path holds none of the six kernels: a library convolution,
        # FFTs and matrix products, as in the JAX package
        launches.expect("dnn serving")
        os.environ["SINCFORMER_MODEL_DIR"] = dnn_dir
        wav_in = os.path.join(dnn_dir, "in.wav")
        wav_out = os.path.join(dnn_dir, "out.wav")
        from scipy.io import wavfile
        wavfile.write(wav_in, 8000, pcm60)
        if cli.main(["enhance", wav_in, wav_out, "--model", "pcirm"]) != 0:
            raise AssertionError("the enhance verb failed")
        launches.expect("enhance --model pcirm")
        got_cli = wavfile.read(wav_out)[1]

        want_batch = on_cpu.enhance_batch(pcm16[:2])
        want_one = on_cpu.enhance_signal(pcm_33)
        want_60 = on_cpu.enhance_batch(pcm60[None, :32000])[0, :28000]
        with torch.inference_mode():
            f_card = fe.extract_frame_features(
                torch.from_numpy(speech16[:2]).cuda()).cpu()
            f_cpu = fe.extract_frame_features(torch.from_numpy(speech16[:2]))
        # card vs CPU per feature block; GFCC is the widest, as expected of
        # differences of a float32 running sum followed by a cube root
        for name, block in (("RASTA-PLP", slice(15, 28)),
                            ("MFCC", slice(28, 41)), ("GFCC", slice(41, 54))):
            delta = (f_card[..., block] - f_cpu[..., block]).abs()
            scale = float(f_cpu[..., block].abs().max())
            worst_frame = int(delta.amax(dim=(0, 2)).argmax())
            say(f"[dnn] {name} features, card vs CPU, 2 x 4 s: max "
                f"difference {float(delta.max()) / scale:.3e} of the "
                f"block's scale {scale:.3f} (worst frame {worst_frame})")
        # (what, card, CPU, end of the valid span, samples before padding:
        # 6 frames of 80 and the half frame they overlap)
        checks = (("enhance_batch (16, 32000) int16, rows 0-1", got_batch[:2],
                   want_batch, 32000, 0),
                  ("enhance_signal 3.3 s int16 (padded to 28000)", got_one,
                   want_one, ((26400 - 160) // 80) * 80 + 160, 560),
                  ("60 s file, host path, first 3.5 s", got_60[:28000],
                   want_60, 28000, 0),
                  ("60 s file, enhance --model pcirm vs the host path",
                   got_cli, np.clip(got_60, -1.0, 1.0), len(pcm60), 0))
        for name, got, want, valid_end, tail in checks:
            check_dnn_wave(name, got, want, valid_end, tail)
        for shape, got in (((16, 32000), got_batch), ((26400,), got_one),
                           ((480000,), got_60)):
            if got.shape != shape or got.dtype != np.float32:
                raise AssertionError(f"dnn: bad output {got.dtype} "
                                     f"{got.shape}, expected {shape}")
        for name, audio_s, fn in (
                ("enhance_batch (16, 32000) int16", 64.0,
                 lambda: served.enhance_batch(pcm16)),
                ("enhance_signal 3.3 s int16", 3.3,
                 lambda: served.enhance_signal(pcm_33)),
                ("60 s int16 file, host path (16 windows, one batch)", 60.0,
                 lambda: host_path.enhance(pcm60))):
            wall = wall_s(fn, reps=5)
            say(f"[perf] dnn {name}: {wall * 1e3:.3f} ms wall, "
                f"{audio_s / wall:.1f}x real time on {smi}")
    launches.reset()

    phase_done("serving, parity, DCSE, front-end and DNN phases")

    # ── phase 11: flagship training (the train verb, 20 steps, vs CPU) ───
    train = check_train(args.seed, smi, launches)
    train.update(time_attention_in_step(args.seed, smi))
    say("[train] " + json.dumps(train))
    launches.reset()
    phase_done("[train]")

    # ── phase 12: evaluation, calibration, WAV input and tracing ─────────
    evaluation = check_evaluate(args.seed, smi, launches)
    eval_grid = evaluation.pop("grid")
    say("[evaluate] " + json.dumps(evaluation))
    calibration = check_calibrate(launches)
    say("[calibrate] " + json.dumps(calibration))
    host = check_native_and_trace(args.seed, launches)
    launches.reset()
    phase_done("[evaluate], [calibrate], [native]")

    # ── phase 13: DCSE and mask-DNN training, reference import, demo ─────
    dcse_train = check_train_dcse(args.seed, smi, launches)
    say("[train-dcse] " + json.dumps(dcse_train))
    dnn_train = check_train_dnn(args.seed, smi, launches)
    say("[train-dnn] " + json.dumps(dnn_train))
    check_import(args.seed, launches)
    check_demo(launches)
    launches.reset()
    phase_done("[train-dcse], [train-dnn], [import], [demo]")

    # ── phase 14: the flagship's variants beside the default ─────────────
    variants = check_variants(args.seed, smi, launches)
    say("[variants] " + json.dumps(variants))
    launches.reset()
    phase_done("[variants]")

    # ── phase 15: data parallelism on the one card ──────────────────────
    distributed = check_distributed(args.seed, smi, launches, eval_grid)
    say("[distributed] " + json.dumps(distributed))
    launches.reset()
    phase_done("[distributed]")

    # ── phase 16: tensor and context parallelism, the dry run ────────────
    parallel = check_parallel(args.seed, smi, launches)
    say("[parallel] " + json.dumps(parallel))
    launches.reset()
    phase_done("[parallel]")

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def row(name, source, replaces, err, timing, extra=None, **more):
        r = {"name": name, "route": "cuda",
             "source": f"sincformer_tpu_torch/csrc/{source}",
             "replaces": replaces, "launches": launches.total[name],
             "max_abs_err": err, **{k: timing[k] for k in keys}}
        if "bound_f32_ms" in timing:
            r["bound_f32_ms"] = timing["bound_f32_ms"]
        for shape, t in more.items():
            r[shape] = {k: t[k] for k in (*keys, "bound_f32_ms", "ms_eager",
                                          "wall_ms") if k in t}
        r.update(extra or {})
        return r
    kernels = [
        row("speech_attention", "speech_attention.cu",
            "sincformer_tpu/ops/speech_attention.py:70", k1_err, k1_time,
            at_B16_T401=k1_time_60s, extra={"in_training_step": {
                "launches_per_step": train["k1_launches_per_step"],
                "forward_ms_B8_T400": train["forward_ms"],
                "plain_backward_ms_B8_T400": train["plain_backward_ms"]},
                "in_adversarial_step": {"launches_per_step": train[
                    "adversarial_step"]["k1_launches_per_step"]},
                "in_evaluate_verb": evaluation["k1_launches"],
                "in_calibrate_verb": calibration["k1_launches"]["cuda"],
                "in_traced_request": host["trace_k1"],
                "in_dcse_training_step": {
                    "launches_per_step": dcse_train["k1_launches_per_step"]},
                "in_dcse_validation": dcse_train["k1_in_validation"],
                "in_dcse_train_verb": dcse_train["verb_k1"],
                "in_variants": {
                    name: {"per_forward": variants[name]["enhance_batch"][
                        "k1_launches"], "per_training_step": variants[name][
                        "train_step"]["k1_launches"]}
                    for name, _ in VARIANT_CONFIGS},
                "in_variant_train_verb": variants["train_verb"][
                    "k1_launches"],
                "in_distributed": {
                    "per_rank_step": {kind: distributed["two_ranks"][kind][0][
                        "k1"] for kind in ("flagship", "dcse")},
                    "per_rank_evaluate": distributed["evaluate"][
                        "k1_per_rank"]},
                "in_tensor_parallel_step_per_rank": {
                    kind: parallel["tp"][kind][0]["k1"]
                    for kind in ("flagship", "dcse")}}),
        row("quantize_int8", "quantize_int8.cu",
            "sincformer_tpu/ops/quantize.py:34", k2_err, k2_time,
            at_flagship_tree=k2_time_tree),
        row("fused_ffn", "fused_ffn.cu",
            "sincformer_tpu/ops/fused_ffn.py:39", k3_err, k3_time,
            at_rows6416=k3_time_60s, extra={
                "in_dcse_validation": dcse_train["k3_in_validation"],
                "in_dcse_step_no_dropout":
                    dcse_train["k3_in_step_no_dropout"],
                "in_distributed_dcse_step_per_rank":
                    distributed["two_ranks"]["dcse"][0]["k3"],
                "in_tensor_parallel_dcse_step_per_rank":
                    parallel["tp"]["dcse"][0]["k3"]}),
        row("meddis", "meddis.cu",
            "sincformer_tpu/ops/meddis_pallas.py:38", k4_err, k4_time),
        row("conv1d_gn", "conv_gn.cu",
            "sincformer_tpu/ops/conv_gn_pallas.py:64", k5_err, k5_time,
            at_flagship_block=k5_time_block),
        row("env_act", "envact.cu",
            "sincformer_tpu/ops/envact_pallas.py:37", k6_err, k6_time)]
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
