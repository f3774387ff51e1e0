"""Shared set-up of the port's parity tests (tests/test_torch_*.py): a narrow
flax SincformerMetacog and the same weights carried into the port through
compat.from_jax. Inputs are made with numpy from a seed and handed to both
packages; both run on the CPU in float32.

The weights fill flax's own parameter tree (taken from ``jax.eval_shape``
of ``model.init``) with seeded numpy values at flax's initialiser scales,
fan-in normal kernels, but with every bias and norm offset non-zero: flax
initialises those to zero, which would hide a bias put in the wrong place.
The model_state collections hold what training leaves there (moved running
statistics, a filled episodic bank).

:class:`Ahead` runs a file's JAX reference programs on background threads
while its tests compute the port's side."""

from __future__ import annotations

import contextlib
import functools
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests import _torch_threads  # noqa: F401

# narrow widths: 2 Conformer blocks, 2 heads of 16, a 65-tap SincConv
NARROW = dict(encoder_channels=32, cpea_hidden=16, cpea_channels=8,
              d_model=32, msa_blocks=2, num_heads=2, d_ff=64, kernel_size=7,
              memory_slots=4, episodic_slots=4, sinc_kernel_size=65)
N_SAMPLES = 4000          # 0.5 s at 8 kHz: STFT T = 51, PA T' = 50


def wave(seed: int, shape=(2, N_SAMPLES), scale: float = 0.3) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _fill(path, leaf, rng):
    names = [getattr(k, "key", str(k)) for k in path]
    shape, name = leaf.shape, names[-1]
    if name == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        return rng.standard_normal(shape) / np.sqrt(fan_in)
    if name == "scale":
        return 1.0 + 0.1 * rng.standard_normal(shape)
    if name == "bias":
        return 0.1 * rng.standard_normal(shape)
    if name in ("low_hz", "band_hz"):       # ERB-like cutoffs in Hz
        return rng.uniform(50.0, 500.0, shape)
    if name in ("act_scale", "act_mu"):
        return rng.uniform(0.5, 2.0, shape)
    if name == "centroids":
        return np.sort(rng.uniform(0.0, 1.0, shape))
    if name == "nu_log":          # |λ| over the whole [0.9, 0.999] of init
        return np.log(-np.log(rng.uniform(0.9, 0.999, shape)))
    if name == "theta_log":       # phases in [1e-4, π/4]
        return np.log(rng.uniform(1e-4, np.pi / 4, shape))
    if name in ("B_re", "B_im", "C_re", "C_im"):     # (in, out)
        return rng.standard_normal(shape) / np.sqrt(shape[0])
    if name == "D":
        return 1.0 + 0.1 * rng.standard_normal(shape)
    return 0.5 * rng.standard_normal(shape)  # memory banks, threshold


_BUILD_LOCK = threading.Lock()


def narrow_model(**variant):
    """(flax module, numpy variables, torch SincformerMetacog loaded from
    them) at the NARROW widths, μ-law fine stream; ``variant`` sets the
    flax model's ``pa_impl``, ``cpea_impl``, ``pa_fine_feats`` or
    ``pa_fine_act``, or a NARROW width (``msa_blocks``). Built once per
    variant, whichever thread asks first."""
    with _BUILD_LOCK:
        return _narrow_model(**variant)


@functools.lru_cache(maxsize=None)
def _narrow_model(**variant):
    from sincformer_tpu.agents.metacog import SincformerMetacog as JaxModel
    from sincformer_tpu_torch.agents.metacog import SincformerMetacog
    from sincformer_tpu_torch.compat.from_jax import load_from_jax

    model = JaxModel(**{**NARROW, "dropout": 0.0, "attn_impl": "speech",
                        "pa_fine_act": "mulaw", **variant})
    wav = jnp.zeros((1, 800))
    spec = jnp.zeros((1, 11, 129))
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), wav, spec, spec, train=False))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map_with_path(
        lambda p, s: _fill(p, s, rng).astype(np.float32), shapes["params"])
    ep, kd = NARROW["episodic_slots"], NARROW["encoder_channels"]
    variables = {
        "params": params,
        "maa_stats": {"maa": {"running_mean": np.float32(0.7),
                              "running_var": np.float32(0.2),
                              "num_updates": np.int32(9)}},
        "memory_bank": {"memory": {
            "keys": rng.standard_normal((ep, kd)).astype(np.float32),
            "values": rng.uniform(0, 1, (ep, 129)).astype(np.float32),
            "age": np.arange(ep, dtype=np.float32)}},
        "memory_stats": {"memory": {
            "usage_count": np.arange(NARROW["memory_slots"] + ep,
                                     dtype=np.float32),
            "num_queries": np.int32(7)}},
    }
    state, buffers, config = load_from_jax(
        variables, num_heads=NARROW["num_heads"],
        sinc_kernel_size=NARROW["sinc_kernel_size"])
    tmodel = SincformerMetacog(config).eval()
    tmodel.load_state_dict({**state, **buffers}, strict=True)
    return model, variables, tmodel


class Ahead:
    """One result of each of a file's JAX reference programs, computed on
    background threads: :meth:`start` submits ``(fn, *args)`` jobs in the
    order the tests use them, and ``ahead(fn, *args)`` waits for that
    result. With two threads one job traces while another compiles (XLA's
    compile releases the GIL), and both run beside the port's side of the
    tests."""

    def __init__(self):
        self._futures = {}

    @contextlib.contextmanager
    def start(self, jobs, threads: int = 2):
        """Run ``jobs`` for the body of the ``with``; on leaving it, drop
        the jobs not begun and wait for those running."""
        with ThreadPoolExecutor(threads) as pool:
            for fn, *args in jobs:
                self._futures[(fn, tuple(args))] = pool.submit(fn, *args)
            try:
                yield self
            finally:
                for future in self._futures.values():
                    future.cancel()
        self._futures.clear()

    def __call__(self, fn, *args):
        return self._futures[(fn, args)].result()


def cancelled_biases(module) -> set:
    """The conv biases of ``module``'s residual conv blocks that a GroupNorm
    of one channel per group removes again (the reference cascade's narrow
    blocks of 16 channels): their true gradient is 0, so both packages
    return rounding there, and an optimizer steps by its sign."""
    from sincformer_tpu_torch.agents.perception import _ConvBlock
    return {f"{m}.{conv}.bias" for m, mod in module.named_modules()
            if isinstance(mod, _ConvBlock)
            and mod.gn1.num_groups == mod.gn1.num_channels
            for conv in ("conv1", "conv2", "skip")}


# narrow DCSE: 2 Conformer blocks, 2 heads of 16
NARROW_DCSE = dict(d_model=32, num_blocks=2, num_heads=2, d_ff=64,
                   kernel_size=7)


@functools.lru_cache(maxsize=None)
def narrow_dcse():
    """(flax SpeechEnhancer kwargs, numpy variables) at the NARROW_DCSE
    widths, every bias and norm offset non-zero."""
    from sincformer_tpu.models.dcse import SpeechEnhancer as JaxModel

    model = JaxModel(n_freq=129, dropout=0.0, attn_impl="speech",
                     **NARROW_DCSE)
    spec = jnp.zeros((1, 11, 129))
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), spec,
                                               spec))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, s: _fill(p, s, rng).astype(np.float32), shapes["params"])
    return {"params": params}


def jax_dcse_model(fused: bool = False):
    from sincformer_tpu.models.dcse import SpeechEnhancer as JaxModel
    return JaxModel(n_freq=129, dropout=0.0, attn_impl="speech",
                    fused_ffn=fused, **NARROW_DCSE)


def torch_dcse_pipeline(fused: bool = False, output_gain: float = 1.0):
    """The port's DCSEPipeline on the CPU with the narrow_dcse weights."""
    from sincformer_tpu_torch import (DCSEPipeline, SpeechEnhancer,
                                      load_dcse_from_jax)
    state, config = load_dcse_from_jax(narrow_dcse(), fused_ffn=fused,
                                       num_heads=NARROW_DCSE["num_heads"])
    pipe = DCSEPipeline(SpeechEnhancer(config), device="cpu",
                        output_gain=output_gain)
    pipe.load_state(state)
    return pipe


def jax_dcse_pipeline(model_dir: str, output_gain: float = 1.0):
    """The JAX DCSEPipeline with the narrow_dcse weights."""
    from sincformer_tpu.train.dcse_trainer import DCSEPipeline
    pipe = DCSEPipeline(model=jax_dcse_model(), model_dir=model_dir)
    pipe.init_state(epochs=1, steps_per_epoch=1, example_len=800)
    pipe.state = pipe.state.replace(
        params=jax.tree.map(jnp.asarray, narrow_dcse()["params"]))
    pipe.output_gain = output_gain
    return pipe


def max_abs(a, b) -> float:
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a.astype(np.float64) - b.astype(np.float64))))


def speechlike(seed: int, n: int, fs: int = 8000) -> np.ndarray:
    """Harmonic voiced segments with a syllable-rate envelope in white
    noise at about 5 dB SNR, peak 0.5: no digital silence, so that the
    ``log(x + 1e-10)`` of the MFCC and RASTA features stays well
    conditioned."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    f0 = 110 + 40 * np.sin(2 * np.pi * 0.7 * t + rng.uniform(0, 6))
    phase = 2 * np.pi * np.cumsum(f0) / fs
    voiced = sum(np.sin(h * phase) / h for h in range(1, 12))
    env = np.clip(np.sin(2 * np.pi * 3.0 * t + rng.uniform(0, 6)), 0, None)
    clean = voiced * env
    noise = rng.standard_normal(n) * np.std(clean) * 10 ** (-5 / 20)
    x = clean + noise
    return (0.5 * x / np.max(np.abs(x))).astype(np.float32)


# narrow mask DNN: 594 -> 2 x 64 -> 64 (the feature and mask widths are the
# front-end's and stay)
NARROW_DNN = dict(hidden_layers=2, hidden_units=64)


@functools.lru_cache(maxsize=None)
def dnn_variables():
    """Seeded flax variables of the narrow mask DNN, every bias non-zero,
    and non-trivial feature statistics (mean, std) of width 594."""
    rng = np.random.default_rng(2)
    widths = [594] + [NARROW_DNN["hidden_units"]] * NARROW_DNN["hidden_layers"]
    params = {}
    for i, (fan_in, fan_out) in enumerate(zip(widths[:-1], widths[1:])):
        params[f"hidden_{i}"] = {
            "kernel": (rng.standard_normal((fan_in, fan_out))
                       * np.sqrt(2.0 / fan_in)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(fan_out)).astype(np.float32)}
    params["output"] = {
        "kernel": (rng.standard_normal((widths[-1], 64))
                   / np.sqrt(widths[-1])).astype(np.float32),
        "bias": (0.1 * rng.standard_normal(64)).astype(np.float32)}
    mean = (0.5 * rng.standard_normal(594)).astype(np.float32)
    std = rng.uniform(0.5, 3.0, 594).astype(np.float32)
    return {"params": params}, mean, std


def jax_dnn_pipeline(model_dir: str, mask_type: str = "pcirm"):
    """The JAX DNNPipeline at the narrow widths with the dnn_variables
    weights and feature statistics."""
    import dataclasses

    from sincformer_tpu import config as cfg
    from sincformer_tpu.train.dnn_trainer import DNNPipeline
    variables, mean, std = dnn_variables()
    pipe = DNNPipeline(mask_type=mask_type, use_rbm_pretrain=False,
                       model_dir=model_dir,
                       dcfg=dataclasses.replace(cfg.DEFAULT.dnn, **NARROW_DNN))
    pipe.state = pipe._init_model_state(1e-3, jax.random.PRNGKey(0))
    pipe.state = pipe.state.replace(params=jax.tree.map(jnp.asarray,
                                                        variables))
    pipe.feat_mean, pipe.feat_std = mean, std
    return pipe


def torch_dnn_pipeline(variables=None, model_dir=None,
                       mask_type: str = "pcirm"):
    """The port's DNNPipeline on the CPU with bridged weights (default: the
    dnn_variables ones) and the same feature statistics."""
    from sincformer_tpu_torch import DNNPipeline, load_dnn_from_jax
    default, mean, std = dnn_variables()
    state, sizes = load_dnn_from_jax(variables or default)
    pipe = DNNPipeline(mask_type=mask_type, device="cpu",
                       model_dir=model_dir)
    pipe.load_state(state, sizes)
    pipe.feat_mean, pipe.feat_std = mean, std
    return pipe


# ── split-TF32 arithmetic of the tensor-core kernels (K1, K3, K5) ─────────
def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 (10 explicit mantissa bits) as ``cvt.rna.tf32.f32``
    rounds: to nearest, ties away from zero. Adding half a unit of the
    kept last place to the sign-magnitude bit pattern and clearing the 13
    dropped bits rounds the magnitude half up, whatever the sign."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """x = hi + lo as the kernels split it (tf32x3.cuh)."""
    hi = tf32(x)
    return hi, tf32(x.float() - hi)


def matmul_tf32(a: torch.Tensor, b: torch.Tensor,
                terms: int = 3) -> torch.Tensor:
    """a @ b with the kernels' tensor-core arithmetic, f32 sums: ``terms=3``
    is lo.hi + hi.lo + hi.hi (small terms first), ``terms=1`` the single
    TF32 product hi.hi that the kernels must not fall back to."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    if terms == 1:
        return a_hi @ b_hi
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def attention_tf32(q, k, v, bias=None, terms: int = 3) -> torch.Tensor:
    """Kernel K1's arithmetic, (B, T, H, dh) in and out: S = Q.K^T and
    O = P.V in split TF32, f32 softmax with the sum divided out last."""
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    qh, kh, vh = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))
    s = matmul_tf32(qh, kh.transpose(-1, -2), terms) * scale
    if bias is not None:
        s = s + bias[:, None, None, :]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = matmul_tf32(p, vh, terms) / p.sum(dim=-1, keepdim=True)
    return o.permute(0, 2, 1, 3)


def fused_ffn_tf32(x, ln_g, ln_b, w1, b1, w2, b2,
                   terms: int = 3) -> torch.Tensor:
    """Kernel K3's arithmetic: f32 LayerNorm (eps 1e-6, centred variance),
    both products in split TF32, f32 bias, swish and residual."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    xn = (x - mu) * torch.rsqrt(var + 1e-6) * ln_g + ln_b
    h = matmul_tf32(xn, w1, terms) + b1
    h = h * torch.sigmoid(h)
    return x + 0.5 * (matmul_tf32(h, w2, terms) + b2)


def conv_gn_tf32(x, w, b, gamma, beta, skip=None, *, stride: int,
                 groups: int, terms: int = 3, eps: float = 1e-6,
                 act: bool = True) -> torch.Tensor:
    """Kernel K5's arithmetic: the SAME strided convolution as one product
    of the im2col of x (B, Tout, K * Cin) with w (K * Cin, Cout) in split
    TF32, then f32 bias, GroupNorm (centred variance), skip and tanh-GELU."""
    import torch.nn.functional as F

    from sincformer_tpu_torch.ops.conv_gn import _same_pads
    k, cin, cout = w.shape
    t_out, pad_l, pad_r = _same_pads(x.shape[1], k, stride)
    xp = F.pad(x.float(), (0, 0, pad_l, pad_r))              # (B, T', Cin)
    cols = xp.unfold(1, k, stride)[:, :t_out]       # (B, Tout, Cin, K)
    cols = cols.permute(0, 1, 3, 2).reshape(x.shape[0], t_out, k * cin)
    y = matmul_tf32(cols, w.float().reshape(k * cin, cout), terms) + b
    yg = y.reshape(x.shape[0], t_out, groups, cout // groups)
    mu = yg.mean(dim=(1, 3), keepdim=True)
    var = ((yg - mu) ** 2).mean(dim=(1, 3), keepdim=True)
    y = ((yg - mu) * torch.rsqrt(var + eps)).reshape(y.shape) * gamma + beta
    if skip is not None:
        y = y + skip
    return F.gelu(y, approximate="tanh") if act else y
