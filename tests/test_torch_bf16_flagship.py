"""The flagship's bf16 forward in the port against the JAX package, on the
CPU: each module of ``SincformerMetacog`` on the same bf16 input and
parameters, and the whole forward of every variant, as ``bench.py`` runs
it (every float variable cast to bf16, a bf16 waveform and STFT,
``train=False``).

Every JAX bf16 program is compiled with XLA's excess precision off
(``tests/test_torch_bf16.py`` says why): then every bf16 operation of the
jaxpr rounds, and the port rounds at the same points.

Bars (``tests/_torch_bf16.py`` for the terms):
  * Modules (the SincConv, the PerceptionAgent with the μ-law and the GELU
    fine streams, the CPEA with the BiLSTM and the BiLRU, the MSA's fusion
    MLP and its mask heads, the episodic memory, the VQ, the MAA; the
    reference cascade is held whole, below): at least 99 % of the output
    elements bit-equal to flax's, and every element within one bf16 ulp
    at its term scale, here the largest magnitude of its row (the last
    axis): a row is the output of one normalisation, product or gate,
    whose terms rounded at that scale. The MSA's ConformerBlocks are held by
    ``tests/test_torch_bf16.py``; here the MSA's fusion MLP runs on the
    same inputs and its heads on JAX's blocks' output. A cuDNN-style LSTM
    (f32 cell and gates, the output rounded once) and a GELU that rounds
    once (PyTorch's) must miss. The PerceptionAgent is held layer by layer
    the same way: its front (SincConv, the two streams, the embeddings) on
    the waveform, each residual block on JAX's input to it, the heads on
    JAX's last block's output. Held whole, one element that the two
    libraries' f32 statistics round apart (a GroupNorm's mean over a whole
    row) passes through the later convolutions and normalisations to about
    a fifth of the output on some inputs, as a whole network decorrelates
    (``tests/_torch_bf16.py``); the whole forward below holds that.
  * The whole forward of the default (BiLSTM), the BiLRU, three MSA
    blocks, the dual stream and the reference cascade, at the NARROW
    widths: the MAA decisions, the VQ indices and the memory's top slots
    equal to JAX bf16's wherever JAX's two best candidates are more than
    two bf16 ulps apart and farther apart than the two packages'
    candidates are from each other, counted up to 16 ulps (the MAA's
    logits, the VQ's input: a whole network's bf16 values decorrelate, so
    a decision's inputs can differ by a few ulps, measured up to 13 ulps
    for the dual stream's logits); the flips are counted and printed, and
    at most 1 % of the frames (of the VQ's mask values) flip;
    on the frames whose route agrees, the enhanced spectrum's noise =
    |port bf16 - JAX f32| / |JAX bf16 - JAX f32| in [0.5, 2] and its cross
    = |port bf16 - JAX bf16| / the same at most 1.2 (the whole-model
    bars of ``tests/test_torch_bf16.py``), on at least 99 % of the
    frames. Measured: the default is bit-equal to JAX's, the others
    0.04-0.3 cross.
  * Planted exact ties in the MAA's logits, the VQ's distances and the
    memory's similarities take the first index, as ``jnp.argmax`` and
    ``jnp.argmin`` do, in both packages.

The JAX programs run on ``Ahead`` threads from the start of the file."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_bf16 import agreement, bf16_ulp, ratios
from tests._torch_parity import NARROW, Ahead, narrow_model, wave

NOEX = {"xla_allow_excess_precision": False}
SHARE = 0.99           # bit-equal elements of a module's output
ULPS = 1.0             # worst element, bf16 ulps at its row's scale
NOISE = (0.5, 2.0)     # the whole forward: tests/test_torch_bf16.py's bars
CROSS = 1.2
TIE_ULPS = 2.0         # a near-tie: JAX's two best within this many ulps,
APART_CAP = 16.0       # or within the packages' disagreement, up to this
KEPT = 0.99            # share of frames (VQ: mask values) that must agree
AHEAD = Ahead()

VARIANTS = {"lstm": {}, "ssm": {"cpea_impl": "ssm"}, "msa3": {"msa_blocks": 3},
            "dual": {"pa_fine_feats": "dual"},
            "reference": {"pa_impl": "reference"}}
MODULES = ["sinc", "pa front mulaw", "pa front gelu", "pa blocks",
           "pa heads", "cpea lstm", "cpea ssm", "msa fuse", "msa heads",
           "memory", "vq", "maa"]
T_FRAMES = 50          # the PA's frames of a NARROW 0.5 s input


def _jit(fn):
    return jax.jit(fn, compiler_options=NOEX)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32)).bfloat16()


def _jbf16(x):
    return jnp.asarray(np.asarray(x, np.float32), jnp.bfloat16)


def _cast(variables):
    """Every float32 leaf to bf16, as ``bench.py`` casts the variables."""
    return jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16)
                        if np.asarray(a).dtype == np.float32
                        else jnp.asarray(a), variables)


@functools.lru_cache(maxsize=None)
def _port16(variant: str):
    """The port's narrow model of ``variant``, cast to bf16."""
    return copy.deepcopy(narrow_model(**VARIANTS[variant])[2]).to(
        torch.bfloat16)


def _row_scale(want) -> np.ndarray:
    w = np.abs(_np(want))
    return np.broadcast_to(np.max(w, axis=-1, keepdims=True), w.shape)


# ── modules ─────────────────────────────────────────────────────────────

def _module_inputs(name: str) -> dict:
    rng = np.random.default_rng(20 + MODULES.index(name))
    d, c = NARROW["encoder_channels"], NARROW["cpea_channels"]
    if name.startswith(("sinc", "pa")):
        return {"wave": wave(21)}
    if name.startswith("cpea"):
        return {"z": rng.standard_normal((2, d, T_FRAMES))}
    if name == "msa fuse":
        return {"z": rng.standard_normal((2, d, T_FRAMES)),
                "zi": rng.standard_normal((2, d, T_FRAMES)),
                "cpea": {k: rng.uniform(-1, 1, (2, T_FRAMES, c)) for k in
                         ("rho_s", "rho_n", "phi1", "phi2")},
                "sr": rng.standard_normal((2, T_FRAMES, 129)),
                "si": rng.standard_normal((2, T_FRAMES, 129))}
    if name == "msa heads":
        return {"x": rng.standard_normal((2, T_FRAMES, NARROW["d_model"]))}
    if name == "memory":
        return {"pooled": rng.standard_normal((8, d))}
    if name == "vq":
        return {"mask": rng.uniform(0.0, 1.0, (2, T_FRAMES, 129))}
    return {"sigma": rng.uniform(0.2, 2.0, (2, 1, T_FRAMES))}   # maa


def _variant_of(name: str) -> str:
    return "ssm" if name == "cpea ssm" else "lstm"


def _jax_module(name: str) -> dict:
    """The flax module's bf16 outputs on ``_module_inputs(name)``, as a
    dict of float32 numpy arrays."""
    import flax.linen as nn

    from sincformer_tpu.agents.cpea import CorrelationPhaseEstimationAgent
    from sincformer_tpu.agents.maa import MetacognitiveArbitrationAgent
    from sincformer_tpu.agents.memory import EpisodicMemory
    from sincformer_tpu.agents.msa import MaskSynthesisAgent
    from sincformer_tpu.agents.perception import PerceptionAgentMXU
    from sincformer_tpu.agents.sincnet import SincConv1d
    from sincformer_tpu.models.vq import VectorQuantizer
    model, variables, _ = narrow_model(**VARIANTS[_variant_of(name)])
    v = _cast(variables)
    p, n, inp = v["params"], NARROW, _module_inputs(name)
    d = n["encoder_channels"]
    if name == "sinc":
        m = SincConv1d(out_channels=d // 4, kernel_size=n["sinc_kernel_size"],
                       channels_last=True)
        out = _jit(m.apply)({"params": p["pa"]["sinc"]}, _jbf16(inp["wave"]))
        return {"y": _np(out)}
    if name.startswith("pa"):
        act = "gelu" if name == "pa front gelu" else "mulaw"
        m = PerceptionAgentMXU(d, 8000, n["sinc_kernel_size"], 80,
                               fine_act=act)
        params = dict(p["pa"])
        if act == "gelu":
            params.pop("act_mu")

        def fn(v_, x):
            seen = {}

            def grab(next_fun, args, kwargs, context):
                out = next_fun(*args, **kwargs)
                name_ = context.module.name or ""
                if (context.method_name == "__call__"
                        and name_.startswith("block_")):
                    seen[name_] = (args[0], out)
                return out
            with nn.intercept_methods(grab):
                out = m.apply(v_, x)
            return out, seen
        out, seen = _jit(fn)({"params": params}, _jbf16(inp["wave"]))
        if name.startswith("pa front"):
            return {"h": _np(seen["block_0"][0])}
        if name == "pa blocks":
            return {f"{k} {io}": _np(x) for k, pair in seen.items()
                    for io, x in zip(("in", "out"), pair)}
        return dict(zip(("z_real", "z_imag", "sigma"), map(_np, out)),
                    h=_np(seen[f"block_{len(seen) - 1}"][1]))
    if name.startswith("cpea"):
        m = CorrelationPhaseEstimationAgent(d, n["cpea_hidden"], 2,
                                            n["cpea_channels"],
                                            impl=model.cpea_impl)
        out = _jit(lambda v_, z: m.apply(v_, z, channels_first=True))(
            {"params": p["cpea"]}, _jbf16(inp["z"]))
        return {k: _np(x) for k, x in out.items()}
    if name.startswith("msa"):
        m = MaskSynthesisAgent(d, n["cpea_channels"], n["d_model"], 129,
                               n["msa_blocks"], n["num_heads"], n["d_ff"],
                               n["kernel_size"], 0.0, attn_impl="speech")
        z = _module_inputs("msa fuse")
        args = (_jbf16(z["z"]), _jbf16(z["zi"]),
                {k: _jbf16(x) for k, x in z["cpea"].items()},
                _jbf16(z["sr"]), _jbf16(z["si"]))
        last = f"block_{n['msa_blocks'] - 1}"

        def fn(v_, x, *a):
            seen = {}

            def grab(next_fun, args_, kwargs, context):
                out = next_fun(*args_, **kwargs)
                if context.method_name == "__call__":
                    if context.module.name == "fusion_ln2":
                        seen["x"] = out
                    if context.module.name == last and x is not None:
                        return x          # the heads run on the given x
                return out
            with nn.intercept_methods(grab):
                re, im = m.apply(v_, *a, deterministic=True)
            return seen["x"], re, im
        if name == "msa fuse":
            return {"x": _np(_jit(lambda v_, *a: fn(v_, None, *a)[0])(
                {"params": p["msa"]}, *args))}
        _, re, im = _jit(fn)({"params": p["msa"]}, _jbf16(inp["x"]), *args)
        return {"re": _np(re), "im": _np(im)}
    if name == "memory":
        m = EpisodicMemory(d, 129, n["memory_slots"],
                           episodic_slots=n["episodic_slots"])
        out = _jit(lambda v_, x: m.apply(v_, x, train=False))(
            {"params": p["memory"], "memory_bank": v["memory_bank"]["memory"],
             "memory_stats": v["memory_stats"]["memory"]},
            _jbf16(inp["pooled"]))
        return {k: _np(x) for k, x in out.items()}
    if name == "vq":
        out = _jit(VectorQuantizer(3, 0.25).apply)({"params": p["vq"]},
                                                   _jbf16(inp["mask"]))
        return {"quantized": _np(out[0]), "indices": _np(out[1])}
    m = MetacognitiveArbitrationAgent(routing="gumbel")
    out = _jit(lambda v_, s: m.apply(v_, s, train=False))(
        {"params": p["maa"], "maa_stats": v["maa_stats"]["maa"]},
        _jbf16(inp["sigma"]))
    return {k: _np(out[k]) for k in ("logits", "probs", "decisions",
                                     "confidence", "route")}


def _port_module(name: str, model=None) -> dict:
    """The port's bf16 module outputs on ``_module_inputs(name)``."""
    m = model if model is not None else _port16(_variant_of(name))
    inp = _module_inputs(name)
    with torch.no_grad():
        if name == "sinc":
            return {"y": _np(m.pa.sinc(_bf16(inp["wave"])))}
        # the port's PA runs (B, C, T), flax's (B, T, C)
        if name.startswith("pa front"):
            pa = m.pa
            if name == "pa front gelu":
                pa = copy.deepcopy(pa)
                pa.fine_act = "gelu"
            return {"h": _np(pa.front(_bf16(inp["wave"])).transpose(1, 2))}
        if name == "pa blocks":       # each block on JAX's input to it
            want = AHEAD(_jax_module, name)
            return {f"block_{i} out": _np(getattr(m.pa, f"block_{i}")(
                _bf16(want[f"block_{i} in"]).transpose(1, 2)).transpose(
                    1, 2)) for i in range(m.pa.num_blocks)}
        if name == "pa heads":        # on JAX's last block's output
            out = m.pa.heads(_bf16(AHEAD(_jax_module, name)["h"]).transpose(
                1, 2))
            return dict(zip(("z_real", "z_imag", "sigma"), map(_np, out)))
        if name.startswith("cpea"):
            return {k: _np(x) for k, x in m.cpea(_bf16(inp["z"])).items()}
        if name == "msa fuse":
            return {"x": _np(m.msa.fuse(
                _bf16(inp["z"]), _bf16(inp["zi"]),
                {k: _bf16(x) for k, x in inp["cpea"].items()},
                _bf16(inp["sr"]), _bf16(inp["si"])))}
        if name == "msa heads":
            re, im = m.msa.heads(_bf16(inp["x"]))
            return {"re": _np(re), "im": _np(im)}
        if name == "memory":
            return {k: _np(x) for k, x in m.memory(
                _bf16(inp["pooled"])).items()}
        if name == "vq":
            q, idx, _ = m.vq(_bf16(inp["mask"]))
            return {"quantized": _np(q), "indices": _np(idx)}
        out = m.maa(_bf16(inp["sigma"]))
        return {k: _np(out[k]) for k in ("logits", "probs", "decisions",
                                         "confidence", "route")}


def _module_agreement(got: dict, want: dict) -> tuple:
    """(worst share, worst ulps, per-output report) over the port's
    outputs."""
    share, ulps, parts = 1.0, 0.0, []
    for k in got:
        s, u = agreement(got[k], want[k], _row_scale(want[k]))
        share, ulps = min(share, s), max(ulps, u)
        parts.append(f"{k} {s:.5f}/{u:.2f}")
    return share, ulps, ", ".join(parts)


# ── the whole forward ───────────────────────────────────────────────────

def _whole_inputs():
    from sincformer_tpu_torch.dsp.stft import stft
    w = wave(23)
    spec = stft(torch.from_numpy(w))
    return w, spec.real.numpy(), spec.imag.numpy()


def _jax_whole(variant: str, bf16: bool) -> dict:
    """JAX's forward of the narrow ``variant`` in bf16 (every variable and
    input cast) or float32: the enhanced spectrum, the decisions and the
    memory's top slots, with the MAA's logits and the VQ's input and
    indices behind them."""
    import flax.linen as nn
    model, variables, _ = narrow_model(**VARIANTS[variant])
    dt = jnp.bfloat16 if bf16 else jnp.float32
    v = _cast(variables) if bf16 else jax.tree.map(jnp.asarray, variables)
    w, sr, si = _whole_inputs()

    def fn(v_, a, b, c):
        seen = {}

        def grab(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if context.method_name == "__call__":
                if context.module.name == "vq":
                    seen["vq_in"], seen["vq_idx"] = args[0], out[1]
                elif context.module.name == "maa":
                    seen["logits"] = out["logits"]
            return out
        with nn.intercept_methods(grab):
            out = model.apply(v_, a, b, c, train=False)
        return {**{k: out[k] for k in ("enhanced_real", "enhanced_imag",
                                       "decisions", "memory_top")}, **seen}
    out = (_jit(fn) if bf16 else jax.jit(fn))(
        v, *(jnp.asarray(x, dt) for x in (w, sr, si)))
    return {k: _np(x) for k, x in out.items()}


def _port_whole(variant: str) -> dict:
    m = _port16(variant)
    w, sr, si = _whole_inputs()
    caught = {}
    hooks = [m.vq.register_forward_hook(
        lambda mod, i, o: caught.update(vq_in=i[0], vq_idx=o[1])),
        m.memory.register_forward_hook(
            lambda mod, i, o: caught.update(mem_in=i[0]))]
    try:
        with torch.no_grad():
            out = m(_bf16(w), _bf16(sr), _bf16(si))
    finally:
        for h in hooks:
            h.remove()
    result = {k: _np(out[k]) for k in ("enhanced_real", "enhanced_imag",
                                       "decisions", "memory_top")}
    result["logits"] = _np(out["route_logits"])
    result["vq_in"], result["vq_idx"] = _np(caught["vq_in"]), _np(
        caught["vq_idx"])
    return result


def _maa_margin(j_logits: np.ndarray, p_logits: np.ndarray) -> tuple:
    """Per frame: JAX's gap between its two largest logits, and the two
    packages' largest disagreement on a logit, both in bf16 ulps at JAX's
    largest logit."""
    j_logits, p_logits = (np.asarray(a, np.float64)
                          for a in (j_logits, p_logits))
    s = np.sort(j_logits, axis=-1)
    ulp = bf16_ulp(np.maximum(np.abs(s[..., -1]), np.abs(s[..., -2])))
    return ((s[..., -1] - s[..., -2]) / ulp,
            np.max(np.abs(p_logits - j_logits), axis=-1) / ulp)


def _vq_margin(j_in: np.ndarray, p_in: np.ndarray,
               centroids: np.ndarray) -> tuple:
    """Per mask value: the distance of JAX's VQ input from the nearest
    boundary between two centroids (where its two best distances are
    equal), and the two packages' disagreement on the input, both in bf16
    ulps of JAX's input."""
    j_in, p_in = (np.asarray(a, np.float64) for a in (j_in, p_in))
    c = np.sort(np.asarray(centroids, np.float64))
    mids = (c[:-1] + c[1:]) / 2
    ulp = bf16_ulp(j_in)
    return (np.min(np.abs(j_in[..., None] - mids), axis=-1) / ulp,
            np.abs(p_in - j_in) / ulp)


@pytest.fixture(scope="module", autouse=True)
def ahead():
    """The JAX programs on two threads, the whole forwards first."""
    jobs = ([(_jax_whole, name, bf16) for name in VARIANTS
             for bf16 in (True, False)]
            + [(_jax_module, name) for name in MODULES]
            + [(_jax_ties,)])
    with AHEAD.start(jobs, threads=2):
        yield AHEAD


def _say(*parts):
    print(*parts, flush=True)


@pytest.mark.parametrize("name", MODULES)
def test_module_rounds_as_flax(name):
    """Each module's bf16 output on the same bf16 input and parameters
    against flax's (with XLA's excess precision off)."""
    want = AHEAD(_jax_module, name)
    got = _port_module(name)
    share, ulps, report = _module_agreement(got, want)
    _say(f"{name}: {report} (bit-equal share / worst ulps at the row's "
         f"scale)")
    assert share >= SHARE and ulps <= ULPS


def test_cudnn_style_lstm_misses():
    """An LSTM that keeps the cell and the gates in float32 and rounds its
    output once (what cuDNN computes from bf16 weights) misses the bar
    that the port's bf16 step loop holds."""
    from sincformer_tpu_torch.agents.cpea import FlaxBiLSTM
    want = AHEAD(_jax_module, "cpea lstm")
    model = copy.deepcopy(_port16("lstm"))
    lstm = model.cpea.lstm

    def f32_cell(self, x):
        with torch.no_grad():
            f32 = copy.deepcopy(self).float()
            return FlaxBiLSTM.forward(f32, x.float()).to(x.dtype)
    lstm.forward = f32_cell.__get__(lstm)
    share, ulps, report = _module_agreement(_port_module("cpea lstm", model),
                                            want)
    _say(f"cpea with an f32-cell LSTM: {report}")
    assert share < SHARE or ulps > ULPS


def test_single_rounding_gelu_misses(monkeypatch):
    """A PerceptionAgent whose GELU rounds once (``F.gelu`` in bf16)
    misses the bar that the expanded GELU holds."""
    import torch.nn.functional as F

    from sincformer_tpu_torch.agents import perception
    want = AHEAD(_jax_module, "pa front gelu")
    monkeypatch.setattr(perception, "gelu",
                        lambda x: F.gelu(x, approximate="tanh"))
    share, ulps, report = _module_agreement(_port_module("pa front gelu"),
                                            want)
    _say(f"pa with a single-rounding GELU: {report}")
    assert share < SHARE or ulps > ULPS


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_whole_forward(variant):
    """The narrow forward of ``variant`` in bf16: the decisions off
    near-ties, then the enhanced spectrum's noise and cross on the frames
    whose route agrees."""
    j16, j32 = AHEAD(_jax_whole, variant, True), AHEAD(_jax_whole, variant,
                                                       False)
    vq_in, vq_idx = j16["vq_in"], j16["vq_idx"]
    got = _port_whole(variant)
    model = _port16(variant)

    # a decision is a near-tie where JAX's two best candidates are within
    # TIE_ULPS, or within the two packages' disagreement on the candidates
    # themselves (their inputs decorrelate as a whole network does), that
    # disagreement counted up to APART_CAP
    gap, apart = _maa_margin(j16["logits"], got["logits"])
    maa_tie = gap <= np.clip(apart, TIE_ULPS, APART_CAP)
    maa_flip = got["decisions"] != j16["decisions"]
    gap_vq, apart_vq = _vq_margin(vq_in, got["vq_in"],
                                  _np(model.vq.centroids))
    vq_tie = gap_vq <= np.clip(apart_vq, TIE_ULPS, APART_CAP)
    vq_flip = got["vq_idx"] != vq_idx
    mem_flip = got["memory_top"] != j16["memory_top"]
    _say(f"{variant}: MAA flips {int(maa_flip.sum())} of {maa_flip.size} "
         f"({int((maa_flip & (gap <= TIE_ULPS)).sum())} within "
         f"{TIE_ULPS:g} ulps; JAX's gaps at flips {gap[maa_flip].tolist()}, "
         f"the logits apart there {apart[maa_flip].tolist()} ulps); VQ flips "
         f"{int(vq_flip.sum())} of {vq_flip.size} "
         f"({int((vq_flip & (gap_vq <= TIE_ULPS)).sum())} within "
         f"{TIE_ULPS:g} ulps of a boundary, the farthest "
         f"{float(gap_vq[vq_flip].max(initial=0)):.2f}); memory top flips "
         f"{int(mem_flip.sum())}")
    assert not (maa_flip & ~maa_tie).any()
    assert not (vq_flip & ~vq_tie).any()
    assert not mem_flip.any()
    assert maa_flip.sum() <= round((1 - KEPT) * maa_flip.size)
    assert vq_flip.sum() <= round((1 - KEPT) * vq_flip.size)

    # the spectrum where the route agrees (a VQ flip reaches the spectrum
    # only through a HARD route)
    t = got["decisions"].shape[1]
    hard_flip = (vq_flip.any(axis=-1) & (j16["decisions"] == 2))
    keep = ~(maa_flip | hard_flip)
    for k in ("enhanced_real", "enhanced_imag"):
        sel = [x[:, :t][keep] for x in (got[k], j16[k], j32[k])]
        noise, cross = ratios(*sel)
        share = float(np.mean(sel[0] == sel[1]))
        _say(f"{variant} {k}: noise {noise:.4f}, cross {cross:.4f}, "
             f"{share:.5f} bit-equal to JAX bf16 on {int(keep.sum())} of "
             f"{keep.size} frames")
        assert NOISE[0] <= noise <= NOISE[1] and cross <= CROSS
    assert keep.sum() >= round(KEPT * keep.size)
    assert got["enhanced_real"].dtype == np.float32


# ── planted ties ────────────────────────────────────────────────────────

def _tie_inputs():
    """MAA parameters whose logits tie exactly between classes 1 and 2
    (the largest), VQ centroids with a repeated value and a value midway
    between two, memory keys with a repeated row."""
    rng = np.random.default_rng(31)
    h = 64
    maa = {"threshold": np.array([0.5], np.float32),
           "fc1": {"kernel": rng.standard_normal((1, h)),
                   "bias": rng.standard_normal(h) * 0.1},
           "fc2": {"kernel": rng.standard_normal((h, h)) / 8,
                   "bias": rng.standard_normal(h) * 0.1},
           "fc3": {"kernel": np.zeros((h, 4)),
                   "bias": np.array([0.0, 2.0, 2.0, 1.0])}}
    maa = jax.tree.map(lambda a: np.asarray(a, np.float32), maa)
    sigma = rng.uniform(0.2, 2.0, (2, 1, 8)).astype(np.float32)
    cents = np.array([0.25, 0.75, 0.75], np.float32)
    mask = np.array([0.5, 0.75, 0.9, 0.1, 0.5], np.float32)[None, None]
    d = NARROW["encoder_channels"]
    keys = rng.standard_normal((4, d)).astype(np.float32)
    keys[2] = keys[1]
    return maa, sigma, cents, mask, keys


def _jax_ties():
    from sincformer_tpu.agents.maa import MetacognitiveArbitrationAgent
    from sincformer_tpu.models.vq import VectorQuantizer
    maa, sigma, cents, mask, keys = _tie_inputs()
    stats = {"running_mean": np.float32(0.7), "running_var": np.float32(0.2),
             "num_updates": np.int32(1)}
    dec = _jit(lambda v, s: MetacognitiveArbitrationAgent().apply(
        v, s)["decisions"])(_cast({"params": maa, "maa_stats": stats}),
                            _jbf16(sigma))
    idx = _jit(lambda v, x: VectorQuantizer(3).apply(v, x)[1])(
        _cast({"params": {"centroids": cents}}), _jbf16(mask))
    top = _jit(lambda q, k: jnp.argmax(q @ k.T, axis=-1))(
        _jbf16(keys[1:3]), _jbf16(keys))
    return np.asarray(dec), np.asarray(idx), np.asarray(top)


def test_planted_ties_take_the_first_index():
    """Exact ties in bf16: the MAA's decision, the VQ's index and the
    memory's top slot are the first of the tied candidates, in the port
    as in JAX."""
    from sincformer_tpu_torch.agents.maa import MetacognitiveArbitrationAgent
    from sincformer_tpu_torch.agents.memory import _unit
    from sincformer_tpu_torch.models.vq import VectorQuantizer
    maa_p, sigma, cents, mask, keys = _tie_inputs()
    j_dec, j_idx, j_top = AHEAD(_jax_ties)
    maa = MetacognitiveArbitrationAgent()
    with torch.no_grad():
        for name in ("fc1", "fc2", "fc3"):
            getattr(maa, name).weight.copy_(torch.from_numpy(
                maa_p[name]["kernel"].T))
            getattr(maa, name).bias.copy_(torch.from_numpy(
                maa_p[name]["bias"]))
        maa.running_mean.fill_(0.7)
        maa.running_var.fill_(0.2)
        maa = maa.to(torch.bfloat16)
        dec = maa(_bf16(sigma))["decisions"].numpy()
        vq = VectorQuantizer(3)
        vq.centroids.copy_(torch.from_numpy(cents))
        idx = vq.to(torch.bfloat16)(_bf16(mask))[1].numpy()
        k = _bf16(keys)
        sim = _unit(k[1:3]) @ _unit(k).T
        top = torch.argmax(sim, dim=-1).numpy()
    _say(f"ties: MAA {dec.ravel().tolist()} (JAX {j_dec.ravel().tolist()}), "
         f"VQ {idx.ravel().tolist()} (JAX {j_idx.ravel().tolist()}), memory "
         f"{top.tolist()} (JAX {j_top.tolist()})")
    assert (dec == 1).all() and (j_dec == 1).all()
    assert idx.ravel().tolist() == [0, 1, 1, 0, 0] == j_idx.ravel().tolist()
    assert top.tolist() == [1, 1] == j_top.tolist()
