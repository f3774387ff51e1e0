"""The flagship's three variants in the port against the JAX package, on the
CPU in float32 at narrow width: the bidirectional LRU CPEA
(``cpea_impl="ssm"``), the reference-cascade PerceptionAgent
(``pa_impl="reference"``), the dual fine stream (``pa_fine_feats="dual"``)
and ``reference`` + ``ssm`` together. Weights are ``tests/_torch_parity.py``'s
seeded fill of each flax tree (|λ| over the whole [0.9, 0.999] of the LRU's
init), carried over by ``compat.from_jax``.

Bars: modules 1e-5 of their output's scale, max(1, peak |reference|), as in
tests/test_torch_modules.py; module gradients 1e-4 of each leaf's scale,
floored at 1e-4 of the largest (the SincConv cutoffs' true gradient is ~0
in both packages, ROADMAP.md Queue 3); ``enhance_batch`` 1e-4 of the peak
with identical MAA decisions; the int8 export the JAX package's quantized
leaves and scales, and each served value within one int8 step.

Each JAX reference program compiles once per file: the module's fixture
starts them all on two background threads (``tests/_torch_parity.Ahead``)
when its first test runs, and each test waits for the one it needs."""

import functools
import importlib
import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import (NARROW, Ahead, cancelled_biases, max_abs,
                                 narrow_model, wave)

TOL = 1e-5
GRAD_TOL = 1e-4
GRAD_FLOOR = 1e-4
WAVE_TOL = 1e-4
D = NARROW["encoder_channels"]
H = 2 * NARROW["cpea_hidden"]            # the BiLRU's width
VARIANTS = {"ssm": dict(cpea_impl="ssm"),
            "reference": dict(pa_impl="reference"),
            "dual": dict(pa_fine_feats="dual"),
            "reference+ssm": dict(pa_impl="reference", cpea_impl="ssm")}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


AHEAD = Ahead()


def _model(name):
    return narrow_model(**VARIANTS.get(name, {}))


def close(got, ref, tol=TOL) -> bool:
    return max_abs(got, ref) <= tol * max(1.0, float(np.max(np.abs(ref))))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _named(tree):
    """A flax (sub)tree of numpy leaves → {port name: array}."""
    from sincformer_tpu_torch.compat.from_jax import _flatten, _param_leaf
    out = {}
    for path, arr in _flatten(jax.tree.map(np.asarray, tree)).items():
        leaf, value = _param_leaf(path, arr)
        out[".".join(path[:-1] + (leaf,))] = value
    return out


def _is_q_node(node) -> bool:
    return isinstance(node, dict) and set(node) == {"q", "s"}


def _grads_close(got: dict, want: dict) -> list:
    """Leaves whose gradient leaves the bar (of each leaf's scale, floored
    at GRAD_FLOOR of the largest)."""
    floor = GRAD_FLOOR * max(float(np.max(np.abs(g))) for g in want.values())
    assert set(got) == set(want)
    return [k for k, w in want.items()
            if max_abs(got[k], w) > GRAD_TOL * max(float(np.max(np.abs(w))),
                                                   floor)]


# ── the scan ───────────────────────────────────────────────────────────────

def _recurrence(seed, t, dtype):
    """λ (H,) and b (2, T, H) as real pairs, |λ| in [0.9, 0.999]."""
    rng = np.random.default_rng(seed)
    mag = rng.uniform(0.9, 0.999, 16)
    theta = rng.uniform(1e-4, np.pi / 4, 16)
    b = rng.standard_normal((2, 2, t, 16))
    return [np.broadcast_to(x, (2, t, 16)).astype(dtype) for x in
            (mag * np.cos(theta), mag * np.sin(theta))] + [
                b[0].astype(dtype), b[1].astype(dtype)]


@pytest.mark.parametrize("t", [1, 2, 3, 400, 401])
def test_associative_scan_equals_sequential_loop(t):
    """float64: the port's scan of the LRU's combine equals the plain
    recurrence h_t = λ·h_{t-1} + b_t to 1e-12 of its scale, at lengths of
    no, one and several levels, odd and even."""
    from sincformer_tpu_torch.agents.ssm import _combine, associative_scan
    lr, li, br, bi = (_t(x) for x in _recurrence(t, t, np.float64))
    _, _, hr, hi = associative_scan(_combine, (lr, li, br, bi))
    want_r, want_i = torch.zeros_like(br), torch.zeros_like(bi)
    h_r = h_i = torch.zeros_like(br[:, 0])
    for k in range(t):
        h_r, h_i = (lr[:, k] * h_r - li[:, k] * h_i + br[:, k],
                    lr[:, k] * h_i + li[:, k] * h_r + bi[:, k])
        want_r[:, k], want_i[:, k] = h_r, h_i
    scale = float(max(want_r.abs().max(), want_i.abs().max()))
    assert float((hr - want_r).abs().max()) <= 1e-12 * scale
    assert float((hi - want_i).abs().max()) <= 1e-12 * scale


# ── modules ────────────────────────────────────────────────────────────────

def _lru_jax():
    """The JAX package's first forward and backward LRU layers of the
    narrow BiLRU over one (2, 400, H) input, one compile for both."""
    from sincformer_tpu.agents.ssm import LRULayer
    _, v, _ = _model("ssm")
    bilru = v["params"]["cpea"]["bilru"]
    x = np.random.default_rng(400).standard_normal((2, 400, H)).astype(
        np.float32)
    fwd, bwd = (LRULayer(H, 128, reverse=r) for r in (False, True))
    ys = jax.jit(lambda p, q, x: (fwd.apply({"params": p}, x),
                                  bwd.apply({"params": q}, x)))(
        bilru["lru_fwd_0"], bilru["lru_bwd_0"], x)
    return x, [np.asarray(y) for y in ys]


@pytest.mark.parametrize("t", [51, 400])
@pytest.mark.parametrize("reverse", [False, True])
def test_lru_layer(reverse, t):
    """Each direction of the first layer, at the narrow slice's 51 frames
    and at 400 (4 s): the error that |λ| up to 0.999 carries along the
    sequence stays within the bar. The JAX layers run once, at 400 frames:
    a forward layer's first 51 outputs are its outputs over the first 51
    inputs, a backward layer's last 51 those over the last 51."""
    _, _, tm = _model("ssm")
    x, refs = AHEAD(_lru_jax)
    frames = slice(400 - t, None) if reverse else slice(0, t)
    with torch.no_grad():
        got = getattr(tm.cpea.bilru, f"lru_{'bwd' if reverse else 'fwd'}_0")(
            _t(np.ascontiguousarray(x[:, frames])))
    assert close(got, refs[reverse][:, frames])


def _bilru_jax(t):
    """The JAX BiLRU's output and its gradients (parameters and input) for
    the cotangent of _bilru_inputs, and the JAX ssm CPEA's four heads over
    the channels-first _cpea_input, one compile for both."""
    from sincformer_tpu.agents.cpea import CorrelationPhaseEstimationAgent
    from sincformer_tpu.agents.ssm import BiLRU
    _, v, _ = _model("ssm")
    x, cot = _bilru_inputs(t)
    mod = BiLRU(D, NARROW["cpea_hidden"], 2)
    cpea = CorrelationPhaseEstimationAgent(D, NARROW["cpea_hidden"], 2,
                                           NARROW["cpea_channels"],
                                           impl="ssm")

    def f(params, x):
        y = mod.apply({"params": params}, x)
        return jnp.sum(y * cot), y

    def both(cpea_params, x, z):
        grad = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            cpea_params["bilru"], x)
        return grad, cpea.apply({"params": cpea_params}, z,
                                channels_first=True)
    ((_, y), grads), heads = jax.jit(both)(v["params"]["cpea"], x,
                                           _cpea_input(t))
    return (np.asarray(y), _named(grads[0]), np.asarray(grads[1]),
            {k: np.asarray(h) for k, h in heads.items()})


def _cpea_input(t):
    return np.random.default_rng(4).standard_normal((2, D, t)).astype(
        np.float32)


def _bilru_inputs(t):
    rng = np.random.default_rng(30 + t)
    return (rng.standard_normal((2, t, D)).astype(np.float32),
            rng.standard_normal((2, t, H)).astype(np.float32))


def _bilru_port(t):
    _, _, tm = _model("ssm")
    x, cot = (_t(a) for a in _bilru_inputs(t))
    x.requires_grad_(True)
    mod = tm.cpea.bilru
    y = mod(x)
    params = dict(mod.named_parameters())
    grads = torch.autograd.grad((y * cot).sum(), [x, *params.values()])
    return y.detach(), dict(zip(params, grads[1:])), grads[0]


def test_bilru_forward():
    """Both layers, both directions, the GLU mixing, at the narrow slice's
    51 frames (the scan at 400: test_lru_layer)."""
    y, _, _ = _bilru_port(51)
    ref = AHEAD(_bilru_jax, 51)[0]
    assert close(y, ref)


def test_bilru_gradients():
    """The gradients of Σ y·c through the scan, for every parameter (in
    the port's names) and the input."""
    _, grads, gx = _bilru_port(51)
    _, want, want_x, _ = AHEAD(_bilru_jax, 51)
    assert not _grads_close(grads, want)
    assert close(gx, want_x, GRAD_TOL)


def test_cpea_ssm():
    """``CorrelationPhaseEstimationAgent(impl="ssm")``: the BiLRU under the
    four heads, channels-first latent in."""
    _, _, tm = _model("ssm")
    ref = AHEAD(_bilru_jax, 51)[3]
    with torch.no_grad():
        got = tm.cpea(_t(_cpea_input(51)))
    for key in ("rho_s", "rho_n", "phi1", "phi2"):
        assert close(got[key], ref[key]), key


PA_LENGTHS = (8000, 3993)     # 1 s, and a length ≢ 0 mod 16
PA_GRAD_LENGTH = 3993


def _reference_pa_jax():
    """The JAX cascade in float64 (``jax.enable_x64``, parameters and input
    cast), one compile: {N: its (z_real, z_imag, σ)} at every PA_LENGTHS,
    and at PA_GRAD_LENGTH the gradients of their weighted sum for the
    parameters."""
    from sincformer_tpu.agents.perception import PerceptionAgent
    _, v, _ = _model("reference")
    mod = PerceptionAgent(D, 8000, NARROW["sinc_kernel_size"], 80)
    cots = _pa_inputs(PA_GRAD_LENGTH)[1]

    def f(params, x):
        outs = mod.apply({"params": params}, x)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), outs

    def program(params, xs):
        outs = {n: mod.apply({"params": params}, x) for n, x in xs.items()
                if n != PA_GRAD_LENGTH}
        (_, outs[PA_GRAD_LENGTH]), g = jax.value_and_grad(
            f, has_aux=True)(params, xs[PA_GRAD_LENGTH])
        return outs, g
    with jax.enable_x64(True):
        params = jax.tree.map(lambda a: np.asarray(a, np.float64),
                              v["params"]["pa"])
        outs, g = jax.jit(program)(params, {
            n: _pa_inputs(n)[0].astype(np.float64) for n in PA_LENGTHS})
        return ({n: [np.asarray(o) for o in out] for n, out in outs.items()},
                _named(g))


def _pa_inputs(n):
    frames = -(-n // 16) // 5
    rng = np.random.default_rng(n)
    return wave(n % 97, (2, n)), [
        rng.standard_normal((2, c, frames)).astype(np.float32)
        for c in (D, D, 1)]


@pytest.mark.parametrize("n", PA_LENGTHS)
def test_reference_perception_agent(n):
    """The stride-2 cascade at 1 s and at a length ≢ 0 mod 16, where flax's
    SAME padding of the stride-2 convs is asymmetric: floor(ceil(N / 16) /
    5) frames, every output within the bar of the JAX cascade computed in
    float64. The cascade is ill-conditioned for float32 at 8 kHz: each
    GroupNorm of one channel per group divides by that channel's spread,
    and the two float32 packages land 1.1-1.2e-5 of the scale apart at
    N = 8000, the port 0.8-0.9e-5 from float64 and JAX 1.3-1.6e-5 (with
    flax's E[x²] - E[x]² variance in the port too, just as far); held
    against float64, the port meets the bar."""
    _, _, tm = _model("reference")
    x, _ = _pa_inputs(n)
    with torch.no_grad():
        got = tm.pa(_t(x))
    ref = AHEAD(_reference_pa_jax)[0][n]
    assert got[0].shape[-1] == -(-n // 16) // 5
    for g, r in zip(got, ref):
        assert max_abs(g, r) <= TOL * max(1.0, float(np.max(np.abs(r))))


def test_reference_perception_agent_gradients():
    """Gradients of the cascade's weighted outputs for every parameter, at
    N = 3993, against JAX's in float64. A conv bias in front of a GroupNorm of one channel per group
    (the narrow blocks 0 and 1) is removed by the group's mean: its true
    gradient is 0, and both packages return rounding there, held below
    1e-4 of the largest gradient in each."""
    _, _, tm = _model("reference")
    x, cots = _pa_inputs(PA_GRAD_LENGTH)
    params = dict(tm.pa.named_parameters())
    outs = tm.pa(_t(x))
    grads = dict(zip(params, torch.autograd.grad(
        sum((o * _t(c)).sum() for o, c in zip(outs, cots)),
        list(params.values()))))
    want = dict(AHEAD(_reference_pa_jax)[1])
    zero = cancelled_biases(tm.pa)
    assert zero and zero <= set(want)
    largest = max(float(np.max(np.abs(g))) for g in want.values())
    for k in zero:
        for g in (grads.pop(k).numpy(), want.pop(k)):
            assert float(np.max(np.abs(g))) <= GRAD_FLOOR * largest, k
    assert not _grads_close(grads, want)


def _dual_pa_jax():
    from sincformer_tpu.agents.perception import PerceptionAgentMXU
    _, v, _ = _model("dual")
    return [np.asarray(o) for o in jax.jit(PerceptionAgentMXU(
        D, 8000, NARROW["sinc_kernel_size"], 80, fine_act="mulaw",
        fine_feats="dual").apply)({"params": v["params"]["pa"]},
                                  _dual_pa_input())]


def _dual_pa_input():
    return wave(5, (2, 4000))


def test_dual_perception_agent():
    """``PerceptionAgentMXU(fine_feats="dual")``: the per-frame normalised
    chunks through ``embed_norm`` added before ``embed_ln``."""
    _, _, tm = _model("dual")
    with torch.no_grad():
        got = tm.pa(_t(_dual_pa_input()))
    for g, r in zip(got, AHEAD(_dual_pa_jax)):
        assert close(g, r)


# ── the slice: enhancement through the pipeline ────────────────────────────

def _mixture(n, seed=40):
    from tests._torch_parity import speechlike
    return np.stack([speechlike(seed + i, n) for i in range(2)])


_DSP = []
_DSP_LOCK = threading.Lock()


def _jax_dsp():
    """JAX's centred STFT and iSTFT at the pipeline's framing, jitted once
    for every variant, whichever thread asks first."""
    from sincformer_tpu.dsp.stft import istft, stft
    with _DSP_LOCK:
        if not _DSP:
            _DSP.extend((jax.jit(lambda wav: stft(wav, 256, 80, 160)),
                         jax.jit(lambda r, i: istft(r + 1j * i, 256, 80,
                                                    160, length=3993))))
    return _DSP


def _enhance_jax(name):
    """What the JAX pipeline's ``_enhance_fn`` computes (the centred STFT,
    the model at train=False, the iSTFT) for the float _mixture(3993), and
    the routing; the STFT and iSTFT are jitted apart from the model (one
    program each for every variant)."""
    model, variables, _ = _model(name)
    x = _mixture(3993)
    stft, istft = _jax_dsp()
    spec = stft(x)
    out = jax.jit(lambda v, w, r, i: model.apply(v, w, r, i, train=False))(
        variables, x, spec.real, spec.imag)
    enh = istft(out["enhanced_real"], out["enhanced_imag"])
    return np.asarray(enh), np.asarray(out["decisions"])


def _port_pipeline(name):
    from sincformer_tpu_torch import (SincformerMetacog, SincformerPipeline,
                                      load_from_jax)
    _, v, _ = _model(name)
    state, buffers, config = load_from_jax(
        v, num_heads=NARROW["num_heads"],
        sinc_kernel_size=NARROW["sinc_kernel_size"])
    pipe = SincformerPipeline(SincformerMetacog(config), device="cpu")
    pipe.load_state(state, buffers)
    return pipe


@pytest.mark.parametrize("name", list(VARIANTS))
def test_enhance_batch_matches_jax(name):
    """``SincformerPipeline.enhance_batch`` of two 3,993-sample mixtures
    (≢ 0 mod 16 and mod 80: the PA's frames are cropped and the edge frame
    repeated to the STFT's 50), weights bridged by ``load_from_jax``:
    within 1e-4 of the peak of JAX's enhancement, the same MAA decision on
    every frame."""
    from sincformer_tpu_torch.dsp.stft import stft
    pipe = _port_pipeline(name)
    assert {k: getattr(pipe.model.config, k) for k in VARIANTS[name]} == \
        VARIANTS[name]
    x = _mixture(3993)
    got = pipe.enhance_batch(x)
    want, want_dec = AHEAD(_enhance_jax, name)
    assert got.shape == x.shape and np.all(np.isfinite(got))
    assert np.max(np.abs(got - want)) <= WAVE_TOL * np.max(np.abs(want))
    tx = _t(x)
    spec = stft(tx)
    with torch.no_grad():
        dec = pipe.model(tx, spec.real, spec.imag)["decisions"]
    np.testing.assert_array_equal(dec.numpy(), want_dec)


def test_long_form_and_online_paths_run_the_cascade():
    """``reference`` + ``ssm`` served as ``serve.py`` serves any pipeline:
    ``StreamingEnhancer``'s whole-file and segmented paths over a 6,000-
    sample signal in windows of 2,000 (each window's GroupNorms take that
    window's statistics, as in JAX) agree within 1e-4 of the peak, and the
    ``OnlineEnhancer``'s 20 ms chunks (a 1,600-sample context) come back
    sample-aligned and finite."""
    from sincformer_tpu_torch.serve import OnlineEnhancer, StreamingEnhancer
    pipe = _port_pipeline("reference+ssm")
    x = _mixture(6000, seed=70)[0]
    kw = dict(window=2000, overlap=200, chunk_batch=1)
    whole = StreamingEnhancer(pipe, pipelined=False, **kw).enhance(x)
    seg = StreamingEnhancer(pipe, pipelined=True, **kw).enhance(x)
    assert whole.shape == seg.shape == x.shape
    assert np.all(np.isfinite(whole)) and np.all(np.isfinite(seg))
    assert np.max(np.abs(whole - seg)) <= WAVE_TOL * np.max(np.abs(whole))
    oe = OnlineEnhancer(pipe, context=1600)
    parts = [oe.push(x[i:i + oe.chunk]) for i in range(0, 800, oe.chunk)]
    out = np.concatenate(parts + [oe.flush()])
    assert out.shape == (800,) and np.all(np.isfinite(out))


# ── export ─────────────────────────────────────────────────────────────────

def _int8_jax():
    """For ``reference`` + ``ssm``: the JAX package's int8 tree (its
    ``quantize_tree``) and that tree dequantized by its
    ``dequantize_tree``."""
    import sincformer_tpu.ops.quantize as jq
    _, v, _ = _model("reference+ssm")
    params_q = jax.tree.map(np.asarray, jax.jit(jq.quantize_tree)(
        jax.tree.map(jnp.asarray, v["params"])))
    deq = jax.tree.map(np.asarray, jax.jit(jq.dequantize_tree)(
        jax.tree.map(jnp.asarray, params_q)))
    return params_q, deq


def test_int8_export_round_trip(tmp_path):
    """``reference`` + ``ssm``: ``save_model(quantize=True)`` quantizes the
    leaves that the JAX package's export quantizes (the ``{"q", "s"}``
    nodes of its ``quantize_tree``; the LRU's
    B and C along their last axis, as JAX), with JAX's scales
    max(amax, 1e-12) / 127 of each column of ``reshape(-1, shape[-1])``
    (IEEE division is correctly rounded, so numpy's float32 quotient is the
    eager JAX export's bit for bit); ``load_model`` of the export rebuilds
    the variant from its keys, every served weight is within one int8 step
    (its channel's scale) of the float one, and the served enhancement is
    finite."""
    from sincformer_tpu_torch import SincformerPipeline
    from sincformer_tpu_torch.ops.quantize import is_quantized
    from sincformer_tpu_torch.train.state import PAYLOAD
    _, v, _ = _model("reference+ssm")
    q_tree = AHEAD(_int8_jax)[0]
    want_q = {}
    for keys, node in jax.tree_util.tree_flatten_with_path(
            q_tree, is_leaf=_is_q_node)[0]:
        if not _is_q_node(node):
            continue
        path = tuple(k.key for k in keys)
        leaf = v["params"]
        for k in path:
            leaf = leaf[k]
        mat = np.asarray(leaf, np.float32).reshape(-1, leaf.shape[-1])
        scale = np.maximum(np.max(np.abs(mat), axis=0),
                           np.float32(1e-12)) / np.float32(127.0)
        name = ".".join(path[:-1] + ("weight" if path[-1] == "kernel"
                                     else path[-1],))
        want_q[name] = {"s": torch.from_numpy(scale),
                        "axis": 0 if path[-1] == "kernel" else leaf.ndim - 1}
    assert "cpea.bilru.lru_fwd_0.B_re" in want_q

    pipe = _port_pipeline("reference+ssm")
    pipe.model_dir = str(tmp_path)
    path = pipe.save_model(quantize=True)
    saved = torch.load(os.path.join(path, PAYLOAD), weights_only=True)
    got_q = {k: n for k, n in saved["params_q"].items() if is_quantized(n)}
    assert set(got_q) == set(want_q)
    for k, node in got_q.items():
        assert node["axis"] == want_q[k]["axis"], k
        assert torch.equal(node["s"], want_q[k]["s"]), k

    served = SincformerPipeline(device="cpu", model_dir=str(tmp_path))
    assert served.load_model() == path
    c = served.model.config
    assert (c.pa_impl, c.cpea_impl) == ("reference", "ssm")
    floats = dict(pipe.model.named_parameters())
    for k, p in served.model.named_parameters():
        diff = (p - floats[k]).abs().detach()
        if k in got_q:
            shape = [1] * p.ndim
            axis = got_q[k]["axis"]
            shape[axis] = p.shape[axis]
            assert bool((diff <= got_q[k]["s"].reshape(shape)).all()), k
        else:
            assert float(diff.max()) == 0.0, k
    out = served.enhance_batch(_mixture(4000))
    assert out.shape == (2, 4000) and np.all(np.isfinite(out))


def test_int8_import_of_jax_export():
    """``reference`` + ``ssm``: the JAX package's own int8 tree, carried
    over by ``convert_quantized_from_jax`` (q transposed like its kernel, s
    kept, nothing rounded again; the LRU's B and C as they are, channels
    last), dequantizes to exactly what ``load_from_jax`` makes of the JAX
    package's dequantized tree, and reads as the same variant."""
    from sincformer_tpu_torch.compat.from_jax import (
        convert_quantized_from_jax, load_from_jax)
    from sincformer_tpu_torch.ops.quantize import (dequantize_tree,
                                                   is_quantized)
    _, v, _ = _model("reference+ssm")
    overrides = dict(num_heads=NARROW["num_heads"],
                     sinc_kernel_size=NARROW["sinc_kernel_size"])
    model_state = {k: x for k, x in v.items() if k != "params"}
    params_q, deq = AHEAD(_int8_jax)
    converted, buffers, config = convert_quantized_from_jax(
        params_q, model_state, **overrides)
    assert is_quantized(converted["cpea.bilru.lru_fwd_0.C_im"])
    assert is_quantized(converted["pa.downsample.weight"])
    want, want_buffers, want_config = load_from_jax(
        {"params": deq, **model_state}, **overrides)
    assert config == want_config
    assert (config.pa_impl, config.cpea_impl) == ("reference", "ssm")
    got = dequantize_tree(converted)
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    for name in want_buffers:
        assert torch.equal(buffers[name], want_buffers[name]), name


FULL_WIDTH = {"default": ({}, 15_509_647, 97),
              "ssm": (dict(cpea_impl="ssm"), 15_577_487, 84),
              "reference": (dict(pa_impl="reference"), 8_855_183, 96),
              "dual": (dict(pa_fine_feats="dual"), 20_752_783, 98)}


def _full_width_jax(name):
    """The JAX package's full-width tree of the variant (shapes only:
    ``jax.eval_shape`` of ``default_metacog``'s init): its parameter
    count, and its export's quantized leaves (the ``{"q", "s"}`` nodes of
    ``quantize_tree``'s output) as {port name: channels} with their count
    in JAX's tree."""
    import sincformer_tpu.ops.quantize as jq
    from sincformer_tpu.agents.metacog import SincformerMetacog as JaxModel
    from sincformer_tpu.train.agent_trainer import default_metacog as jax_dm
    from sincformer_tpu_torch.compat.from_jax import _param_leaf
    model = jax_dm(**{"pa_fine_act": "mulaw", "pa_fine_feats": "single",
                      "pa_impl": "mxu", **FULL_WIDTH[name][0]})
    assert isinstance(model, JaxModel)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 800)), jnp.zeros((1, 11, 129)),
        jnp.zeros((1, 11, 129)), train=False))["params"]
    q_tree = jax.eval_shape(jq.quantize_tree, shapes)
    nodes = jax.tree_util.tree_flatten_with_path(q_tree,
                                                 is_leaf=_is_q_node)[0]
    jax_q = {}
    for keys, node in nodes:
        if not isinstance(node, dict):
            continue
        path = tuple(k.key for k in keys)
        if path[1].startswith("LSTMCell_"):       # the port stacks gates
            layer, direction = divmod(int(path[1].split("_")[1]), 2)
            side = "ih" if path[2][0] == "i" else "hh"
            name_ = (f"cpea.lstm.{'weight' if side == 'ih' else 'kernel'}"
                     f"_{side}_l{layer}{'_reverse' if direction else ''}")
            jax_q[name_] = jax_q.get(name_, 0) + node["s"].shape[0]
        else:
            leaf, _ = _param_leaf(path, np.zeros(node["q"].shape))
            jax_q[".".join(path[:-1] + (leaf,))] = node["s"].shape[0]
    return (sum(x.size for x in jax.tree.leaves(shapes)), jax_q,
            sum(isinstance(n, dict) for _, n in nodes))


@pytest.mark.parametrize("name", list(FULL_WIDTH))
def test_full_width_quantized_leaves_match_jax(name):
    """At full width, the leaves the JAX export quantizes are the port's
    ``work_table`` leaves: the same names, one for one but the BiLSTM,
    whose four gate kernels of a direction are one stacked port leaf
    (quantized when they are), and each with the same number of
    channels; the parameter and leaf counts are the JAX tree's."""
    from sincformer_tpu_torch import MetacogConfig, SincformerMetacog
    from sincformer_tpu_torch.ops.quantize import work_table
    variant, n_params, n_leaves = FULL_WIDTH[name]
    assert AHEAD(_full_width_jax, name)[::2] == (n_params, n_leaves)
    with torch.device("meta"):
        port = SincformerMetacog(MetacogConfig(**variant))
    entries = work_table({k: tuple(p.shape)
                          for k, p in port.named_parameters()})[0]
    port_q = {e.name: (e.rows if e.axis == 0 else e.cols) for e in entries}
    assert port_q == AHEAD(_full_width_jax, name)[1]


# ── autodetection, the environment, the CLI ────────────────────────────────

@pytest.mark.parametrize("name", ["default", *VARIANTS])
def test_infer_config_reads_the_variant(name):
    """``infer_config`` reads each variant off the flax tree (``bilru``,
    ``downsample``, ``embed_norm``, ``act_mu``) with its sizes."""
    from sincformer_tpu_torch.compat.from_jax import infer_config
    variant = VARIANTS.get(name, {})
    _, v, tm = narrow_model(**variant)
    config = infer_config(v, num_heads=NARROW["num_heads"],
                          sinc_kernel_size=NARROW["sinc_kernel_size"])
    want = {"pa_impl": "mxu", "cpea_impl": "lstm", "pa_fine_feats": "single",
            "pa_fine_act": "mulaw", **variant}
    assert {k: getattr(config, k) for k in want} == want
    assert config == tm.config
    assert (config.encoder_channels, config.cpea_hidden,
            config.cpea_layers) == (D, NARROW["cpea_hidden"], 2)


def test_tree_that_fits_no_variant_raises():
    """Only a tree that fits no variant raises, and says what it found."""
    from sincformer_tpu_torch.compat.from_jax import load_from_jax
    for name, part, drop in (("reference+ssm", "cpea", "bilru"),
                             ("reference+ssm", "pa", "downsample"),
                             ("default", "cpea", "LSTMCell_")):
        _, v, _ = narrow_model(**VARIANTS.get(name, {}))
        params = {**v["params"], part: {k: x for k, x in
                                        v["params"][part].items()
                                        if not k.startswith(drop)}}
        with pytest.raises(ValueError, match="fit no SincformerMetacog"):
            load_from_jax({**v, "params": params},
                          num_heads=NARROW["num_heads"],
                          sinc_kernel_size=NARROW["sinc_kernel_size"])


@pytest.mark.parametrize("name", list(VARIANTS))
def test_load_model_takes_the_variant_from_the_keys(name, tmp_path):
    """A checkpoint of each variant served by a default pipeline: the model
    is rebuilt as the weights' keys show (also where the sidecar does not
    record it, as in a checkpoint written before the variants), and it
    serves the saved model's numbers; a sidecar that names another
    variant than the keys raises."""
    from sincformer_tpu_torch import SincformerPipeline
    from sincformer_tpu_torch.train.state import read_step_meta
    pipe = _port_pipeline(name)
    pipe.model_dir = str(tmp_path)
    path = pipe.save_model()
    meta_path = path.rstrip(os.sep) + ".meta.json"
    meta = read_step_meta(path)
    for k in ("pa_impl", "cpea_impl", "pa_fine_feats"):
        meta["config"].pop(k)
    json.dump(meta, open(meta_path, "w"))
    served = SincformerPipeline(device="cpu", model_dir=str(tmp_path))
    assert served.load_model() == path
    assert served.model.config == pipe.model.config
    x = _mixture(4000, seed=50)
    np.testing.assert_array_equal(served.enhance_batch(x),
                                  pipe.enhance_batch(x))
    wrong = ("mxu" if pipe.model.config.pa_impl == "reference"
             else "reference")
    meta["config"]["pa_impl"] = wrong
    json.dump(meta, open(meta_path, "w"))
    with pytest.raises(ValueError, match="other variants"):
        SincformerPipeline(device="cpu", model_dir=str(tmp_path)).load_model()


def test_environment_selects_the_fine_stream_as_in_jax(monkeypatch):
    """``SINCFORMER_PA_FINE_ACT=gelu SINCFORMER_PA_FINE_FEATS=dual``: a
    process of the port (the variables read at import, as the JAX package
    reads them) builds with ``default_metacog`` the model the JAX package's
    ``default_metacog`` builds under the same variables: the same variant
    fields and the same parameter shapes, leaf for leaf."""
    from sincformer_tpu import config as jax_cfg
    from sincformer_tpu.train.agent_trainer import default_metacog as jax_dm
    from sincformer_tpu_torch.compat.from_jax import load_from_jax
    env = {"SINCFORMER_PA_FINE_ACT": "gelu",
           "SINCFORMER_PA_FINE_FEATS": "dual"}
    for k, val in env.items():
        monkeypatch.setenv(k, val)
    sizes = {k: NARROW[k] for k in ("encoder_channels", "cpea_hidden",
                                    "cpea_channels", "d_model", "msa_blocks",
                                    "num_heads", "d_ff", "kernel_size",
                                    "memory_slots", "episodic_slots",
                                    "sinc_kernel_size")}
    code = ("import json\n"
            "from sincformer_tpu_torch.train.agent_trainer import "
            "default_metacog\n"
            f"m = default_metacog(**{sizes!r})\n"
            "print(json.dumps({'config': {k: getattr(m.config, k) for k in "
            "('pa_impl', 'pa_fine_act', 'pa_fine_feats', 'cpea_impl')}, "
            "'shapes': {k: list(v.shape) for k, v in "
            "m.state_dict().items()}}))\n")
    # the port's process runs beside JAX's shapes
    with subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                          env={**os.environ, "PYTHONPATH": REPO},
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          text=True) as proc:
        jax_model = jax_dm(agcfg=jax_cfg.AgentConfig(), **sizes)
        assert (jax_model.pa_fine_act, jax_model.pa_fine_feats) == ("gelu",
                                                                    "dual")
        spec = jnp.zeros((1, 11, 129))
        shapes = jax.eval_shape(lambda: jax_model.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 800)), spec, spec,
            train=False))
        variables = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                 dict(shapes))
        state, buffers, _ = load_from_jax(variables,
                                          num_heads=NARROW["num_heads"],
                                          sinc_kernel_size=NARROW[
                                              "sinc_kernel_size"])
        want = {k: list(v.shape) for k, v in {**state, **buffers}.items()}
        out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-2000:]
    port = json.loads(out.strip().splitlines()[-1])
    assert port["config"] == {k: getattr(jax_model, k)
                              for k in port["config"]}
    assert port["shapes"].keys() == want.keys()
    assert port["shapes"] == {k: want[k] for k in port["shapes"]}


def test_info_names_each_checkpoints_variant(tmp_path, monkeypatch, capsys):
    """``info`` lists the flagship checkpoints under the model directory
    with the variant their weights show."""
    from sincformer_tpu_torch import cli
    pipe = _port_pipeline("reference+ssm")
    pipe.model_dir = str(tmp_path)
    pipe.save_model("best_sincformer")
    monkeypatch.setenv("SINCFORMER_MODEL_DIR", str(tmp_path))
    assert cli.main(["info", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    line = next(x for x in out.splitlines() if "best_sincformer:" in x)
    assert "cpea_impl ssm" in line and "pa_impl reference" in line
    assert cli._MISSING == ""


@pytest.mark.gpu
def test_variants_forward_on_the_card():
    """Needs a CUDA card and nvcc: each variant's forward on the card
    launches K1 once per Conformer block and gives the CPU's enhancement
    within 1e-4 of the peak."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU mode")
    from sincformer_tpu_torch import SincformerPipeline
    from sincformer_tpu_torch.ops.speech_attention import speech_attention
    x = _mixture(3993)
    for name in VARIANTS:
        cpu = _port_pipeline(name)
        card = SincformerPipeline(type(cpu.model)(cpu.model.config),
                                  device="cuda")
        card.model.load_state_dict(cpu.model.state_dict())
        before = speech_attention.launches
        got = card.enhance_batch(x)
        assert speech_attention.launches - before == NARROW["msa_blocks"]
        want = cpu.enhance_batch(x)
        assert np.max(np.abs(got - want)) <= WAVE_TOL * np.max(np.abs(want))


@pytest.fixture(scope="module", autouse=True)
def _references_ahead():
    """The JAX references of this file, started when its first test runs,
    in the order the tests use them. The modules they use are imported
    here first: two threads importing one package at once can fail."""
    for module in ("sincformer_tpu.agents.metacog", "sincformer_tpu.dsp.stft",
                   "sincformer_tpu.ops.quantize",
                   "sincformer_tpu.train.agent_trainer",
                   "sincformer_tpu_torch.agents.metacog",
                   "sincformer_tpu_torch.compat.from_jax"):
        importlib.import_module(module)
    jobs = [(_lru_jax,), (_bilru_jax, 51), (_reference_pa_jax,),
            (_dual_pa_jax,), *((_enhance_jax, n) for n in VARIANTS),
            (_int8_jax,), *((_full_width_jax, n) for n in FULL_WIDTH)]
    with AHEAD.start(jobs):
        yield
