"""bf16 DCSE in the port against the JAX package, on the CPU: kernels K1
and K3's plain bf16 versions against JAX's references, their backwards,
each Conformer module on the same bf16 input, the training forward and its
gradients against ``DCSEPipeline._loss_fn`` with ``compute_dtype=
jnp.bfloat16`` at narrow width (``"layer"``, ``"batch"``, fused), one AdamW
step, the eval step, and the full-width forward as ``bench.py`` runs it.

Every JAX bf16 program here is compiled with XLA's excess precision off
(``xla_allow_excess_precision=False``): with it on, XLA keeps bf16
intermediates in f32 inside its fusions wherever its fusion plan puts them
(a Dense reads a LayerNorm's unrounded output), so JAX's bf16 result
depends on the compiler's fusions (``test_excess_precision_skips_roundings``).
With it off every bf16 operation of the jaxpr rounds, and the port, which
rounds where the jaxpr does, gives every module's output bit for bit on the
same input (``test_modules_round_as_flax``).

Bars (``tests/_torch_bf16.py`` for the terms):
  * K1, K3 against JAX's references: at least 99 % of the elements
    bit-equal and every element within one bf16 ulp at its term scale; a
    planted K1 that keeps P in f32 misses. JAX's own Pallas K1 in interpret
    mode rounds the unnormalised P (it divides after P.V): the port is
    held to be as close to it as JAX's reference is.
  * The backwards against ``jax.vjp`` of the references in bf16: each
    gradient's distance from JAX's bf16 gradient at most 0.5x JAX's bf16
    distance from its f32 gradient.
  * Modules: each one's bf16 output at least 99 % bit-equal to flax's on
    the same bf16 input and parameters (the fused feed-forward's training
    branch too, at a dropout rate that keeps every element: JAX's own
    LayerNorm math there, bf16 statistics); a BatchNorm that takes its
    statistics in bf16 misses.
  * The training forward of the narrow model: the loss within 2^-10 of
    JAX's bf16 loss (relative: a quarter of a bf16 ulp); the enhanced
    waveform's noise in [0.5, 2] and cross at most 1; each gradient leaf's
    noise in [0.3, 2.5] and cross at most 1.5, the median over leaves of
    the noise in [0.7, 1.4] and of the cross at most 1. A cross of at most
    0.5 for the loss and every leaf is out of reach: the whole network's bf16
    results decorrelate after the first element that the two libraries'
    f32 sums round apart (``_torch_bf16``), and torch's autograd rounds its
    bf16 backward at other points than JAX's transposes: the gradients'
    crosses measured 0.24-1.15, the waveform's 0.00-0.80.
    Parameters left f32 with only the inputs cast (the planted fault)
    give a noise median of about 0.2 and miss. The depthwise convolution's
    bias in front of a training BatchNorm has a gradient of zero in exact
    arithmetic and is left out, as in ``tests/test_torch_dcse_train.py``.
  * One AdamW step from the same float32 masters with each package's bf16
    gradients: the masters within 1e-5 of their scale where the two
    gradients agree in sign and both pass 1e-4 of the leaf's largest
    (AdamW's first step is lr times the gradient's sign there); the other
    elements at most 1 % of all.
  * The eval step: loss and SI-SNR within 2^-10 relative of JAX's bf16,
    the log-gain sum within 2^-10 per utterance, the counts equal. (A
    scalar's cross is a ratio of two small chance deviations, printed: the
    training loss's measured 0.49-4.1, JAX's bf16 loss 2e-5 to 1.3e-4 from
    its f32 one.)
  * The full-width forward (d 256, 4 blocks, 51 frames, every variable
    cast as ``bench.py:105-113`` casts it): each output's noise in
    [0.5, 2] and cross at most 1.2 (four blocks decorrelate further than
    the narrow two: measured 0.92-0.96).

The gradients and the step are held without the multi-resolution STFT
term, as ``tests/test_torch_dcse_train.py`` holds them (ROADMAP.md Queue
3). The JAX programs run on ``Ahead`` threads from the start of the file."""

import functools
import tempfile
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tests.test_torch_dcse_train as dcse_train
from tests._torch_bf16 import (agreement, attention_p_in_f32,
                               attention_scale, distance, ffn_scale, ratios)
from tests._torch_parity import NARROW_DCSE, Ahead, _fill

NOEX = {"xla_allow_excess_precision": False}
SHARE = 0.99           # bit-equal elements of a kernel or a module
ULPS = 1.0             # worst element, bf16 ulps at its term scale
LOSS_REL = 2.0 ** -10  # a quarter of a bf16 ulp, relative
PARAM_TOL = 1e-5
GRAD_TOL = 1e-4
AHEAD = Ahead()

# (B, T, H, dh, masked)
K1_CASES = [(2, 401, 4, 64, True), (2, 401, 4, 64, False),
            (2, 37, 4, 16, True), (2, 37, 4, 32, False),
            (2, 1, 4, 128, False), (2, 37, 2, 128, True)]
# (rows, d, d_ff)
K3_CASES = [(1, 256, 1024), (401, 256, 1024), (1604, 256, 1024),
            (130, 32, 64)]
MODULES = ["ff", "ff fused", "ff fused dropout", "mhsa", "conv layer",
           "conv group", "conv batch train", "conv batch eval"]
# a dropout rate whose masks keep every element and whose scale 1 / (1 -
# rate) rounds to 1 in bf16: the training branch of a module, compared
# without either package's random draws
NO_DROP = 1e-9
DCSE_CASES = [("layer", False), ("batch", False), ("layer", True)]


def _bf16(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16()


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _jit(fn):
    return jax.jit(fn, compiler_options=NOEX)


# ── kernels ─────────────────────────────────────────────────────────────

def _k1_inputs(case):
    b, t, h, dh, masked = case
    rng = np.random.default_rng(100 + t + dh)
    q, k, v = (rng.standard_normal((b, t, h, dh)).astype(np.float32)
               for _ in range(3))
    bias = None
    if masked:
        valid = np.arange(t)[None] < np.array([t, max(1, t - 7)])[:, None]
        bias = np.where(valid, 0.0, -1e9).astype(np.float32)
    return q, k, v, bias


def _jax_k1(case):
    from sincformer_tpu.ops.speech_attention import _reference
    q, k, v, bias = _k1_inputs(case)
    b4 = None if bias is None else jnp.asarray(bias)[:, None, None, :]
    scale = 1.0 / float(case[3]) ** 0.5
    return _np(_jit(lambda a, b_, c: _reference(a, b_, c, b4, scale))(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))))


def _port_k1(case):
    from sincformer_tpu_torch.ops.speech_attention import \
        _speech_attention_plain
    q, k, v, bias = _k1_inputs(case)
    args = (_bf16(q), _bf16(k), _bf16(v),
            None if bias is None else torch.from_numpy(bias))
    return args, _speech_attention_plain(*args)


def _jax_k1_interpret():
    """JAX's Pallas K1 in interpret mode and its reference, bf16, at the
    shape tests/test_torch_speech_attention.py runs it."""
    from sincformer_tpu.ops.speech_attention import (_reference,
                                                     _speech_attention_fwd)
    q, k, v, _ = _k1_inputs((2, 100, 2, 32, False))
    b, t, h, dh = q.shape
    q3, k3, v3 = (jnp.asarray(x, jnp.bfloat16).reshape(b, t, h * dh)
                  for x in (q, k, v))
    pallas = _speech_attention_fwd(q3, k3, v3, jnp.zeros((b, t)),
                                   num_heads=h, sm_scale=1.0 / dh ** 0.5,
                                   interpret=True)
    ref = _jit(lambda a, b_, c: _reference(a, b_, c, None, 1.0 / dh ** 0.5))(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    return _np(pallas).reshape(q.shape), _np(ref)


def _k3_inputs(case):
    m, d, f = case
    rng = np.random.default_rng(200 + m + d)
    arrays = (rng.standard_normal((m, d)), 1.0 + 0.1 * rng.standard_normal(d),
              0.1 * rng.standard_normal(d),
              rng.standard_normal((d, f)) / d ** 0.5,
              0.1 * rng.standard_normal(f),
              rng.standard_normal((f, d)) / f ** 0.5,
              0.1 * rng.standard_normal(d))
    return [np.asarray(a, np.float32) for a in arrays]


def _jax_k3(case):
    from sincformer_tpu.ops.fused_ffn import _ffn_reference
    return _np(_jit(_ffn_reference)(
        *(jnp.asarray(a, jnp.bfloat16) for a in _k3_inputs(case))))


def _jax_k1_vjp():
    """dq, dk, dv of JAX's K1 reference at (2, 401, 4, 64) masked, in bf16
    and in f32, for one seeded cotangent."""
    from sincformer_tpu.ops.speech_attention import _reference
    q, k, v, bias = _k1_inputs(K1_CASES[0])
    cot = np.random.default_rng(300).standard_normal(q.shape)
    b4 = jnp.asarray(bias)[:, None, None, :]
    out = {}
    for dt in (jnp.bfloat16, jnp.float32):
        out[dt] = [_np(g) for g in _jit(lambda a, b_, c, g: jax.vjp(
            lambda *x: _reference(*x, b4, 0.125), a, b_, c)[1](g))(
            *(jnp.asarray(x, dt) for x in (q, k, v, cot)))]
    return out[jnp.bfloat16], out[jnp.float32]


def _jax_k3_vjp():
    """The 7 gradients of JAX's K3 reference at 401 rows of (256, 1024),
    in bf16 and in f32, for one seeded cotangent."""
    from sincformer_tpu.ops.fused_ffn import _ffn_reference
    args = _k3_inputs(K3_CASES[1])
    cot = np.random.default_rng(301).standard_normal(args[0].shape)
    out = {}
    for dt in (jnp.bfloat16, jnp.float32):
        out[dt] = [_np(g) for g in _jit(lambda g, *a: jax.vjp(
            _ffn_reference, *a)[1](g))(
            *(jnp.asarray(x, dt) for x in (cot, *args)))]
    return out[jnp.bfloat16], out[jnp.float32]


# ── modules ─────────────────────────────────────────────────────────────

def _module_input():
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 51, 32)) + 0.3).astype(np.float32)
    mask = np.ones((2, 51), bool)
    mask[1, 40:] = False
    return x, mask


@functools.lru_cache(maxsize=None)
def _module_pair(name):
    """(flax module, torch module factory, numpy variables) of one of
    MODULES at d 32 (2 heads, kernel 7, d_ff 64), every bias non-zero."""
    from sincformer_tpu.models import conformer as jc
    from sincformer_tpu_torch.models import conformer as tc
    d = 32
    kind = name.split()[1] if name.startswith("conv") else None
    if kind is not None:
        jm = jc.ConvolutionModule(d, 7, 0.0, kind)
        tm = functools.partial(tc.ConvolutionModule, d, 7, 0.0, kind)
    elif name == "mhsa":
        jm = jc.MultiHeadSelfAttention(d, 2, 0.0, attn_impl="speech")
        tm = functools.partial(tc.MultiHeadSelfAttention, d, 2, "speech", 0.0)
    else:                                   # the feed-forward modules
        fused = name != "ff"
        rate = NO_DROP if name == "ff fused dropout" else 0.0
        jm = (jc.FusedFeedForward if fused else jc.FeedForwardModule)(
            d, 64, rate)
        tm = functools.partial(tc.FeedForwardModule, d, 64, fused, rate)
    x, _ = _module_input()
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x))
    rng = np.random.default_rng(8)
    variables = {"params": jax.tree_util.tree_map_with_path(
        lambda p, s: _fill(p, s, rng).astype(np.float32), shapes["params"])}
    if kind == "batch":
        variables["batch_stats"] = {"bn": {
            "mean": (0.1 * rng.standard_normal(d)).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, d).astype(np.float32)}}
    return jm, tm, variables


def _jax_module(name, excess: bool = False):
    """The module's output in bf16 (parameters and input cast, statistics
    float32) as flax computes it; ``excess``: compiled with XLA's excess
    precision on (its default)."""
    jit = jax.jit if excess else _jit
    jm, _, variables = _module_pair(name)
    x, mask = _module_input()
    v = {**variables, "params": jax.tree.map(
        lambda a: jnp.asarray(a, jnp.bfloat16), variables["params"])}
    xb = jnp.asarray(x, jnp.bfloat16)
    if name == "mhsa":
        fn = jit(lambda v_, x_: jm.apply(v_, x_, True, jnp.asarray(mask)))
    elif name == "conv batch train":
        fn = jit(lambda v_, x_: jm.apply(v_, x_, False,
                                         mutable=["batch_stats"])[0])
    elif name == "ff fused dropout":
        fn = jit(lambda v_, x_: jm.apply(
            v_, x_, False, rngs={"dropout": jax.random.PRNGKey(3)}))
    else:
        fn = jit(lambda v_, x_: jm.apply(v_, x_, True))
    return _np(fn(v, xb))


def _port_module(name):
    from sincformer_tpu_torch.compat.from_jax import (_dcse_buffers,
                                                      _dcse_named)
    _, factory, variables = _module_pair(name)
    x, mask = _module_input()
    tm = factory()
    state = {k: torch.from_numpy(np.array(v)) for k, v in {
        **_dcse_named(variables["params"]),
        **_dcse_buffers(variables.get("batch_stats"))}.items()}
    tm.load_state_dict(state, strict=True)
    for p in tm.parameters():
        p.data = p.data.bfloat16()
    with torch.no_grad():
        if name == "mhsa":
            return tm(_bf16(x), torch.from_numpy(mask))
        train = name in ("conv batch train", "ff fused dropout")
        return tm(_bf16(x), torch.Generator().manual_seed(0)
                  if train else None)


# ── the narrow DCSE ─────────────────────────────────────────────────────

def _jax_pipeline(norm, fused, dtype):
    from sincformer_tpu.models.dcse import SpeechEnhancer
    from sincformer_tpu.train.dcse_trainer import DCSEPipeline
    return DCSEPipeline(model=SpeechEnhancer(
        n_freq=129, dropout=0.0, attn_impl="speech", conv_norm=norm,
        fused_ffn=fused, **NARROW_DCSE), model_dir=tempfile.mkdtemp(),
        compute_dtype=dtype)


def _jax_step(norm, fused, bf16):
    """JAX's training forward without the MR-STFT term, in bf16 (``bf16``)
    or in f32: (loss, enhanced waveform, {port name: gradient},
    batch_stats after, {port name: parameter after one AdamW step}, the
    latter only in bf16). The unfused f32 forwards are the programs of
    ``tests/test_torch_dcse_train.py`` (shared with it and with the
    data- and tensor-parallel tests in one process)."""
    import sincformer_tpu.train.dcse_trainer as jax_dcse
    from sincformer_tpu_torch.compat.from_jax import _dcse_named
    variables = dcse_train._variables(norm)
    ms = ({"batch_stats": variables["batch_stats"]} if norm == "batch"
          else None)
    noisy, clean = dcse_train._batch(5)
    if not bf16 and not fused:
        ((loss, (_, new_ms, enh)), grads), _ = dcse_train._jax_fns(norm)[0](
            variables["params"], ms, noisy, clean)
        return (float(loss), _np(enh), _dcse_named(jax.tree.map(_np, grads)),
                jax.tree.map(_np, new_ms), None)
    pipe = _jax_pipeline(norm, fused, jnp.bfloat16 if bf16 else None)

    def f(params):
        def loss(p):
            total, (neg, new_ms, enh) = pipe._loss_fn(
                p, ms, noisy, clean, jax.random.PRNGKey(0), True)
            return total, (new_ms, enh)
        return jax.value_and_grad(loss, has_aux=True)(params)
    # the trace patches the JAX module's MR-STFT loss, which a trace on
    # another thread must not see: the lock of tests/test_torch_dcse_train
    with dcse_train._TRACE_LOCK, mock.patch.object(
            jax_dcse, "multi_resolution_stft_loss",
            lambda pred, target: jnp.sum(pred) * 0.0):
        lowered = (_jit(f) if bf16 else jax.jit(f)).lower(
            variables["params"])
    (loss, (new_ms, enh)), grads = lowered.compile()(variables["params"])
    return (float(loss), _np(enh), _dcse_named(jax.tree.map(_np, grads)),
            jax.tree.map(_np, new_ms),
            _dcse_named(jax.tree.map(_np, _jax_adamw(variables["params"],
                                                      grads)))
            if bf16 else None)


def _jax_eval(bf16):
    """JAX's eval step on the "batch" model and a padded batch, in bf16
    (``bf16``) or in f32 (the program of tests/test_torch_dcse_train.py)."""
    variables = dcse_train._variables("batch")
    noisy, clean = dcse_train._batch(13, padded=True)
    lengths = np.array([4000, 3000], np.int32)
    step = (_jit(_jax_pipeline("batch", False, jnp.bfloat16
                               )._make_eval_step().__wrapped__) if bf16
            else dcse_train._jax_fns("batch")[1])
    return [float(x) for x in step(
        variables["params"], {"batch_stats": variables["batch_stats"]},
        noisy, clean, lengths)]


@functools.lru_cache(maxsize=None)
def _full_width_variables():
    from sincformer_tpu.models.dcse import default_speech_enhancer
    model = default_speech_enhancer()
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 11, 129)),
        jnp.zeros((1, 11, 129))))
    rng = np.random.default_rng(12)
    return model, {"params": jax.tree_util.tree_map_with_path(
        lambda p, s: _fill(p, s, rng).astype(np.float32), shapes["params"])}


def _full_width_input():
    rng = np.random.default_rng(14)
    return [(0.5 * rng.standard_normal((2, 51, 129))).astype(np.float32)
            for _ in range(2)]


def _jax_full_width(dtype: str):
    """The full-width SpeechEnhancer's forward, every variable and the
    input cast to ``dtype`` as bench.py casts them to bf16."""
    model, variables = _full_width_variables()
    re, im = _full_width_input()
    dt = jnp.dtype(dtype)
    v = jax.tree.map(lambda a: jnp.asarray(a, dt), variables)
    fn = jax.jit if dt == jnp.float32 else _jit
    return [_np(o) for o in fn(lambda v_, a, b: model.apply(
        v_, a, b, deterministic=True))(v, jnp.asarray(re, dt),
                                       jnp.asarray(im, dt))]


@pytest.fixture(scope="module", autouse=True)
def ahead():
    """The JAX programs on two threads, the longest (the DCSE steps, ~5 s
    of compile each) first."""
    jobs = ([(_jax_step, *case, bf16) for case in DCSE_CASES
             for bf16 in (True, False)]
            + [(_jax_full_width, "bfloat16"), (_jax_full_width, "float32"),
               (_jax_eval, True), (_jax_eval, False)]
            + [(_jax_k1, case) for case in K1_CASES] + [(_jax_k1_interpret,)]
            + [(_jax_k3, case) for case in K3_CASES]
            + [(_jax_k1_vjp,), (_jax_k3_vjp,)]
            + [(_jax_module, name) for name in MODULES]
            + [(_jax_module, "conv layer", True)])
    with AHEAD.start(jobs, threads=2):
        yield AHEAD


def _say(*parts):
    print(*parts, flush=True)


@pytest.mark.parametrize("case", K1_CASES)
def test_k1_plain_matches_jax_reference_in_bf16(case):
    """K1's plain bf16 version against JAX's ``_reference`` in bf16."""
    want = AHEAD(_jax_k1, case)
    args, got = _port_k1(case)
    share, ulps = agreement(got, want, attention_scale(*args))
    _say(f"K1 {case}: {share:.5f} bit-equal, worst {ulps:.3f} ulp")
    assert got.dtype == torch.bfloat16
    assert share >= SHARE and ulps <= ULPS


def test_k1_that_keeps_p_in_f32_misses():
    """A planted fault, P.V taken on the f32 softmax: fewer than 99 % of
    the elements bit-equal to JAX's reference."""
    want = AHEAD(_jax_k1, K1_CASES[0])
    args, _ = _port_k1(K1_CASES[0])
    share, ulps = agreement(attention_p_in_f32(*args), want,
                            attention_scale(*args))
    _say(f"K1 with P in f32: {share:.5f} bit-equal, worst {ulps:.3f} ulp")
    assert share < SHARE


def test_k1_plain_against_pallas_interpret_in_bf16():
    """JAX's Pallas K1 (interpret mode) rounds exp(s - m) before P.V and
    divides by the sum after it, JAX's reference rounds the normalised P:
    two bf16 functions. The port's plain version is as close to the Pallas
    kernel as JAX's reference is: its bit-equal share within 0.2 % of the
    reference's and its worst element no farther (ulps at the term
    scale)."""
    pallas, ref = AHEAD(_jax_k1_interpret)
    args, got = _port_k1((2, 100, 2, 32, False))
    scale = attention_scale(*args)
    port_share, port_ulps = agreement(got, pallas, scale)
    ref_share, ref_ulps = agreement(ref, pallas, scale)
    _say(f"K1 vs Pallas interpret: port {port_share:.5f} bit-equal, worst "
         f"{port_ulps:.3f} ulp; JAX reference {ref_share:.5f}, "
         f"{ref_ulps:.3f} ulp")
    assert abs(port_share - ref_share) <= 0.002 and port_ulps <= ref_ulps


@pytest.mark.parametrize("case", K3_CASES)
def test_k3_plain_matches_jax_reference_in_bf16(case):
    """K3's plain bf16 version against JAX's ``_ffn_reference`` in
    bf16."""
    from sincformer_tpu_torch.ops.fused_ffn import _fused_ffn_plain
    want = AHEAD(_jax_k3, case)
    args = [_bf16(a) for a in _k3_inputs(case)]
    got = _fused_ffn_plain(*args)
    share, ulps = agreement(got, want, ffn_scale(*args))
    _say(f"K3 {case}: {share:.5f} bit-equal, worst {ulps:.3f} ulp")
    assert got.dtype == torch.bfloat16
    assert share >= SHARE and ulps <= ULPS


def _cross_of_grads(got, want16, want32, what):
    worst = 0.0
    for i, (g, w16, w32) in enumerate(zip(got, want16, want32)):
        cross = distance(g, w16) / distance(w16, w32)
        _say(f"{what} gradient {i}: cross {cross:.4f}")
        worst = max(worst, cross)
    return worst


def test_k1_backward_in_bf16_matches_jax():
    """The autograd of K1 on bf16 CPU tensors (the plain formulation's
    gradient in bf16, JAX's ``_vjp_bwd``) against ``jax.vjp`` of JAX's
    reference: each of dq, dk, dv at a cross of at most 0.5."""
    from sincformer_tpu_torch.ops.speech_attention import speech_attention
    want16, want32 = AHEAD(_jax_k1_vjp)
    q, k, v, bias = _k1_inputs(K1_CASES[0])
    cot = np.random.default_rng(300).standard_normal(q.shape)
    leaves = [_bf16(a).requires_grad_(True) for a in (q, k, v)]
    out = speech_attention(*leaves, torch.from_numpy(bias))
    got = torch.autograd.grad(out, leaves, _bf16(cot))
    assert all(g.dtype == torch.bfloat16 for g in got)
    assert _cross_of_grads(got, want16, want32, "K1") <= 0.5


def test_k3_backward_in_bf16_matches_jax():
    """The autograd of K3 on bf16 CPU tensors against ``jax.vjp`` of JAX's
    ``_ffn_reference``: each of the 7 gradients at a cross of at most
    0.5."""
    from sincformer_tpu_torch.ops.fused_ffn import fused_ffn
    want16, want32 = AHEAD(_jax_k3_vjp)
    args = _k3_inputs(K3_CASES[1])
    cot = np.random.default_rng(301).standard_normal(args[0].shape)
    leaves = [_bf16(a).requires_grad_(True) for a in args]
    got = torch.autograd.grad(fused_ffn(*leaves), leaves, _bf16(cot))
    assert _cross_of_grads(got, want16, want32, "K3") <= 0.5


@pytest.mark.parametrize("name", MODULES)
def test_modules_round_as_flax(name):
    """Each Conformer module in bf16 (parameters cast, BatchNorm's running
    statistics float32) on the same bf16 input as flax's: at least 99 % of
    the output bit-equal."""
    want = AHEAD(_jax_module, name)
    got = _port_module(name)
    share = float(np.mean(_np(got) == want))
    _say(f"{name}: {share:.5f} bit-equal")
    assert got.dtype == torch.bfloat16 and share >= SHARE


def test_excess_precision_skips_roundings():
    """Why JAX's bf16 programs are compiled with XLA's excess precision
    off: with it on (XLA's default) the conv module's bf16 output is not
    flax's operation-by-operation rounding (fewer than 99 % of the
    elements equal to the port's, which rounds at every bf16 operation);
    with it off it is (``test_modules_round_as_flax``)."""
    on = AHEAD(_jax_module, "conv layer", True)
    off = AHEAD(_jax_module, "conv layer")
    got = _np(_port_module("conv layer"))
    share_on, share_off = (float(np.mean(got == w)) for w in (on, off))
    _say(f"conv layer: {share_off:.5f} bit-equal to JAX's bf16 with excess "
         f"precision off, {share_on:.5f} with it on")
    assert share_off >= SHARE and share_on < SHARE


def test_batchnorm_statistics_in_bf16_miss():
    """A planted fault: the conv module's BatchNorm taking its batch
    statistics in bf16 (and normalising in bf16) misses the module bar."""
    import sincformer_tpu_torch.models.conformer as conformer

    def bf16_stats(x, weight, bias, running_mean, running_var, train,
                   momentum=0.99, eps=1e-5):
        mean = x.mean(dim=(0, 1))
        var = torch.clamp((x * x).mean(dim=(0, 1)) - mean * mean, min=0.0)
        with torch.no_grad():
            running_mean.mul_(momentum).add_((1 - momentum) * mean.float())
            running_var.mul_(momentum).add_((1 - momentum) * var.float())
        return (x - mean) * (torch.rsqrt(var + eps) * weight) + bias
    want = AHEAD(_jax_module, "conv batch train")
    with mock.patch.object(conformer, "batch_norm", bf16_stats):
        got = _port_module("conv batch train")
    share = float(np.mean(_np(got) == want))
    _say(f"BatchNorm with bf16 statistics: {share:.5f} bit-equal")
    assert share < SHARE


def _port_trainer(norm, fused, dtype=torch.bfloat16):
    from sincformer_tpu_torch.compat.from_jax import \
        load_dcse_train_state_from_jax
    from sincformer_tpu_torch.models.dcse import SpeechEnhancer
    from sincformer_tpu_torch.train.dcse_trainer import DCSETrainer
    v = dcse_train._variables(norm)
    named, buffers, _, config = load_dcse_train_state_from_jax(
        v["params"], v.get("batch_stats"), None,
        num_heads=NARROW_DCSE["num_heads"], dropout=0.0, fused_ffn=fused)
    pipe = DCSETrainer(SpeechEnhancer(config), device="cpu",
                       model_dir=tempfile.mkdtemp(), compute_dtype=dtype)
    pipe.load_state(named, buffers)
    pipe.init_state(dcse_train.EPOCHS, dcse_train.STEPS, init_params=False)
    return pipe


def _port_step(pipe, inputs_in_bf16=False):
    """The port's training forward without the MR-STFT term: (loss,
    enhanced waveform, {name: gradient}). ``inputs_in_bf16``: the STFT's
    parts rounded to bf16 and nothing else (a planted fault, for a float32
    trainer)."""
    import sincformer_tpu_torch.train.dcse_trainer as port_dcse
    noisy, clean = dcse_train._batch(5)
    stft = port_dcse.stft

    def rounded(*a):
        s = stft(*a)
        return torch.complex(s.real.bfloat16().float(),
                             s.imag.bfloat16().float())
    with mock.patch.object(port_dcse, "multi_resolution_stft_loss",
                           lambda pred, target: pred.sum() * 0.0), \
            mock.patch.object(port_dcse, "stft",
                              rounded if inputs_in_bf16 else stft):
        loss, (_, wav) = pipe._loss(torch.from_numpy(noisy),
                                    torch.from_numpy(clean), True)
        grads = torch.autograd.grad(loss, list(pipe.params().values()))
    return float(loss.detach()), _np(wav), dict(zip(pipe.params(),
                                           (_np(g) for g in grads)))


def _zero(norm, names) -> set:
    """The leaves whose gradient is zero in exact arithmetic: the depthwise
    convolution's bias in front of a training BatchNorm."""
    return {k for k in names if norm == "batch"
            and k.endswith("depthwise.bias")}


def _step_bars(norm, got, j16, j32):
    """The training forward's bars; returns the rows printed."""
    loss, wav, grads = got
    zero = _zero(norm, grads)
    loss_cross = abs(loss - j16[0]) / abs(j16[0] - j32[0])
    wav_noise, wav_cross = ratios(wav, j16[1], j32[1])
    rows = sorted((*ratios(grads[k], j16[2][k], j32[2][k]), k)
                  for k in grads if k not in zero)
    noise = [r[0] for r in rows]
    cross = [r[1] for r in rows]
    _say(f"{norm}: loss {loss:.7f}, JAX bf16 {j16[0]:.7f}, f32 "
         f"{j32[0]:.7f} ({abs(loss - j16[0]) / abs(j16[0]):.3e} relative; "
         f"its cross {loss_cross:.3f}); waveform noise "
         f"{wav_noise:.3f}, cross {wav_cross:.3f}; gradients noise "
         f"{min(noise):.3f}-{max(noise):.3f} (median "
         f"{np.median(noise):.3f}), cross {min(cross):.3f}-{max(cross):.3f}"
         f" (median {np.median(cross):.3f})")
    for n, c, k in rows:
        _say(f"  {k}: noise {n:.3f}, cross {c:.3f}")
    return {"loss_rel": abs(loss - j16[0]) / abs(j16[0]),
            "wav": (wav_noise, wav_cross), "noise": noise, "cross": cross}


def _passes(bars) -> bool:
    return (bars["loss_rel"] <= LOSS_REL
            and 0.5 <= bars["wav"][0] <= 2.0 and bars["wav"][1] <= 1.0
            and min(bars["noise"]) >= 0.3 and max(bars["noise"]) <= 2.5
            and 0.7 <= np.median(bars["noise"]) <= 1.4
            and max(bars["cross"]) <= 1.5 and np.median(bars["cross"]) <= 1.0)


def _jax_adamw(params, grads):
    """optax's AdamW step (``make_adamw``) of the flat parameters with the
    NaN guard, as ``DCSEPipeline``'s train step applies it."""
    from jax.flatten_util import ravel_pytree

    from sincformer_tpu.train.state import make_adamw
    flat, unravel = ravel_pytree(jax.tree.map(jnp.asarray, params))
    tx = make_adamw(dcse_train.LR, dcse_train.EPOCHS, dcse_train.STEPS)
    g = ravel_pytree(grads)[0]
    updates, _ = jax.jit(tx.update)(g, tx.init(flat), flat)
    return unravel(optax.apply_updates(flat, updates))


@pytest.mark.parametrize("norm,fused", DCSE_CASES)
def test_dcse_training_forward_in_bf16_matches_jax(norm, fused):
    """The narrow model's bf16 training forward and its gradients against
    JAX's ``_loss_fn(compute_dtype=jnp.bfloat16)`` (module docstring), the
    master parameters float32; for "batch" the running statistics after the
    forward within 1e-4 of JAX's bf16 step's; then one AdamW step of the
    float32 masters with each package's bf16 gradients."""
    from sincformer_tpu_torch.compat.from_jax import _dcse_buffers
    from sincformer_tpu_torch.train.state import guard_nan_update
    j16, j32 = AHEAD(_jax_step, norm, fused, True), AHEAD(_jax_step, norm,
                                                          fused, False)
    pipe = _port_trainer(norm, fused)
    assert all(p.dtype == torch.float32 for p in pipe.params().values())
    got = _port_step(pipe)
    assert _passes(_step_bars(norm, got, j16, j32))
    if norm == "batch":
        want = _dcse_buffers(j16[3]["batch_stats"])
        for k, b in pipe.model.named_buffers():
            assert b.dtype == torch.float32
            assert np.max(np.abs(_np(b) - want[k])) <= 1e-4 * max(
                1.0, float(np.abs(want[k]).max())), k

    # one AdamW step from the same masters
    before = {k: _np(p) for k, p in pipe.params().items()}
    params = pipe.params()
    grads = [torch.from_numpy(got[2][k]) for k in params]
    guarded, _ = guard_nan_update(grads, torch.tensor(got[0]),
                                  params.values())
    pipe.tx.update(params, guarded, pipe.opt_state)
    want_params = j16[4]
    loose = total = 0
    for k, w in want_params.items():
        a, b = got[2][k], j16[2][k]
        big = GRAD_TOL * float(np.max(np.abs(b)))
        settled = ((np.sign(a) == np.sign(b)) & (np.abs(a) > big)
                   & (np.abs(b) > big) & (k not in _zero(norm, [k])))
        diff = np.abs(_np(params[k]) - w)
        assert np.all(diff[settled] <= PARAM_TOL * float(np.max(np.abs(w)))
                      ), k
        step = float(np.max(np.abs(w - before[k])))
        assert np.all(diff[~settled] <= 2 * step + PARAM_TOL * float(
            np.max(np.abs(w)))), k
        loose += int(np.sum(~settled))
        total += w.size
    _say(f"{norm} fused={fused}: AdamW step, elements where the bf16 "
         f"gradients disagree in sign or are small: {loose} of {total} "
         f"({loose / total:.4f})")
    assert loose <= 0.01 * total


def test_f32_parameters_with_bf16_inputs_miss():
    """A planted fault: parameters left float32 and only the STFT's parts
    cast to bf16 (what a bf16 input does to a float32 flax model) misses
    the training forward's bars ("layer")."""
    j16, j32 = AHEAD(_jax_step, "layer", False, True), AHEAD(
        _jax_step, "layer", False, False)
    bars = _step_bars("layer (planted)", _port_step(
        _port_trainer("layer", False, None), inputs_in_bf16=True), j16, j32)
    assert not _passes(bars)


def test_eval_step_in_bf16_matches_jax():
    """The bf16 eval step ("batch" on its running statistics, a padded
    row) against JAX's ``_make_eval_step`` with ``compute_dtype=
    jnp.bfloat16``; the statistics are left as they were."""
    want16, want32 = AHEAD(_jax_eval, True), AHEAD(_jax_eval, False)
    pipe = _port_trainer("batch", False)
    stats = {k: v.clone() for k, v in pipe.model.named_buffers()}
    noisy, clean = dcse_train._batch(13, padded=True)
    got = [float(x) for x in pipe.eval_step(
        torch.from_numpy(noisy), torch.from_numpy(clean),
        torch.tensor([4000, 3000]))]
    _say(f"eval step: port bf16 {got}, JAX bf16 {want16}, JAX f32 {want32}")
    for g, w in zip(got[:2], want16[:2]):
        assert abs(g - w) <= LOSS_REL * abs(w)
    assert abs(got[2] - want16[2]) <= LOSS_REL * want16[3]
    assert got[3] == want16[3] == 2
    for k, v in pipe.model.named_buffers():
        assert torch.equal(v, stats[k])


def test_full_width_forward_in_bf16():
    """``DCSEConfig()``'s SpeechEnhancer (d 256, 4 blocks) with seeded
    weights, cast to bf16 whole as ``bench.py`` casts the JAX model, on 51
    frames: each output's noise in [0.5, 2] and cross at most 1.2 against
    JAX's bf16 and f32 forwards; the outputs are bf16."""
    from sincformer_tpu_torch import SpeechEnhancer, load_dcse_from_jax
    want16, want32 = (AHEAD(_jax_full_width, "bfloat16"),
                      AHEAD(_jax_full_width, "float32"))
    _, variables = _full_width_variables()
    state, config = load_dcse_from_jax(variables, num_heads=4)
    model = SpeechEnhancer(config).eval()
    model.load_state_dict(state)
    model.to(torch.bfloat16)
    re, im = _full_width_input()
    with torch.no_grad():
        got = model(_bf16(re), _bf16(im))
    for name, g, w16, w32 in zip(("real", "imag", "mask"), got, want16,
                                 want32):
        noise, cross = ratios(_np(g), w16, w32)
        _say(f"full width {name}: {float(np.mean(_np(g) == w16)):.4f} "
             f"bit-equal, noise {noise:.3f}, cross {cross:.3f}")
        assert g.dtype == torch.bfloat16
        assert 0.5 <= noise <= 2.0 and cross <= 1.2
