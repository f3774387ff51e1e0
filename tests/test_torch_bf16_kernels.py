"""bf16 forms of kernels K5 and K6, context parallelism and ``impl="xla"``
in bf16, in the port against the JAX package on the CPU.

Every JAX bf16 program is compiled with XLA's excess precision off
(``tests/test_torch_bf16.py`` says why); JAX's Pallas kernels run in
interpret mode, as the JAX package's own tests run them.

Bars (``tests/_torch_bf16.py`` for the terms):
  * K5's and K6's plain bf16 versions against JAX's ``conv_gn_reference``
    and ``env_act_reference`` in bf16: at least 99 % of the elements
    bit-equal and every element within one bf16 ulp at its term scale
    (K5: the normalised magnitudes of the convolution's terms and of the
    mean, plus |beta| and |skip|; K6's activation: |x * scale|; K6's
    envelope: its own magnitude). Both compute in float32 and round once
    (K5 the whole convolution, GroupNorm and GELU, K6 the envelope); K6's
    activation rounds every operation of the GELU in both.
  * Against JAX's Pallas kernels in bf16 (interpret mode), whose K5 rounds
    the convolution to bf16 between its two passes (a second bf16
    function, ROADMAP.md Queue 3): the distance is printed, and the port
    is as close to the Pallas kernel as JAX's reference is (its bit-equal
    share within 0.2 % of the reference's and its worst element no
    farther, in ulps of the element's magnitude).
  * The backwards in bf16 (the plain recompute) against ``jax.vjp`` of
    JAX's ``custom_vjp`` (K5) and of its reference (K6, whose custom VJP
    is the reference's gradient): K5's gradients' cross = |port bf16 -
    JAX bf16| / |JAX bf16 - JAX f32| at most 0.5, as for K1 and K3; K6's
    at most 1 with a noise in [0.3, 2.5] (its test says why).
  * ``impl="xla"`` attention in bf16, the key bias in q's dtype, against
    JAX's ``jax.nn.dot_product_attention`` branch: at least 99 %
    bit-equal, within one ulp at the attention's term scale.
  * Context parallelism: the narrow DCSE model in bf16 on the trainer's
    bf16 copies of float32 masters, ``attn_impl="ring"`` and the halo conv
    under ``ring_mesh`` on two gloo ranks of half the frames each, against
    the same model in one process with the one-process attention. The
    ring keeps P in float32 where the one-process attention rounds it to
    bf16, so the two are different bf16 functions, held as
    ``tests/test_torch_bf16.py`` holds a whole bf16 network: cross = |ring bf16 - one bf16| / |one bf16 - one
    f32| at most 1 for the loss and the enhanced STFT, each master's
    gradient at most 1.5 and their median at most 1 (the depthwise conv's
    bias in front of the training BatchNorm, whose gradient is zero in
    exact arithmetic, left out as in ``tests/test_torch_bf16.py``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import _torch_dp_worker as worker
from tests._torch_bf16 import (agreement, attention_scale,
                               conv_gn_scale, distance)
from tests._torch_parity import NARROW_DCSE, Ahead

NOEX = {"xla_allow_excess_precision": False}
SHARE = 0.99
ULPS = 1.0
GRAD_CROSS = 0.5          # a kernel's backward (the K1, K3 bar)
K6_GRAD_CROSS = 1.0       # K6's: its test says why
GRAD_NOISE = (0.3, 2.5)   # test_torch_bf16.py's bars for a gradient leaf
CP_CROSS, CP_LEAF_CROSS, CP_LEAF_MEDIAN = 1.0, 1.5, 1.0
AHEAD = Ahead()

# (T, Cin, Cout, K, stride, act, skip): tests/test_torch_conv_gn.py's
K5_CASES = [(1000, 64, 128, 7, 2, True, False),
            (500, 128, 128, 3, 1, False, True),
            (513, 128, 256, 7, 2, True, False),
            (300, 32, 48, 9, 1, True, True)]
# (shape, Pallas block): tests/test_torch_envact.py's
K6_CASES = [((2, 800, 64), 400), ((2, 2400, 64), 8), ((1, 16, 3), 8)]
CP_CONFIG = dict(d_model=NARROW_DCSE["d_model"],
                 num_blocks=NARROW_DCSE["num_blocks"],
                 num_heads=NARROW_DCSE["num_heads"],
                 ff_dim=NARROW_DCSE["d_ff"],
                 kernel_size=NARROW_DCSE["kernel_size"], dropout=0.0,
                 conv_norm="batch")


def _jit(fn):
    return jax.jit(fn, compiler_options=NOEX)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16()


def _cross(got, want16, want32) -> float:
    return distance(got, want16) / distance(want16, want32)


def _say(*parts):
    print(*parts, flush=True)


# ── K5 ──────────────────────────────────────────────────────────────────

def _k5_inputs(case):
    t, cin, cout, k, s, _, with_skip = case
    rng = np.random.default_rng(40 + t + cin)
    f = np.float32
    t_out = -(-t // s)
    return [(rng.standard_normal((2, t, cin))).astype(f),
            (rng.standard_normal((k, cin, cout)) * 0.1).astype(f),
            (rng.standard_normal(cout) * 0.1).astype(f),
            (1 + 0.1 * rng.standard_normal(cout)).astype(f),
            (0.1 * rng.standard_normal(cout)).astype(f),
            rng.standard_normal((2, t_out, cout)).astype(f)
            if with_skip else None]


def _jax_k5(case, pallas: bool):
    from sincformer_tpu.ops import conv_gn_pallas as jc
    _, _, _, _, s, act, _ = case
    args = [None if a is None else jnp.asarray(a, jnp.bfloat16)
            for a in _k5_inputs(case)]
    kw = dict(stride=s, groups=16, eps=1e-6, act=act)
    if pallas:
        return _np(jc._conv1d_gn_pallas(*args, **kw, interpret=True))
    return _np(_jit(lambda *a: jc.conv_gn_reference(*a, **kw))(*args))


def _k5_scale(case) -> torch.Tensor:
    return conv_gn_scale(*_k5_inputs(case), case[4], 16)


def _port_k5(case):
    from sincformer_tpu_torch.ops.conv_gn import conv1d_gn
    _, _, _, _, s, act, _ = case
    args = [None if a is None else _bf16(a) for a in _k5_inputs(case)]
    return conv1d_gn(*args, s, 16, 1e-6, act)


def _jax_k5_vjp():
    """The six gradients of JAX's ``conv1d_gn`` (its custom VJP) at the
    second case, with a skip, in bf16 and in f32, for one cotangent."""
    from sincformer_tpu.ops import conv_gn_pallas as jc
    case = K5_CASES[1]
    args = _k5_inputs(case)
    cot = np.random.default_rng(41).standard_normal(
        (2, -(-case[0] // case[4]), case[2])).astype(np.float32)
    out = {}
    for dt in (jnp.bfloat16, jnp.float32):
        out[dt] = [_np(g) for g in _jit(lambda g, *a: jax.vjp(
            lambda *x: jc.conv1d_gn(*x, case[4], 16, 1e-6, case[5]),
            *a)[1](g))(*(jnp.asarray(x, dt) for x in (cot, *args)))]
    return out[jnp.bfloat16], out[jnp.float32], cot


# ── K6 ──────────────────────────────────────────────────────────────────

def _k6_inputs(shape):
    rng = np.random.default_rng(50 + shape[1])
    return ((rng.standard_normal(shape) * 3).astype(np.float32),
            rng.uniform(0.5, 2.0, shape[-1]).astype(np.float32))


def _jax_k6(case, pallas: bool):
    from sincformer_tpu.ops import envact_pallas as je
    shape, block = case
    x, scale = (jnp.asarray(a, jnp.bfloat16) for a in _k6_inputs(shape))
    if pallas:
        out = je.env_act(x, scale, block=block, interpret=True)
    else:
        out = _jit(je.env_act_reference)(x, scale)
    return [_np(o) for o in out]


def _jax_k6_vjp():
    """dx, dscale of JAX's env_act reference (its custom VJP's backward) at
    the first shape, in bf16 and in f32, for seeded cotangents."""
    from sincformer_tpu.ops import envact_pallas as je
    shape = K6_CASES[0][0]
    x, scale = _k6_inputs(shape)
    rng = np.random.default_rng(51)
    cots = (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal((shape[0], shape[1] // 8, shape[2])
                                ).astype(np.float32))
    out = {}
    for dt in (jnp.bfloat16, jnp.float32):
        out[dt] = [_np(g) for g in _jit(lambda a, b, c, d: jax.vjp(
            je.env_act_reference, a, b)[1]((c, d)))(
            *(jnp.asarray(v, dt) for v in (x, scale, *cots)))]
    return out[jnp.bfloat16], out[jnp.float32], cots


# ── impl="xla" ──────────────────────────────────────────────────────────

def _xla_inputs():
    rng = np.random.default_rng(60)
    q, k, v = (rng.standard_normal((2, 51, 2, 16)).astype(np.float32)
               for _ in range(3))
    mask = np.arange(51)[None] < np.array([[51], [40]])
    return q, k, v, mask


def _jax_xla():
    from sincformer_tpu.ops.attention import dot_product_attention
    q, k, v, mask = _xla_inputs()
    return _np(_jit(lambda a, b, c, m: dot_product_attention(
        a, b, c, mask=m, impl="xla"))(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
        jnp.asarray(mask)))


@pytest.fixture(scope="module", autouse=True)
def ahead(tmp_path_factory):
    """The ranks' bf16 ring job first, the JAX programs meanwhile."""
    rng = np.random.default_rng(70)
    job = {"kind": "cp_bf16", "config": CP_CONFIG,
           **{k: (0.5 * rng.standard_normal((2, 64, 129))).astype(np.float32)
              for k in ("re", "im")},
           "weight": rng.uniform(0.5, 1.5, (2, 64, 129)).astype(np.float32)}
    ticket = worker.pool().submit(job, str(tmp_path_factory.mktemp("cp16")))
    jobs = ([(_jax_k5, case, p) for case in K5_CASES for p in (False, True)]
            + [(_jax_k6, case, p) for case in K6_CASES for p in (False, True)]
            + [(_jax_k5_vjp,), (_jax_k6_vjp,), (_jax_xla,)])
    with AHEAD.start(jobs, threads=2):
        AHEAD.cp_job, AHEAD.cp_ranks = job, ticket
        yield AHEAD


@pytest.mark.parametrize("case", K5_CASES)
def test_k5_plain_matches_jax_reference_in_bf16(case):
    want = AHEAD(_jax_k5, case, False)
    got = _port_k5(case)
    share, ulps = agreement(got, want, _k5_scale(case))
    _say(f"K5 {case}: {share:.5f} bit-equal, worst {ulps:.3f} ulp")
    assert got.dtype == torch.bfloat16
    assert share >= SHARE and ulps <= ULPS


@pytest.mark.parametrize("case", K5_CASES)
def test_k5_plain_against_pallas_interpret_in_bf16(case):
    """JAX's Pallas K5 rounds the convolution to bf16 before its
    GroupNorm pass: the port's plain version (one rounding) is as close
    to it as JAX's reference is."""
    pallas = AHEAD(_jax_k5, case, True)
    ref = AHEAD(_jax_k5, case, False)
    got = _port_k5(case)
    scale = _k5_scale(case)
    p_share, p_ulps = agreement(got, pallas, scale)
    r_share, r_ulps = agreement(ref, pallas, scale)
    _say(f"K5 {case} vs Pallas interpret: port {p_share:.5f} bit-equal, "
         f"worst {p_ulps:.3f} ulp; JAX reference {r_share:.5f}, "
         f"{r_ulps:.3f} ulp")
    assert abs(p_share - r_share) <= 0.002 and p_ulps <= r_ulps


@pytest.mark.parametrize("case", K6_CASES)
def test_k6_plain_matches_jax_reference_in_bf16(case):
    from sincformer_tpu_torch.ops.envact import env_act
    y_want, env_want = AHEAD(_jax_k6, case, False)
    x, scale = (_bf16(a) for a in _k6_inputs(case[0]))
    y, env = env_act(x, scale)
    for name, got, want, terms in (("y", y, y_want, (x * scale).abs()),
                                   ("env", env, env_want, 0.0)):
        share, ulps = agreement(got, want, terms)
        _say(f"K6 {case} {name}: {share:.5f} bit-equal, worst {ulps:.3f} ulp")
        assert got.dtype == torch.bfloat16
        assert share >= SHARE and ulps <= ULPS


@pytest.mark.parametrize("case", K6_CASES)
def test_k6_plain_against_pallas_interpret_in_bf16(case):
    from sincformer_tpu_torch.ops.envact import env_act
    pallas = AHEAD(_jax_k6, case, True)
    ref = AHEAD(_jax_k6, case, False)
    x, scale = (_bf16(a) for a in _k6_inputs(case[0]))
    terms = ((x * scale).abs(), 0.0)
    for name, got, p, r, t in zip(("y", "env"), env_act(x, scale), pallas,
                                  ref, terms):
        p_share, p_ulps = agreement(got, p, t)
        r_share, r_ulps = agreement(r, p, t)
        _say(f"K6 {case} {name} vs Pallas interpret: port {p_share:.5f} "
             f"bit-equal, worst {p_ulps:.3f} ulp; JAX reference "
             f"{r_share:.5f}, {r_ulps:.3f} ulp")
        assert abs(p_share - r_share) <= 0.002 and p_ulps <= r_ulps


def test_k5_backward_in_bf16_matches_jax():
    """The autograd of ``conv1d_gn`` on bf16 CPU tensors (the plain
    recompute in bf16) against ``jax.vjp`` of JAX's custom VJP."""
    from sincformer_tpu_torch.ops.conv_gn import conv1d_gn
    want16, want32, cot = AHEAD(_jax_k5_vjp)
    case = K5_CASES[1]
    leaves = [_bf16(a).requires_grad_(True) for a in _k5_inputs(case)]
    out = conv1d_gn(*leaves, case[4], 16, 1e-6, case[5])
    got = torch.autograd.grad(out, leaves, _bf16(cot))
    crosses = [_cross(g, w16, w32) for g, w16, w32 in
               zip(got, want16, want32)]
    _say(f"K5 bf16 gradients' cross: {[round(c, 4) for c in crosses]}")
    assert all(g.dtype == torch.bfloat16 for g in got)
    assert max(crosses) <= GRAD_CROSS


def test_k6_backward_in_bf16_matches_jax():
    """K6's backward runs through the GELU's expansion, about ten bf16
    operations whose gradients PyTorch's autograd rounds at other points
    than JAX's transposes: the two bf16 gradients are independent bf16
    errors of about one size. Each gradient's noise = |port bf16 - JAX
    f32| / |JAX bf16 - JAX f32| within ``tests/test_torch_bf16.py``'s
    bars for a gradient leaf, [0.3, 2.5] (dscale, a sum over every element
    that PyTorch takes in f32, measured 0.49), and its cross at most 1
    (measured 0.80 and 0.95)."""
    from sincformer_tpu_torch.ops.envact import env_act
    want16, want32, cots = AHEAD(_jax_k6_vjp)
    leaves = [_bf16(a).requires_grad_(True)
              for a in _k6_inputs(K6_CASES[0][0])]
    got = torch.autograd.grad(env_act(*leaves), leaves,
                              tuple(_bf16(c) for c in cots))
    crosses = [_cross(g, w16, w32) for g, w16, w32 in
               zip(got, want16, want32)]
    noises = [distance(g, w32) / distance(w16, w32) for g, w16, w32 in
              zip(got, want16, want32)]
    _say(f"K6 bf16 gradients' cross {[round(c, 4) for c in crosses]}, "
         f"noise {[round(n, 4) for n in noises]}")
    assert all(g.dtype == torch.bfloat16 for g in got)
    assert max(crosses) <= K6_GRAD_CROSS
    assert all(GRAD_NOISE[0] <= n <= GRAD_NOISE[1] for n in noises)


def test_xla_attention_in_bf16_matches_jax():
    """``impl="xla"`` with bf16 q, k, v and a valid-frame mask: the bias
    in q's dtype, S and the softmax in f32, P rounded to V's dtype."""
    from sincformer_tpu_torch.ops.attention import dot_product_attention
    want = AHEAD(_jax_xla)
    q, k, v, mask = _xla_inputs()
    args = [_bf16(x) for x in (q, k, v)]
    got = dot_product_attention(*args, mask=torch.from_numpy(mask),
                                impl="xla")
    bias = torch.where(torch.from_numpy(mask), 0.0, -1e9)
    share, ulps = agreement(got, want, attention_scale(*args, bias))
    _say(f"impl='xla' bf16: {share:.5f} bit-equal, worst {ulps:.3f} ulp")
    assert got.dtype == torch.bfloat16 and share >= SHARE and ulps <= ULPS


@functools.lru_cache(maxsize=None)
def _one_process(dtype):
    from tests._torch_tp_jobs import dcse_bf16_step, dcse_model
    return dcse_bf16_step(dcse_model(CP_CONFIG, "speech"), AHEAD.cp_job,
                          dtype=dtype)


def test_ring_step_in_bf16_on_two_ranks():
    """The bf16 DCSE model with the ring and the halo conv on two gloo
    ranks against one process: the loss (summed over the ranks), the
    enhanced STFT (the ranks' blocks joined) and each master's gradient
    (summed) against the one-process bf16 step, each by its cross with
    the one-process bf16 - f32 distance."""
    ranks = AHEAD.cp_ranks.result()
    one16, one32 = _one_process(torch.bfloat16), _one_process(torch.float32)
    loss = sum(r["loss"] for r in ranks)
    loss_cross = abs(loss - one16["loss"]) / abs(one16["loss"]
                                                 - one32["loss"])
    out = torch.cat([r["out"] for r in ranks], dim=2)
    out_cross = _cross(out, one16["out"], one32["out"])
    # the depthwise conv's bias in front of a training BatchNorm has a
    # gradient of zero in exact arithmetic: rounding on either side
    leaf = {k: _cross(sum(r["grads"][k] for r in ranks), g,
                      one32["grads"][k]) for k, g in one16["grads"].items()
            if not k.endswith("depthwise.bias")}
    median = float(np.median(list(leaf.values())))
    worst = max(leaf, key=leaf.get)
    _say(f"bf16 ring on 2 ranks vs one process: loss cross "
         f"{loss_cross:.4f}, output cross {out_cross:.4f}, gradient "
         f"crosses median {median:.4f}, worst {leaf[worst]:.4f} ({worst})")
    assert np.isfinite(loss)
    assert loss_cross <= CP_CROSS and out_cross <= CP_CROSS
    assert median <= CP_LEAF_MEDIAN and leaf[worst] <= CP_LEAF_CROSS
