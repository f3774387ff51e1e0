"""Context parallelism in the port against the JAX package, on the CPU.

Two gloo ranks (``tests/_torch_dp_worker.py``, the job in
``tests/_torch_tp_jobs.py``), each holding half of the frames:
``ring_attention`` at (2, 64, 2, 8) against JAX's ``ring_attention`` on a
2-device mesh and against full attention (5e-5); a ConformerBlock (d 32,
2 heads, d_ff 64, k 7) with ``attn_impl="ring"`` and its halo conv under
``ring_mesh``, summed over the ranks, against JAX's block with
``attn_impl="xla"`` at JAX's bars (``tests/test_ring_attention.py``: the
loss 1e-5 relative, the input gradient 3e-5, each parameter gradient
5e-4), and one SGD step whose loss falls; the same block with a hop whose
backward keeps the gradient on the rank it reached (the backward of a
``ppermute`` taken as the identity) misses the input-gradient bar;
``cp_depthwise_conv`` against JAX's one-device conv, forward and
gradients within 1e-5, on a (2, 1) and a (1, 2) ("data", "model") mesh;
the ops refuse a T that does not divide the axis, an even kernel and a
block shorter than the halo, as JAX asserts; under ``ring_mesh`` the
depthwise conv with an even kernel or a block shorter than the halo
(JAX's fallback, the conv over the whole sequence) and the conv module
with "batch" (training) and "group" norm equal the one-process module,
output and gradients within 1e-5 (float64).

bf16 on the same two ranks: ``ring_attention`` (q, k, v above) and
``cp_depthwise_conv`` (the conv above, 20 frames a rank) on bf16 inputs
against JAX's ``ring_attention_in_mesh`` and ``cp_depthwise_conv`` in bf16
on a 2-device mesh, compiled with XLA's excess precision off
(``tests/test_torch_bf16.py`` says why): at least 99 % of the elements
bit-equal and every element within one bf16 ulp at its term scale
(``tests/_torch_bf16.py``: sum_j p_j |v_j| for attention, the
convolution's sum |x||w| + |b| for the conv).

One process: a ConformerBlock with ``attn_impl="ring"`` and no ring
context raises in a training forward and warns and falls back in
inference (the dispatch itself: ``tests/test_torch_modules.py``). The dry
run on four CPU processes is marked ``slow``, as JAX's is."""

import functools
import os
import subprocess
import sys
import tempfile
import threading
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import _torch_dp_worker as worker
from tests._torch_bf16 import distance, ratios
from tests._torch_parity import NARROW_DCSE, Ahead, _fill, narrow_dcse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = dict(d_model=32, num_heads=2, d_ff=64, kernel_size=7)
RING_TOL = 5e-5
LOSS_RTOL, X_GRAD_TOL, P_GRAD_TOL = 1e-5, 3e-5, 5e-4
CONV_TOL = 1e-5
NOEX = {"xla_allow_excess_precision": False}
SHARE_16, ULPS_16 = 0.99, 1.0       # the bf16 bars of the port's modules
# the bf16 training step's bars (tests/test_torch_bf16.py): the loss
# relative to JAX's bf16 loss; each gradient leaf's noise and cross, and
# their medians over the leaves
STEP_LOSS_REL = 2.0 ** -10
STEP_NOISE, STEP_NOISE_MEDIAN = (0.3, 2.5), (0.7, 1.4)
STEP_CROSS, STEP_CROSS_MEDIAN = 1.5, 1.0
# the bf16 ring step against the port's one-process step: each leaf's noise
# |ring bf16 - one f32| / |one bf16 - one f32| at most this median and this
# worst (the ring rounds K's and V's gradients at every hop, as JAX's does)
RING_NOISE_MEDIAN, RING_NOISE_WORST = 4.0, 6.0
_PATCH_LOCK = threading.Lock()      # one trace patches JAX's loss at a time


def _inputs():
    rng = np.random.default_rng(29)
    f32 = lambda *s, scale=1.0: (  # noqa: E731
        rng.standard_normal(s) * scale).astype(np.float32)
    return {"q": f32(2, 64, 2, 8, scale=0.5), "k": f32(2, 64, 2, 8, scale=0.5),
            "v": f32(2, 64, 2, 8, scale=0.5), "x": f32(2, 64, 32),
            "y": f32(2, 64, 32), "conv_x": f32(2, 40, 8),
            "conv_k": f32(7, 1, 8, scale=0.2), "conv_b": f32(8, scale=0.1),
            "conv_cot": f32(2, 40, 8),
            "mask": np.arange(64)[None, :] < np.array([[64], [45]])}


def _trainer_batch():
    """(2, 4,080) noisy and clean: 52 STFT frames at hop 80, two blocks
    of 26."""
    rng = np.random.default_rng(43)
    clean = (rng.standard_normal((2, 4080)) * 0.2).astype(np.float32)
    noisy = (clean + rng.standard_normal((2, 4080)) * 0.1).astype(np.float32)
    return noisy, clean


@functools.lru_cache(maxsize=None)
def _jax_block():
    """JAX's block with ``attn_impl="xla"``: seeded parameters (every norm
    scale off 1 and every bias off 0: with flax's init the final
    LayerNorm makes sum(out²) nearly constant and its gradients nearly
    zero), and the loss sum(out²) with its gradients in the parameters
    and the input."""
    from sincformer_tpu.models.conformer import ConformerBlock
    x = jnp.asarray(_inputs()["x"])
    blk = ConformerBlock(**BLOCK, dropout=0.0, attn_impl="xla")
    rng = np.random.default_rng(31)
    p = jax.tree_util.tree_map_with_path(
        lambda path, s: jnp.asarray(_fill(path, s, rng), jnp.float32),
        jax.eval_shape(lambda: blk.init(jax.random.PRNGKey(0), x)))
    loss, (gp, gx) = jax.jit(jax.value_and_grad(
        lambda p_, x_: jnp.sum(blk.apply(p_, x_, True) ** 2),
        argnums=(0, 1)))(p, x)
    return jax.tree.map(np.asarray, (p["params"], float(loss), gp["params"],
                                     gx))


def _jax_ring_and_full():
    from sincformer_tpu.ops.ring_attention import ring_attention
    from sincformer_tpu.parallel.mesh import make_mesh
    i = _inputs()
    q, k, v = (jnp.asarray(i[n]) for n in "qkv")
    return (np.asarray(ring_attention(q, k, v, make_mesh(2, ("data",)))),
            np.asarray(jax.nn.dot_product_attention(q, k, v)))


def _jax_conv():
    """JAX's SAME depthwise conv on one device and its gradients for the
    cotangent ``conv_cot``."""
    i = _inputs()

    def conv(x, kernel, bias):
        return jax.lax.conv_general_dilated(
            x, kernel, window_strides=(1,), padding="SAME",
            dimension_numbers=("NWC", "WIO", "NWC"),
            feature_group_count=kernel.shape[-1]) + bias
    y, pull = jax.vjp(conv, *(jnp.asarray(i[n]) for n in
                              ("conv_x", "conv_k", "conv_b")))
    return jax.tree.map(np.asarray, (y, pull(jnp.asarray(i["conv_cot"]))))


def _jax_cp_bf16():
    """JAX's ring attention and halo conv on the bf16 inputs, on a
    2-device mesh, compiled with XLA's excess precision off."""
    from sincformer_tpu.ops.cp_conv import cp_depthwise_conv
    from sincformer_tpu.ops.ring_attention import ring_attention_in_mesh
    from sincformer_tpu.parallel.mesh import make_mesh
    i = _inputs()
    mesh = make_mesh(2, ("data",))
    bf16 = {n: jnp.asarray(i[n], jnp.bfloat16)
            for n in ("q", "k", "v", "conv_x", "conv_k", "conv_b")}
    ring = jax.jit(lambda q, k, v: ring_attention_in_mesh(q, k, v, mesh),
                   compiler_options=NOEX)(*(bf16[n] for n in "qkv"))
    conv = jax.jit(lambda x, k, b: cp_depthwise_conv(x, k, b, mesh),
                   compiler_options=NOEX)(
        *(bf16[n] for n in ("conv_x", "conv_k", "conv_b")))
    return tuple(np.asarray(o.astype(jnp.float32)) for o in (ring, conv))


def _jax_ring_step(bf16: bool):
    """JAX's narrow DCSE training forward (``DCSEPipeline._loss_fn``) with
    ``attn_impl="ring"`` traced under ``ring_mesh`` on a 2-device mesh,
    without the multi-resolution STFT term (``tests/test_torch_bf16.py``
    says why), with ``compute_dtype=jnp.bfloat16`` and XLA's excess
    precision off (``bf16``) or in float32: (loss, {port name:
    gradient})."""
    import sincformer_tpu.train.dcse_trainer as jax_dcse
    from sincformer_tpu.models.dcse import SpeechEnhancer
    from sincformer_tpu.ops.attention import ring_mesh
    from sincformer_tpu.parallel.mesh import make_mesh
    from sincformer_tpu_torch.compat.from_jax import _dcse_named
    pipe = jax_dcse.DCSEPipeline(
        model=SpeechEnhancer(n_freq=129, dropout=0.0, attn_impl="ring",
                             **NARROW_DCSE), model_dir=tempfile.mkdtemp(),
        compute_dtype=jnp.bfloat16 if bf16 else None)
    params = narrow_dcse()["params"]
    noisy, clean = _trainer_batch()

    def f(p):
        return jax.value_and_grad(lambda p_: pipe._loss_fn(
            p_, None, noisy, clean, jax.random.PRNGKey(0), True)[0])(p)
    with _PATCH_LOCK, mock.patch.object(
            jax_dcse, "multi_resolution_stft_loss",
            lambda pred, target: jnp.sum(pred) * 0.0), \
            ring_mesh(make_mesh(2, ("data",)), "data"):
        lowered = jax.jit(f, compiler_options=NOEX if bf16 else None
                          ).lower(params)
    loss, grads = lowered.compile()(params)
    return float(loss), _dcse_named(jax.tree.map(np.asarray, grads))


# the modules under ring_mesh: (kind, features, kernel, norm) and frames
MODULES = {"even_k": (("depthwise", 8, 6, None), 40),
           "short_block": (("depthwise", 8, 7, None), 4),
           "batch": (("conv", 8, 7, "batch"), 40),
           "group": (("conv", 8, 7, "group"), 40)}


@functools.lru_cache(maxsize=None)
def _module_cases() -> dict:
    """Each case of :data:`MODULES` with seeded parameters and buffers,
    input and cotangent, in float64: the ranks' sums of partial
    statistics and gradients then agree with one process far below the
    bar, and a block's own statistics or a zero-padded block edge miss it
    by orders of magnitude."""
    from tests._torch_tp_jobs import module_of
    rng = np.random.default_rng(37)
    cases = {}
    for name, (spec, t) in MODULES.items():
        state = {k: rng.standard_normal(v.shape) * 0.3
                 for k, v in module_of(spec).state_dict().items()}
        cases[name] = {"spec": spec, "state": state, **{
            k: rng.standard_normal((2, t, spec[1])) for k in ("x", "cot")}}
    return cases


@pytest.fixture(scope="module")
def ahead(tmp_path_factory):
    """JAX's block first (its parameters go to the ranks), then the ranks'
    job, and JAX's ring and conv references meanwhile."""
    import sincformer_tpu.models.conformer  # noqa: F401
    import sincformer_tpu.ops.ring_attention  # noqa: F401
    from sincformer_tpu_torch.compat.from_jax import _dcse_named
    params = _jax_block()[0]
    i = _inputs()
    noisy, clean = _trainer_batch()
    job = {"kind": "cp", **{n: i[n] for n in ("q", "k", "v", "x", "y",
                                              "conv_x", "conv_b",
                                              "conv_cot", "mask")},
           "noisy": noisy, "clean": clean, "dcse": narrow_dcse()["params"],
           "conv_w": np.ascontiguousarray(i["conv_k"].transpose(2, 1, 0)),
           "block": {"d_model": 32, "num_heads": 2, "d_ff": 64,
                     "kernel_size": 7},
           "block_params": {k: np.ascontiguousarray(v) for k, v in
                            _dcse_named(params).items()},
           "modules": _module_cases()}
    ticket = worker.pool().submit(job, str(tmp_path_factory.mktemp("cp")))
    a = Ahead()
    with a.start([(_jax_ring_and_full,), (_jax_conv,), (_jax_cp_bf16,),
                  (_jax_ring_step, False), (_jax_ring_step, True)]):
        a.ranks, a.job = ticket, job
        yield a


def _np(t) -> np.ndarray:
    return t.detach().numpy().astype(np.float64)


def test_ring_attention_over_two_ranks(ahead):
    """Each rank's block of the ring's output, joined, against JAX's ring
    on two devices and against full attention. With a valid-frame mask the
    ring warns and falls back, as JAX's dispatch does: each rank's block
    of the whole sequence's masked attention, against JAX's."""
    from sincformer_tpu.ops.attention import dot_product_attention
    outs = ahead.ranks.result()
    got = np.concatenate([_np(o["ring"]) for o in outs], axis=1)
    ring, full = ahead(_jax_ring_and_full)
    assert np.abs(got - ring).max() <= RING_TOL
    assert np.abs(got - full).max() <= RING_TOL
    i = _inputs()
    masked = np.asarray(dot_product_attention(
        *(jnp.asarray(i[n]) for n in "qkv"), mask=jnp.asarray(i["mask"]),
        impl="xla"))
    for o in outs:
        assert any("valid-frame mask" in w for w in o["masked"]["warned"])
    got = np.concatenate([_np(o["masked"]["out"]) for o in outs], axis=1)
    assert np.abs(got - masked).max() <= RING_TOL


def test_ring_conformer_block_matches_jax(ahead):
    """The ring block over two ranks against JAX's one-device block with
    plain attention: the loss, the input gradient and every parameter's
    gradient at JAX's bars; one SGD step lowers the loss; a hop whose
    backward keeps the gradient misses the input-gradient bar."""
    from sincformer_tpu_torch.compat.from_jax import _dcse_named
    outs = ahead.ranks.result()
    _, loss, gp, gx = _jax_block()
    got = [o["block"] for o in outs]
    assert abs(sum(g["loss"] for g in got) - loss) <= LOSS_RTOL * abs(loss)
    x_grad = sum(_np(g["x_grad"]) for g in got)
    assert np.abs(x_grad - gx).max() <= X_GRAD_TOL
    want = _dcse_named(gp)
    worst = {k: float(np.abs(sum(_np(g["grads"][k]) for g in got)
                             - w).max()) for k, w in want.items()}
    assert set(worst) == set(got[0]["grads"])
    assert max(worst.values()) <= P_GRAD_TOL, worst
    before, after = outs[0]["sgd"]
    assert outs[1]["sgd"] == (before, after)
    assert np.isfinite(before) and after < before, (before, after)
    kept = sum(_np(o["kept_hop"]["x_grad"]) for o in outs)
    miss = float(np.abs(kept - gx).max()) / X_GRAD_TOL
    print(f"hop whose backward keeps the gradient: input gradient "
          f"{miss:.3g} x the bar")
    assert miss > 1.0


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_halo_conv_matches_jax_local_conv(ahead, shape):
    """``cp_depthwise_conv`` over the "data" axis of a (2, 1) mesh (two
    blocks of 20 frames) and of a (1, 2) mesh (one block, the model axis
    unused) against JAX's conv on one device: the output and the
    gradients in the input, the weight and the bias within 1e-5."""
    outs = [o["conv"][shape] for o in ahead.ranks.result()]
    y, (gx, gk, gb) = ahead(_jax_conv)
    assert [o["n"] for o in outs] == [shape[0]] * 2
    # two blocks make one sequence; one block is the whole on each rank
    for ranks in ([outs] if shape[0] == 2 else [[o] for o in outs]):
        ranks = sorted(ranks, key=lambda o: o["r"])
        got = {"y": np.concatenate([_np(o["y"]) for o in ranks], axis=1)}
        for g in ("x_grad", "w_grad", "b_grad"):
            got[g] = sum(_np(o[g]) for o in ranks)
        assert np.abs(got["y"] - y).max() <= CONV_TOL
        assert np.abs(got["x_grad"] - gx).max() <= CONV_TOL
        assert np.abs(got["w_grad"] - gk.transpose(2, 1, 0)).max() \
            <= CONV_TOL
        assert np.abs(got["b_grad"] - gb).max() <= CONV_TOL


def test_ring_and_halo_conv_in_bf16_match_jax(ahead):
    """The two ranks' blocks of the bf16 ring attention and halo conv,
    joined, against JAX's on a 2-device mesh in bf16: the ring widens q,
    k and v to f32, keeps P in f32 and rounds the output once; the conv
    rounds the convolution, then its sum with the bias."""
    import torch.nn.functional as F

    from tests._torch_bf16 import agreement, attention_scale
    outs = ahead.ranks.result()
    ring_want, conv_want = ahead(_jax_cp_bf16)
    i = _inputs()
    bf = {n: torch.from_numpy(i[n]).bfloat16().float()
          for n in ("q", "k", "v", "conv_x", "conv_b")}
    w = torch.from_numpy(i["conv_k"].transpose(2, 1, 0).copy())
    conv_terms = F.conv1d(F.pad(bf["conv_x"].abs().transpose(1, 2), (3, 3)),
                          w.bfloat16().float().abs(),
                          bf["conv_b"].abs(), groups=w.shape[0])
    for name, want, terms in (
            ("ring", ring_want, attention_scale(*(bf[n] for n in "qkv"))),
            ("conv", conv_want, conv_terms.transpose(1, 2))):
        got = torch.cat([o["bf16"][name] for o in outs], dim=1)
        share, ulps = agreement(got, want, terms)
        print(f"bf16 {name} on 2 ranks vs JAX on 2 devices: {share:.5f} "
              f"bit-equal, worst {ulps:.3f} ulp")
        assert got.dtype == torch.bfloat16
        assert share >= SHARE_16 and ulps <= ULPS_16, name


def test_trainer_step_under_a_ring_matches_jax(ahead):
    """``DCSETrainer.loss_and_grads`` of the narrow model with JAX's
    weights and ``attn_impl="ring"`` under ``ring_mesh`` on two ranks
    (each runs its 26 of the 52 frames, the enhanced STFT is gathered, the
    gradients summed over the ring) against JAX's training forward traced
    under ``ring_mesh`` on two devices. In float32 at JAX's ring bars
    above (the loss 1e-5 relative, each parameter's gradient 5e-4); in
    bf16 at the bf16 step's bars of ``tests/test_torch_bf16.py`` against
    JAX's bf16 and f32 ring steps (module constants). Both ranks return
    the same step. Against the port's step without a mesh (one process,
    ``attn_impl="speech"``): float32 at the same bars; bf16 by each
    gradient leaf's noise, the ring's bf16 error beside one process's (a
    different bf16 function: the ring keeps P in f32 and rounds K's and
    V's gradients at each hop)."""
    from tests._torch_tp_jobs import cp_trainer
    outs = [o["trainer"] for o in ahead.ranks.result()]
    for dtype in ("f32", "bf16"):
        a, b = outs[0][dtype], outs[1][dtype]
        assert a["loss"] == b["loss"], dtype
        assert all(torch.equal(a["grads"][k], b["grads"][k])
                   for k in a["grads"]), dtype
    (l32, g32), (l16, g16) = (ahead(_jax_ring_step, bf16)
                              for bf16 in (False, True))
    got32, got16 = outs[0]["f32"], outs[0]["bf16"]
    assert set(got32["grads"]) == set(g32)
    worst32 = max(float(np.abs(_np(got32["grads"][k]) - g).max())
                  for k, g in g32.items())
    loss_rel16 = abs(got16["loss"] - l16) / abs(l16)
    rows = [ratios(got16["grads"][k], g16[k], g32[k]) for k in g16]
    noise, cross = [r[0] for r in rows], [r[1] for r in rows]
    print(f"trainer step on a 2-rank ring vs JAX's on 2 devices: f32 loss "
          f"{abs(got32['loss'] - l32) / abs(l32):.3g} relative, gradients "
          f"{worst32:.3g}; bf16 loss {loss_rel16:.3g} relative (JAX's bf16 "
          f"{abs(l16 - l32) / abs(l32):.3g} from its f32), gradients' noise "
          f"{min(noise):.3f}-{max(noise):.3f} (median "
          f"{np.median(noise):.3f}), cross {min(cross):.3f}-"
          f"{max(cross):.3f} (median {np.median(cross):.3f})")
    assert abs(got32["loss"] - l32) <= LOSS_RTOL * abs(l32)
    assert worst32 <= P_GRAD_TOL

    one = cp_trainer(ahead.job)
    one32, one16 = one["f32"], one["bf16"]
    worst_one = max(float((got32["grads"][k] - g).abs().max())
                    for k, g in one32["grads"].items())
    ring_noise = [distance(got16["grads"][k], g) / distance(
        one16["grads"][k], g) for k, g in one32["grads"].items()]
    print(f"the same ring step vs the port's without a mesh: f32 loss "
          f"{abs(got32['loss'] - one32['loss']) / abs(one32['loss']):.3g} "
          f"relative, gradients {worst_one:.3g}; bf16 gradients' noise "
          f"median {np.median(ring_noise):.3f}, worst {max(ring_noise):.3f}")
    assert abs(got32["loss"] - one32["loss"]) <= LOSS_RTOL * abs(
        one32["loss"])
    assert worst_one <= P_GRAD_TOL
    assert np.isfinite(got16["loss"])
    assert np.median(ring_noise) <= RING_NOISE_MEDIAN
    assert max(ring_noise) <= RING_NOISE_WORST
    assert loss_rel16 <= STEP_LOSS_REL
    assert STEP_NOISE[0] <= min(noise) and max(noise) <= STEP_NOISE[1]
    assert STEP_NOISE_MEDIAN[0] <= np.median(noise) <= STEP_NOISE_MEDIAN[1]
    assert max(cross) <= STEP_CROSS
    assert np.median(cross) <= STEP_CROSS_MEDIAN


def test_cp_ops_refuse_what_jax_asserts(ahead):
    """On two ranks: ring attention with T = 63, the halo conv with an even
    kernel, with T = 41 and with blocks of 2 frames against a halo of 3."""
    raises = ahead.ranks.result()[0]["raises"]
    assert "must divide" in raises["ring_t"]
    assert "odd kernel" in raises["conv_even_k"]
    assert "must divide" in raises["conv_t"]
    assert "shorter than halo" in raises["conv_block"]


@pytest.mark.parametrize("case", list(MODULES))
def test_modules_under_ring_match_one_process(ahead, case):
    """Under ``ring_mesh`` on two ranks: the depthwise conv with an even
    kernel (blocks of 20 frames) and with blocks of 2 frames against a halo
    of 3, where JAX's module convolves the whole sequence, and the conv
    module (k 7, the halo conv) with "batch" norm in a training forward
    and with "group" norm, whose statistics span every rank's frames.
    Each rank's block joined, the gradients summed over the ranks and the
    BatchNorm's running statistics against the one-process module, within
    1e-5 (float64)."""
    from tests._torch_tp_jobs import apply_module, module_of
    c = _module_cases()[case]
    mod = module_of(c["spec"], c["state"])
    x = torch.from_numpy(c["x"]).requires_grad_(True)
    y = apply_module(mod, c, x)
    gx, *gp = torch.autograd.grad(torch.sum(y * torch.from_numpy(c["cot"])),
                                  [x, *mod.parameters()])
    outs = [o["modules"][case] for o in ahead.ranks.result()]
    got = np.concatenate([_np(o["y"]) for o in outs], axis=1)
    assert np.abs(got - _np(y)).max() <= CONV_TOL
    assert np.abs(sum(_np(o["x_grad"]) for o in outs) - _np(gx)).max() \
        <= CONV_TOL
    for (k, _), g in zip(mod.named_parameters(), gp):
        assert np.abs(sum(_np(o["grads"][k]) for o in outs)
                      - _np(g)).max() <= CONV_TOL, k
    for k, b in mod.named_buffers():
        for o in outs:
            assert np.abs(_np(o["buffers"][k]) - _np(b)).max() <= CONV_TOL, k


def test_ring_block_without_a_context():
    """``attn_impl="ring"`` with no ``ring_mesh``: a training forward (one
    given a generator) raises JAX's "training apply" error; an inference
    forward warns and equals the block with ``"speech"`` attention."""
    from sincformer_tpu_torch.models.conformer import ConformerBlock
    torch.manual_seed(0)
    blk = ConformerBlock(**BLOCK, attn_impl="ring")
    for p in blk.parameters():
        torch.nn.init.normal_(p, std=0.2)
    x = torch.from_numpy(_inputs()["x"])
    with pytest.raises(RuntimeError, match="training apply"):
        blk(x, generator=torch.Generator().manual_seed(1))
    with pytest.warns(RuntimeWarning, match="ring"):
        got = blk(x)
    blk.MultiHeadSelfAttention_0.attn_impl = "speech"
    assert torch.equal(got, blk(x))


@pytest.mark.slow
def test_dryrun_on_four_cpu_processes():
    """``python -m sincformer_tpu_torch.parallel.dryrun 4 --device cpu``
    from a clean environment: JAX's four checks on a (2, 2) mesh of gloo
    processes, and JAX's tail line with OK."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    proc = subprocess.run(
        [sys.executable, "-m", "sincformer_tpu_torch.parallel.dryrun", "4",
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    tail = proc.stdout.strip().splitlines()[-1]
    for field in ("mesh={'data': 2, 'model': 2}", "loss=", "ring_attn_delta=",
                  "cp_train_loss=", "->", "ring_grad_delta=",
                  "eval_cell_stoi=", "eval_cell_ssnr="):
        assert field in tail, tail
    assert tail.endswith(" OK"), tail
