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

One process: a ConformerBlock with ``attn_impl="ring"`` and no ring
context raises in a training forward and warns and falls back in
inference (the dispatch itself: ``tests/test_torch_modules.py``). The dry
run on four CPU processes is marked ``slow``, as JAX's is."""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import _torch_dp_worker as worker
from tests._torch_parity import Ahead, _fill

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = dict(d_model=32, num_heads=2, d_ff=64, kernel_size=7)
RING_TOL = 5e-5
LOSS_RTOL, X_GRAD_TOL, P_GRAD_TOL = 1e-5, 3e-5, 5e-4
CONV_TOL = 1e-5


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
    job = {"kind": "cp", **{n: i[n] for n in ("q", "k", "v", "x", "y",
                                              "conv_x", "conv_b",
                                              "conv_cot", "mask")},
           "conv_w": np.ascontiguousarray(i["conv_k"].transpose(2, 1, 0)),
           "block": {"d_model": 32, "num_heads": 2, "d_ff": 64,
                     "kernel_size": 7},
           "block_params": {k: np.ascontiguousarray(v) for k, v in
                            _dcse_named(params).items()},
           "modules": _module_cases()}
    ticket = worker.pool().submit(job, str(tmp_path_factory.mktemp("cp")))
    a = Ahead()
    with a.start([(_jax_ring_and_full,), (_jax_conv,)]):
        a.ranks = ticket
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
