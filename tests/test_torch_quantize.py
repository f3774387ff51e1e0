"""Kernel K2 (int8 stochastic rounding) and the quantized parameter trees of
the port against sincformer_tpu/ops/quantize.py.

The random streams cannot agree (the JAX package draws from the TPU's
generator or from threefry, the port from Philox keyed by element index), so
parity with JAX means the bars of tests/test_pallas_ops.py::TestInt8Quantize:
a round-trip error of at most one step per channel, a mean rounding error
under 2e-3 on that test's input, small leaves untouched. What is exact:
the scales (same amax, same division), and dequantization of the JAX
package's own (q, s)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sincformer_tpu.ops import quantize as jq
from sincformer_tpu_torch.ops import quantize as tq
from tests._torch_parity import narrow_model


def _philox_numpy(counter: np.ndarray, seed: int) -> np.ndarray:
    """Philox-4x32-10 of (counter lo, counter hi, 0, 0), written again with
    numpy uint64 products, independent of the port's int64 arithmetic."""
    m32 = np.uint64(0xFFFFFFFF)
    c = [counter.astype(np.uint64) & m32, counter.astype(np.uint64) >> np.uint64(32),
         np.zeros_like(counter, np.uint64), np.zeros_like(counter, np.uint64)]
    k0, k1 = seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF
    for _ in range(10):
        p0 = np.uint64(0xD2511F53) * c[0]
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ np.uint64(k0), p1 & m32,
             (p0 >> np.uint64(32)) ^ c[3] ^ np.uint64(k1), p0 & m32]
        k0, k1 = (k0 + 0x9E3779B9) & 0xFFFFFFFF, (k1 + 0xBB67AE85) & 0xFFFFFFFF
    return np.stack(c, axis=1)


def test_philox_known_answer_and_numpy_twin():
    """The published known-answer vector of Philox-4x32-10 for the zero
    counter and key, and an independent numpy implementation on large
    counters and a 64-bit seed."""
    zero = tq._philox4x32_10(torch.tensor([0]), 0)[0].tolist()
    assert zero == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    counter = np.array([0, 1, 2, 0xFFFFFFFF, 1 << 32, (1 << 40) + 12345])
    seed = 0xDEADBEEF12345678
    got = tq._philox4x32_10(torch.from_numpy(counter), seed).numpy()
    np.testing.assert_array_equal(got.astype(np.uint64),
                                  _philox_numpy(counter, seed))


@pytest.mark.parametrize("channel_axis", [0, 1])
def test_roundtrip_error_bounded(channel_axis):
    """TestInt8Quantize bar: |dequantize(quantize(x)) - x| <= one step of
    the element's channel (+1e-7), on a non-square ragged matrix."""
    x = (np.random.default_rng(1234).standard_normal((67, 129)) * 0.1
         ).astype(np.float32)
    vals, scales = tq.quantize_int8(torch.from_numpy(x), seed=1,
                                    channel_axis=channel_axis)
    assert vals.dtype == torch.int8
    assert scales.shape == (x.shape[channel_axis],)
    back = tq.dequantize_int8(vals, scales, channel_axis).numpy()
    step = scales.numpy()[:, None] if channel_axis == 0 \
        else scales.numpy()[None, :]
    assert np.all(np.abs(back - x) <= step + 1e-7)


def test_stochastic_rounding_zero_mean():
    """TestInt8Quantize bar, same input: 30 seeds of an off-grid value
    average to it within 2e-3 (the step is 1/127 = 7.9e-3)."""
    x = torch.full((256, 8), 0.31641)
    x[0, :] = 1.0                       # pins every column's scale
    acc = np.zeros((256, 8))
    for seed in range(30):
        vals, scales = tq.quantize_int8(x, seed=seed, channel_axis=1)
        acc += tq.dequantize_int8(vals, scales, 1).numpy()
    assert np.abs(acc[1:] / 30 - 0.31641).mean() < 2e-3


def test_seed_and_element_index_key_the_bits():
    """Another seed gives other roundings; the same seed the same; a value
    on the grid is never moved."""
    x = torch.from_numpy((np.random.default_rng(0).standard_normal((64, 64))
                          ).astype(np.float32))
    a, _ = tq.quantize_int8(x, seed=3)
    b, _ = tq.quantize_int8(x, seed=3)
    c, _ = tq.quantize_int8(x, seed=4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    grid = torch.arange(-127, 128, dtype=torch.float32).repeat(4, 1)
    vals, scales = tq.quantize_int8(grid, seed=9)
    assert torch.equal(vals.float(), grid) and torch.all(scales == 1.0)


def test_scales_equal_jax_on_non_square_leaves():
    """One scale per output channel: the JAX package scales the columns of
    its (in, out) and (k, in, out) kernels, the port the rows of its
    (out, in) and (out, in, k) weights, so ``s`` has the same length and
    the same float32 values, bit for bit."""
    rng = np.random.default_rng(5)
    dense = rng.standard_normal((48, 96)).astype(np.float32)       # in, out
    conv = rng.standard_normal((5, 24, 40)).astype(np.float32)     # k, in, out
    bank = rng.standard_normal((64, 72)).astype(np.float32)        # as is
    jtree = jq.quantize_tree({"dense": {"kernel": jnp.asarray(dense)},
                              "conv": {"kernel": jnp.asarray(conv)},
                              "memory": {"keys": jnp.asarray(bank)}})
    ttree = tq.quantize_tree({
        "dense.weight": torch.from_numpy(dense.T.copy()),
        "conv.weight": torch.from_numpy(conv.transpose(2, 1, 0).copy()),
        "memory.keys": torch.from_numpy(bank)})
    for jname, tname, axis, n in (("dense", "dense.weight", 0, 96),
                                  ("conv", "conv.weight", 0, 40),
                                  ("memory", "memory.keys", 1, 72)):
        leaf = next(iter(jtree[jname].values()))
        node = ttree[tname]
        assert node["axis"] == axis and node["s"].shape == (n,)
        assert node["q"].shape[axis] == n
        np.testing.assert_array_equal(node["s"].numpy(), np.asarray(leaf["s"]))


def test_tree_skips_small_leaves_and_counts_seeds():
    """Leaves with ndim < 2 or fewer than 4096 elements stay float32; the
    k-th quantized leaf is rounded under seed + k."""
    rng = np.random.default_rng(2)
    params = {"a.weight": torch.from_numpy(rng.standard_normal((128, 64)
                                                               ).astype("f4")),
              "a.bias": torch.zeros(64),
              "small.weight": torch.ones(63, 65),
              "b.weight": torch.from_numpy(rng.standard_normal((64, 128)
                                                               ).astype("f4"))}
    tree = tq.quantize_tree(params, seed=10)
    assert tq.is_quantized(tree["a.weight"]) and tq.is_quantized(tree["b.weight"])
    assert tree["a.bias"].dtype == torch.float32
    assert tree["small.weight"].dtype == torch.float32
    assert torch.equal(tree["a.weight"]["q"],
                       tq.quantize_int8(params["a.weight"], seed=11)[0])
    assert torch.equal(tree["b.weight"]["q"],
                       tq.quantize_int8(params["b.weight"], seed=12)[0])
    back = tq.dequantize_tree(tree)
    err = (back["a.weight"] - params["a.weight"]).abs().max()
    assert err < params["a.weight"].abs().max() / 127 + 1e-6


def test_dequantize_tree_bit_equal_on_jax_params_q():
    """The JAX package's own quantized tree of the narrow flagship, carried
    over by convert_quantized_from_jax (q transposed, s kept, nothing
    rounded again), dequantizes to exactly what load_from_jax makes of the
    JAX package's dequantized tree."""
    from sincformer_tpu_torch.compat.from_jax import (
        convert_quantized_from_jax, load_from_jax)
    from tests._torch_parity import NARROW
    import jax
    _, variables, _ = narrow_model()
    overrides = dict(num_heads=NARROW["num_heads"],
                     sinc_kernel_size=NARROW["sinc_kernel_size"])
    params_q = jax.tree.map(np.asarray, jax.jit(jq.quantize_tree)(
        jax.tree.map(jnp.asarray, variables["params"])))
    model_state = {k: v for k, v in variables.items() if k != "params"}
    converted, buffers, config = convert_quantized_from_jax(
        params_q, model_state, **overrides)
    n_q = sum(tq.is_quantized(v) for v in converted.values())
    assert n_q >= 3, "the narrow model must have quantized leaves"
    deq = jax.tree.map(np.asarray, jax.jit(jq.dequantize_tree)(
        jax.tree.map(jnp.asarray, params_q)))
    want, want_buffers, want_config = load_from_jax(
        {"params": deq, **model_state}, **overrides)
    assert config == want_config
    got = tq.dequantize_tree(converted)
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    for name in want_buffers:
        assert torch.equal(buffers[name], want_buffers[name]), name


def test_cpu_tensor_takes_plain_version_without_launch():
    x = torch.randn(70, 66, generator=torch.Generator().manual_seed(0))
    before = tq.quantize_int8.launches
    vals, scales = tq.quantize_int8(x, seed=5)
    assert tq.quantize_int8.launches == before
    assert torch.equal(vals, tq._quantize_plain(x, scales[:, None], 5))
    with pytest.raises(TypeError, match="float32"):
        tq.quantize_int8(x.double())
    with pytest.raises(ValueError, match="matrix"):
        tq.quantize_int8(x[0])


@pytest.mark.gpu
@pytest.mark.parametrize("shape,channel_axis", [((256, 1024), 0),
                                                ((67, 129), 0),
                                                ((67, 129), 1)])
def test_cuda_kernel_equals_plain(shape, channel_axis):
    """Needs a CUDA card and nvcc (builds csrc/quantize_int8.cu): the
    kernel's int8 output equals the plain version's, element for element."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    x = torch.randn(*shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0)) * 0.1
    before = tq.quantize_int8.launches
    vals, scales = tq.quantize_int8(x, seed=7, channel_axis=channel_axis)
    torch.cuda.synchronize()
    assert tq.quantize_int8.launches == before + 1
    s = scales[:, None] if channel_axis == 0 else scales[None, :]
    assert torch.equal(vals, tq._quantize_plain(x, s, 7))


# a tree of every kind of leaf the kernel's table takes: rows scaled (the
# port's weights, C % 4 != 0 too, one row), columns scaled (a memory bank,
# C % 4 != 0), and leaves that stay float32 (under 4096 elements, 1-D)
MIXED_SHAPES = {"a.weight": (40, 33, 5), "bank.keys": (70, 130),
                "a.bias": (40,), "small.weight": (63, 65),
                "b.weight_ih_l0": (300, 256), "one.weight": (1, 4099),
                "bank.values": (4099, 3), "c.weight": (8, 20480)}


def _mixed_tree():
    rng = np.random.default_rng(11)
    return {name: torch.from_numpy((rng.standard_normal(shape) * 0.1
                                    ).astype(np.float32))
            for name, shape in MIXED_SHAPES.items()}


def test_work_table_covers_every_element_once():
    """The kernel's table: every element of every quantized leaf falls in
    exactly one block, the k-th quantized leaf (dictionary order) keyed by
    seed + k, the blocks of the leaves consecutive from 0."""
    entries, n_blocks = tq.work_table(MIXED_SHAPES, seed=40)
    quantized = [n for n, s in MIXED_SHAPES.items() if tq.is_quantizable(s)]
    assert [e.name for e in entries] == quantized
    assert [e.key for e in entries] == [40 + k for k in
                                        range(1, len(quantized) + 1)]
    assert {e.name: e.axis for e in entries} == {
        "a.weight": 0, "bank.keys": 1, "b.weight_ih_l0": 0,
        "one.weight": 0, "bank.values": 1, "c.weight": 0}
    first = 0
    for e in entries:
        shape = MIXED_SHAPES[e.name]
        assert e.rows * e.cols == int(np.prod(shape))
        assert e.first_block == first
        first += e.n_blocks
        hits = np.zeros((e.rows, e.cols), dtype=np.int64)
        for blk in range(e.n_blocks):
            rows, cols = tq.block_span(e, blk)
            assert rows.stop > rows.start and cols.stop > cols.start
            hits[rows, cols] += 1
        assert np.all(hits == 1), e.name
    assert first == n_blocks


def test_tree_on_cpu_matches_leaf_by_leaf():
    """The CPU tree rounds each leaf as quantize_int8 does under its key,
    along the leaf's channel axis, and keeps the small leaves."""
    params = _mixed_tree()
    tree = tq.quantize_tree(params, seed=40)
    for e in tq.work_table(MIXED_SHAPES, seed=40)[0]:
        mat = params[e.name].reshape(e.rows, e.cols)
        q, s = tq.quantize_int8(mat, seed=e.key, channel_axis=e.axis)
        assert torch.equal(tree[e.name]["q"].reshape(e.rows, e.cols), q)
        assert torch.equal(tree[e.name]["s"], s)
    assert torch.equal(tree["a.bias"], params["a.bias"])
    assert torch.equal(tree["small.weight"], params["small.weight"])


@pytest.mark.gpu
def test_cuda_tree_equals_cpu_tree_in_one_launch():
    """Needs a CUDA card and nvcc: the card's quantize_tree is one launch
    for the whole tree and equals the CPU's bit for bit (int8 values,
    scales, axis); a NaN in a channel gives that channel a NaN scale, as
    torch.amax does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    params = _mixed_tree()
    params["bank.keys"][5, 17] = float("nan")
    params["a.weight"][3, 0, 0] = float("nan")
    on_card = {n: p.cuda() for n, p in params.items()}
    before = tq.quantize_int8.launches
    tree = tq.quantize_tree(on_card, seed=40)
    torch.cuda.synchronize()
    assert tq.quantize_int8.launches == before + 1
    want = tq.quantize_tree(params, seed=40)
    for name, node in want.items():
        if not tq.is_quantized(node):
            assert torch.equal(tree[name].cpu(), node)
            continue
        got = tree[name]
        assert got["axis"] == node["axis"]
        torch.testing.assert_close(got["s"].cpu(), node["s"], rtol=0, atol=0,
                                   equal_nan=True)
        # int8 of a NaN is left to the cast: compare the finite channels
        shape = [1] * node["q"].ndim
        shape[node["axis"]] = -1
        keep = torch.isfinite(node["s"]).reshape(shape).expand_as(node["q"])
        assert torch.equal(got["q"].cpu()[keep], node["q"][keep]), name
    assert torch.isnan(tree["bank.keys"]["s"][17].cpu())
    assert torch.isnan(tree["a.weight"]["s"][3].cpu())


def test_tree_saves_only_its_own_bytes():
    """A small leaf that is a view into a larger storage (as cuDNN's flat
    LSTM weights hold the biases on the card) is copied, so the saved tree
    does not carry the whole storage with it."""
    import io
    flat = torch.randn(100_000)
    params = {"w.weight": flat[:8192].view(64, 128), "w.bias": flat[8192:8256]}
    tree = tq.quantize_tree(params)
    assert torch.equal(tree["w.bias"], params["w.bias"])
    buf = io.BytesIO()
    torch.save(tree, buf)
    assert buf.tell() < 4 * 20_000
