"""Kernel K5 (Conv1d + GroupNorm [+ skip] [+ GELU]): the port's plain
version against the JAX Pallas kernel run in interpret mode and against the
JAX reference formulation, on the geometries of
tests/test_pallas_ops.py::TestConvGN, and the CUDA kernel against the plain
version where a card is present; the CUDA kernel's split-TF32 arithmetic
emulated on the CPU against the JAX reference.

Tolerance 1e-5 of the output's scale (float32 on both sides, a contraction
over up to 1280 products summed in another order, then a normalisation)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sincformer_tpu.ops import conv_gn_pallas as jax_conv_gn
from sincformer_tpu_torch.ops.conv_gn import (_same_pads, conv1d_gn,
                                              conv_gn_reference)

TOL = 1e-5
GEOMETRIES = [
    (1000, 64, 128, 7, 2, True, False),    # PA block conv1
    (500, 128, 128, 3, 1, False, True),    # PA block conv2 (+ skip)
    (1000, 64, 128, 1, 2, False, False),   # PA block skip conv
    (512, 256, 256, 5, 2, True, False),    # PA downsample
    (513, 128, 256, 7, 2, True, False),    # odd T
]


def _inputs(t, cin, cout, k, s, with_skip, mean=0.0, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    t_out = -(-t // s)
    return ((rng.standard_normal((2, t, cin)) + mean).astype(f),
            (rng.standard_normal((k, cin, cout)) * 0.1).astype(f),
            (rng.standard_normal(cout) * 0.1).astype(f),
            (1 + 0.1 * rng.standard_normal(cout)).astype(f),
            (0.1 * rng.standard_normal(cout)).astype(f),
            rng.standard_normal((2, t_out, cout)).astype(f)
            if with_skip else None)


def _torch(args):
    return [None if a is None else torch.from_numpy(a) for a in args]


def _jax(args):
    return [None if a is None else jnp.asarray(a) for a in args]


def _assert_close(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = float(np.max(np.abs(got - ref)))
    assert err <= TOL * float(np.abs(ref).max()), err


@pytest.mark.parametrize("t,cin,cout,k,s,act,with_skip", GEOMETRIES)
def test_plain_matches_pallas_interpret(t, cin, cout, k, s, act, with_skip):
    args = _inputs(t, cin, cout, k, s, with_skip)
    ref = jax_conv_gn._conv1d_gn_pallas(*_jax(args), stride=s, groups=16,
                                        eps=1e-6, act=act, interpret=True)
    got = conv1d_gn(*_torch(args), stride=s, groups=16, act=act)
    _assert_close(got.numpy(), ref)


@pytest.mark.parametrize("t,cin,cout,k,s,act,with_skip", GEOMETRIES + [
    (300, 32, 48, 9, 1, True, True),       # k = 9 at stride 1
    (257, 24, 80, 21, 2, True, False),     # outside the TPU kernel's guard
])
def test_plain_matches_jax_reference(t, cin, cout, k, s, act, with_skip):
    args = _inputs(t, cin, cout, k, s, with_skip, seed=1)
    ref = jax_conv_gn.conv_gn_reference(*_jax(args), stride=s, groups=16,
                                        act=act)
    got = conv_gn_reference(*_torch(args), stride=s, groups=16, act=act)
    _assert_close(got.numpy(), ref)


def test_input_mean_far_from_zero():
    """Activations with a mean of 4 standard deviations: the variance must
    not be lost in the difference of two large numbers."""
    args = _inputs(1000, 64, 128, 7, 2, False, mean=4.0, seed=2)
    ref = jax_conv_gn.conv_gn_reference(*_jax(args), stride=2, groups=16)
    _assert_close(conv1d_gn(*_torch(args), stride=2, groups=16).numpy(), ref)


@pytest.mark.parametrize("t,k,s", [(1000, 7, 2), (513, 7, 2), (500, 3, 1),
                                   (512, 5, 2), (10, 1, 3), (7, 9, 4)])
def test_same_pads_match_jax(t, k, s):
    assert _same_pads(t, k, s) == jax_conv_gn._same_pads(t, k, s)


def test_arguments_refused():
    x, w, b, ga, be, _ = _torch(_inputs(64, 8, 16, 3, 1, False))
    with pytest.raises(ValueError, match="groups"):
        conv1d_gn(x, w, b, ga, be, None, 1, 5)
    with pytest.raises(ValueError, match="skip"):
        conv1d_gn(x, w, b, ga, be, torch.zeros(2, 63, 16), 1, 4)
    with pytest.raises(ValueError, match="stride"):
        conv1d_gn(x, w, b, ga, be, None, 0, 4)
    with pytest.raises(ValueError, match="Cin"):
        conv1d_gn(x[..., :4], w, b, ga, be, None, 1, 4)


def test_cpu_tensor_takes_plain_version_without_launch():
    args = _torch(_inputs(100, 8, 16, 3, 2, True))
    before = conv1d_gn.launches
    out = conv1d_gn(*args, 2, 4)
    assert conv1d_gn.launches == before
    assert torch.equal(out, conv_gn_reference(*args, stride=2, groups=4))


@pytest.mark.parametrize("t,cin,cout,k,s,act,with_skip,mean", [
    GEOMETRIES[0] + (0.0,), GEOMETRIES[3] + (0.0,),
    (1000, 64, 128, 7, 2, True, False, 4.0)])
def test_split_tf32_meets_the_bar_and_one_tf32_product_misses(
        t, cin, cout, k, s, act, with_skip, mean):
    """The CUDA kernel's convolution runs on the tensor cores in split TF32
    (three products lo.hi + hi.lo + hi.hi); emulated on the CPU it stays
    within 1e-5 of the output's scale of the JAX reference, and one TF32
    product alone does not."""
    from tests._torch_parity import conv_gn_tf32
    args = _inputs(t, cin, cout, k, s, with_skip, mean, seed=3)
    ref = np.asarray(jax_conv_gn.conv_gn_reference(*_jax(args), stride=s,
                                                   groups=16, act=act))
    bar = TOL * float(np.abs(ref).max())
    errs = {terms: float(np.max(np.abs(conv_gn_tf32(
        *_torch(args), stride=s, groups=16, terms=terms, act=act).numpy()
        - ref))) for terms in (3, 1)}
    assert errs[3] <= bar, errs
    assert errs[1] > bar, errs


@pytest.mark.gpu
@pytest.mark.parametrize("t,cin,cout,k,s,act,with_skip,mean,groups", [
    g + (0.0, 16) for g in GEOMETRIES] + [
    (300, 32, 48, 9, 1, True, True, 0.0, 16),
    (257, 24, 80, 21, 2, True, False, 0.0, 16),
    (1000, 64, 128, 7, 2, True, False, 4.0, 16),
    (100, 24, 48, 1, 4, True, False, 0.0, 16),    # K=1, s=4, Tout < a tile
    (333, 12, 80, 5, 4, True, True, 0.0, 16),     # Cin % 8 != 0, s=4
    (50, 3, 18, 3, 1, False, False, 0.0, 3),      # Cin, Cout % 4 != 0
    (1200, 64, 128, 31, 1, True, False, 0.0, 16)])  # taps in groups
def test_cuda_kernel_matches_plain(t, cin, cout, k, s, act, with_skip, mean,
                                   groups):
    """Needs a CUDA card and nvcc (builds csrc/conv_gn.cu)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    args = [None if a is None else a.cuda()
            for a in _torch(_inputs(t, cin, cout, k, s, with_skip, mean))]
    before = conv1d_gn.launches
    out = conv1d_gn(*args, s, groups, 1e-6, act)
    torch.cuda.synchronize()
    assert conv1d_gn.launches == before + 1
    ref = conv_gn_reference(*args, stride=s, groups=groups, act=act)
    assert float((out - ref).abs().max()) <= TOL * float(ref.abs().max())
