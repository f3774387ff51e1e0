"""Kernel K5 (Conv1d + GroupNorm [+ skip] [+ GELU]): the port's plain
version against the JAX Pallas kernel run in interpret mode and against the
JAX reference formulation, on the geometries of
tests/test_pallas_ops.py::TestConvGN, and the CUDA kernel against the plain
version where a card is present; the CUDA kernel's split-TF32 arithmetic
emulated on the CPU against the JAX reference.

Tolerance 1e-5 of the output's scale (float32 on both sides, a contraction
over up to 1280 products summed in another order, then a normalisation)."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sincformer_tpu.ops import conv_gn_pallas as jax_conv_gn
from sincformer_tpu_torch.ops.conv_gn import (_BF16_SMEM, _BF16_WIDTHS,
                                              _bf16_smem, _same_pads,
                                              bf16_instances, bf16_plan,
                                              conv1d_gn,
                                              conv_gn_reference, stat_buffers)
from tests._torch_bf16 import agreement, conv_gn_scale
from tests.test_torch_bf16_port import K5_BATCHED, K5_CARD

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


# chip_smoke.py's CONV_GN_CASES: (T, Cin, Cout, K, s, act, skip, mean,
# groups), the f32 kernel's edges
CARD_CASES = [g + (0.0, 16) for g in GEOMETRIES] + [
    (300, 32, 48, 9, 1, True, True, 0.0, 16),
    (257, 24, 80, 21, 2, True, False, 0.0, 16),
    (1000, 64, 128, 7, 2, True, False, 4.0, 16),
    (100, 24, 48, 1, 4, True, False, 0.0, 16),    # K=1, s=4, Tout < a tile
    (333, 12, 80, 5, 4, True, True, 0.0, 16),     # Cin % 8 != 0, s=4
    (50, 3, 18, 3, 1, False, False, 0.0, 3),      # Cin, Cout % 4 != 0
    (1200, 64, 128, 31, 1, True, False, 0.0, 16),   # taps in groups
    (400, 256, 256, 7, 1, True, True, 4.0, 16)]     # the flagship block
# the bf16 form's other paths at batch 2 (chip_smoke.py's BF16_K5_CASES):
# (T, Cin, Cout, K, s, act, skip, mean, groups, fused, resident, slabs)
BF16_PATHS = [(20000, 64, 128, 31, 1, True, False, 0.0, 16, False, False, 1),
              (30001, 12, 80, 5, 4, True, True, 0.0, 16, False, True, 1),
              (9000, 3, 18, 3, 1, False, False, 0.0, 3, False, True, 1),
              (16000, 256, 256, 7, 2, True, False, 0.0, 16, False, False, 2),
              (20000, 64, 256, 3, 2, True, True, 0.0, 16, False, True, 2),
              (300, 256, 64, 31, 1, True, False, 0.0, 16, True, False, 4)]
# the instantiation (nt, mt, fused) that each of tests/test_torch_bf16_port.py's
# K5_BATCHED shapes reaches
BATCHED_INSTANCES = [(16, 8, True), (32, 1, True), (32, 2, True),
                     (32, 4, True), (128, 1, True), (16, 1, False)]
# PERF.md's timed shapes: (B, T, Cin, Cout, K, s)
CALL_SITE = (16, 32000, 64, 128, 7, 2)
FLAGSHIP_BLOCK = (16, 400, 256, 256, 7, 1)


def _check_plan(plan, bsz, t, cin, cout, k, s, groups):
    """A plan that conv_gn_fwd_bf16 takes: its width, ring and shared
    memory within csrc/conv_gn.cu's bounds, its grid whole slabs."""
    t_out = _same_pads(t, k, s)[0]
    slabs = -(-cout // plan.nb)
    assert plan.nt in _BF16_WIDTHS and 0 < plan.nb <= plan.nt
    assert plan.mt in (1, 2, 4, 8) and plan.mt * plan.nt <= 128
    assert plan.ck % 16 == 0 and 2 <= plan.stages <= 8
    assert plan.fused or (plan.stages % 2 == 0 and plan.stages >= 4)
    assert 1 <= plan.taps <= k and (plan.taps == k or not plan.resident)
    assert plan.smem == _bf16_smem(cin, k, s, plan.nt, plan.mt, plan.ck,
                                   plan.taps, plan.stages, plan.resident,
                                   plan.fused)
    assert plan.smem <= _BF16_SMEM
    assert plan.blocks % slabs == 0 and len(plan.args()) == 9
    if plan.fused:
        assert plan.nb % (cout // groups) == 0 and plan.blocks == bsz * slabs
        assert t_out <= 128 * plan.mt
    else:
        assert plan.nb == plan.nt and plan.mt == 1 and plan.blocks <= 132


@pytest.mark.parametrize("t,cin,cout,k,s,act,with_skip,mean,groups",
                         CARD_CASES)
def test_bf16_plan_maps_every_edge_to_a_kernel_path(t, cin, cout, k, s, act,
                                                    with_skip, mean, groups):
    """Every shape the card holds the kernel at has a bf16 tiling; at batch
    2 those of up to 1,024 output rows fit a batch row's groups in a
    block's registers (one launch)."""
    plan = bf16_plan(2, t, cin, cout, k, s, groups)
    _check_plan(plan, 2, t, cin, cout, k, s, groups)
    assert plan.fused == (_same_pads(t, k, s)[0] <= 1024)


@pytest.mark.parametrize(
    "t,cin,cout,k,s,act,with_skip,mean,groups,fused,resident,slabs",
    BF16_PATHS)
def test_bf16_plan_takes_each_path(t, cin, cout, k, s, act, with_skip, mean,
                                   groups, fused, resident, slabs):
    """The bf16 edge shapes of chip_smoke.py reach two passes and the fused
    path, w resident and streamed (in tap groups at K 31), one slab of
    channels and several."""
    plan = bf16_plan(2, t, cin, cout, k, s, groups)
    _check_plan(plan, 2, t, cin, cout, k, s, groups)
    assert (plan.fused, plan.resident, -(-cout // plan.nb)) == (
        fused, resident, slabs)
    if k == 31 and not fused:
        assert -(-k // plan.taps) >= 2


@pytest.mark.parametrize("shape", [CALL_SITE, FLAGSHIP_BLOCK])
def test_bf16_plan_at_the_timed_shapes(shape):
    """The flagship block is one launch of 128 blocks (400 rows x 32
    channels each) with no f32 buffer at all; the call site is two passes
    on 132 persistent blocks with w resident, whose only f32 buffers are the
    64-row tiles' partials and the statistics, never a (B, Tout, Cout)
    tensor."""
    bsz, t, cin, cout, k, s = shape
    plan = bf16_plan(bsz, t, cin, cout, k, s, 16)
    _check_plan(plan, bsz, t, cin, cout, k, s, 16)
    t_out = _same_pads(t, k, s)[0]
    partial, stats = stat_buffers(plan, bsz, t_out, cout, 16, "cpu")
    if shape == FLAGSHIP_BLOCK:
        assert plan.fused and (plan.nt, plan.blocks) == (32, 128)
        assert partial is None and stats is None
    else:
        assert not plan.fused and plan.resident and plan.blocks == 132
        assert partial.shape == (bsz, 250, cout, 2)
        assert stats.shape == (bsz, 16, 2)


@pytest.mark.parametrize("case,instance",
                         list(zip(K5_BATCHED, BATCHED_INSTANCES)))
def test_bf16_plan_takes_each_instance(case, instance):
    """The batched bf16 shapes reach the instantiations they are held
    for."""
    bsz, t, cin, cout, k, s, _, _, groups = case
    plan = bf16_plan(bsz, t, cin, cout, k, s, groups)
    _check_plan(plan, bsz, t, cin, cout, k, s, groups)
    assert (plan.nt, plan.mt, plan.fused) == instance


def _held_instances(cases):
    """{(nt, mt, fused)} of bf16 plans of (B, T, Cin, Cout, K, s, groups)."""
    return {(p.nt, p.mt, p.fused) for p in (bf16_plan(*c) for c in cases)}


def test_bf16_held_cases_cover_every_instance():
    """Every (NT, MT) that csrc/conv_gn.cu dispatches, on the fused path and
    (MT 1) in two passes, is held against the plain version on the card by
    chip_smoke.py [bf16] and by the gpu tests of
    tests/test_torch_bf16_port.py."""
    import chip_smoke
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "sincformer_tpu_torch", "csrc",
            "conv_gn.cu")) as f:
        dispatched = {(int(a), int(b)) for a, b in re.findall(
            r"CONV_GN_BF16\((\d+), (\d+)\)", f.read())}
    assert dispatched == set(bf16_instances())
    want = {(nt, mt, True) for nt, mt in dispatched} | {
        (nt, 1, False) for nt, mt in dispatched if mt == 1}
    assert list(chip_smoke.BF16_K5_BATCHED) == K5_BATCHED
    smoke = ([(2,) + c[:5] + (c[7],) for c in chip_smoke.BF16_K5_CASES]
             + [c[:6] + (c[8],) for c in K5_BATCHED]
             + [shape + (16,) for _, shape in chip_smoke.BF16_K5_TIMED])
    assert _held_instances(smoke) == want
    card = ([(2,) + c[:5] + (c[7],) for c in K5_CARD]
            + [c[:6] + (c[8],) for c in K5_BATCHED])
    assert _held_instances(card) == want


def test_f32_buffers_are_the_partials_and_statistics():
    partial, stats = stat_buffers(None, 2, 500, 128, 16, "cpu")
    assert partial.shape == (2, 4, 128, 2) and stats.shape == (2, 16, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,cin,cout,k,s,act,with_skip,mean,groups",
                         CARD_CASES + [c[:9] for c in BF16_PATHS])
def test_cuda_kernel_matches_plain(t, cin, cout, k, s, act, with_skip, mean,
                                   groups, dtype):
    """Needs a CUDA card and nvcc (builds csrc/conv_gn.cu). float32: within
    1e-5 of the output's scale; bfloat16: at least 99 % of the elements
    bit-equal to the plain bf16 version and none beyond one bf16 ulp at its
    term scale (tests/_torch_bf16.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    args = [None if a is None else a.cuda().to(dtype)
            for a in _torch(_inputs(t, cin, cout, k, s, with_skip, mean))]
    before = conv1d_gn.launches
    out = conv1d_gn(*args, s, groups, 1e-6, act)
    torch.cuda.synchronize()
    assert conv1d_gn.launches == before + 1
    ref = conv_gn_reference(*args, stride=s, groups=groups, act=act)
    if dtype == torch.float32:
        assert float((out - ref).abs().max()) <= TOL * float(ref.abs().max())
    else:
        share, ulps = agreement(out.cpu(), ref.cpu(),
                                conv_gn_scale(*args, s, groups))
        assert out.dtype == dtype and share >= 0.99 and ulps <= 1.0

