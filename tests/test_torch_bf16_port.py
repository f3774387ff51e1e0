"""The port's bf16 paths that need no JAX reference (this file imports no
JAX, so that its card cases can run on a machine without it): the bf16
forms of kernels K1 and K3 on the card against their plain versions, also
under autograd; the wrappers on CPU tensors; ``remat`` under bf16; a
trainer on a one-rank mesh; the fused feed-forward's cached weights under
bf16 copies; the checkpoints and the serving of a bf16 trainer.

The card's bars are the CPU's (``tests/_torch_bf16.py``): at least 99 % of
the elements bit-equal to the plain bf16 version on the same card and
every element within one bf16 ulp at its term scale."""

import tempfile
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

import tests._torch_dp_worker as worker
from tests._torch_bf16 import (agreement, attention_scale,
                               conv_gn_scale, ffn_scale)

# (B, T, dh, masked) on the card: the shapes chip_smoke.py's [bf16] holds,
# and the edges of the bf16 form's paths: S in registers up to T = 448
# (dh 128: 256), the tiled two-pass form beyond (csrc/speech_attention.cu:
# dh 64 on warpgroup products, the other widths on warp products); at
# B = 8 and 16 a (batch, head) gets fewer blocks than row tiles on 132 SMs,
# so a block walks several tiles on one copy of K and V
K1_CARD = [(4, 400, 64, False), (4, 401, 64, True), (2, 1, 16, False),
           (2, 37, 32, True), (2, 2100, 128, True), (16, 401, 64, False),
           (8, 401, 64, True), (2, 447, 64, True), (2, 448, 64, False),
           (2, 449, 64, True), (2, 448, 16, True), (2, 449, 32, False),
           (2, 255, 128, False), (2, 256, 128, True), (2, 257, 128, False),
           (16, 401, 16, True), (16, 448, 32, True), (16, 255, 128, False),
           (16, 256, 128, True)]
# (rows, d, d_ff): 64-row work units, one a block (its two consumer
# warpgroups splitting d_ff) up to 132 units (an H100's SMs), 128-row tiles
# on persistent blocks beyond; a d_ff that ends 32 columns into a 64-column
# chunk
K3_CARD = [(1, 256, 1024), (401, 256, 1024), (6416, 256, 1024),
           (130, 32, 64), (200, 128, 512), (63, 256, 1024),
           (64, 256, 1024), (65, 256, 1024), (127, 256, 1024),
           (128, 256, 1024), (129, 256, 1024), (3208, 256, 1024),
           (8448, 256, 1024), (8449, 256, 1024), (200, 128, 96),
           (70, 64, 96), (33, 32, 96)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _narrow_config(**fields):
    from sincformer_tpu_torch.config import DCSEConfig
    # here, not at the top: tests._torch_parity imports JAX, which the card
    # tests below need not have
    from tests._torch_parity import NARROW_DCSE
    return DCSEConfig(d_model=NARROW_DCSE["d_model"],
                      num_blocks=NARROW_DCSE["num_blocks"],
                      num_heads=NARROW_DCSE["num_heads"],
                      ff_dim=NARROW_DCSE["d_ff"],
                      kernel_size=NARROW_DCSE["kernel_size"], **fields)


def _trainer(mesh=None, dtype=torch.bfloat16, **fields):
    """A narrow DCSE trainer on the CPU with weights drawn from seed 0."""
    from sincformer_tpu_torch.models.dcse import SpeechEnhancer
    from sincformer_tpu_torch.train.dcse_trainer import DCSETrainer
    pipe = DCSETrainer(SpeechEnhancer(_narrow_config(**fields)),
                       device="cpu", model_dir=tempfile.mkdtemp(),
                       mesh=mesh, compute_dtype=dtype)
    pipe.init_state(worker.LR_EPOCHS, worker.LR_STEPS)
    return pipe


def _batch():
    rng = np.random.default_rng(5)
    clean = (rng.standard_normal((2, 4000)) * 0.2).astype(np.float32)
    noisy = (clean + rng.standard_normal((2, 4000)) * 0.1).astype(np.float32)
    return noisy, clean


def _k1_args(case, device):
    b, t, dh, masked = case
    g = torch.Generator(device=device).manual_seed(t + dh)
    q, k, v = (torch.randn(b, t, 4, dh, device=device, generator=g)
               .bfloat16() for _ in range(3))
    bias = None
    if masked:
        lengths = torch.tensor(([t, t - 7, t // 2, 1] * 4)[:b],
                               device=device).clamp_min(1)
        bias = torch.where(torch.arange(t, device=device)[None]
                           < lengths[:, None], 0.0, -1e9).float()
    return q, k, v, bias


def _k3_args(case, device):
    m, d, f = case
    g = torch.Generator(device=device).manual_seed(m + d)

    def r(*shape, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(*shape, device=device,
                                            generator=g)).bfloat16()
    return (r(m, d), r(d, scale=0.1, shift=1.0), r(d, scale=0.1),
            r(d, f, scale=d ** -0.5), r(f, scale=0.1),
            r(f, d, scale=f ** -0.5), r(d, scale=0.1))


def test_k3_bf16_rules_raise_on_cpu_tensors():
    """The bf16 form's rules, checked on CPU tensors: x is read in 16-byte
    pieces and w1, w2 by TMA (16-byte aligned), d_ff a multiple of 32 and d
    one of the kernel's widths."""
    from sincformer_tpu_torch.ops.fused_ffn import _check_cuda_args
    args = _k3_args((8, 64, 96), "cpu")
    _check_cuda_args(*args)

    def shifted(t):
        """A contiguous tensor of t's shape whose base lies 4 bytes (two
        bf16) past an aligned one."""
        buf = torch.zeros(t.numel() + 8, dtype=t.dtype)
        return buf[2:2 + t.numel()].view(t.shape)
    for i, name in ((0, "x"), (3, "w1"), (5, "w2")):
        bad = list(args)
        bad[i] = shifted(args[i])
        with pytest.raises(ValueError, match=f"{name} aligned to 16"):
            _check_cuda_args(*bad)
    with pytest.raises(ValueError, match="multiple of 32"):
        _check_cuda_args(*_k3_args((8, 64, 48), "cpu"))
    with pytest.raises(ValueError, match="supports d in"):
        _check_cuda_args(*_k3_args((8, 48, 64), "cpu"))


def test_bf16_wrappers_on_cpu_tensors_launch_nothing():
    """On bf16 CPU tensors both wrappers return their plain versions'
    bf16 result and count no launch of either form."""
    from sincformer_tpu_torch.ops.fused_ffn import _fused_ffn_plain, fused_ffn
    from sincformer_tpu_torch.ops.speech_attention import (
        _speech_attention_plain, speech_attention)
    counts = (speech_attention.launches, speech_attention.launches_bf16,
              fused_ffn.launches, fused_ffn.launches_bf16)
    args = _k1_args((2, 37, 32, True), "cpu")
    out = speech_attention(*args)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, _speech_attention_plain(*args))
    args = _k3_args((33, 32, 64), "cpu")
    out = fused_ffn(*args)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, _fused_ffn_plain(*args))
    assert counts == (speech_attention.launches,
                      speech_attention.launches_bf16, fused_ffn.launches,
                      fused_ffn.launches_bf16)


def _k5_args(case, device, dtype=torch.bfloat16, bsz=2):
    t, cin, cout, k, s, act, with_skip, groups = case
    g = torch.Generator(device=device).manual_seed(t + cin)

    def r(*shape, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(*shape, device=device,
                                            generator=g)).to(dtype)
    t_out = -(-t // s)
    return (r(bsz, t, cin), r(k, cin, cout, scale=(k * cin) ** -0.5),
            r(cout, scale=0.1), r(cout, scale=0.1, shift=1.0),
            r(cout, scale=0.1), r(bsz, t_out, cout) if with_skip else None)


def _k6_args(shape, device, dtype=torch.bfloat16):
    g = torch.Generator(device=device).manual_seed(shape[1])
    return ((3.0 * torch.randn(*shape, device=device, generator=g)).to(dtype),
            (0.5 + 1.5 * torch.rand(shape[-1], device=device, generator=g)
             ).to(dtype))


# (T, Cin, Cout, K, stride, act, skip, groups) of K5's bf16 form on the
# card: chip_smoke.py's shapes, the edges of its staging (Cin % 8, Cout %
# 8, w streamed in tap groups, Tout under a tile) and odd lengths, on its
# fused path and, from T 9000 at batch 2, its two passes (ops/conv_gn.py::
# bf16_plan: one slab of channels and two, w resident and streamed)
K5_CARD = [(1000, 64, 128, 7, 2, True, False, 16),
           (400, 256, 256, 7, 1, True, True, 16),
           (500, 128, 128, 3, 1, False, True, 16),
           (257, 24, 80, 21, 2, True, False, 16),
           (100, 24, 48, 1, 4, True, False, 16),
           (333, 12, 80, 5, 4, True, True, 16),
           (50, 3, 18, 3, 1, False, False, 3),
           (1200, 64, 128, 31, 1, True, False, 16),
           (300, 256, 64, 31, 1, True, False, 16),
           (30001, 12, 80, 5, 4, True, True, 16),
           (9000, 3, 18, 3, 1, False, False, 3),
           (16000, 256, 256, 7, 2, True, False, 16),
           (20000, 64, 256, 3, 2, True, True, 16)]
# (B, T, Cin, Cout, K, stride, act, skip, groups): chip_smoke.py's
# BF16_K5_BATCHED, one shape for each instantiation of the kernel that batch
# 2 does not reach (tests/test_torch_conv_gn.py's BATCHED_INSTANCES)
K5_BATCHED = [(2, 900, 64, 64, 3, 1, True, True, 16),
              (16, 100, 256, 256, 7, 1, True, False, 16),
              (16, 256, 256, 256, 7, 1, True, True, 16),
              (16, 400, 256, 256, 7, 1, True, True, 16),
              (2, 100, 64, 128, 3, 1, True, False, 2),
              (2, 9000, 8, 16, 3, 1, False, False, 4)]
# (B, N, C) of K6's bf16 form: eight channels a thread where C % 8 == 0,
# one otherwise
K6_CARD = [(2, 8000, 64), (1, 16, 3), (2, 800, 12), (3, 2400, 64)]


def test_k5_k6_bf16_on_cpu_tensors_launch_nothing():
    """On bf16 CPU tensors ``conv1d_gn`` and ``env_act`` return their plain
    versions' bf16 results and count no launch; mixed dtypes are refused
    by the kernels' argument checks."""
    from sincformer_tpu_torch.ops import conv_gn, envact
    counts = (conv_gn.conv1d_gn.launches, conv_gn.conv1d_gn.launches_bf16,
              envact.env_act.launches, envact.env_act.launches_bf16)
    case = K5_CARD[2]
    args = _k5_args(case, "cpu")
    out = conv_gn.conv1d_gn(*args, case[4], case[7], 1e-6, case[5])
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, conv_gn.conv_gn_reference(
        *args, stride=case[4], groups=case[7], act=case[5]))
    x, scale = _k6_args(K6_CARD[1], "cpu")
    y, env = envact.env_act(x, scale)
    assert y.dtype == env.dtype == torch.bfloat16
    ref = envact.env_act_reference(x, scale)
    assert torch.equal(y, ref[0]) and torch.equal(env, ref[1])
    assert counts == (conv_gn.conv1d_gn.launches,
                      conv_gn.conv1d_gn.launches_bf16,
                      envact.env_act.launches, envact.env_act.launches_bf16)
    with pytest.raises(TypeError, match="one dtype"):
        envact._forward(x, scale.float())
    with pytest.raises(TypeError, match="one dtype"):
        conv_gn._forward(*args[:2], args[2].float(), *args[3:],
                         case[4], case[7], 1e-6, case[5])


@pytest.mark.parametrize("norm", ["layer", "batch"])
def test_remat_in_bf16_is_bit_equal(norm):
    """A bf16 training forward with ``remat`` (dropout 0.1 and, for
    "batch", the running statistics stepped once) gives the loss, the
    float32 gradients and the buffers of the same forward without it, bit
    for bit: the recompute reads the bf16 copies that
    ``functional_call`` stood in for the parameters."""
    got = []
    for remat in (False, True):
        pipe = _trainer(conv_norm=norm, dropout=0.1, remat=remat)
        loss, sisnr, grads = pipe.loss_and_grads(
            *(torch.from_numpy(a) for a in _batch()))
        got.append((loss, grads, [b.clone() for b in pipe.model.buffers()]))
    (l0, g0, b0), (l1, g1, b1) = got
    assert torch.equal(l0, l1)
    assert all(g.dtype == torch.float32 for g in g0)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(a, b) for a, b in zip(b0, b1))


@pytest.fixture
def group_of_one():
    """A gloo group of one rank in this process (two CPU threads, as in
    tests/test_torch_parallel.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{worker.free_port()}",
        world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(threads)


@pytest.mark.parametrize("axes", [("data",), ("data", "model")])
def test_one_rank_mesh_bf16_step_is_bit_equal(group_of_one, axes):
    """A bf16 trainer ("batch") on a one-rank mesh, a data axis alone and
    with a model axis, takes the step of a bf16 trainer without a mesh bit
    for bit: the whole loss, the gradients, the parameters and the
    BatchNorm statistics after the step."""
    from sincformer_tpu_torch.parallel import make_mesh
    mesh = make_mesh(axis_names=axes)
    noisy, clean = _batch()
    job = {"noisy": noisy, "clean": clean}
    got = worker._dcse_step(job, "batch", mesh,
                            _trainer(mesh, conv_norm="batch", dropout=0.0))
    want = worker._dcse_step(job, "batch", None,
                             _trainer(conv_norm="batch", dropout=0.0))
    for key, value in want.items():
        if isinstance(value, dict):
            bad = [k for k in value if not torch.equal(got[key][k],
                                                       value[k])]
            assert not bad, (key, bad)
        else:
            assert got[key] == value, key


class _TwoRankRing:
    """A stand-in for a DeviceMesh of one 2-rank "data" axis, this rank
    the first: enough for the model to size its blocks of frames."""
    mesh_dim_names = ("data",)

    def size(self, dim=0):
        return 2

    def get_local_rank(self, axis):
        return 0


def test_bf16_step_under_a_ring_raises():
    """A bf16 training step inside ``ops.ring_mesh`` runs the model on
    this rank's block of the STFT frames (two real ranks are held in
    ``tests/test_torch_bf16_kernels.py``), and the model refuses, before
    any collective, a frame count that the ring does not divide (4,000
    samples: 51 frames on 2 ranks) with JAX's training error; it raised
    ``NotImplementedError`` before the ring was ported in bf16."""
    from sincformer_tpu_torch.ops import ring_mesh
    pipe = _trainer(dropout=0.0, attn_impl="ring")
    with ring_mesh(_TwoRankRing(), "data"), pytest.raises(
            RuntimeError, match="T=51 does not divide the 'data' axis"):
        pipe.loss_and_grads(*(torch.from_numpy(a) for a in _batch()))


def test_fused_weights_follow_casts_and_stand_ins():
    """The fused feed-forward's (in, out) weight copies: a module cast to
    bf16 after a float32 call computes with the bf16 weights, and bf16
    stand-ins given by ``torch.func.functional_call`` without autograd are
    used as given at every call, whatever memory they reuse."""
    from sincformer_tpu_torch.models.conformer import FeedForwardModule
    torch.manual_seed(0)
    ff = FeedForwardModule(32, 64, fused=True).eval()
    x = torch.randn(2, 9, 32)
    with torch.no_grad():
        ff(x)                                   # caches the f32 copies
        ff.to(torch.bfloat16)
        fresh = FeedForwardModule(32, 64, fused=True).eval().to(
            torch.bfloat16)
        fresh.load_state_dict(ff.state_dict())
        assert torch.equal(ff(x.bfloat16()), fresh(x.bfloat16()))
        ff.float()
        for scale in (1.0, -2.0, 3.0):
            stand_in = {k: (scale * p).bfloat16()
                        for k, p in ff.named_parameters()}
            ref = FeedForwardModule(32, 64, fused=True).eval().to(
                torch.bfloat16)
            ref.load_state_dict(stand_in)
            got = torch.func.functional_call(ff, stand_in, (x.bfloat16(),))
            assert torch.equal(got, ref(x.bfloat16()))
            del stand_in     # the next stand-ins may take the same memory


def test_bf16_trainer_saves_f32_and_serves_f32(tmp_path):
    """After a bf16 step the trainer's parameters, optimizer state and
    checkpoint are float32, a serving pipeline loads the checkpoint, and
    the trainer's own ``enhance_signal`` is the float32 pipeline's, bit
    for bit (serving does not take ``compute_dtype``, as in JAX)."""
    import sincformer_tpu_torch.train.dcse_trainer as port_dcse
    from sincformer_tpu_torch import DCSEPipeline
    pipe = _trainer(conv_norm="batch", dropout=0.0)
    pipe.model_dir = str(tmp_path)
    with mock.patch.object(port_dcse, "multi_resolution_stft_loss",
                           lambda pred, target: pred.sum() * 0.0):
        loss, _ = pipe.train_step(*(torch.from_numpy(a) for a in _batch()))
    assert torch.isfinite(loss)
    assert all(v.dtype == torch.float32 for v in pipe.params().values())
    assert all(v.dtype == torch.float32 for k in ("mu", "nu")
               for v in pipe.opt_state[k].values())
    pipe.save_model()
    served = DCSEPipeline(device="cpu", model_dir=str(tmp_path))
    served.load_model()
    for k, v in served.model.state_dict().items():
        assert v.dtype == torch.float32 and torch.equal(
            v, pipe.model.state_dict()[k]), k
    wav = _batch()[0][0]
    assert np.array_equal(pipe.enhance_signal(wav),
                          served.enhance_signal(wav))


@pytest.mark.gpu
@pytest.mark.parametrize("case", K1_CARD)
def test_k1_bf16_form_on_the_card(case):
    """K1's bf16 form against its plain bf16 version on the same card, one
    launch counted in both counts."""
    _need_card()
    from sincformer_tpu_torch.ops.speech_attention import (
        _speech_attention_plain, speech_attention)
    args = _k1_args(case, "cuda")
    before = speech_attention.launches_bf16
    out = speech_attention(*args)
    torch.cuda.synchronize()
    assert speech_attention.launches_bf16 == before + 1
    share, ulps = agreement(out, _speech_attention_plain(*args),
                            attention_scale(*args))
    assert out.dtype == torch.bfloat16 and share >= 0.99 and ulps <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("case", K3_CARD)
def test_k3_bf16_form_on_the_card(case):
    """K3's bf16 form against its plain bf16 version on the same card."""
    _need_card()
    from sincformer_tpu_torch.ops.fused_ffn import _fused_ffn_plain, fused_ffn
    args = _k3_args(case, "cuda")
    before = fused_ffn.launches_bf16
    out = fused_ffn(*args)
    torch.cuda.synchronize()
    assert fused_ffn.launches_bf16 == before + 1
    share, ulps = agreement(out, _fused_ffn_plain(*args), ffn_scale(*args))
    assert out.dtype == torch.bfloat16 and share >= 0.99 and ulps <= 1.0


@pytest.mark.gpu
def test_bf16_forms_under_autograd_on_the_card():
    """Under autograd each bf16 form's output has a ``grad_fn`` and its
    gradients are the plain bf16 version's autograd, bit for bit."""
    _need_card()
    from sincformer_tpu_torch.ops.fused_ffn import _fused_ffn_plain, fused_ffn
    from sincformer_tpu_torch.ops.speech_attention import (
        _speech_attention_plain, speech_attention)
    q, k, v, bias = _k1_args((4, 400, 64, True), "cuda")
    for fn, plain, args, extra in (
            (speech_attention, _speech_attention_plain, (q, k, v), (bias,)),
            (fused_ffn, _fused_ffn_plain,
             _k3_args((401, 256, 1024), "cuda"), ())):
        leaves = [a.clone().requires_grad_(True) for a in args]
        out = fn(*leaves, *extra)
        assert out.grad_fn is not None
        cot = torch.randn_like(out)
        got = torch.autograd.grad(out, leaves, cot)
        ref = [a.clone().requires_grad_(True) for a in args]
        want = torch.autograd.grad(plain(*ref, *extra), ref, cot)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(2,) + c for c in K5_CARD] + K5_BATCHED)
def test_k5_bf16_form_on_the_card(case):
    """K5's bf16 form against its plain bf16 version on the same card, one
    launch counted in both counts."""
    _need_card()
    torch.backends.cudnn.allow_tf32 = False
    from sincformer_tpu_torch.ops.conv_gn import conv1d_gn, conv_gn_reference
    bsz, case = case[0], case[1:]
    args = _k5_args(case, "cuda", bsz=bsz)
    _, _, _, _, s, act, _, groups = case
    before = conv1d_gn.launches_bf16
    out = conv1d_gn(*args, s, groups, 1e-6, act)
    torch.cuda.synchronize()
    assert conv1d_gn.launches_bf16 == before + 1
    share, ulps = agreement(out.cpu(), conv_gn_reference(
        *args, stride=s, groups=groups, act=act).cpu(),
        conv_gn_scale(*args, s, groups))
    assert out.dtype == torch.bfloat16 and share >= 0.99 and ulps <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("shape", K6_CARD)
def test_k6_bf16_form_on_the_card(shape):
    """K6's bf16 form against its plain bf16 version on the same card."""
    _need_card()
    from sincformer_tpu_torch.ops.envact import env_act, env_act_reference
    x, scale = _k6_args(shape, "cuda")
    before = env_act.launches_bf16
    y, env = env_act(x, scale)
    torch.cuda.synchronize()
    assert env_act.launches_bf16 == before + 1
    y_ref, env_ref = env_act_reference(x, scale)
    for got, want, terms in ((y, y_ref, (x.float() * scale.float()).abs()),
                             (env, env_ref, torch.zeros(()))):
        share, ulps = agreement(got.cpu(), want.cpu(), terms.cpu())
        assert got.dtype == torch.bfloat16 and share >= 0.99 and ulps <= 1.0


@pytest.mark.gpu
def test_k5_k6_bf16_forms_under_autograd_on_the_card():
    """Under autograd the bf16 forms of K5 and K6 keep a ``grad_fn`` and
    their gradients are the plain bf16 versions' autograd, bit for bit."""
    _need_card()
    torch.backends.cudnn.allow_tf32 = False
    from sincformer_tpu_torch.ops.conv_gn import conv1d_gn, conv_gn_reference
    from sincformer_tpu_torch.ops.envact import env_act, env_act_reference
    case = K5_CARD[1]
    k5 = _k5_args(case, "cuda")
    for fn, plain, args in (
            (lambda *a: conv1d_gn(*a, 1, 16, 1e-6, True),
             lambda *a: conv_gn_reference(*a, stride=1, groups=16), k5),
            (lambda *a: env_act(*a)[0], lambda *a: env_act_reference(*a)[0],
             _k6_args(K6_CARD[0], "cuda"))):
        leaves = [a.clone().requires_grad_(True) for a in args]
        out = fn(*leaves)
        assert out.grad_fn is not None
        cot = torch.randn_like(out)
        got = torch.autograd.grad(out, leaves, cot)
        ref = [a.clone().requires_grad_(True) for a in args]
        want = torch.autograd.grad(plain(*ref), ref, cot)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
def test_argmax_ties_take_the_first_index_on_the_card():
    """Exact bf16 ties on the card: the MAA's decision, the VQ's index and
    the memory's top slot take the first tied candidate, as on the CPU
    and in JAX."""
    _need_card()
    from sincformer_tpu_torch.agents.memory import _unit
    from sincformer_tpu_torch.models.vq import VectorQuantizer
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0]] * 1000, device="cuda",
                          dtype=torch.bfloat16)
    assert (torch.argmax(logits, dim=-1) == 1).all()
    vq = VectorQuantizer(3).cuda()
    with torch.no_grad():
        vq.centroids.copy_(torch.tensor([0.25, 0.75, 0.75]))
        vq = vq.to(torch.bfloat16)
        mask = torch.tensor([0.5, 0.75, 0.9, 0.1, 0.5] * 200, device="cuda",
                            dtype=torch.bfloat16)
        idx = vq(mask)[1].cpu().tolist()
    assert idx == [0, 1, 1, 0, 0] * 200
    keys = torch.randn(4, 32, device="cuda").bfloat16()
    keys[2] = keys[1]
    sim = _unit(keys[1:3]) @ _unit(keys).T
    assert torch.argmax(sim, dim=-1).cpu().tolist() == [1, 1]
