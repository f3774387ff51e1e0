"""Kernel K3 (fused feed-forward) and the DCSE path of the port against
sincformer_tpu: the plain version against the Pallas kernel in interpret mode
and its unfused reference, the kernel's split-TF32 arithmetic emulated on the
CPU against the plain version, the feed-forward module fused and unfused, and
the SpeechEnhancer with bridged weights (the DCSE pipeline is held against
the JAX pipeline in tests/test_torch_serve.py, which builds one anyway).

Tolerance 1e-5 of the output's scale throughout: float32 on both sides, sums
of at most a few hundred terms taken in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sincformer_tpu.ops.fused_ffn import _ffn_fwd_pallas, _ffn_reference
from sincformer_tpu_torch.ops.fused_ffn import _fused_ffn_plain, fused_ffn
from tests._torch_parity import (NARROW_DCSE, fused_ffn_tf32,
                                 jax_dcse_model, max_abs, narrow_dcse)

TOL = 1e-5


def _ffn_args(m, d, d_ff, seed=0):
    rng = np.random.default_rng(seed)

    def g(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return (g(m, d), 1.0 + g(d, scale=0.1), g(d, scale=0.1),
            g(d, d_ff, scale=d ** -0.5), g(d_ff, scale=0.1),
            g(d_ff, d, scale=d_ff ** -0.5), g(d, scale=0.1))


@pytest.mark.parametrize("m,d,d_ff", [(100, 32, 64), (300, 64, 128)])
def test_plain_matches_pallas_interpret_and_reference(m, d, d_ff):
    """Row counts that are no multiple of the Pallas tile (256): the TPU
    kernel pads and trims, the port's formula has no tile."""
    args = _ffn_args(m, d, d_ff)
    jargs = [jnp.asarray(a) for a in args]
    got = fused_ffn(*[torch.from_numpy(a) for a in args]).numpy()
    for ref in (_ffn_fwd_pallas(*jargs, interpret=True),
                _ffn_reference(*jargs)):
        ref = np.asarray(ref)
        assert ref.shape == (m, d)
        assert np.max(np.abs(got - ref)) <= TOL * max(1.0, np.abs(ref).max())


def test_split_tf32_keeps_the_kernel_bar():
    """The kernel's products in split TF32 (lo.hi + hi.lo + hi.hi) stay
    within K3's bar of its plain version at the DCSE widths (256 rows, d 256,
    d_ff 1024); one TF32 product alone breaks it many times over, so a
    kernel that drops the lo terms fails the card's check."""
    args = [torch.from_numpy(a) for a in _ffn_args(256, 256, 1024, seed=4)]
    ref = _fused_ffn_plain(*args)
    scale = float(ref.abs().max())
    err3 = float((fused_ffn_tf32(*args, terms=3) - ref).abs().max())
    err1 = float((fused_ffn_tf32(*args, terms=1) - ref).abs().max())
    assert err3 <= TOL / 5 * scale
    assert err1 >= 5 * TOL * scale


def test_variance_is_mean_of_centred_squares():
    """LayerNorm statistics on rows with a large common offset: the
    variance must be the mean of (x - mean)^2 (E[x^2] - mean^2 loses every
    digit here), with eps 1e-6; checked against float64."""
    args = list(_ffn_args(16, 32, 64, seed=3))
    args[0] = args[0] * 0.01 + 300.0
    got = fused_ffn(*[torch.from_numpy(a) for a in args]).double().numpy()
    want = _fused_ffn_plain(*[torch.from_numpy(a).double() for a in args])
    assert np.max(np.abs(got - want.numpy())) <= 2e-2   # f32 at offset 300
    jref = np.asarray(_ffn_reference(*[jnp.asarray(a) for a in args]))
    assert np.max(np.abs(got - jref)) <= 2e-2


def test_module_fused_equals_unfused_and_follows_the_weights():
    """Same parameter names in both forms (a checkpoint loads into either);
    the fused form's transposed weights are refreshed when the weights are
    rewritten."""
    from sincformer_tpu_torch.models.conformer import FeedForwardModule
    g = torch.Generator().manual_seed(0)
    plain_mod = FeedForwardModule(32, 64).eval()
    fused_mod = FeedForwardModule(32, 64, fused=True).eval()
    assert list(plain_mod.state_dict()) == list(fused_mod.state_dict())
    x = torch.randn(2, 25, 32, generator=g)
    with torch.no_grad():
        for _ in range(2):
            for p in plain_mod.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.2)
            fused_mod.load_state_dict(plain_mod.state_dict())
            want = plain_mod(x)
            assert max_abs(fused_mod(x), want) <= TOL * float(want.abs().max())
    with torch.inference_mode():        # weights without a version counter
        made_here = FeedForwardModule(32, 64, fused=True).eval()
        made_here.load_state_dict(plain_mod.state_dict())
        assert max_abs(made_here(x), want) <= TOL * float(want.abs().max())


@pytest.mark.parametrize("fused", [False, True])
def test_speech_enhancer_matches_jax(fused):
    """SpeechEnhancer at deterministic=True with bridged weights, fused and
    unfused feed-forward (the JAX package's fused form on the CPU is its
    reference formulation): all three outputs."""
    from sincformer_tpu_torch import SpeechEnhancer, load_dcse_from_jax
    variables = narrow_dcse()
    rng = np.random.default_rng(7)
    re, im = (rng.standard_normal((2, 51, 129)).astype(np.float32)
              for _ in range(2))
    ref = jax.jit(lambda v, a, b: jax_dcse_model(fused).apply(
        v, a, b, deterministic=True))(variables, re, im)
    state, config = load_dcse_from_jax(variables, fused_ffn=fused,
                                       num_heads=NARROW_DCSE["num_heads"])
    assert (config.fused_ffn, config.d_model, config.num_blocks,
            config.ff_dim, config.kernel_size) == (fused, 32, 2, 64, 7)
    model = SpeechEnhancer(config).eval()
    model.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(re), torch.from_numpy(im))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert max_abs(g, r) <= TOL * max(1.0, np.abs(r).max())


def test_unported_dcse_variants_raise():
    """What the port leaves out raises: ``remat``; a tree that does not
    fill the model (a ``batch_stats`` collection without BatchNorm
    parameters, a missing head); a reference checkpoint that is not
    there."""
    from sincformer_tpu_torch import (DCSEConfig, DCSEPipeline,
                                      load_dcse_from_jax)
    with pytest.raises(NotImplementedError, match="remat"):
        DCSEConfig(remat=True)
    with pytest.raises(FileNotFoundError):
        DCSEPipeline.from_torch_checkpoint("conformer_final.pt",
                                           device="cpu")
    variables = dict(narrow_dcse(), batch_stats={"x": np.zeros(3)})
    with pytest.raises(ValueError, match="batch"):
        load_dcse_from_jax(variables)
    broken = {"params": {k: v for k, v in narrow_dcse()["params"].items()
                         if k != "mag_head"}}
    with pytest.raises((ValueError, KeyError)):
        load_dcse_from_jax(broken)


def test_cpu_tensor_takes_plain_version_without_launch():
    args = [torch.from_numpy(a) for a in _ffn_args(9, 32, 64)]
    before = fused_ffn.launches
    out = fused_ffn(*args)
    assert fused_ffn.launches == before
    torch.testing.assert_close(out, _fused_ffn_plain(*args), rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("m,d,d_ff", [(1, 256, 1024), (33, 256, 1024),
                                      (401, 256, 1024), (6416, 256, 1024),
                                      (130, 32, 64), (70, 64, 96),
                                      (200, 128, 512)])
def test_cuda_kernel_matches_plain(m, d, d_ff):
    """Needs a CUDA card and nvcc (builds csrc/fused_ffn.cu)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    args = [torch.from_numpy(a).cuda() for a in _ffn_args(m, d, d_ff)]
    before = fused_ffn.launches
    out = fused_ffn(*args)
    torch.cuda.synchronize()
    assert fused_ffn.launches == before + 1
    ref = _fused_ffn_plain(*args)
    assert float((out - ref).abs().max()) <= TOL * float(ref.abs().max())
    with pytest.raises(ValueError, match="supports d in"):
        fused_ffn(torch.zeros(4, 96, device="cuda"), *[
            torch.zeros(s, device="cuda") for s in (
                (96,), (96,), (96, 64), (64,), (64, 96), (96,))])
