"""Kernel K1 (speech attention): the port's plain version against the JAX
Pallas kernel run in interpret mode and against its unfused reference, the
kernel's split-TF32 arithmetic emulated on the CPU against the plain
version, and the CUDA kernel against the plain version where a card is
present.

Tolerance 1e-5 absolute on outputs of O(1) (float32, a softmax over at most
2100 keys; the sums run in another order on each side)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sincformer_tpu.ops.speech_attention import (_reference,
                                                 _speech_attention_fwd)
from sincformer_tpu_torch.ops.speech_attention import (
    _speech_attention_plain, speech_attention)
from tests._torch_parity import attention_tf32, split_tf32, tf32

TOL = 1e-5


def _qkv(t, b=2, h=2, dh=32, seed=0):
    rng = np.random.default_rng(seed + t)
    return [(rng.standard_normal((b, t, h, dh)) * 0.3).astype(np.float32)
            for _ in range(3)]


def _bias(b, t, valid):
    lengths = np.array([t, valid][:b])[:, None]
    return np.where(np.arange(t)[None, :] < lengths, 0.0, -1e9).astype(
        np.float32)


@pytest.mark.parametrize("t", [100, 600, 1025])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_matches_pallas_interpret(t, masked):
    """The Pallas kernel itself (interpret mode, lane-padded T) against the
    port's plain version; with a mask, only valid query rows are compared,
    as in tests/test_pallas_ops.py."""
    q, k, v = _qkv(t)
    b, _, h, dh = q.shape
    bias = _bias(b, t, int(t * 0.7)) if masked else np.zeros((b, t),
                                                             np.float32)
    ref = np.asarray(_speech_attention_fwd(
        jnp.asarray(q.reshape(b, t, h * dh)),
        jnp.asarray(k.reshape(b, t, h * dh)),
        jnp.asarray(v.reshape(b, t, h * dh)), jnp.asarray(bias),
        num_heads=h, sm_scale=1.0 / dh ** 0.5, interpret=True)).reshape(q.shape)
    got = speech_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v),
                           torch.from_numpy(bias) if masked else None).numpy()
    rows = int(t * 0.7) if masked else t
    assert np.max(np.abs(got[:, :rows] - ref[:, :rows])) < TOL


def test_plain_matches_reference_long():
    """T=2100, past the JAX dispatch's flash hand-off: the port keeps one
    kernel for every T; against the JAX unfused reference."""
    q, k, v = _qkv(2100, b=1, h=4, dh=64)
    bias = _bias(1, 2100, 2100)
    ref = np.asarray(_reference(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v),
                                jnp.asarray(bias)[:, None, None, :],
                                1.0 / 8.0))
    got = _speech_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v),
                                  torch.from_numpy(bias)).numpy()
    assert np.max(np.abs(got - ref)) < TOL


def test_cpu_tensor_takes_plain_version_without_launch():
    q, k, v = (torch.from_numpy(x) for x in _qkv(50))
    before = speech_attention.launches
    out = speech_attention(q, k, v)
    assert speech_attention.launches == before
    torch.testing.assert_close(out, _speech_attention_plain(q, k, v),
                               rtol=0, atol=0)


def test_tf32_rounding_is_cvt_rna():
    """The emulation rounds as cvt.rna.tf32.f32: 10 mantissa bits, to
    nearest, ties away from zero, either sign; hi + lo carries about 21
    bits of the value."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0 + ulp / 2, 1.0 + 1.5 * ulp, 1.0 + ulp / 4,
                      -(1.0 + ulp / 2), -(1.0 + 0.75 * ulp)])
    want = [1.0 + ulp, 1.0 + 2 * ulp, 1.0, -(1.0 + ulp), -(1.0 + ulp)]
    assert tf32(x).tolist() == want
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32))
    hi, lo = split_tf32(y)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    assert float(((hi - y).abs() / y.abs()).max()) <= 2.0 ** -11
    assert float(((hi + lo - y).abs() / y.abs()).max()) <= 2.0 ** -21


@pytest.mark.parametrize("masked", [False, True])
def test_split_tf32_keeps_the_kernel_bar(masked):
    """The kernel's products in split TF32 (lo.hi + hi.lo + hi.hi) stay
    within K1's bar of its plain version at the main path's head width
    (B=1, T=100, H=4, dh=64, inputs of unit scale as in chip_smoke.py); one
    TF32 product alone breaks it many times over, so a kernel that drops
    the lo terms fails the card's check."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 100, 4, 64))
                                .astype(np.float32)) for _ in range(3))
    bias = torch.from_numpy(_bias(1, 100, 70)) if masked else None
    ref = _speech_attention_plain(q, k, v, bias)
    err3 = float((attention_tf32(q, k, v, bias, terms=3) - ref).abs().max())
    err1 = float((attention_tf32(q, k, v, bias, terms=1) - ref).abs().max())
    assert err3 <= TOL / 5
    assert err1 >= 10 * TOL


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("t", [1, 50, 100, 400, 601, 2100])
def test_cuda_kernel_matches_plain(t, dh):
    """Needs a CUDA card and nvcc (builds csrc/speech_attention.cu)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v = (torch.from_numpy(x).cuda() for x in _qkv(t, b=2, h=4, dh=dh))
    bias = torch.from_numpy(_bias(2, t, max(t // 2, 1))).cuda()
    before = speech_attention.launches
    for bb in (None, bias):
        out = speech_attention(q, k, v, bb)
        torch.cuda.synchronize()
        ref = _speech_attention_plain(q, k, v, bb)
        assert float((out - ref).abs().max()) < TOL
    assert speech_attention.launches == before + 2
    with pytest.raises(ValueError, match="contiguous"):
        speech_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
