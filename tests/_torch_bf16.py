"""The bf16 bars of the port's tests (``tests/test_torch_bf16*.py``), in
plain PyTorch and numpy (no JAX: the card's tests import this too).

A bf16 kernel or plain version is held against another bf16 computation of
the same function by the share of its elements that are bit-equal and by
its worst element in bf16 ulps. An element's ulp is taken at its *term
scale*: the larger of its magnitude and the sum of the magnitudes of the
terms it is the sum of (for attention sum_j p_j |v_j|, for the fused
feed-forward |x| + (|h| . |W2| + |b2|) / 2). Where a sum cancels, two
correct computations of the same rounded terms can differ by many ulps of
the small result (a term rounded one way in one and the other way in the
other moves it by an ulp of the term), but not by more than an ulp at the
scale the terms were rounded at.

A whole bf16 model is held by distances (the L2 norm of a difference):
``noise`` = |port bf16 - JAX f32| / |JAX bf16 - JAX f32|, the port's bf16
error beside JAX's, and ``cross`` = |port bf16 - JAX bf16| / |JAX bf16 -
JAX f32|. Bit for bit agreement does not survive a whole network: one
element that the two libraries' f32 sums (a GEMM's, a LayerNorm's) round
to neighbouring bf16 values spreads through attention and every later
rounding, so that the two bf16 results decorrelate from there on."""

from __future__ import annotations

import numpy as np
import torch

from tests import _torch_threads  # noqa: F401


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float64)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values (8 significant bits) at |x|."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-38)))
    return np.exp2(e - 7)


def agreement(got, want, scale) -> tuple:
    """(share of bit-equal elements, worst |got - want| in bf16 ulps at
    each element's term scale ``scale``)."""
    got, want, scale = _f64(got), _f64(want), _f64(scale)
    assert got.shape == want.shape, (got.shape, want.shape)
    at = np.maximum(np.maximum(np.abs(got), np.abs(want)), scale)
    return (float(np.mean(got == want)),
            float(np.max(np.abs(got - want) / bf16_ulp(at), initial=0.0)))


def attention_scale(q, k, v, bias=None) -> torch.Tensor:
    """sum_j p_j |v_j| of (B, T, H, dh) bf16 attention, p the f32 softmax."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s / float(q.shape[-1]) ** 0.5
    if bias is not None:
        s = s + bias[:, None, None, :].float()
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1),
                        v.float().abs())


def ffn_scale(x, ln_g, ln_b, w1, b1, w2, b2) -> torch.Tensor:
    """|x| + (|h| . |W2| + |b2|) / 2 of the bf16 fused feed-forward, h the
    rounded swish."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    xn = ((xf - mu) * torch.rsqrt(var + 1e-6) * ln_g.float()
          + ln_b.float()).bfloat16().float()
    h = xn @ w1.float() + b1.float()
    h = (h * torch.sigmoid(h)).bfloat16().float()
    return xf.abs() + 0.5 * (h.abs() @ w2.float().abs() + b2.float().abs())


def conv_gn_scale(x, w, b, gamma, beta, skip, stride: int,
                  groups: int) -> torch.Tensor:
    """The term scale of kernel K5's (B, Tout, Cout) output: the
    normalised magnitudes of the convolution's terms and of the mean,
    (sum |x||w| + |b| + |mu|) * rstd * |gamma|, plus |beta| and |skip| (the
    tanh-GELU's slope is at most 1.13), in float32 on the host."""
    import torch.nn.functional as F
    x, w, b, gamma, beta = (torch.as_tensor(t).float().cpu()
                            for t in (x, w, b, gamma, beta))
    k = w.shape[0]
    t_out = -(-x.shape[1] // stride)
    total = max((t_out - 1) * stride + k - x.shape[1], 0)

    def conv(x_, w_, b_):
        return F.conv1d(F.pad(x_.transpose(1, 2),
                              (total // 2, total - total // 2)),
                        w_.permute(2, 1, 0), b_, stride=stride).transpose(1, 2)
    y = conv(x, w, b)
    bsz, _, cout = y.shape
    yg = y.reshape(bsz, t_out, groups, cout // groups)
    mu = yg.mean(dim=(1, 3), keepdim=True)
    rstd = torch.rsqrt(((yg - mu) ** 2).mean(dim=(1, 3), keepdim=True) + 1e-6)
    terms = conv(x.abs(), w.abs(), b.abs()).reshape(yg.shape) + mu.abs()
    scale = (terms * rstd).reshape(y.shape) * gamma.abs() + beta.abs()
    if skip is not None:
        scale = scale + torch.as_tensor(skip).float().cpu().abs()
    return scale


def attention_p_in_f32(q, k, v, bias=None) -> torch.Tensor:
    """A planted fault: bf16 attention that keeps P in f32 for P.V."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s / float(q.shape[-1]) ** 0.5
    if bias is not None:
        s = s + bias[:, None, None, :].float()
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1),
                        v.float()).to(q.dtype)


def distance(a, b) -> float:
    """The L2 norm of a - b, in float64."""
    return float(np.sqrt(np.sum((_f64(a) - _f64(b)) ** 2)))


def ratios(port16, jax16, jax32) -> tuple:
    """(noise, cross) of the module docstring."""
    ref = distance(jax16, jax32)
    return distance(port16, jax32) / ref, distance(port16, jax16) / ref
