"""flax's elementwise functions and norms as the JAX package computes them,
for every module of the port (``ops/``, ``agents/``, ``models/``).

In float32 each is PyTorch's own operator. In bfloat16 each rounds where
XLA's expansion of the JAX function rounds with its excess precision off:
Python constants to bfloat16 (:func:`in_dtype`), every operation of the
sigmoid, GELU, softplus and softmax, and the norms' statistics and
normalisation in float32 with one rounding (:func:`flax_norm`), where
PyTorch's bf16 operator would round once or take the variance about the
mean.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from sincformer_tpu_torch.ops.fused_ffn import LN_EPS


def in_dtype(c: float, dtype: torch.dtype) -> float:
    """The Python constant ``c`` rounded to bfloat16 for a bfloat16 operand
    (JAX rounds a Python scalar to the array's dtype, PyTorch computes with
    it whole); ``c`` itself for any other dtype."""
    if dtype != torch.bfloat16:
        return c
    return float(torch.tensor(c, dtype=torch.bfloat16))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``torch.sigmoid``; in bfloat16 ``1 / (1 + exp(-x))`` with every
    operation rounded to bfloat16, as XLA expands the JAX package's
    ``jax.nn.sigmoid`` (PyTorch's bf16 sigmoid rounds once)."""
    if x.dtype != torch.bfloat16:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


def swish(x: torch.Tensor) -> torch.Tensor:
    """x · sigmoid(x): ``F.silu`` in float32; in bfloat16 the product of x
    and :func:`sigmoid`, rounded, as the JAX package's ``swish``."""
    return F.silu(x) if x.dtype != torch.bfloat16 else x * sigmoid(x)


def glu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.glu`` over the last axis: ``F.glu`` in float32; in
    bfloat16 a · :func:`sigmoid` (b), rounded."""
    if x.dtype != torch.bfloat16:
        return F.glu(x, dim=-1)
    a, b = x.chunk(2, dim=-1)
    return a * sigmoid(b)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``, the tanh approximation: ``F.gelu`` in float32; in
    bfloat16 ``x · 0.5 · (1 + tanh(c · (x + 0.044715 · x · x · x)))`` with
    every operation and both constants rounded to bfloat16, as the JAX
    package's ``jax.nn.gelu`` expands (PyTorch's bf16 GELU rounds once)."""
    if x.dtype != torch.bfloat16:
        return F.gelu(x, approximate="tanh")
    c = in_dtype(math.sqrt(2.0 / math.pi), x.dtype)
    cube = x * (x * x)
    inner = c * (x + in_dtype(0.044715, x.dtype) * cube)
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.softplus``: ``F.softplus`` in float32; in bfloat16
    ``max(x, 0) + log1p(exp(-|x|))`` with every operation rounded, as
    ``jnp.logaddexp(x, 0)`` expands."""
    if x.dtype != torch.bfloat16:
        return F.softplus(x)
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """flax ``nn.softmax``: ``F.softmax`` in float32; in bfloat16
    ``exp(x - max) / sum`` with every operation rounded (the sum taken in
    float32 and rounded once), as ``jax.nn.softmax`` computes it."""
    if x.dtype != torch.bfloat16:
        return F.softmax(x, dim=dim)
    e = torch.exp(x - torch.amax(x, dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True)


def flax_norm(x: torch.Tensor, dims, weight: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None, eps: float = LN_EPS,
              across: Optional[Callable] = None) -> torch.Tensor:
    """flax's normalisation of a float32 (or float64) ``x`` over ``dims``
    (``use_fast_variance``): the mean and the variance max(0, E[x²] -
    E[x]²), then ``(x - mean) · (rsqrt(var + eps) · weight) + bias``.
    ``weight`` and ``bias`` broadcast against ``x``; ``across`` maps each
    local mean to the mean over a wider set of frames (the ring's, under
    ``ops.ring_mesh``)."""
    def mean_of(t):
        m = t.mean(dim=dims, keepdim=True)
        return m if across is None else across(m)
    mean = mean_of(x)
    var = torch.clamp(mean_of(x * x) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + eps)
    if weight is not None:
        mul = mul * weight
    y = (x - mean) * mul
    return y if bias is None else y + bias


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               eps: float = LN_EPS) -> torch.Tensor:
    """flax ``nn.LayerNorm`` over the last axis: ``F.layer_norm`` in float32;
    in bfloat16 :func:`flax_norm` in float32, rounded once (PyTorch's bf16
    LayerNorm takes the variance about the mean, which rounds apart from
    flax's more often)."""
    if x.dtype != torch.bfloat16:
        return F.layer_norm(x, x.shape[-1:], weight, bias, eps)
    return flax_norm(x.float(), -1, weight, bias, eps).to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` whose bfloat16 forward is :func:`layer_norm`'s
    (flax's arithmetic); the same parameters and state-dict keys."""

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)
