"""Conformer block (``sincformer_tpu/models/conformer.py``).

Submodules carry the flax names (``FeedForwardModule_0``, ``LayerNorm_0``,
``qkv``, ...) so a state-dict key is the flax parameter path joined with
dots (compat/from_jax.py). Normalisation layers use flax's eps 1e-6.

Dropout sits where the JAX block has it (after the feed-forward Swish and
its second Dense, after the attention output projection, after the conv
module's last pointwise layer). A forward given a ``generator`` is a
training forward and draws its dropout masks from it; without one it is
deterministic.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sincformer_tpu_torch.ops.attention import dot_product_attention
from sincformer_tpu_torch.ops.fused_ffn import LN_EPS, fused_ffn


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 - p, drawn
    from ``generator``, and divide the kept ones by 1 - p. The identity when
    ``generator`` is None (deterministic) or p is 0."""
    if generator is None or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def same_pad(x: torch.Tensor, k: int) -> torch.Tensor:
    """flax ``padding="SAME"`` for a stride-1 conv over the last axis:
    (k-1)//2 before and the rest after (asymmetric for even k)."""
    before = (k - 1) // 2
    return F.pad(x, (before, k - 1 - before))


class FeedForwardModule(nn.Module):
    """LN → Dense(d_ff) → Swish → Dropout → Dense(d) → Dropout, half
    residual.

    ``fused=True`` runs the whole module as one call of ``ops.fused_ffn``
    (kernel K3 on a CUDA tensor) unless dropout is active, where it takes
    the unfused math, as the JAX package's ``FusedFeedForward`` does. Both
    forms have the same parameters, so a checkpoint loads into either. The
    kernel reads the weights as (in, out), the transposes of
    ``Linear.weight``: under autograd they are transposed views made
    contiguous, so the gradient reaches the weights; without it they are
    made once and again only when a weight was rewritten or moved.
    """

    def __init__(self, d_model: int, d_ff: int, fused: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        self.fused = fused
        self.dropout = dropout
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.Dense_0 = nn.Linear(d_model, d_ff)
        self.Dense_1 = nn.Linear(d_ff, d_model)
        self._transposed = None         # (key, w1 (d, d_ff), w2 (d_ff, d))

    def _in_out_weights(self):
        w0, w1 = self.Dense_0.weight, self.Dense_1.weight
        if torch.is_grad_enabled() and (w0.requires_grad or w1.requires_grad):
            return w0.t().contiguous(), w1.t().contiguous()
        # (a tensor made under inference_mode has no version counter)
        key = tuple((w.data_ptr(), 0 if w.is_inference() else w._version)
                    for w in (w0, w1))
        if self._transposed is None or self._transposed[0] != key:
            self._transposed = (key, w0.detach().t().contiguous(),
                                w1.detach().t().contiguous())
        return self._transposed[1:]

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if self.fused and (generator is None or self.dropout == 0.0):
            w1, w2 = self._in_out_weights()
            ln = self.LayerNorm_0
            return fused_ffn(x.contiguous(), ln.weight, ln.bias, w1,
                             self.Dense_0.bias, w2, self.Dense_1.bias)
        y = F.silu(self.Dense_0(self.LayerNorm_0(x)))
        y = dropout(y, self.dropout, generator)
        y = dropout(self.Dense_1(y), self.dropout, generator)
        return x + 0.5 * y


class MultiHeadSelfAttention(nn.Module):
    """Pre-LN multi-head self-attention with residual; the fused ``qkv``
    projection splits in q, k, v order."""

    def __init__(self, d_model: int, num_heads: int, attn_impl: str = "speech",
                 dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.dropout = dropout
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.qkv = nn.Linear(d_model, 3 * d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, x, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        b, t, d = x.shape
        h = self.num_heads
        # the split's views are strided: the kernel takes contiguous copies,
        # through which the gradient flows back to qkv
        q, k, v = (y.reshape(b, t, h, d // h).contiguous()
                   for y in self.qkv(self.LayerNorm_0(x)).split(d, dim=-1))
        o = dot_product_attention(q, k, v, mask=mask, impl=self.attn_impl)
        return x + dropout(self.out(o.reshape(b, t, d)), self.dropout,
                           generator)


class DepthwiseConv(nn.Module):
    """SAME-padded stride-1 depthwise conv over time on (B, T, D)."""

    def __init__(self, features: int, kernel_size: int):
        super().__init__()
        self.kernel_size = kernel_size
        self.weight = nn.Parameter(torch.empty(features, 1, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        y = F.conv1d(same_pad(x.transpose(1, 2), self.kernel_size),
                     self.weight, self.bias, groups=self.weight.shape[0])
        return y.transpose(1, 2)


class ConvolutionModule(nn.Module):
    """LN → pointwise(2d) → GLU → depthwise(k) → LN → Swish → pointwise →
    Dropout, residual (the flagship's ``norm="layer"``)."""

    def __init__(self, d_model: int, kernel_size: int = 31,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.pointwise1 = nn.Linear(d_model, 2 * d_model)
        self.depthwise = DepthwiseConv(d_model, kernel_size)
        self.ln = nn.LayerNorm(d_model, eps=LN_EPS)
        self.pointwise2 = nn.Linear(d_model, d_model)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        y = F.glu(self.pointwise1(self.LayerNorm_0(x)), dim=-1)
        y = F.silu(self.ln(self.depthwise(y)))
        return x + dropout(self.pointwise2(y), self.dropout, generator)


class ConformerBlock(nn.Module):
    """FF½ → MHSA → Conv → FF½ → LN."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int,
                 kernel_size: int, attn_impl: str = "speech",
                 fused_ffn: bool = False, dropout: float = 0.0):
        super().__init__()
        self.FeedForwardModule_0 = FeedForwardModule(d_model, d_ff, fused_ffn,
                                                     dropout)
        self.MultiHeadSelfAttention_0 = MultiHeadSelfAttention(
            d_model, num_heads, attn_impl, dropout)
        self.ConvolutionModule_0 = ConvolutionModule(d_model, kernel_size,
                                                     dropout)
        self.FeedForwardModule_1 = FeedForwardModule(d_model, d_ff, fused_ffn,
                                                     dropout)
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        x = self.FeedForwardModule_0(x, generator)
        x = self.MultiHeadSelfAttention_0(x, mask, generator)
        x = self.ConvolutionModule_0(x, generator)
        x = self.FeedForwardModule_1(x, generator)
        return self.LayerNorm_0(x)
