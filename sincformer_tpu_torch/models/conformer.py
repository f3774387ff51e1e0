"""Conformer block (``sincformer_tpu/models/conformer.py``), inference only.

Submodules carry the flax names (``FeedForwardModule_0``, ``LayerNorm_0``,
``qkv``, ...) so a state-dict key is the flax parameter path joined with
dots (compat/from_jax.py). Normalisation layers use flax's eps 1e-6.
Dropout is the identity at inference and is not modelled.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sincformer_tpu_torch.ops.attention import dot_product_attention
from sincformer_tpu_torch.ops.fused_ffn import LN_EPS, fused_ffn


def same_pad(x: torch.Tensor, k: int) -> torch.Tensor:
    """flax ``padding="SAME"`` for a stride-1 conv over the last axis:
    (k-1)//2 before and the rest after (asymmetric for even k)."""
    before = (k - 1) // 2
    return F.pad(x, (before, k - 1 - before))


class FeedForwardModule(nn.Module):
    """LN → Dense(d_ff) → Swish → Dense(d), half residual.

    ``fused=True`` runs the whole module as one call of ``ops.fused_ffn``
    (kernel K3 on a CUDA tensor). Both forms have the same parameters, so a
    checkpoint loads into either. The kernel reads the weights as (in, out),
    the transposes of ``Linear.weight``; they are made once and again only
    when a weight was rewritten or moved, not per call.
    """

    def __init__(self, d_model: int, d_ff: int, fused: bool = False):
        super().__init__()
        self.fused = fused
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.Dense_0 = nn.Linear(d_model, d_ff)
        self.Dense_1 = nn.Linear(d_ff, d_model)
        self._transposed = None         # (key, w1 (d, d_ff), w2 (d_ff, d))

    def _in_out_weights(self):
        w0, w1 = self.Dense_0.weight, self.Dense_1.weight
        # (a tensor made under inference_mode has no version counter)
        key = tuple((w.data_ptr(), 0 if w.is_inference() else w._version)
                    for w in (w0, w1))
        if self._transposed is None or self._transposed[0] != key:
            self._transposed = (key, w0.detach().t().contiguous(),
                                w1.detach().t().contiguous())
        return self._transposed[1:]

    def forward(self, x):
        if self.fused:
            w1, w2 = self._in_out_weights()
            ln = self.LayerNorm_0
            return fused_ffn(x.contiguous(), ln.weight, ln.bias, w1,
                             self.Dense_0.bias, w2, self.Dense_1.bias)
        return x + 0.5 * self.Dense_1(F.silu(self.Dense_0(self.LayerNorm_0(x))))


class MultiHeadSelfAttention(nn.Module):
    """Pre-LN multi-head self-attention with residual; the fused ``qkv``
    projection splits in q, k, v order."""

    def __init__(self, d_model: int, num_heads: int, attn_impl: str = "speech"):
        super().__init__()
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.qkv = nn.Linear(d_model, 3 * d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        b, t, d = x.shape
        h = self.num_heads
        q, k, v = (y.reshape(b, t, h, d // h).contiguous()
                   for y in self.qkv(self.LayerNorm_0(x)).split(d, dim=-1))
        o = dot_product_attention(q, k, v, mask=mask, impl=self.attn_impl)
        return x + self.out(o.reshape(b, t, d))


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
    """LN → pointwise(2d) → GLU → depthwise(k) → LN → Swish → pointwise,
    residual (the flagship's ``norm="layer"``)."""

    def __init__(self, d_model: int, kernel_size: int = 31):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.pointwise1 = nn.Linear(d_model, 2 * d_model)
        self.depthwise = DepthwiseConv(d_model, kernel_size)
        self.ln = nn.LayerNorm(d_model, eps=LN_EPS)
        self.pointwise2 = nn.Linear(d_model, d_model)

    def forward(self, x):
        y = F.glu(self.pointwise1(self.LayerNorm_0(x)), dim=-1)
        y = F.silu(self.ln(self.depthwise(y)))
        return x + self.pointwise2(y)


class ConformerBlock(nn.Module):
    """FF½ → MHSA → Conv → FF½ → LN."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int,
                 kernel_size: int, attn_impl: str = "speech",
                 fused_ffn: bool = False):
        super().__init__()
        self.FeedForwardModule_0 = FeedForwardModule(d_model, d_ff, fused_ffn)
        self.MultiHeadSelfAttention_0 = MultiHeadSelfAttention(
            d_model, num_heads, attn_impl)
        self.ConvolutionModule_0 = ConvolutionModule(d_model, kernel_size)
        self.FeedForwardModule_1 = FeedForwardModule(d_model, d_ff, fused_ffn)
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        x = self.FeedForwardModule_0(x)
        x = self.MultiHeadSelfAttention_0(x, mask)
        x = self.ConvolutionModule_0(x)
        x = self.FeedForwardModule_1(x)
        return self.LayerNorm_0(x)
