"""Conformer block and the complex-domain ComplexConformer
(``sincformer_tpu/models/conformer.py``).

Submodules carry the flax names (``FeedForwardModule_0``, ``LayerNorm_0``,
``qkv``, ...) so a state-dict key is the flax parameter path joined with
dots (compat/from_jax.py). LayerNorm and GroupNorm use flax's eps 1e-6,
BatchNorm flax's 1e-5.

Dropout sits where the JAX block has it (after the feed-forward Swish and
its second Dense, after the attention output projection, after the conv
module's last pointwise layer). A forward given a ``generator`` is a
training forward: it draws its dropout masks from it, and a BatchNorm
normalises by the batch's statistics and steps its running ones; without
one it is deterministic.

Tensor parallelism: every Dense and the depthwise conv go through
``parallel/sharding.py`` (a split weight computes its column block and
gathers); the fused feed-forward gathers its two weights and runs kernel
K3 whole. Context parallelism: under ``ops.ring_mesh`` the block's input
is this rank's block of frames (a model given the whole sequence cuts it
for its blocks, ``parallel/context.py``); ``attn_impl="ring"`` attends
over every rank's frames, the depthwise conv exchanges halo frames
(``ops/cp_conv.py``), and the "batch" and "group" norms take their
statistics over every rank's frames.

bfloat16: every module runs in the dtype of its input and parameters, as
flax's modules do under the JAX package's bf16 path (``DCSETrainer``'s
``compute_dtype``, a model cast with ``.to(torch.bfloat16)``). The norms
take their statistics in float32 and return the input's dtype, the
LayerNorm and the GroupNorm with flax's variance E[x²] - E[x]²; BatchNorm's
running statistics stay float32 buffers stepped from float32 statistics;
the attention's key bias stays float32. Where PyTorch's bf16 operator
would round once and the JAX package's rounds twice, the bf16 path rounds
as JAX's: a Dense or a convolution rounds its product and then its sum
with the bias, and the sigmoid (of the swish, the GLU and the mask head)
is XLA's ``1 / (1 + exp(-x))`` with each operation rounded. In float32
every path is as before.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sincformer_tpu_torch.ops.attention import (active_ring_mesh,
                                                dot_product_attention)
from sincformer_tpu_torch.ops.cp_conv import cp_depthwise_conv_in_mesh
from sincformer_tpu_torch.ops.flax_math import (LayerNorm, flax_norm, glu,
                                                in_dtype, swish)
from sincformer_tpu_torch.ops.fused_ffn import LN_EPS, fused_ffn
from sincformer_tpu_torch.parallel import collectives
from sincformer_tpu_torch.parallel import sharding as tp


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 - p, drawn
    from ``generator``, and divide the kept ones by 1 - p (in bfloat16 by
    1 - p rounded to bfloat16, as JAX divides by a Python constant). The
    identity when ``generator`` is None (deterministic) or p is 0."""
    if generator is None or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / in_dtype(1.0 - p, x.dtype),
                       torch.zeros_like(x))


def same_pad(x: torch.Tensor, k: int, stride: int = 1) -> torch.Tensor:
    """Zero-pad the last axis as flax's ``padding="SAME"`` does for a conv or
    pool of window ``k`` and ``stride``: the output has ceil(T / stride)
    steps, and of total = max((out - 1)·stride + k - T, 0) padded zeros,
    total // 2 go before (asymmetric for an even total)."""
    t = x.shape[-1]
    out = -(-t // stride)
    total = max((out - 1) * stride + k - t, 0)
    return F.pad(x, (total // 2, total - total // 2))


class FeedForwardModule(nn.Module):
    """LN → Dense(d_ff) → Swish → Dropout → Dense(d) → Dropout, half
    residual.

    ``fused=True`` runs the whole module as one call of ``ops.fused_ffn``
    (kernel K3 on a CUDA tensor) unless dropout is active, where it takes
    the unfused math, as the JAX package's ``FusedFeedForward`` does (in
    bfloat16 that module's own math: :meth:`_fused_dropout_bf16`). Both
    forms have the same parameters, so a checkpoint loads into either. The
    kernel reads the weights as (in, out), the transposes of
    ``Linear.weight``: under autograd they are transposed views made
    contiguous, so the gradient reaches the weights; without it they are
    made once and again only when a weight was rewritten, moved or cast;
    tensors that stand in for the weights (``torch.func.functional_call``
    with bfloat16 copies) are transposed at every call, never cached. Split
    weights (tensor parallelism) are gathered first, every call.
    """

    def __init__(self, d_model: int, d_ff: int, fused: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        self.fused = fused
        self.dropout = dropout
        self.LayerNorm_0 = LayerNorm(d_model, eps=LN_EPS)
        self.Dense_0 = nn.Linear(d_model, d_ff)
        self.Dense_1 = nn.Linear(d_ff, d_model)
        self._transposed = None         # (key, w1 (d, d_ff), w2 (d_ff, d))

    def _in_out_weights(self):
        w0, w1 = self.Dense_0.weight, self.Dense_1.weight
        if hasattr(w0, "tp_split") or hasattr(w1, "tp_split"):
            w0, w1 = tp.whole(w0), tp.whole(w1)
            return w0.t().contiguous(), w1.t().contiguous()
        if (torch.is_grad_enabled() and (w0.requires_grad or w1.requires_grad)
                or not all(isinstance(w, nn.Parameter) for w in (w0, w1))):
            return w0.t().contiguous(), w1.t().contiguous()
        # (a tensor made under inference_mode has no version counter)
        key = tuple((w.data_ptr(), w.dtype,
                     0 if w.is_inference() else w._version) for w in (w0, w1))
        if self._transposed is None or self._transposed[0] != key:
            self._transposed = (key, w0.detach().t().contiguous(),
                                w1.detach().t().contiguous())
        return self._transposed[1:]

    def _fused_dropout_bf16(self, x, generator):
        """The JAX package's ``FusedFeedForward`` with dropout active, in
        bfloat16: its own LayerNorm, whose mean and variance are means
        taken in f32 and rounded to bf16 and whose every other operation
        rounds to bf16, then the unfused Dense, swish and dropout."""
        ln = self.LayerNorm_0
        mu = x.float().mean(dim=-1, keepdim=True).to(x.dtype)
        var = ((x - mu) ** 2).float().mean(dim=-1, keepdim=True).to(x.dtype)
        y = ((x - mu) * torch.rsqrt(var + in_dtype(LN_EPS, x.dtype))
             * ln.weight + ln.bias)
        y = dropout(swish(tp.linear(self.Dense_0, y)), self.dropout,
                    generator)
        y = dropout(tp.linear(self.Dense_1, y), self.dropout, generator)
        return x + 0.5 * y

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if self.fused and (generator is None or self.dropout == 0.0):
            w1, w2 = self._in_out_weights()
            ln = self.LayerNorm_0
            return fused_ffn(x.contiguous(), ln.weight, ln.bias, w1,
                             self.Dense_0.bias, w2, self.Dense_1.bias)
        if self.fused and x.dtype == torch.bfloat16:
            return self._fused_dropout_bf16(x, generator)
        y = swish(tp.linear(self.Dense_0, self.LayerNorm_0(x)))
        y = dropout(y, self.dropout, generator)
        y = dropout(tp.linear(self.Dense_1, y), self.dropout, generator)
        return x + 0.5 * y


class FusedFeedForward(FeedForwardModule):
    """The JAX package's ``FusedFeedForward``: a :class:`FeedForwardModule`
    with ``fused=True`` (the same parameters, that module's dropout
    default)."""

    def __init__(self, d_model: int, d_ff: int, dropout: float = 0.1):
        super().__init__(d_model, d_ff, fused=True, dropout=dropout)


class MultiHeadSelfAttention(nn.Module):
    """Pre-LN multi-head self-attention with residual; the fused ``qkv``
    projection splits in q, k, v order. A forward given a ``generator`` is
    a training forward for ``ops.attention``'s ``impl="ring"`` rules."""

    def __init__(self, d_model: int, num_heads: int, attn_impl: str = "speech",
                 dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.dropout = dropout
        self.LayerNorm_0 = LayerNorm(d_model, eps=LN_EPS)
        self.qkv = nn.Linear(d_model, 3 * d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, x, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        b, t, d = x.shape
        h = self.num_heads
        # the split's views are strided: the kernel takes contiguous copies,
        # through which the gradient flows back to qkv
        qkv = tp.linear(self.qkv, self.LayerNorm_0(x))
        q, k, v = (y.reshape(b, t, h, d // h).contiguous()
                   for y in qkv.split(d, dim=-1))
        o = dot_product_attention(q, k, v, mask=mask, impl=self.attn_impl,
                                  train=generator is not None)
        return x + dropout(tp.linear(self.out, o.reshape(b, t, d)),
                           self.dropout, generator)


def _sequence_mean(stat: torch.Tensor) -> torch.Tensor:
    """A mean over this rank's frames made the mean over the whole
    sequence under an ``ops.ring_mesh`` context (every rank's block is as
    long); ``stat`` itself outside one."""
    ctx = active_ring_mesh()
    if ctx is None:
        return stat
    return collectives.mean_over(stat, ctx[0].get_group(ctx[1]))


class DepthwiseConv(nn.Module):
    """SAME-padded stride-1 depthwise conv over time on (B, T, D). Under an
    ``ops.ring_mesh`` context, with an odd kernel and a block of frames at
    least as long as the halo, it exchanges (k - 1) / 2 halo frames with
    the neighbouring ranks (``ops/cp_conv.py``), as the JAX module does;
    otherwise it runs the same conv on every rank's frames gathered and
    keeps this rank's block (JAX's fallback, the conv over the whole
    sequence). The parameters keep their names either way."""

    def __init__(self, features: int, kernel_size: int):
        super().__init__()
        self.kernel_size = kernel_size
        self.weight = nn.Parameter(torch.empty(features, 1, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        k = self.kernel_size
        ctx = active_ring_mesh()
        if ctx is None:
            return self._conv(x)
        if k % 2 == 1 and x.shape[1] >= (k - 1) // 2:
            return cp_depthwise_conv_in_mesh(x, tp.whole(self.weight),
                                             self.bias, *ctx)
        mesh, seq_axis = ctx
        tl, r = x.shape[1], mesh.get_local_rank(seq_axis)
        # each rank's gradient of the whole reaches every rank's frames
        whole = collectives.gather(x, 1, group=mesh.get_group(seq_axis),
                                   summed=True)
        return self._conv(whole)[:, r * tl:(r + 1) * tl]

    def _conv(self, x):
        y = tp.depthwise_conv1d(same_pad(x.transpose(1, 2),
                                         self.kernel_size),
                                self.weight, self.bias)
        return y.transpose(1, 2)


BN_EPS = 1e-5          # flax BatchNorm's epsilon
BN_MOMENTUM = 0.99     # flax BatchNorm: ra <- 0.99 ra + 0.01 x


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               running_mean: torch.Tensor, running_var: torch.Tensor,
               train: bool, momentum: float = BN_MOMENTUM,
               eps: float = BN_EPS) -> torch.Tensor:
    """flax ``nn.BatchNorm`` on (B, T, D) with the feature axis last.

    Training (``train=True``): normalise by the statistics of this batch,
    taken over B and T (padded frames included, as in JAX; in a
    data-parallel step over every rank's B, ``parallel/collectives.py``,
    so the running statistics agree on every rank; under ``ops.ring_mesh``
    over every rank's frames), the variance
    as max(0, E[x²] - E[x]²); then step the running statistics in place,
    ``ra = momentum · ra + (1 - momentum) · stat`` with the *biased*
    variance. Otherwise normalise by the running statistics. The output is
    ``(x - mean) · (rsqrt(var + eps) · weight) + bias``, flax's order.
    A bfloat16 ``x`` is widened to float32 for the statistics and the
    normalisation and the result rounded back once, as flax does; the
    running statistics stay float32."""
    dtype = x.dtype
    x = x.float() if dtype == torch.bfloat16 else x
    if train:
        mean = _sequence_mean(collectives.mean(x, dim=(0, 1)))
        var = torch.clamp(_sequence_mean(collectives.mean(x * x, dim=(0, 1)))
                          - mean * mean, min=0.0)
        with torch.no_grad():
            running_mean.mul_(momentum).add_((1.0 - momentum)
                                             * mean.detach())
            running_var.mul_(momentum).add_((1.0 - momentum) * var.detach())
    else:
        mean, var = running_mean, running_var
    return ((x - mean) * (torch.rsqrt(var + eps) * weight) + bias).to(dtype)


class BatchNorm(nn.Module):
    """Parameters ``weight`` (flax's scale) and ``bias``, running statistics
    ``mean`` and ``var`` in buffers (flax's ``batch_stats``): see
    :func:`batch_norm`."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x, train: bool = False):
        return batch_norm(x, self.weight, self.bias, self.mean, self.var,
                          train)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` on (B, T, D): statistics per batch row and
    group over T and the group's channels, flax's fast variance, eps 1e-6;
    in float32 for a bfloat16 input, rounded back once, as flax does."""

    def __init__(self, features: int, num_groups: int, eps: float = LN_EPS):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        b, t, d = x.shape
        g = self.num_groups
        xf = x.float() if x.dtype == torch.bfloat16 else x
        y = flax_norm(xf.reshape(b, t, g, d // g), (1, 3),
                      self.weight.view(g, -1), self.bias.view(g, -1),
                      self.eps, _sequence_mean)
        return y.reshape(b, t, d).to(x.dtype)


class ConvolutionModule(nn.Module):
    """LN → pointwise(2d) → GLU → depthwise(k) → norm → Swish → pointwise →
    Dropout, residual. ``norm``: "layer" (``ln``, the flagship's and the
    default), "batch" (``bn``, flax BatchNorm with running statistics) or
    "group" (``gn``, GroupNorm of min(32, d_model) groups), the JAX names."""

    def __init__(self, d_model: int, kernel_size: int = 31,
                 dropout: float = 0.0, norm: str = "layer"):
        super().__init__()
        self.dropout = dropout
        self.norm = norm
        self.LayerNorm_0 = LayerNorm(d_model, eps=LN_EPS)
        self.pointwise1 = nn.Linear(d_model, 2 * d_model)
        self.depthwise = DepthwiseConv(d_model, kernel_size)
        if norm == "batch":
            self.bn = BatchNorm(d_model)
        elif norm == "group":
            self.gn = GroupNorm(d_model, min(32, d_model))
        elif norm == "layer":
            self.ln = LayerNorm(d_model, eps=LN_EPS)
        else:
            raise ValueError(f"norm must be 'layer', 'batch' or 'group', got "
                             f"{norm!r}")
        self.pointwise2 = nn.Linear(d_model, d_model)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        y = glu(tp.linear(self.pointwise1, self.LayerNorm_0(x)))
        y = self.depthwise(y)
        if self.norm == "batch":
            y = self.bn(y, train=generator is not None)
        elif self.norm == "group":
            y = self.gn(y)
        else:
            y = self.ln(y)
        return x + dropout(tp.linear(self.pointwise2, swish(y)),
                           self.dropout, generator)


class ConformerBlock(nn.Module):
    """FF½ → MHSA → Conv → FF½ → LN."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int,
                 kernel_size: int, attn_impl: str = "speech",
                 fused_ffn: bool = False, dropout: float = 0.0,
                 conv_norm: str = "layer"):
        super().__init__()
        self.FeedForwardModule_0 = FeedForwardModule(d_model, d_ff, fused_ffn,
                                                     dropout)
        self.MultiHeadSelfAttention_0 = MultiHeadSelfAttention(
            d_model, num_heads, attn_impl, dropout)
        self.ConvolutionModule_0 = ConvolutionModule(d_model, kernel_size,
                                                     dropout, conv_norm)
        self.FeedForwardModule_1 = FeedForwardModule(d_model, d_ff, fused_ffn,
                                                     dropout)
        self.LayerNorm_0 = LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        x = self.FeedForwardModule_0(x, generator)
        x = self.MultiHeadSelfAttention_0(x, mask, generator)
        x = self.ConvolutionModule_0(x, generator)
        x = self.FeedForwardModule_1(x, generator)
        return self.LayerNorm_0(x)


class ComplexConformer(nn.Module):
    """Complex STFT → complex mask: concat(re, im) → Linear(2F → d) → N
    blocks → + global skip → Linear(d → 2F), split into (real, imag). A
    library model, as in the JAX package: no verb trains or serves it."""

    def __init__(self, n_freq: int = 129, d_model: int = 256,
                 num_blocks: int = 6, num_heads: int = 4, d_ff: int = 1024,
                 kernel_size: int = 31, dropout: float = 0.1,
                 conv_norm: str = "layer", attn_impl: str = "speech"):
        super().__init__()
        self.n_freq = n_freq
        self.num_blocks = num_blocks
        self.input_proj = nn.Linear(2 * n_freq, d_model)
        for i in range(num_blocks):
            self.add_module(f"block_{i}", ConformerBlock(
                d_model, num_heads, d_ff, kernel_size, attn_impl, False,
                dropout, conv_norm))
        self.output_proj = nn.Linear(d_model, 2 * n_freq)

    def forward(self, stft_real, stft_imag,
                mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        x = tp.linear(self.input_proj,
                      torch.cat([stft_real, stft_imag], dim=-1))
        skip = x
        for i in range(self.num_blocks):
            x = getattr(self, f"block_{i}")(x, mask, generator)
        x = tp.linear(self.output_proj, x + skip)
        return x[..., :self.n_freq], x[..., self.n_freq:]

    @staticmethod
    def apply_mask(stft_real, stft_imag, mask_real, mask_imag):
        """Ŝ = M̂ ⊙ Z, the complex product."""
        return (mask_real * stft_real - mask_imag * stft_imag,
                mask_real * stft_imag + mask_imag * stft_real)


def default_complex_conformer(ccfg=None, acfg=None,
                              **overrides) -> ComplexConformer:
    """The ComplexConformer at ``ConformerConfig``'s sizes (6 blocks,
    dropout 0.1) on ``AudioConfig``'s frequency bins."""
    from sincformer_tpu_torch.config import AudioConfig, ConformerConfig
    ccfg, acfg = ccfg or ConformerConfig(), acfg or AudioConfig()
    kw = dict(n_freq=acfg.n_freq, d_model=ccfg.d_model,
              num_blocks=ccfg.num_blocks, num_heads=ccfg.num_heads,
              d_ff=ccfg.ff_dim, kernel_size=ccfg.kernel_size,
              dropout=ccfg.dropout, attn_impl=ccfg.attn_impl)
    kw.update(overrides)
    return ComplexConformer(**kw)
