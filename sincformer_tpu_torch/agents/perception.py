"""Perception agents (``sincformer_tpu/agents/perception.py``): waveform →
complex latent (z_real, z_imag) and σ on the 80-sample STFT grid.

``PerceptionAgentMXU`` (``pa_impl="mxu"``): SincConv, a companded fine
stream and a log-envelope stream patchified onto the frame grid by k=4 and
k=2 convs (``fine_feats="dual"`` adds a k=4 conv of the per-frame
normalised fine chunks), three residual conv blocks at frame rate, then the
complex latent and σ heads. ``PerceptionAgent`` (``pa_impl="reference"``):
the reference's stride-2 cascade, SincConv → GroupNorm → GELU at 8 kHz,
three residual stride-2 blocks, a stride-2 downsample, a 5× average pool
(VALID: the tail is dropped) onto the frame grid, and 1×1 heads. Layout
inside is (B, C, T), PyTorch's conv layout; every conv pads as flax's SAME
does (``models.conformer.same_pad``), asymmetric for even kernels and for
stride 2 on even lengths. Every conv and Dense goes through
``parallel/sharding.py`` (tensor parallelism: a split weight computes its
block of output channels and the blocks are gathered).

bfloat16 (a model cast with ``.to(torch.bfloat16)``) rounds where the JAX
package's bf16 forward rounds: GELU, softplus and constants as
``ops.flax_math`` expands them, a conv's product before its bias, the
GroupNorms' statistics and normalisation in float32 with one rounding, as
flax's ``nn.GroupNorm`` does.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sincformer_tpu_torch.agents.sincnet import SincConv1d
from sincformer_tpu_torch.models.conformer import LN_EPS, same_pad
from sincformer_tpu_torch.ops.flax_math import (LayerNorm, flax_norm, gelu,
                                                in_dtype, layer_norm,
                                                softplus)
from sincformer_tpu_torch.parallel import sharding as tp


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` over (B, C, T); in bfloat16 flax's arithmetic
    (``ops.flax_math.flax_norm`` over each group in float32), rounded
    once."""

    def forward(self, x):
        if x.dtype != torch.bfloat16:
            return super().forward(x)
        b, c, t = x.shape
        g = self.num_groups
        y = flax_norm(x.float().reshape(b, g, c // g, t), (2, 3),
                      self.weight.view(g, -1, 1), self.bias.view(g, -1, 1),
                      self.eps)
        return y.reshape(b, c, t).to(x.dtype)


class _Conv1d(nn.Conv1d):
    """``nn.Conv1d`` whose weight may be split over the model ranks."""

    def forward(self, x):
        return tp.conv1d(self, x)


class _SameConv1d(_Conv1d):
    """Conv over (B, C, T) with flax SAME padding, at its stride."""

    def forward(self, x):
        return super().forward(same_pad(x, self.kernel_size[0],
                                        self.stride[0]))


class _ConvBlock(nn.Module):
    """7-conv (stride s) → GN → GELU → 3-conv → GN, plus a 1×1 stride-s skip
    → GN; then GELU. GroupNorm of min(16, out) groups."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        g = min(16, out_ch)
        self.conv1 = _SameConv1d(in_ch, out_ch, 7, stride=stride)
        self.gn1 = GroupNorm(g, out_ch, eps=LN_EPS)
        self.conv2 = _SameConv1d(out_ch, out_ch, 3)
        self.gn2 = GroupNorm(g, out_ch, eps=LN_EPS)
        # k = 1: flax's SAME pads nothing at any stride
        self.skip = _Conv1d(in_ch, out_ch, 1, stride=stride)
        self.gn_skip = GroupNorm(g, out_ch, eps=LN_EPS)

    def forward(self, x):
        main = self.gn2(self.conv2(gelu(self.gn1(self.conv1(x)))))
        return gelu(main + self.gn_skip(self.skip(x)))


class PerceptionAgentMXU(nn.Module):
    """(B, N) waveform → (z_real, z_imag, σ): (B, D, T'), (B, D, T'),
    (B, 1, T') with T' = N // hop."""

    def __init__(self, encoder_channels: int = 256, sample_rate: int = 8000,
                 sinc_kernel_size: int = 251, align_hop: int = 80,
                 num_blocks: int = 3, env_pool: int = 8,
                 fine_act: str = "mulaw", fine_feats: str = "single"):
        super().__init__()
        d = encoder_channels
        c = d // 4
        self.hop = align_hop
        self.env_pool = env_pool
        self.fine_act = fine_act
        self.fine_feats = fine_feats
        self.sinc = SincConv1d(c, sinc_kernel_size, sample_rate,
                               channels_last=True)
        self.act_scale = nn.Parameter(torch.ones(c))
        if fine_act == "mulaw":
            self.act_mu = nn.Parameter(torch.ones(c))
        self.embed = _SameConv1d(align_hop * c, d, 4)
        self.embed_env = _SameConv1d(align_hop // env_pool * c, d, 2)
        if fine_feats == "dual":
            self.embed_norm = _SameConv1d(align_hop * c, d, 4)
        self.embed_ln = LayerNorm(d, eps=LN_EPS)
        for i in range(num_blocks):
            self.add_module(f"block_{i}", _ConvBlock(d, d))
        self.num_blocks = num_blocks
        self.real_proj = nn.Linear(d, d)
        self.gn_real = GroupNorm(16, d, eps=LN_EPS)
        self.imag_proj = nn.Linear(d, d)
        self.gn_imag = GroupNorm(16, d, eps=LN_EPS)
        self.unc1 = _SameConv1d(d, d // 4, 3)
        self.unc2 = nn.Linear(d // 4, 1)

    def front(self, waveform: torch.Tensor) -> torch.Tensor:
        """SincConv, the two streams, their embeddings, LayerNorm and GELU:
        (B, N) waveform → (B, D, T) at frame rate."""
        hop, pool = self.hop, self.env_pool
        x = self.sinc(waveform)                          # (B, N, C)
        b, n, c = x.shape
        t = n // hop

        # envelope stream: |x| → pool-sample means → log1p, hop chunks
        env = torch.abs(x[:, :t * hop]).reshape(b, t * hop // pool, pool, c)
        env = torch.log1p(env.mean(dim=2))
        echunks = env.reshape(b, t, hop // pool * c)

        # fine stream: per-channel companding (μ-law) or GELU
        z = x * self.act_scale
        if self.fine_act == "mulaw":
            mu = softplus(self.act_mu) + in_dtype(1e-4, z.dtype)
            x = torch.sign(z) * torch.log1p(mu * torch.abs(z))
        else:
            x = gelu(z)
        chunks = x[:, :t * hop].reshape(b, t, hop * c)

        h = (self.embed(chunks.transpose(1, 2))
             + self.embed_env(echunks.transpose(1, 2)))   # (B, D, T)
        if self.fine_feats == "dual":
            # a level-decoupled view of the same chunks: LayerNorm without
            # scale or bias over each frame's hop·C values
            normed = layer_norm(chunks)
            h = h + self.embed_norm(normed.transpose(1, 2))
        return gelu(self.embed_ln(h.transpose(1, 2))).transpose(1, 2)

    def heads(self, h: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The latent and σ heads on the blocks' (B, D, T) output."""
        h_t = h.transpose(1, 2)                           # (B, T, D)
        z_real = self.gn_real(tp.linear(self.real_proj, h_t).transpose(1, 2))
        z_imag = self.gn_imag(tp.linear(self.imag_proj, h_t).transpose(1, 2))
        u = gelu(self.unc1(h)).transpose(1, 2)
        log_var = tp.linear(self.unc2, u).transpose(1, 2)  # (B, 1, T)
        sigma = torch.exp(0.5 * torch.clamp(log_var, -10.0, 10.0))
        return z_real, z_imag, sigma

    def forward(self, waveform: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        h = self.front(waveform)
        for i in range(self.num_blocks):
            h = getattr(self, f"block_{i}")(h)
        return self.heads(h)


class PerceptionAgent(nn.Module):
    """The reference cascade: (B, N) waveform → (z_real, z_imag, σ), (B, D,
    T'), (B, D, T'), (B, 1, T') with T' = floor(ceil(N / 16) / 5) for the
    80-sample hop. The GroupNorms take whole-window statistics, as in
    JAX."""

    def __init__(self, encoder_channels: int = 256, sample_rate: int = 8000,
                 sinc_kernel_size: int = 251, align_hop: int = 80):
        super().__init__()
        d = encoder_channels
        self.sinc = SincConv1d(d // 4, sinc_kernel_size, sample_rate)
        self.sinc_norm = GroupNorm(8, d // 4, eps=LN_EPS)
        widths = (d // 4, d // 2, d // 2, d)
        for i in range(3):
            self.add_module(f"block_{i}", _ConvBlock(widths[i], widths[i + 1],
                                                     stride=2))
        self.downsample = _SameConv1d(d, d, 5, stride=2)
        self.down_norm = GroupNorm(16, d, eps=LN_EPS)
        self.pool = align_hop // 16
        self.real_proj = _Conv1d(d, d, 1)
        self.gn_real = GroupNorm(16, d, eps=LN_EPS)
        self.imag_proj = _Conv1d(d, d, 1)
        self.gn_imag = GroupNorm(16, d, eps=LN_EPS)
        self.unc1 = _SameConv1d(d, d // 4, 3)
        self.unc2 = _Conv1d(d // 4, 1, 1)

    def forward(self, waveform: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = gelu(self.sinc_norm(self.sinc(waveform)))    # (B, D/4, N)
        for i in range(3):
            x = getattr(self, f"block_{i}")(x)           # 2× down each
        x = gelu(self.down_norm(self.downsample(x)))     # (B, D, N/16)
        if self.pool > 1:   # onto the STFT grid; VALID drops the tail
            x = F.avg_pool1d(x, self.pool, self.pool)
        z_real = self.gn_real(self.real_proj(x))
        z_imag = self.gn_imag(self.imag_proj(x))
        log_var = self.unc2(gelu(self.unc1(x)))           # (B, 1, T')
        sigma = torch.exp(0.5 * torch.clamp(log_var, -10.0, 10.0))
        return z_real, z_imag, sigma
