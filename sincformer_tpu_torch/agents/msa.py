"""Mask synthesis agent (``sincformer_tpu/agents/msa.py``): fused features →
fusion MLP → Conformer blocks → bounded polar mask (phase within ±π/8).
A forward given a ``generator`` runs its blocks' dropout from it (the JAX
module's ``deterministic=False``). Every Dense goes through
``parallel/sharding.py`` (tensor parallelism)."""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from sincformer_tpu_torch.agents.perception import gelu
from sincformer_tpu_torch.models.conformer import LN_EPS, ConformerBlock
from sincformer_tpu_torch.parallel import sharding as tp


class MaskSynthesisAgent(nn.Module):
    """(z_real, z_imag, cpea, stft_re, stft_im) → (mask_re, mask_im)."""

    def __init__(self, latent_dim: int = 256, cpea_dim: int = 64,
                 d_model: int = 256, n_freq: int = 129, num_blocks: int = 4,
                 num_heads: int = 4, d_ff: int = 1024, kernel_size: int = 31,
                 attn_impl: str = "speech", phase_bound_div: float = 8.0,
                 dropout: float = 0.0):
        super().__init__()
        self.phase_bound = math.pi / phase_bound_div
        self.num_blocks = num_blocks
        self.fusion1 = nn.Linear(2 * latent_dim + 4 * cpea_dim + 2 * n_freq,
                                 d_model)
        self.fusion_ln1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.fusion2 = nn.Linear(d_model, d_model)
        self.fusion_ln2 = nn.LayerNorm(d_model, eps=LN_EPS)
        for i in range(num_blocks):
            self.add_module(f"block_{i}", ConformerBlock(
                d_model, num_heads, d_ff, kernel_size, attn_impl,
                dropout=dropout))
        self.head_hidden = nn.Linear(d_model, d_model)
        self.mag_head = nn.Linear(d_model, n_freq)
        self.phase_head = nn.Linear(d_model, n_freq)

    def forward(self, z_real, z_imag, cpea: Dict[str, torch.Tensor],
                noisy_stft_real, noisy_stft_imag,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        # log1p-magnitude normalisation of the noisy STFT
        mag = torch.sqrt(noisy_stft_real ** 2 + noisy_stft_imag ** 2 + 1e-8)
        norm = torch.log1p(mag) / mag
        fused = torch.cat(
            [z_real.transpose(1, 2), z_imag.transpose(1, 2), cpea["rho_s"],
             cpea["rho_n"], cpea["phi1"], cpea["phi2"],
             noisy_stft_real * norm, noisy_stft_imag * norm], dim=-1)
        x = gelu(self.fusion_ln1(tp.linear(self.fusion1, fused)))
        x = self.fusion_ln2(tp.linear(self.fusion2, x))
        for i in range(self.num_blocks):
            x = getattr(self, f"block_{i}")(x, generator=generator)
        h = gelu(tp.linear(self.head_hidden, x))
        mask_mag = torch.sigmoid(tp.linear(self.mag_head, h))
        mask_phase = torch.tanh(tp.linear(self.phase_head, h)) \
            * self.phase_bound
        return mask_mag * torch.cos(mask_phase), mask_mag * torch.sin(mask_phase)
