"""Mask synthesis agent (``sincformer_tpu/agents/msa.py``): fused features →
fusion MLP → Conformer blocks → bounded polar mask (phase within ±π/8).
A forward given a ``generator`` runs its blocks' dropout from it (the JAX
module's ``deterministic=False``). Every Dense goes through
``parallel/sharding.py`` (tensor parallelism). In bfloat16 the GELU, the
sigmoid and the constants round as JAX's do (``ops.flax_math``)."""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from sincformer_tpu_torch.models.conformer import LN_EPS, ConformerBlock
from sincformer_tpu_torch.ops.flax_math import (LayerNorm, gelu, in_dtype,
                                                sigmoid)
from sincformer_tpu_torch.parallel import sharding as tp
from sincformer_tpu_torch.parallel.context import split_sequence


class MaskSynthesisAgent(nn.Module):
    """(z_real, z_imag, cpea, stft_re, stft_im) → (mask_re, mask_im).

    Inside ``ops.ring_mesh`` with ``attn_impl="ring"`` the inputs are the
    whole sequence on every rank: the fusion runs whole, the blocks and the
    heads (the ring region, :meth:`ring_region`) run on this rank's block
    of frames, and the masks are joined whole again
    (``parallel/context.py``)."""

    def __init__(self, latent_dim: int = 256, cpea_dim: int = 64,
                 d_model: int = 256, n_freq: int = 129, num_blocks: int = 4,
                 num_heads: int = 4, d_ff: int = 1024, kernel_size: int = 31,
                 attn_impl: str = "speech", phase_bound_div: float = 8.0,
                 dropout: float = 0.0):
        super().__init__()
        self.phase_bound = math.pi / phase_bound_div
        self.num_blocks = num_blocks
        self.attn_impl = attn_impl
        self.fusion1 = nn.Linear(2 * latent_dim + 4 * cpea_dim + 2 * n_freq,
                                 d_model)
        self.fusion_ln1 = LayerNorm(d_model, eps=LN_EPS)
        self.fusion2 = nn.Linear(d_model, d_model)
        self.fusion_ln2 = LayerNorm(d_model, eps=LN_EPS)
        for i in range(num_blocks):
            self.add_module(f"block_{i}", ConformerBlock(
                d_model, num_heads, d_ff, kernel_size, attn_impl,
                dropout=dropout))
        self.head_hidden = nn.Linear(d_model, d_model)
        self.mag_head = nn.Linear(d_model, n_freq)
        self.phase_head = nn.Linear(d_model, n_freq)

    def ring_region(self) -> Tuple[nn.Module, ...]:
        """The layers that run on this rank's block of frames under a ring,
        in order: the blocks, then the heads' three Dense. :meth:`forward`
        and :meth:`heads` take them from here."""
        return (*(getattr(self, f"block_{i}")
                  for i in range(self.num_blocks)),
                self.head_hidden, self.mag_head, self.phase_head)

    def fuse(self, z_real, z_imag, cpea: Dict[str, torch.Tensor],
             noisy_stft_real, noisy_stft_imag) -> torch.Tensor:
        """The fusion MLP: (B, T, d_model) features from the latents, the
        CPEA outputs and the log1p-normalised noisy STFT."""
        dt = noisy_stft_real.dtype
        mag = torch.sqrt(noisy_stft_real ** 2 + noisy_stft_imag ** 2
                         + in_dtype(1e-8, dt))
        norm = torch.log1p(mag) / mag
        fused = torch.cat(
            [z_real.transpose(1, 2), z_imag.transpose(1, 2), cpea["rho_s"],
             cpea["rho_n"], cpea["phi1"], cpea["phi2"],
             noisy_stft_real * norm, noisy_stft_imag * norm], dim=-1)
        x = gelu(self.fusion_ln1(tp.linear(self.fusion1, fused)))
        return self.fusion_ln2(tp.linear(self.fusion2, x))

    def heads(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The mask heads on the blocks' output: (mask_re, mask_im)."""
        hidden, mag, phase = self.ring_region()[-3:]
        h = gelu(tp.linear(hidden, x))
        mask_mag = sigmoid(tp.linear(mag, h))
        mask_phase = torch.tanh(tp.linear(phase, h)) \
            * in_dtype(self.phase_bound, h.dtype)
        return mask_mag * torch.cos(mask_phase), mask_mag * torch.sin(mask_phase)

    def forward(self, z_real, z_imag, cpea: Dict[str, torch.Tensor],
                noisy_stft_real, noisy_stft_imag,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.fuse(z_real, z_imag, cpea, noisy_stft_real, noisy_stft_imag)
        with split_sequence(x.shape[1], generator is not None,
                            self.attn_impl) as ring:
            if ring is not None:
                x = ring.cut(x)
            for block in self.ring_region()[:-3]:
                x = block(x, generator=generator)
            masks = self.heads(x)
            if ring is not None:
                masks = tuple(ring.join(torch.stack(masks), dim=2).unbind(0))
        return masks
