"""DCSE SpeechEnhancer (``sincformer_tpu/models/dcse.py``):

    concat(re, im) → LayerNorm → Linear(2F→d) → Conformer blocks → LayerNorm
    → sigmoid magnitude head and tanh·π/6 phase head → polar to cartesian →
    complex product with the noisy STFT.

The bounded polar mask (magnitude in [0, 1], phase within ±π/phase_bound_div)
is kept exactly. Submodules carry the flax names, so a state-dict key is the
flax parameter path joined with dots (compat/from_jax.py). With
``config.fused_ffn`` the feed-forward modules run through kernel K3 (a
training forward with dropout takes the unfused math, as JAX does);
``config.conv_norm`` picks each conv module's norm. A forward given a
``generator`` is a training forward (dropout drawn from it, BatchNorm on the
batch's statistics); without one it is the deterministic serving forward.

``config.remat`` recomputes each Conformer block in the backward
(``torch.utils.checkpoint``, JAX's ``nn.remat`` per block) with the same
dropout masks (the generator's state replayed) and one step of the
BatchNorm running statistics, so its gradients are the ones without it,
bit for bit. Every Dense goes through ``parallel/sharding.py`` (tensor
parallelism).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from sincformer_tpu_torch.config import DCSEConfig
from sincformer_tpu_torch.models.conformer import LN_EPS, ConformerBlock
from sincformer_tpu_torch.models.init import variance_scaling_
from sincformer_tpu_torch.parallel import sharding as tp


def rematerialised(block: nn.Module, x: torch.Tensor,
                   mask: Optional[torch.Tensor],
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """``block(x, mask, generator)`` whose activations are recomputed in the
    backward instead of kept. The recompute draws the forward's dropout
    masks again (``generator``'s state is set back to where the forward
    found it, then restored), and its BatchNorm step of the running
    statistics is undone, so the running statistics move once, as under
    JAX's ``nn.remat``."""
    start = None if generator is None else generator.get_state()
    calls = []

    def run(x_):
        if not calls:
            calls.append(True)
            return block(x_, mask, generator)
        resume = None if generator is None else generator.get_state()
        buffers = [b.clone() for b in block.buffers()]
        if generator is not None:
            generator.set_state(start)
        try:
            return block(x_, mask, generator)
        finally:
            if generator is not None:
                generator.set_state(resume)
            with torch.no_grad():
                for b, saved in zip(block.buffers(), buffers):
                    b.copy_(saved)
    return torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False)


class SpeechEnhancer(nn.Module):
    """(noisy_real, noisy_imag): (B, T, F) → (enh_real, enh_imag, mask_mag)."""

    def __init__(self, config: DCSEConfig = DCSEConfig()):
        super().__init__()
        c = config
        self.config = c
        self.phase_bound = math.pi / c.phase_bound_div
        self.input_norm = nn.LayerNorm(2 * c.n_freq, eps=LN_EPS)
        self.input_proj = nn.Linear(2 * c.n_freq, c.d_model)
        for i in range(c.num_blocks):
            self.add_module(f"block_{i}", ConformerBlock(
                c.d_model, c.num_heads, c.ff_dim, c.kernel_size, c.attn_impl,
                c.fused_ffn, c.dropout, c.conv_norm))
        self.output_norm = nn.LayerNorm(c.d_model, eps=LN_EPS)
        self.mag_head = nn.Linear(c.d_model, c.n_freq)
        self.phase_head = nn.Linear(c.d_model, c.n_freq)

    def forward(self, noisy_real: torch.Tensor, noisy_imag: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = tp.linear(self.input_proj, self.input_norm(
            torch.cat([noisy_real, noisy_imag], dim=-1)))
        remat = self.config.remat and torch.is_grad_enabled()
        for i in range(self.config.num_blocks):
            block = getattr(self, f"block_{i}")
            x = (rematerialised(block, x, mask, generator) if remat
                 else block(x, mask, generator))
        x = self.output_norm(x)
        mask_mag = torch.sigmoid(tp.linear(self.mag_head, x))
        mask_phase = (torch.tanh(tp.linear(self.phase_head, x))
                      * self.phase_bound)
        mask_real = mask_mag * torch.cos(mask_phase)
        mask_imag = mask_mag * torch.sin(mask_phase)
        enh_real = mask_real * noisy_real - mask_imag * noisy_imag
        enh_imag = mask_real * noisy_imag + mask_imag * noisy_real
        return enh_real, enh_imag, mask_mag

    @torch.no_grad()
    def training_init(self, generator: torch.Generator) -> "SpeechEnhancer":
        """The weights training starts from, drawn as flax draws them:
        every matrix and kernel ``lecun_normal`` (truncated at 2σ), zero
        biases, unit norm scales; BatchNorm statistics zero mean, unit
        variance."""
        for name, p in self.named_parameters():
            if p.ndim >= 2:
                variance_scaling_(p, 1.0, generator)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)
        for name, b in self.named_buffers():
            b.fill_(1.0 if name.endswith(".var") else 0.0)
        return self

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "SpeechEnhancer":
        """Random weights drawn from ``generator`` only, after the flax
        initialisers' scales: N(0, 1/fan_in) matrices and kernels, zero
        biases, unit norm scales (the parity tests' and the smoke run's
        weights; training draws :meth:`training_init`'s)."""
        for name, p in self.named_parameters():
            if p.ndim >= 2:
                p.copy_(torch.randn(p.shape, generator=generator)
                        / p[0].numel() ** 0.5)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)
        return self


def default_speech_enhancer(**overrides) -> SpeechEnhancer:
    """The DCSE model as the ``train`` verb builds it: ``DCSEConfig()``
    (6,225,414 parameters), fields overridden by ``overrides``."""
    return SpeechEnhancer(DCSEConfig(**overrides))
