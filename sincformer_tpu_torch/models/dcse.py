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
dropout masks (the generator's state replayed), the same parameter tensors
(the bfloat16 copies of a ``torch.func.functional_call`` too) and one step
of the BatchNorm running statistics, so its gradients are the ones without
it, bit for bit. Every Dense goes through ``parallel/sharding.py`` (tensor
parallelism).

In bfloat16 (inputs and parameters, as ``bench.py`` runs the JAX model and
``DCSETrainer``'s ``compute_dtype`` trains it) the whole forward runs in
bf16 and returns bf16, the norms' statistics in float32
(``models/conformer.py``); the phase bound is rounded to bf16 before it
scales the tanh, as JAX rounds a Python constant to the array's dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from sincformer_tpu_torch.config import DEFAULT, AudioConfig, DCSEConfig
from sincformer_tpu_torch.models.conformer import LN_EPS, ConformerBlock
from sincformer_tpu_torch.models.init import variance_scaling_
from sincformer_tpu_torch.ops.flax_math import LayerNorm, in_dtype, sigmoid
from sincformer_tpu_torch.parallel import sharding as tp
from sincformer_tpu_torch.parallel.context import split_sequence


def rematerialised(block: nn.Module, x: torch.Tensor,
                   mask: Optional[torch.Tensor],
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """``block(x, mask, generator)`` whose activations are recomputed in the
    backward instead of kept. The recompute draws the forward's dropout
    masks again (``generator``'s state is set back to where the forward
    found it, then restored), and its BatchNorm step of the running
    statistics is undone, so the running statistics move once, as under
    JAX's ``nn.remat``. The recompute reads the parameter tensors that the
    forward read, also where ``torch.func.functional_call`` stood copies in
    for them (it has returned by the time of the backward)."""
    start = None if generator is None else generator.get_state()
    calls = []
    params = dict(block.named_parameters())

    def run(x_):
        if not calls:
            calls.append(True)
            return block(x_, mask, generator)
        resume = None if generator is None else generator.get_state()
        buffers = [b.clone() for b in block.buffers()]
        if generator is not None:
            generator.set_state(start)
        try:
            return torch.func.functional_call(block, params,
                                              (x_, mask, generator))
        finally:
            if generator is not None:
                generator.set_state(resume)
            with torch.no_grad():
                for b, saved in zip(block.buffers(), buffers):
                    b.copy_(saved)
    return torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False)


class SpeechEnhancer(nn.Module):
    """(noisy_real, noisy_imag): (B, T, F) → (enh_real, enh_imag, mask_mag).

    Inside ``ops.ring_mesh`` with ``attn_impl="ring"`` every rank gives the
    whole sequence and gets the whole output: the model runs on this
    rank's block of frames (every layer works frame by frame or is
    ring-aware, so all of it is the ring region, :meth:`ring_region`) and
    joins its three outputs (``parallel/context.py``)."""

    def __init__(self, config: DCSEConfig = DCSEConfig()):
        super().__init__()
        c = config
        self.config = c
        self.phase_bound = math.pi / c.phase_bound_div
        self.input_norm = LayerNorm(2 * c.n_freq, eps=LN_EPS)
        self.input_proj = nn.Linear(2 * c.n_freq, c.d_model)
        for i in range(c.num_blocks):
            self.add_module(f"block_{i}", ConformerBlock(
                c.d_model, c.num_heads, c.ff_dim, c.kernel_size, c.attn_impl,
                c.fused_ffn, c.dropout, c.conv_norm))
        self.output_norm = LayerNorm(c.d_model, eps=LN_EPS)
        self.mag_head = nn.Linear(c.d_model, c.n_freq)
        self.phase_head = nn.Linear(c.d_model, c.n_freq)

    def ring_region(self) -> Tuple[nn.Module, ...]:
        """The layers that run on this rank's block of frames under a ring:
        all of them (:meth:`forward` runs the whole model between the cut
        and the join)."""
        return (self,)

    def forward(self, noisy_real: torch.Tensor, noisy_imag: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        with split_sequence(noisy_real.shape[1], generator is not None,
                            self.config.attn_impl,
                            mask is not None) as ring:
            if ring is None:
                return self._forward(noisy_real, noisy_imag, mask,
                                     generator)
            out = self._forward(ring.cut(noisy_real), ring.cut(noisy_imag),
                                None, generator)
            return tuple(ring.join(torch.stack(out), dim=2).unbind(0))

    def _forward(self, noisy_real, noisy_imag, mask, generator):
        x = tp.linear(self.input_proj, self.input_norm(
            torch.cat([noisy_real, noisy_imag], dim=-1)))
        remat = self.config.remat and torch.is_grad_enabled()
        for i in range(self.config.num_blocks):
            block = getattr(self, f"block_{i}")
            x = (rematerialised(block, x, mask, generator) if remat
                 else block(x, mask, generator))
        x = self.output_norm(x)
        mask_mag = sigmoid(tp.linear(self.mag_head, x))
        mask_phase = (torch.tanh(tp.linear(self.phase_head, x))
                      * in_dtype(self.phase_bound, x.dtype))
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


def default_speech_enhancer(dcfg: DCSEConfig = DEFAULT.dcse,
                            acfg: AudioConfig = DEFAULT.audio,
                            **overrides) -> SpeechEnhancer:
    """The DCSE model as the ``train`` verb builds it, as in the JAX
    package: ``dcfg`` (``DEFAULT.dcse``, 6,225,414 parameters) with the
    frequency bins of ``acfg``, fields of :class:`config.DCSEConfig`
    overridden by ``overrides``."""
    return SpeechEnhancer(dataclasses.replace(
        dcfg, **{"n_freq": acfg.n_freq, **overrides}))
