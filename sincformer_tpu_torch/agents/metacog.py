"""SincformerMetacog at inference (``sincformer_tpu/agents/metacog.py``,
``train=False`` with no dropout rng).

    waveform → PerceptionAgentMXU → (z_real, z_imag, σ)   [T' = N // hop]
    z → CPEA;  (z, CPEA, noisy STFT) → MSA → polar mask
    pooled z → EpisodicMemory → magnitude bias
    σ → MAA → one-hot route over {soft, resample (= soft), VQ-hard, unity}
    routed magnitude · e^{i·phase} ⊙ STFT, last frame repeated to the STFT
    length T = N // hop + 1.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from sincformer_tpu_torch.agents.cpea import CorrelationPhaseEstimationAgent
from sincformer_tpu_torch.agents.maa import MetacognitiveArbitrationAgent
from sincformer_tpu_torch.agents.memory import EpisodicMemory
from sincformer_tpu_torch.agents.msa import MaskSynthesisAgent
from sincformer_tpu_torch.agents.perception import PerceptionAgentMXU
from sincformer_tpu_torch.config import MetacogConfig
from sincformer_tpu_torch.models.vq import VectorQuantizer


class SincformerMetacog(nn.Module):
    """(B, N) waveform + (B, T, F) noisy STFT parts → enhanced STFT parts
    and routing outputs. The caller owns the STFT and iSTFT."""

    def __init__(self, config: MetacogConfig = MetacogConfig()):
        super().__init__()
        c = config
        self.config = c
        self.pa = PerceptionAgentMXU(c.encoder_channels, c.sample_rate,
                                     c.sinc_kernel_size, c.hop,
                                     c.pa_num_blocks, c.pa_env_pool,
                                     c.pa_fine_act)
        self.cpea = CorrelationPhaseEstimationAgent(
            c.encoder_channels, c.cpea_hidden, c.cpea_layers, c.cpea_channels)
        self.msa = MaskSynthesisAgent(
            c.encoder_channels, c.cpea_channels, c.d_model, c.n_freq,
            c.msa_blocks, c.num_heads, c.d_ff, c.kernel_size, c.attn_impl)
        self.memory = EpisodicMemory(c.encoder_channels, c.n_freq,
                                     c.memory_slots, c.episodic_slots)
        self.vq = VectorQuantizer(c.vq_centroids, c.vq_commitment)
        self.maa = MetacognitiveArbitrationAgent()

    def forward(self, waveform: torch.Tensor, stft_real: torch.Tensor,
                stft_imag: torch.Tensor) -> Dict[str, torch.Tensor]:
        z_real, z_imag, sigma = self.pa(waveform)
        # align the latent frames to the STFT grid (T' = N//hop ≤ T)
        t = min(z_real.shape[-1], stft_real.shape[-2])
        z_real, z_imag, sigma = z_real[..., :t], z_imag[..., :t], sigma[..., :t]
        sr, si = stft_real[:, :t], stft_imag[:, :t]

        cpea = self.cpea(z_real)
        mask_r, mask_i = self.msa(z_real, z_imag, cpea, sr, si)
        mask_mag = torch.sqrt(mask_r ** 2 + mask_i ** 2 + 1e-12)
        mask_phase = torch.atan2(mask_i, mask_r)

        mem = self.memory(z_real.mean(dim=-1))
        mask_mag = torch.clamp(mask_mag + mem["bias"][:, None, :], 0.0, 1.0)

        hard, _, vq_loss = self.vq(mask_mag)
        routing = self.maa(sigma)
        # soft, resample (= soft without a dropout pass), hard, pass-through
        strategies = torch.stack(
            [mask_mag, mask_mag, hard, torch.ones_like(mask_mag)], dim=-1)
        # the route is one-hot: an elementwise product keeps the pick exact
        final_mag = (strategies * routing["route"][:, :, None, :]).sum(-1)

        final_r = final_mag * torch.cos(mask_phase)
        final_i = final_mag * torch.sin(mask_phase)
        enh_r = final_r * sr - final_i * si
        enh_i = final_r * si + final_i * sr
        pad = stft_real.shape[-2] - t
        if pad > 0:   # repeat the edge frame back to the full STFT length
            enh_r = torch.cat([enh_r, enh_r[:, -1:].expand(-1, pad, -1)], 1)
            enh_i = torch.cat([enh_i, enh_i[:, -1:].expand(-1, pad, -1)], 1)

        return {"enhanced_real": enh_r, "enhanced_imag": enh_i,
                "mask_mag": final_mag, "mask_phase": mask_phase,
                "vq_loss": vq_loss, "sigma": sigma,
                "decisions": routing["decisions"],
                "route_logits": routing["logits"],
                "route_probs": routing["probs"],
                "confidence": routing["confidence"],
                "memory_gate": mem["gate"], "memory_top": mem["top_indices"]}

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "SincformerMetacog":
        """Random weights drawn from ``generator`` only, after the flax
        initialisers' scales: N(0, 1/fan_in) matrices and kernels, zero
        biases, unit norm scales, N(0, 0.01²) memory banks, a 0.01-scaled
        memory value projection; SincConv cutoffs, VQ centroids, the MAA
        threshold and the companding parameters keep their constants, and
        every buffer returns to its initial value."""
        fresh = SincformerMetacog(self.config)
        norms = (nn.LayerNorm, nn.GroupNorm)
        norm_params = {f"{m}.{p}" for m, mod in self.named_modules()
                       if isinstance(mod, norms) for p in ("weight", "bias")}
        for name, p in self.named_parameters():
            def randn(std):
                return torch.randn(p.shape, generator=generator) * std
            if name in norm_params:
                p.copy_(torch.ones_like(p) if name.endswith("weight")
                        else torch.zeros_like(p))
            elif name in ("memory.keys", "memory.values"):
                p.copy_(randn(0.01))
            elif name.split(".")[-1].startswith("bias"):
                p.zero_()
            elif p.ndim >= 2:
                fan_in = p[0].numel()
                scale = 0.01 if name == "memory.value_proj.weight" else 1.0
                p.copy_(randn(scale / fan_in ** 0.5))
            else:   # cutoffs, companding, centroids, threshold
                p.copy_(fresh.get_parameter(name))
        for name, buf in self.named_buffers():
            buf.copy_(fresh.get_buffer(name))
        return self
