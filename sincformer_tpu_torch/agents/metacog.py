"""SincformerMetacog (``sincformer_tpu/agents/metacog.py``).

    waveform → PerceptionAgentMXU → (z_real, z_imag, σ)   [T' = N // hop]
               (PerceptionAgent, the reference cascade, for pa_impl
               "reference": T' = floor(ceil(N / 16) / 5))
    z → CPEA (BiLSTM, or BiLRU for cpea_impl "ssm");
    (z, CPEA, noisy STFT) → MSA → polar mask
    pooled z → EpisodicMemory → magnitude bias
    σ → MAA → route over {soft, resample, VQ-hard, unity}
    routed magnitude · e^{i·phase} ⊙ STFT, last frame repeated to the STFT
    length T = N // hop + 1.

At inference (``train=False``) the MSA runs once without dropout, the
resample strategy is the soft mask and the route is one-hot. A training
forward (``train=True``, with a dropout and a routing generator) runs the
MSA with dropout, writes the episodic memory, steps the MAA statistics,
routes by Gumbel straight-through (or softmax) and runs the MSA a second
time with fresh dropout masks for the resample strategy, as the JAX model
does, also when the dropout rate is 0.

bfloat16: a model cast with ``.to(torch.bfloat16)`` and given a bf16
waveform and STFT runs the forward that the JAX package's ``bench.py``
runs with every variable cast to bf16, rounding where JAX's rounds (each
agent's module says how). The inference route is a float32 one-hot, as
``jax.nn.one_hot`` makes it, so the routed magnitude and the enhanced STFT
come out float32 there, as JAX's do.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from sincformer_tpu_torch.agents.cpea import CorrelationPhaseEstimationAgent
from sincformer_tpu_torch.agents.maa import MetacognitiveArbitrationAgent
from sincformer_tpu_torch.agents.memory import EpisodicMemory
from sincformer_tpu_torch.agents.msa import MaskSynthesisAgent
from sincformer_tpu_torch.agents.perception import (PerceptionAgent,
                                                    PerceptionAgentMXU)
from sincformer_tpu_torch.agents.ssm import LRULayer
from sincformer_tpu_torch.config import MetacogConfig
from sincformer_tpu_torch.models.vq import VectorQuantizer
from sincformer_tpu_torch.ops.flax_math import in_dtype


def variant_of(names) -> Dict[str, str]:
    """The variant fields that a model's parameter names show: the port's
    state-dict keys, or a flax tree's paths joined with dots. ``cpea.bilru``
    is the BiLRU, ``cpea.lstm`` (``cpea.LSTMCell_*`` in flax) the BiLSTM;
    ``pa.downsample`` the reference cascade, ``pa.embed`` the mxu encoder,
    whose ``pa.embed_norm`` is the dual stream and ``pa.act_mu`` the μ-law
    fine stream (the JAX package's checkpoint autodetection). A part that
    fits none is left out."""
    names = set(names)

    def has(*prefixes):
        return any(n.startswith(prefixes) for n in names)
    found = {}
    if has("cpea.bilru."):
        found["cpea_impl"] = "ssm"
    elif has("cpea.lstm.", "cpea.LSTMCell_"):
        found["cpea_impl"] = "lstm"
    if has("pa.downsample."):
        found["pa_impl"] = "reference"
    elif has("pa.embed."):
        found.update(pa_impl="mxu",
                     pa_fine_feats="dual" if has("pa.embed_norm.")
                     else "single",
                     pa_fine_act="mulaw" if "pa.act_mu" in names else "gelu")
    return found


def _polar_mag(mask_r: torch.Tensor, mask_i: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(mask_r ** 2 + mask_i ** 2
                      + in_dtype(1e-12, mask_r.dtype))


class SincformerMetacog(nn.Module):
    """(B, N) waveform + (B, T, F) noisy STFT parts → enhanced STFT parts
    and routing outputs. The caller owns the STFT and iSTFT.

    Inside ``ops.ring_mesh`` with ``attn_impl="ring"`` every rank gives the
    whole waveform and STFT and gets the whole output, JAX's function: the
    PerceptionAgent and the CPEA run whole on every rank, the MSA's blocks
    and heads on this rank's block of frames (the ring region,
    :meth:`ring_region`), and the MAA, the memory and the VQ on the whole
    joined mask (``agents/msa.py``, ``parallel/context.py``)."""

    def __init__(self, config: MetacogConfig = MetacogConfig()):
        super().__init__()
        c = config
        self.config = c
        if c.pa_impl == "reference":
            self.pa = PerceptionAgent(c.encoder_channels, c.sample_rate,
                                      c.sinc_kernel_size, c.hop)
        else:
            self.pa = PerceptionAgentMXU(c.encoder_channels, c.sample_rate,
                                         c.sinc_kernel_size, c.hop,
                                         c.pa_num_blocks, c.pa_env_pool,
                                         c.pa_fine_act, c.pa_fine_feats)
        self.cpea = CorrelationPhaseEstimationAgent(
            c.encoder_channels, c.cpea_hidden, c.cpea_layers, c.cpea_channels,
            c.cpea_impl)
        self.msa = MaskSynthesisAgent(
            c.encoder_channels, c.cpea_channels, c.d_model, c.n_freq,
            c.msa_blocks, c.num_heads, c.d_ff, c.kernel_size, c.attn_impl,
            dropout=c.dropout)
        self.memory = EpisodicMemory(c.encoder_channels, c.n_freq,
                                     c.memory_slots, c.episodic_slots)
        self.vq = VectorQuantizer(c.vq_centroids, c.vq_commitment)
        self.maa = MetacognitiveArbitrationAgent(routing=c.routing)

    def ring_region(self) -> Tuple[nn.Module, ...]:
        """The layers that run on this rank's block of frames under a ring:
        the MSA's."""
        return self.msa.ring_region()

    def forward(self, waveform: torch.Tensor, stft_real: torch.Tensor,
                stft_imag: torch.Tensor, train: bool = False,
                use_vq: bool = True, gumbel_tau=None,
                dropout_generator: Optional[torch.Generator] = None,
                routing_generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """``train=True`` needs ``dropout_generator`` and, for Gumbel
        routing, ``routing_generator``; ``gumbel_tau`` (a float or a 0-d
        tensor) overrides the Gumbel temperature."""
        if train and dropout_generator is None:
            raise ValueError("a training forward needs a dropout_generator")
        drop = dropout_generator if train else None
        z_real, z_imag, sigma = self.pa(waveform)
        # align the latent frames to the STFT grid (T' ≤ T = N//hop + 1)
        t = min(z_real.shape[-1], stft_real.shape[-2])
        z_real, z_imag, sigma = z_real[..., :t], z_imag[..., :t], sigma[..., :t]
        sr, si = stft_real[:, :t], stft_imag[:, :t]

        cpea = self.cpea(z_real)
        mask_r, mask_i = self.msa(z_real, z_imag, cpea, sr, si, drop)
        mask_mag = _polar_mag(mask_r, mask_i)
        mask_phase = torch.atan2(mask_i, mask_r)

        # in training the episodic bank first takes the batch's mean mask
        write = (mask_mag.mean(dim=1)
                 if train and self.config.episodic_slots > 0 else None)
        mem = self.memory(z_real.mean(dim=-1), train=train,
                          write_value=write)
        bias = mem["bias"][:, None, :]
        mask_mag = torch.clamp(mask_mag + bias, 0.0, 1.0)

        if train:   # resample: a second MSA pass with its own dropout masks
            mask_r2, mask_i2 = self.msa(z_real, z_imag, cpea, sr, si, drop)
            mag2 = torch.clamp(_polar_mag(mask_r2, mask_i2) + bias, 0.0, 1.0)
            resample = 0.5 * (mask_mag + mag2)
        else:
            resample = mask_mag
        hard, _, vq_loss = self.vq(mask_mag)
        if not use_vq:
            hard = mask_mag
            vq_loss = 0.0 * vq_loss
        routing = self.maa(sigma, train=train, tau=gumbel_tau,
                           generator=routing_generator)
        strategies = torch.stack(
            [mask_mag, resample, hard, torch.ones_like(mask_mag)], dim=-1)
        # at inference the route is one-hot: an elementwise product keeps
        # the pick exact
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
                "memory_gate": mem["gate"], "memory_top": mem["top_indices"],
                "cpea": cpea}

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "SincformerMetacog":
        """Random weights drawn from ``generator`` only, after the flax
        initialisers' scales: N(0, 1/fan_in) matrices and kernels, the
        CPEA's recurrent kernels orthogonal per gate block (flax
        ``orthogonal()``), the BiLRU's recurrences by
        ``ssm.LRULayer.init_params``, zero biases, unit norm scales,
        N(0, 0.01²) memory banks, a 0.01-scaled memory value projection;
        SincConv cutoffs, VQ centroids, the MAA threshold and the companding
        parameters keep their constants, and every buffer returns to its
        initial value."""
        fresh = SincformerMetacog(self.config)
        norms = (nn.LayerNorm, nn.GroupNorm)
        norm_params = {f"{m}.{p}" for m, mod in self.named_modules()
                       if isinstance(mod, norms) for p in ("weight", "bias")}
        lru = {f"{m}.{p}": mod for m, mod in self.named_modules()
               if isinstance(mod, LRULayer) for p, _ in
               mod.named_parameters()}
        for name, p in self.named_parameters():
            def randn(std):
                return torch.randn(p.shape, generator=generator) * std
            if name in lru:
                if name.endswith(".nu_log"):    # once per layer, in order
                    lru[name].init_params(generator)
            elif name in norm_params:
                p.copy_(torch.ones_like(p) if name.endswith("weight")
                        else torch.zeros_like(p))
            elif name in ("memory.keys", "memory.values"):
                p.copy_(randn(0.01))
            elif name.split(".")[-1].startswith("bias"):
                p.zero_()
            elif ".kernel_hh" in name:
                h = p.shape[1]
                p.copy_(torch.cat([orthogonal(h, generator)
                                   for _ in range(p.shape[0] // h)]))
            elif p.ndim >= 2:
                fan_in = p[0].numel()
                scale = 0.01 if name == "memory.value_proj.weight" else 1.0
                p.copy_(randn(scale / fan_in ** 0.5))
            else:   # cutoffs, companding, centroids, threshold
                p.copy_(fresh.get_parameter(name))
        for name, buf in self.named_buffers():
            buf.copy_(fresh.get_buffer(name))
        return self


def orthogonal(n: int, generator: torch.Generator) -> torch.Tensor:
    """A random (n, n) orthogonal matrix as flax's ``orthogonal()`` draws
    one: Q of the QR decomposition of a standard normal matrix, its columns
    signed by the diagonal of R."""
    a = torch.randn(n, n, generator=generator, dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    return (q * torch.sign(torch.diagonal(r))[None, :]).to(torch.float32)
