"""Audio framing and model sizes of the flagship and of DCSE.

A copy of what the port needs from ``sincformer_tpu/config.py`` (AudioConfig,
ConformerConfig.attn_impl, AgentConfig, VQConfig, the inference fields of
DCSEConfig) and of the ``SincformerMetacog`` fields that ``default_metacog``
sets. The JAX
package's ``SINCFORMER_*`` environment knobs are plain fields here with the
same defaults; nothing reads the environment.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class AudioConfig:
    """Narrowband 8 kHz framing: 20 ms frames, 50 % hop, 256-point FFT."""
    sample_rate: int = 8000
    fft_size: int = 256
    frame_size: int = 160
    hop_size: int = 80

    @property
    def n_freq(self) -> int:
        return self.fft_size // 2 + 1


@dataclass(frozen=True)
class MetacogConfig:
    """Sizes of ``SincformerMetacog`` at inference (defaults: the flagship)."""
    encoder_channels: int = 256
    sample_rate: int = 8000
    sinc_kernel_size: int = 251
    hop: int = 80
    pa_num_blocks: int = 3
    pa_env_pool: int = 8
    pa_fine_act: str = "mulaw"      # "mulaw" | "gelu"
    cpea_hidden: int = 128
    cpea_layers: int = 2
    cpea_channels: int = 64
    d_model: int = 256
    n_freq: int = 129
    msa_blocks: int = 4
    num_heads: int = 4
    d_ff: int = 1024
    kernel_size: int = 31
    attn_impl: str = "speech"       # "speech" (kernel K1) | "xla" (plain)
    vq_centroids: int = 3
    vq_commitment: float = 0.25
    memory_slots: int = 64
    episodic_slots: int = 16

    def __post_init__(self):
        if self.pa_fine_act not in ("mulaw", "gelu"):
            raise ValueError(f"pa_fine_act must be 'mulaw' or 'gelu', got "
                             f"{self.pa_fine_act!r}")
        if self.d_model % self.num_heads:
            raise ValueError(f"d_model={self.d_model} is not a multiple of "
                             f"num_heads={self.num_heads}")
        if self.hop % self.pa_env_pool:
            raise ValueError(f"hop={self.hop} is not a multiple of "
                             f"pa_env_pool={self.pa_env_pool}")


@dataclass(frozen=True)
class DCSEConfig:
    """Sizes of the DCSE ``SpeechEnhancer`` at inference (the inference
    fields of the JAX package's ``DCSEConfig`` plus the ``n_freq`` and
    ``conv_norm`` of its ``SpeechEnhancer``)."""
    d_model: int = 256
    num_blocks: int = 4
    num_heads: int = 4
    ff_dim: int = 1024
    kernel_size: int = 31
    phase_bound_div: float = 6.0    # phase within +-pi/6
    attn_impl: str = "speech"       # "speech" (kernel K1) | "xla" (plain)
    fused_ffn: bool = False         # feed-forward modules through kernel K3
    n_freq: int = 129
    conv_norm: str = "layer"

    def __post_init__(self):
        if self.d_model % self.num_heads:
            raise ValueError(f"d_model={self.d_model} is not a multiple of "
                             f"num_heads={self.num_heads}")
        if self.conv_norm == "batch":
            raise NotImplementedError(
                "conv_norm='batch' (the reference checkpoints' BatchNorm) is "
                "not ported yet: it waits for the DCSE training slice "
                "(ROADMAP.md Queue 1)")
        if self.conv_norm != "layer":
            raise ValueError(f"conv_norm must be 'layer' or 'batch', got "
                             f"{self.conv_norm!r}")
