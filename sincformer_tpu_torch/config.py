"""Audio framing, the auditory front-end's and the feature extractor's
constants, the training data and loss settings, the curriculum, model sizes
and training settings of the flagship, of DCSE, of the ComplexConformer and
of the mask DNN, RBM pretraining, the particle swarm, the OPT-PCIRM
quantizer and the VQ quantizer.

The configuration tree of ``sincformer_tpu/config.py``, field for field and
default for default: every dataclass there (AudioConfig, GammatoneConfig,
FeatureConfig, DataConfig, DNNConfig, RBMConfig, PSOConfig, OptPCIRMConfig,
ConformerConfig, DCSEConfig, VQConfig, AgentConfig, LossConfig,
CurriculumConfig, EvalConfig), the root :class:`Config`, :data:`DEFAULT`
and :func:`replace`; plus the port's own :class:`MetacogConfig` (the
``SincformerMetacog`` fields, whose sizes default to those of the sections
that ``default_metacog`` reads) and the
``n_freq``, ``conv_norm`` and ``remat`` of :class:`DCSEConfig`. The data,
loss and PerceptionAgent-variant fields read the same ``SINCFORMER_*``
environment knobs as the JAX package (``SINCFORMER_MAX_WAVE_SECONDS``,
``SINCFORMER_MASK_MSE_WEIGHT``, ``SINCFORMER_PA_FINE_ACT``,
``SINCFORMER_PA_FINE_FEATS``, the dataset, output and model directories)
when an instance is made; :data:`DEFAULT`'s are read at import, as the JAX
package's.

``LossConfig.perceptual_weight`` is the JAX package's 10.0, which neither
package's flagship trainer reads: both take their own ``perceptual_weight``
argument, 1.0 unless given (``train/agent_trainer.py``).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Tuple

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def replace(cfg, **kw):
    """``dataclasses.replace``: a copy of ``cfg`` with the fields in ``kw``
    changed."""
    return dataclasses.replace(cfg, **kw)


@dataclass(frozen=True)
class AudioConfig:
    """Narrowband 8 kHz framing: 20 ms frames, 50 % hop, 256-point FFT."""
    sample_rate: int = 8000
    frame_size_ms: int = 20
    fft_size: int = 256
    window: str = "hamming"

    @property
    def frame_size(self) -> int:    # 160 samples
        return int(self.sample_rate * self.frame_size_ms / 1000)

    @property
    def hop_size(self) -> int:      # 80 samples: 50 % overlap
        return self.frame_size // 2

    @property
    def n_freq(self) -> int:
        return self.fft_size // 2 + 1


@dataclass(frozen=True)
class GammatoneConfig:
    """64-channel gammatone filterbank, 50-4000 Hz."""
    num_channels: int = 64
    freq_low: float = 50.0
    freq_high: float = 4000.0
    filter_order: int = 4
    ir_duration: float = 0.05       # seconds of impulse response


@dataclass(frozen=True)
class FeatureConfig:
    """AMS / RASTA-PLP / MFCC / GFCC sizes of the DNN's input features."""
    ams_segments: int = 128
    ams_overlap: int = 64
    ams_fft_size: int = 256
    ams_num_bands: int = 15
    ams_decimate: int = 8
    ams_low_hz: float = 15.6
    ams_high_hz: float = 400.0

    mfcc_num_coeff: int = 13
    mfcc_fft_size: int = 512
    mfcc_num_filters: int = 64

    gfcc_num_coeff: int = 13
    gfcc_decimate_rate: int = 100   # Hz: a 10 ms frame shift

    rasta_num_coeff: int = 13
    rasta_num_bands: int = 21       # bark critical bands

    context_frames: int = 5         # +-5 frames of context: 11 x the frame

    @property
    def raw_dim(self) -> int:       # 15 + 13 + 13 + 13 = 54
        return (self.ams_num_bands + self.rasta_num_coeff
                + self.mfcc_num_coeff + self.gfcc_num_coeff)

    @property
    def dim(self) -> int:           # 54 * 11 = 594
        return self.raw_dim * (2 * self.context_frames + 1)


@dataclass(frozen=True)
class DataConfig:
    """Noise grid, split and utterance length of the training data."""
    noise_types: Tuple[str, ...] = ("babble", "white", "factory1",
                                    "destroyerengine")
    snr_levels: Tuple[int, ...] = (-5, 0, 5, 10)
    max_train_utterances: int = 19200
    max_test_utterances: int = 1920
    train_split_seed: int = 42
    eval_sample_seed: int = 99          # utterances drawn for evaluation
    train_fraction: float = 0.9
    # pad / crop length of an utterance in training batches
    max_wave_seconds: float = field(default_factory=lambda: float(
        os.environ.get("SINCFORMER_MAX_WAVE_SECONDS", "4.0")))
    timit_dir: str = field(default_factory=lambda: os.environ.get(
        "SINCFORMER_TIMIT_DIR", os.path.join(_REPO, "DARPA-TIMIT", "data")))
    noisex_dir: str = field(default_factory=lambda: os.environ.get(
        "SINCFORMER_NOISEX_DIR", os.path.join(_REPO, "Noises", "NoiseX-92")))
    output_dir: str = field(default_factory=lambda: os.environ.get(
        "SINCFORMER_OUTPUT_DIR", "output"))
    model_dir: str = field(default_factory=lambda: os.environ.get(
        "SINCFORMER_MODEL_DIR", "saved_models"))
    # the mask DNN's per-utterance feature and mask cache
    cache_dir: str = field(default_factory=lambda: os.environ.get(
        "SINCFORMER_CACHE_DIR", "feature_cache"))


@dataclass(frozen=True)
class LossConfig:
    """Loss weights of flagship training. ``perceptual_weight`` is the
    reference's weight of the STOI term; the trainer does not read it (its
    own ``perceptual_weight`` argument, 1.0 unless given, as in the JAX
    package: the reference's 10.0 destabilised training)."""
    perceptual_weight: float = 10.0
    commitment_weight: float = 0.25     # weight of the VQ loss
    adversarial_weight: float = 0.5     # weight of the stage-3 GAN term
    # stage-1/2 mask-domain MSE against the oracle PCIRM
    mask_mse_weight: float = field(default_factory=lambda: float(
        os.environ.get("SINCFORMER_MASK_MSE_WEIGHT", "1.0")))


@dataclass(frozen=True)
class CurriculumConfig:
    """Epochs of the three curriculum stages."""
    stage1_epochs: int = 15
    stage2_epochs: int = 20
    stage3_epochs: int = 15


@dataclass(frozen=True)
class EvalConfig:
    """Metric settings. ``pesq_impl``: "auto" takes the ITU C library when
    it is installed, else the native P.862 (``evaluation/p862.py``);
    "clib" the C library only (raises without it); "native" always the
    native P.862; "proxy" the log-spectral-distortion proxy on the
    device."""
    stoi_extended: bool = False
    pesq_mode: str = "nb"
    pesq_impl: str = "auto"


@dataclass(frozen=True)
class DNNConfig:
    """The original paper's mask DNN, 594 -> 3 x 1024 -> 64, and its Adam
    training (the rate before any plateau reduction)."""
    hidden_layers: int = 3
    hidden_units: int = 1024
    dropout: float = 0.2
    learning_rate: float = 1e-3
    epochs: int = 50
    batch_size: int = 256
    output_dim: int = 64            # one mask value per gammatone channel


@dataclass(frozen=True)
class RBMConfig:
    """CD-k pretraining of the DNN's hidden layers."""
    learning_rate: float = 0.01
    epochs: int = 10
    batch_size: int = 256
    k_steps: int = 1
    max_samples: int = 50000        # frames taken for pretraining


@dataclass(frozen=True)
class PSOConfig:
    """The particle swarm of the OPT-PCIRM middle-step search."""
    num_particles: int = 30
    max_iter: int = 100
    w: float = 0.7
    c1: float = 1.5
    c2: float = 1.5
    bounds: Tuple[float, float] = (0.0, 1.0)


@dataclass(frozen=True)
class OptPCIRMConfig:
    """Hard-mask quantization: M steps from the local criterion in dB."""
    num_steps: int = 3
    local_criterion_db: float = -15.0


@dataclass(frozen=True)
class ConformerConfig:
    """Sizes of the ComplexConformer mask estimator (a library model: no
    verb trains or serves it)."""
    num_blocks: int = 6
    d_model: int = 256
    num_heads: int = 4
    ff_dim: int = 1024
    kernel_size: int = 31
    dropout: float = 0.1
    attn_impl: str = "speech"       # "speech" (kernel K1) | "xla" (plain)


# the flagship's variant fields and their values (the first: the default)
VARIANTS = {"pa_impl": ("mxu", "reference"),
            "pa_fine_act": ("mulaw", "gelu"),
            "pa_fine_feats": ("single", "dual"),
            "cpea_impl": ("lstm", "ssm")}


@dataclass(frozen=True)
class VQConfig:
    """The VQ quantizer: M centroids and the commitment weight."""
    num_centroids: int = 3
    commitment_weight: float = 0.25


@dataclass(frozen=True)
class AgentConfig:
    """Sizes and variant of the agent stack (the JAX package's
    ``AgentConfig``), which ``train.agent_trainer.default_metacog`` builds
    the flagship from; the mxu encoder's fine-stream activation and feature
    streams are read from ``SINCFORMER_PA_FINE_ACT`` and
    ``SINCFORMER_PA_FINE_FEATS`` when an instance is made."""
    cpea_hidden_size: int = 128
    cpea_num_layers: int = 2
    pa_encoder_channels: int = 256
    maa_threshold_init: float = 0.5
    sinc_kernel_size: int = 251
    memory_slots: int = 64
    msa_phase_bound_div: float = 8.0    # phase within +-pi/8
    pa_impl: str = "mxu"                # "mxu" | "reference"
    pa_fine_act: str = field(default_factory=lambda: os.environ.get(
        "SINCFORMER_PA_FINE_ACT", "mulaw"))
    pa_fine_feats: str = field(default_factory=lambda: os.environ.get(
        "SINCFORMER_PA_FINE_FEATS", "single"))


@dataclass(frozen=True)
class MetacogConfig:
    """Sizes and training settings of ``SincformerMetacog`` (defaults: the
    flagship). ``dropout`` and ``routing`` act in training only:
    ``routing="gumbel"`` routes by Gumbel-softmax straight-through,
    ``"softmax"`` by the softmax probabilities. ``pa_impl``,
    ``pa_fine_act``, ``pa_fine_feats`` and ``cpea_impl`` select the
    variant (:data:`VARIANTS`); ``pa_num_blocks``, ``pa_env_pool``,
    ``pa_fine_act`` and ``pa_fine_feats`` shape the mxu encoder only. The
    fields that ``default_metacog`` takes from the audio, agent, VQ and
    Conformer sections default to those sections' defaults."""
    encoder_channels: int = AgentConfig.pa_encoder_channels
    sample_rate: int = AudioConfig.sample_rate
    sinc_kernel_size: int = AgentConfig.sinc_kernel_size
    hop: int = AudioConfig().hop_size
    pa_num_blocks: int = 3
    pa_env_pool: int = 8
    pa_fine_act: str = "mulaw"      # "mulaw" | "gelu"
    pa_impl: str = AgentConfig.pa_impl  # "mxu" (frame-rate encoder) |
                                    # "reference" (stride-2 conv cascade)
    pa_fine_feats: str = "single"   # "single" | "dual" (+ a per-frame
                                    # normalised fine stream; mxu only)
    cpea_impl: str = "lstm"         # "lstm" (BiLSTM) | "ssm" (BiLRU)
    cpea_hidden: int = AgentConfig.cpea_hidden_size
    cpea_layers: int = AgentConfig.cpea_num_layers
    cpea_channels: int = 64
    d_model: int = 256
    n_freq: int = AudioConfig().n_freq
    msa_blocks: int = 4
    num_heads: int = 4
    d_ff: int = 1024
    kernel_size: int = 31
    attn_impl: str = ConformerConfig.attn_impl  # "speech" (kernel K1) |
                                                # "xla" (plain)
    vq_centroids: int = VQConfig.num_centroids
    vq_commitment: float = VQConfig.commitment_weight
    memory_slots: int = AgentConfig.memory_slots
    episodic_slots: int = 16
    dropout: float = 0.1
    routing: str = "gumbel"         # "gumbel" | "softmax"

    def __post_init__(self):
        if self.routing not in ("gumbel", "softmax"):
            raise ValueError(f"routing must be 'gumbel' or 'softmax', got "
                             f"{self.routing!r}")
        for name, allowed in VARIANTS.items():
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, got "
                                 f"{getattr(self, name)!r}")
        if self.d_model % self.num_heads:
            raise ValueError(f"d_model={self.d_model} is not a multiple of "
                             f"num_heads={self.num_heads}")
        if self.hop % self.pa_env_pool:
            raise ValueError(f"hop={self.hop} is not a multiple of "
                             f"pa_env_pool={self.pa_env_pool}")


@dataclass(frozen=True)
class DCSEConfig:
    """The DCSE ``SpeechEnhancer``: the JAX package's ``DCSEConfig`` (sizes
    and the AdamW recipe of its training) plus the ``n_freq``, ``conv_norm``
    and ``remat`` of its ``SpeechEnhancer``. ``conv_norm``: "layer" (the
    default), "batch" (the reference checkpoints' BatchNorm, statistics in
    buffers) or "group" (GroupNorm of min(32, d_model) groups). ``dropout``
    acts in training only. ``remat`` recomputes each Conformer block in the
    backward instead of keeping its activations (``models/dcse.py``)."""
    d_model: int = 256
    num_blocks: int = 4
    num_heads: int = 4
    ff_dim: int = 1024
    kernel_size: int = 31
    dropout: float = 0.15
    phase_bound_div: float = 6.0    # phase within +-pi/6
    attn_impl: str = "speech"       # "speech" (kernel K1) | "xla" (plain)
    fused_ffn: bool = False         # feed-forward modules through kernel K3
    lr: float = 5e-4                # peak of the warmup-cosine schedule
    betas: Tuple[float, float] = (0.9, 0.98)
    weight_decay: float = 0.01
    grad_clip: float = 5.0
    batch_size: int = 8
    epochs: int = 50
    mag_loss_weight: float = 0.5
    n_freq: int = 129
    conv_norm: str = "layer"
    remat: bool = False

    def __post_init__(self):
        if self.d_model % self.num_heads:
            raise ValueError(f"d_model={self.d_model} is not a multiple of "
                             f"num_heads={self.num_heads}")
        if self.conv_norm not in ("layer", "batch", "group"):
            raise ValueError(f"conv_norm must be 'layer', 'batch' or "
                             f"'group', got {self.conv_norm!r}")


@dataclass(frozen=True)
class Config:
    """The root of the tree, one instance of each section."""
    audio: AudioConfig = field(default_factory=AudioConfig)
    gammatone: GammatoneConfig = field(default_factory=GammatoneConfig)
    features: FeatureConfig = field(default_factory=FeatureConfig)
    data: DataConfig = field(default_factory=DataConfig)
    dnn: DNNConfig = field(default_factory=DNNConfig)
    rbm: RBMConfig = field(default_factory=RBMConfig)
    pso: PSOConfig = field(default_factory=PSOConfig)
    opt_pcirm: OptPCIRMConfig = field(default_factory=OptPCIRMConfig)
    conformer: ConformerConfig = field(default_factory=ConformerConfig)
    dcse: DCSEConfig = field(default_factory=DCSEConfig)
    vq: VQConfig = field(default_factory=VQConfig)
    agents: AgentConfig = field(default_factory=AgentConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    curriculum: CurriculumConfig = field(default_factory=CurriculumConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)


# made at import, as the JAX package's DEFAULT
DEFAULT = Config()
