"""Enhancement entry points: :class:`SincformerPipeline` (the inference half
of ``sincformer_tpu/train/agent_trainer.py``), :class:`DCSEPipeline` (of
``sincformer_tpu/train/dcse_trainer.py``) and :class:`DNNPipeline` (of
``sincformer_tpu/train/dnn_trainer.py``, the original paper's pipeline).

    wave (int16 or float) → pcm_to_float → centred STFT → model → complex
    mask × STFT → iSTFT → × output_gain                  (the first two)

    wave → AMS/RASTA-PLP/MFCC/GFCC features ± 5 frames → z-score → DNN →
    64-channel mask → 129 STFT bins → masked uncentred iSTFT      (the DNN)

A pipeline runs on the card (``device="cuda"``, the default) unless the
caller asks for ``device="cpu"``; without CUDA the default raises instead of
running anywhere else. ``output_gain`` is read at every call, so a changed
gain takes effect at once; ``calibrate_gain`` fits it on held-out mixtures
and persists it in the loaded checkpoint's sidecar. ``save_model`` /
``load_model`` write and read the serving checkpoints of
``train/state.py``. Training is a subclass of each that also saves and
restores the optimizer state: ``train/agent_trainer.SincformerTrainer``,
``train/dcse_trainer.DCSETrainer`` and ``train/dnn_trainer.DNNTrainer``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from sincformer_tpu_torch.agents.metacog import SincformerMetacog, variant_of
from sincformer_tpu_torch.config import (AudioConfig, DataConfig, DCSEConfig,
                                         DNNConfig, GammatoneConfig,
                                         MetacogConfig)
from sincformer_tpu_torch.data.loader import (WaveformDataset, batch_iterator,
                                              heldout_noises, remix_for_stage)
from sincformer_tpu_torch.dsp.features import FeatureExtractor
from sincformer_tpu_torch.dsp.gammatone import GammatoneFilterbank, erb_space
from sincformer_tpu_torch.dsp.stft import (istft, real_edge_bins, stft,
                                           stft_uncentered)
from sincformer_tpu_torch.models.dcse import SpeechEnhancer
from sincformer_tpu_torch.models.dnn import SpeechEnhancementDNN, create_dnn
from sincformer_tpu_torch.train.state import (inference_ckpt_order,
                                              latest_step_dir,
                                              merge_train_meta,
                                              read_step_meta,
                                              resolve_output_gain,
                                              restore_checkpoint,
                                              save_checkpoint,
                                              save_checkpoint_quantized)
from sincformer_tpu_torch.utils.device import resolve_device
from sincformer_tpu_torch.utils.signal import (hann_window, overlap_add,
                                               pcm_to_float)


def with_training_state(pipe, state: dict, quantize: bool) -> dict:
    """``state``, and once a trainer has made an optimizer state, in a
    float32 checkpoint also that state and the NaN count."""
    if not quantize and getattr(pipe, "opt_state", None) is not None:
        state.update(opt_state=pipe.opt_state, nan_count=pipe.nan_count)
    return state


def model_buffers(model: torch.nn.Module) -> dict:
    """The buffers a checkpoint keeps: those of ``state_dict()``, the
    persistent ones (read off the modules, without building the state
    dict, which would compose weights from split parameters)."""
    return {f"{m}.{k}" if m else k: b
            for m, mod in model.named_modules()
            for k, b in mod._buffers.items()
            if b is not None and k not in mod._non_persistent_buffers_set}


class _EnhancementPipeline:
    """What both pipelines share: the device, the waveform entry points and
    the checkpoint I/O. A subclass names its model and config classes and
    its checkpoint families, and maps an STFT to the enhanced STFT."""

    MODEL = None
    CONFIG = None
    FINAL_NAME = ""
    BEST_NAME = ""

    def __init__(self, model=None, device="cuda", output_gain: float = 1.0,
                 audio: AudioConfig = AudioConfig(),
                 model_dir: Optional[str] = None):
        self.device = resolve_device(device)
        self.audio = audio
        self.model = (model or self.MODEL()).to(self.device).eval()
        self.output_gain = float(output_gain)
        self.model_dir = model_dir or os.environ.get("SINCFORMER_MODEL_DIR",
                                                     "saved_models")
        self.step = 0
        self._loaded_ckpt_path: Optional[str] = None

    def _enhanced_spec(self, wav: torch.Tensor,
                       spec: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @staticmethod
    def _variant(params: Mapping[str, torch.Tensor]) -> dict:
        """The config fields that a checkpoint's parameter names fix."""
        return {}

    def load_state(self, state_dict: Mapping[str, torch.Tensor],
                   buffers: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> None:
        """Load parameters and buffers (e.g. from compat.from_jax); every
        key of the model must be given and no other."""
        self.model.load_state_dict({**state_dict, **(buffers or {})},
                                   strict=True)

    # ── inference ───────────────────────────────────────────────────────

    @torch.inference_mode()
    def enhance_tensor(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, N) int16 or float tensor on ``self.device`` → (B, N) float."""
        a = self.audio
        wav = pcm_to_float(wav)
        spec = stft(wav, a.fft_size, a.hop_size, a.frame_size)
        enh = istft(self._enhanced_spec(wav, spec), a.fft_size, a.hop_size,
                    a.frame_size, length=wav.shape[-1])
        return enh * self.output_gain if self.output_gain != 1.0 else enh

    def enhance_signal(self, noisy_signal: np.ndarray,
                       pad_quantum: int = 4000) -> np.ndarray:
        """One signal (N,) → (N,) float32; zero-padded to a multiple of
        ``pad_quantum`` samples for the forward pass. int16 input is scaled
        by 1/32768 on the host."""
        noisy_signal = np.asarray(noisy_signal)
        if noisy_signal.dtype == np.int16:
            noisy_signal = noisy_signal.astype(np.float32) / 32768.0
        n = len(noisy_signal)
        wav = np.zeros((1, int(np.ceil(n / pad_quantum) * pad_quantum)),
                       np.float32)
        wav[0, :n] = noisy_signal
        out = self.enhance_tensor(torch.from_numpy(wav).to(self.device))
        return out[0, :n].cpu().numpy()

    def enhance_batch(self, noisy: np.ndarray) -> np.ndarray:
        """(B, N) → (B, N) float32. int16 PCM is sent to the device as is
        and converted there."""
        noisy = np.asarray(noisy)
        if noisy.dtype != np.int16:
            noisy = noisy.astype(np.float32)
        out = self.enhance_tensor(torch.from_numpy(noisy).to(self.device))
        return out.cpu().numpy()

    # ── model I/O ───────────────────────────────────────────────────────

    def save_model(self, name: Optional[str] = None,
                   quantize: bool = False) -> str:
        """Write the model under ``<model_dir>/<name>/step_<step>`` and the
        output gain into the family's sidecar. ``quantize=True`` writes the
        int8 serving form (the parameters go through ``quantize_tree`` on
        this pipeline's device)."""
        name = name or self.FINAL_NAME
        save = save_checkpoint_quantized if quantize else save_checkpoint
        path = save(os.path.join(self.model_dir, name),
                    self._checkpoint_state(quantize), self.step,
                    extra={"config": dataclasses.asdict(self.model.config)})
        merge_train_meta(self.model_dir, name,
                         {"output_gain": float(self.output_gain)})
        return path

    def _checkpoint_state(self, quantize: bool) -> dict:
        """What a checkpoint holds: the parameters and the buffers, and a
        trainer's optimizer state (:func:`with_training_state`)."""
        return with_training_state(
            self, {"params": dict(self.model.named_parameters()),
                   "model_state": model_buffers(self.model)}, quantize)

    def load_model(self, path: Optional[str] = None) -> str:
        """Restore a checkpoint (``path`` = a ``.../family/step_N``
        directory; default: the newest step of the preferred family under
        ``model_dir``). The model is rebuilt at the sizes the checkpoint's
        sidecar records and as the variant its weights show
        (:meth:`_variant`; a sidecar that names another raises); the output
        gain comes from the family's sidecar."""
        if path is None:
            for name in inference_ckpt_order(self.FINAL_NAME, self.BEST_NAME):
                path = latest_step_dir(os.path.join(self.model_dir, name))
                if path:
                    break
        if path is None:
            raise FileNotFoundError(
                f"no {self.FINAL_NAME} or {self.BEST_NAME} checkpoint under "
                f"{self.model_dir}")
        restored = restore_checkpoint(path)
        config = read_step_meta(path).get("config")
        if config is not None:          # JSON keeps a tuple as a list
            config = {k: tuple(v) if isinstance(v, list) else v
                      for k, v in config.items()}
        shown = self._variant(restored["params"])
        wrong = {k: (config[k], v) for k, v in shown.items()
                 if config is not None and k in config and config[k] != v}
        if wrong:
            raise ValueError(
                f"{path}: the sidecar's config and the weights name other "
                f"variants, (sidecar, weights): {wrong}")
        config = {**(config or {}), **shown} or None
        current = dataclasses.asdict(self.model.config)
        # fields the checkpoint does not record (e.g. the training-only
        # dropout and routing of an older serving checkpoint) keep the
        # pipeline's values
        if config is not None and {**current, **config} != current:
            self.model = self.MODEL(self.CONFIG(**{**current, **config})).to(
                self.device).eval()
        self.load_state(restored["params"], restored["model_state"])
        self.step = restored["step"]
        self.output_gain = resolve_output_gain(path)
        self._loaded_ckpt_path = path
        return path

    # ── output-gain calibration ─────────────────────────────────────────

    def _calibrate(self, ds: WaveformDataset, batch_size: int,
                   persist: bool) -> float:
        """Fit the output gain on the (noisy, clean) pairs of ``ds``: the
        residual log-gain α = ⟨clean, enh⟩ / ‖enh‖² of each utterance over
        its true samples is measured through the current gain, so the new
        gain is the current one times exp(mean log α) over the utterances
        with a finite α in (1e-3, 1e3). ``persist`` writes it into the
        loaded checkpoint's family sidecar, where every later load reads
        it."""
        logs = []
        for batch in batch_iterator(ds, batch_size, shuffle=False,
                                    drop_last=False):
            enh = self.enhance_batch(batch["noisy"].astype(np.float32))
            for i, n in enumerate(batch["lengths"]):
                e, c = enh[i, :n], batch["clean"][i, :n]
                alpha = float(np.dot(c, e) / (np.dot(e, e) + 1e-12))
                if np.isfinite(alpha) and 1e-3 < alpha < 1e3:
                    logs.append(np.log(alpha))
        if not logs:
            return float(self.output_gain)
        self.output_gain = float(self.output_gain * np.exp(np.mean(logs)))
        if persist and self._loaded_ckpt_path is not None:
            fam = os.path.dirname(os.path.abspath(self._loaded_ckpt_path))
            merge_train_meta(os.path.dirname(fam), os.path.basename(fam),
                             {"output_gain": float(self.output_gain)})
        return float(self.output_gain)


class SincformerPipeline(_EnhancementPipeline):
    """Sincformer-metacog enhancement of (B, N) or (N,) waveforms."""

    MODEL = SincformerMetacog
    CONFIG = MetacogConfig
    FINAL_NAME = "sincformer_final"
    BEST_NAME = "best_sincformer"

    def _enhanced_spec(self, wav, spec):
        out = self.model(wav, spec.real, spec.imag)
        return torch.complex(out["enhanced_real"], out["enhanced_imag"])

    @staticmethod
    def _variant(params):
        """The flagship's variant from its keys (``cpea.bilru.*``,
        ``pa.downsample.*``, ``pa.embed_norm.*``, ``pa.act_mu``), as the
        JAX package matches its model to a checkpoint's tree."""
        return variant_of(params)

    def calibrate_gain(self, clean_signals: Sequence[np.ndarray],
                       noises: Dict[str, np.ndarray], batch_size: int = 8,
                       max_len: Optional[int] = None,
                       persist: bool = True) -> float:
        """Post-hoc output-gain calibration of a loaded checkpoint: mix
        ``clean_signals`` (cut to ``max_len``, default 2 s) with held-out
        crops of ``noises`` (``data.loader.heldout_noises``) at every SNR of
        the grid, fit the gain (:meth:`_calibrate`), apply it and, with
        ``persist``, write it into the loaded checkpoint's sidecar. Returns
        the new gain."""
        max_len = max_len or 2 * self.audio.sample_rate
        ds = remix_for_stage(clean_signals, heldout_noises(noises),
                             list(DataConfig().snr_levels), max_len, 0)
        return self._calibrate(ds, batch_size, persist)


class DCSEPipeline(_EnhancementPipeline):
    """DCSE (STFT → Conformer → bounded polar mask) enhancement of (B, N)
    or (N,) waveforms, from the port's checkpoints (``load_model``) or from
    a reference PyTorch checkpoint (``from_torch_checkpoint``, a
    ``conv_norm="batch"`` model). Training is
    ``train/dcse_trainer.DCSETrainer``."""

    MODEL = SpeechEnhancer
    CONFIG = DCSEConfig
    FINAL_NAME = "conformer_final"
    BEST_NAME = "best_conformer"

    def _enhanced_spec(self, wav, spec):
        enh_real, enh_imag, _ = self.model(spec.real, spec.imag)
        return torch.complex(enh_real, enh_imag)

    def calibrate_gain(self, ds: WaveformDataset, batch_size: int = 8,
                       persist: bool = True) -> float:
        """Post-hoc output-gain calibration on an already mixed (noisy,
        clean) dataset, which must use held-out noise crops
        (``data.loader.heldout_noises``): see
        ``SincformerPipeline.calibrate_gain``."""
        return self._calibrate(ds, batch_size, persist)

    @classmethod
    def from_torch_checkpoint(cls, path: str, model_dir: Optional[str] = None,
                              allow_pickle: bool = False, device="cuda",
                              **model_overrides) -> "DCSEPipeline":
        """A serving pipeline from a reference checkpoint
        (``conformer_final.pt`` / ``best_conformer.pt``) through
        ``compat.torch_import``: the architecture is read off the tensor
        shapes (``num_heads`` is not in them: 4 unless overridden) and the
        model built with ``conv_norm="batch"`` to carry the reference's
        BatchNorm statistics. ``allow_pickle`` opts in to full unpickling
        of a file that weights-only loading refuses."""
        from sincformer_tpu_torch.compat.torch_import import \
            load_reference_checkpoint
        loaded = load_reference_checkpoint(path, allow_pickle=allow_pickle)
        if loaded["kind"] != "dcse":
            raise ValueError(f"{path} is not a DCSE checkpoint")
        config = DCSEConfig(**{**loaded["config"], "conv_norm": "batch",
                               **model_overrides})
        pipe = cls(SpeechEnhancer(config), device=device, model_dir=model_dir)
        pipe.load_state(loaded["state_dict"])
        return pipe


def mask_interp_matrix(centers: np.ndarray, freqs: np.ndarray) -> np.ndarray:
    """(len(freqs), len(centers)) float32 matrix W with ``W @ row`` equal to
    ``np.interp(freqs, centers, row)``: linear interpolation between the
    channel centres, the first and last value held beyond them."""
    eye = np.eye(len(centers))
    return np.stack([np.interp(freqs, centers, eye[j])
                     for j in range(len(centers))], axis=1).astype(np.float32)


class DNNPipeline:
    """Feature-domain DNN mask estimation, the inference half of the
    original paper's pipeline: enhancement of one signal or of a batch, and
    checkpoint I/O with the feature statistics in the step's sidecar. It has
    no ``enhance_tensor``, as in the JAX package, so ``StreamingEnhancer``
    serves it through its host path."""

    def __init__(self, mask_type: str = "pcirm", device="cuda",
                 model_dir: Optional[str] = None,
                 model: Optional[SpeechEnhancementDNN] = None,
                 dcfg: DNNConfig = DNNConfig(),
                 acfg: AudioConfig = AudioConfig()):
        if mask_type not in ("pcirm", "opt_pcirm", "irm"):
            raise ValueError(f"mask_type must be 'pcirm', 'opt_pcirm' or "
                             f"'irm', got {mask_type!r}")
        self.mask_type = mask_type
        self.device = resolve_device(device)
        self.dcfg = dcfg
        self.acfg = acfg
        self.fs = acfg.sample_rate
        self.model_dir = model_dir or os.environ.get("SINCFORMER_MODEL_DIR",
                                                     "saved_models")
        self.fe = FeatureExtractor(fs=self.fs)
        self.gfb = GammatoneFilterbank(sample_rate=self.fs)
        self.feature_dim = self.fe.feature_dim
        self.mask_dim = self.gfb.num_channels
        self.model = model.to(self.device).eval() if model is not None else None
        self.feat_mean: Optional[np.ndarray] = None
        self.feat_std: Optional[np.ndarray] = None
        self.step = 0
        gcfg = GammatoneConfig()
        self._interp = torch.from_numpy(mask_interp_matrix(
            erb_space(gcfg.freq_low, gcfg.freq_high, self.mask_dim),
            np.linspace(0, self.fs / 2, acfg.fft_size // 2 + 1))
        ).to(self.device)
        self._window = torch.from_numpy(
            hann_window(acfg.frame_size, periodic=False)).to(self.device)

    @property
    def FINAL_NAME(self) -> str:
        return f"dnn_{self.mask_type}_final"

    @property
    def BEST_NAME(self) -> str:
        return f"best_{self.mask_type}"

    # ── model I/O ───────────────────────────────────────────────────────

    def save_model(self, name: Optional[str] = None,
                   quantize: bool = False) -> Optional[str]:
        """Write the DNN under ``<model_dir>/<name>/step_<step>`` with the
        feature statistics, the mask type and the sizes in the step's
        sidecar; nothing when no model is loaded. ``quantize=True`` writes
        the int8 serving form."""
        if self.model is None:
            return None
        name = name or self.FINAL_NAME
        save = save_checkpoint_quantized if quantize else save_checkpoint
        return save(os.path.join(self.model_dir, name),
                    self._checkpoint_state(quantize), self.step,
                    self._sidecar())

    def _checkpoint_state(self, quantize: bool) -> dict:
        """What a checkpoint holds: the parameters, and a trainer's
        optimizer state (:func:`with_training_state`)."""
        return with_training_state(
            self, {"params": dict(self.model.named_parameters())}, quantize)

    def _sidecar(self) -> dict:
        """The step's sidecar: feature statistics, mask type, sizes (a
        trainer adds its schedule's progress)."""
        def listed(a):
            return None if a is None else np.asarray(a, np.float32).tolist()
        return {"feat_mean": listed(self.feat_mean),
                "feat_std": listed(self.feat_std),
                "mask_type": self.mask_type,
                "feature_dim": self.feature_dim, "mask_dim": self.mask_dim,
                "config": self.model.sizes}

    def load_state(self, state_dict: Mapping[str, torch.Tensor],
                   sizes: Optional[Mapping] = None) -> None:
        """Load parameters (e.g. from compat.from_jax); the model is built
        at ``sizes`` (default: the paper's) unless one of those sizes is
        already there."""
        sizes = dict(sizes) if sizes else create_dnn(
            self.feature_dim, self.mask_dim, self.dcfg).sizes
        if self.model is None or self.model.sizes != sizes:
            self.model = SpeechEnhancementDNN(**sizes).to(self.device).eval()
        self.model.load_state_dict(dict(state_dict), strict=True)

    def load_model(self, path: Optional[str] = None) -> str:
        """Restore a checkpoint (``path`` = a ``.../family/step_N``
        directory; default: the newest step of the preferred family under
        ``model_dir``) and the feature statistics of its sidecar."""
        if path is None:
            for name in inference_ckpt_order(self.FINAL_NAME, self.BEST_NAME):
                path = latest_step_dir(os.path.join(self.model_dir, name))
                if path:
                    break
        if path is None:
            raise FileNotFoundError("no DNN checkpoint found")
        meta = read_step_meta(path)
        if meta.get("feat_mean") is not None:
            self.feat_mean = np.asarray(meta["feat_mean"], np.float32)
            self.feat_std = np.asarray(meta["feat_std"], np.float32)
        restored = restore_checkpoint(path)
        self.load_state(restored["params"], meta.get("config"))
        self.step = restored["step"]
        return path

    # ── inference ───────────────────────────────────────────────────────

    def _statistics(self):
        mean = (self.feat_mean if self.feat_mean is not None
                else np.zeros(self.feature_dim, np.float32))
        std = (self.feat_std if self.feat_std is not None
               else np.ones(self.feature_dim, np.float32))
        return (torch.from_numpy(np.asarray(mean, np.float32)).to(self.device),
                torch.from_numpy(np.asarray(std, np.float32)).to(self.device))

    @torch.inference_mode()
    def _enhance_core(self, noisy: torch.Tensor,
                      t_true: torch.Tensor) -> torch.Tensor:
        """(B, N) float waveforms on the device and their (B,) counts of
        valid frames → (B, N): features → DNN → mask onto the STFT bins →
        masked frames → overlap-add over the valid frames only."""
        if self.model is None:
            raise RuntimeError("No model loaded. Call load_model() first.")
        a = self.acfg
        frame, hop, n_fft = a.frame_size, a.hop_size, a.fft_size
        n = noisy.shape[-1]
        mean, std = self._statistics()
        feats = self.fe.add_context(self.fe.extract_frame_features(noisy))
        feats = torch.clamp((feats - mean) / std, -10.0, 10.0)
        feats = torch.nan_to_num(feats, nan=0.0, posinf=0.0, neginf=0.0)
        mask64 = torch.clamp(self.model(feats), 0.0, 1.0)     # (B, T, 64)
        spec = stft_uncentered(noisy, frame, hop, n_fft)
        t = min(mask64.shape[-2], spec.shape[-2])
        stft_mask = mask64[..., :t, :] @ self._interp.T       # (B, t, 129)
        valid = (torch.arange(t, device=noisy.device)[None, :]
                 < t_true[:, None])[..., None]
        masked = spec[..., :t, :] * stft_mask * valid
        frames = torch.fft.irfft(real_edge_bins(masked, n_fft), n=n_fft,
                                 dim=-1)[..., :frame] * self._window
        y = overlap_add(frames, hop, n)
        wsq = overlap_add((self._window * self._window) * valid, hop, n)
        return y / torch.where(wsq < 1e-8, torch.ones_like(wsq), wsq)

    def enhance_signal(self, noisy_signal: np.ndarray,
                       pad_quantum: int = 2000) -> np.ndarray:
        """One signal (N,) → (N,) float32. The input is zero-padded to a
        multiple of ``pad_quantum`` and frames past the true length are
        masked out, as in the JAX package: the whole-utterance RASTA-PLP
        mean runs over the padded signal, so the padding is part of the
        numbers. int16 input is scaled by 1/32768."""
        noisy = np.asarray(noisy_signal)
        noisy = (noisy.astype(np.float32) / 32768.0
                 if noisy.dtype == np.int16 else noisy.astype(np.float32))
        n_true = len(noisy)
        n_pad = int(np.ceil(n_true / pad_quantum) * pad_quantum)
        t_true = (n_true - self.acfg.frame_size) // self.acfg.hop_size + 1
        wav = np.zeros((1, n_pad), np.float32)
        wav[0, :n_true] = noisy
        out = self._enhance_core(
            torch.from_numpy(wav).to(self.device),
            torch.tensor([t_true], device=self.device))
        return out[0, :n_true].cpu().numpy()

    def enhance_batch(self, noisy: np.ndarray,
                      lengths: Optional[np.ndarray] = None) -> np.ndarray:
        """(B, N) → (B, N) float32, with no padding to a quantum. int16 PCM
        goes to the device as it is and is converted there.

        ``lengths``: optional (B,) true sample counts of rows padded to a
        common N; each row's valid-frame mask is then what
        :meth:`enhance_signal` applies to it."""
        noisy = np.asarray(noisy)
        if noisy.dtype != np.int16:
            noisy = noisy.astype(np.float32)
        b, n = noisy.shape
        frame, hop = self.acfg.frame_size, self.acfg.hop_size
        if lengths is None:
            t_true = np.full((b,), (n - frame) // hop + 1, np.int64)
        else:
            t_true = np.maximum(
                (np.asarray(lengths, np.int64) - frame) // hop + 1, 1)
        out = self._enhance_core(
            pcm_to_float(torch.from_numpy(noisy).to(self.device)),
            torch.from_numpy(t_true).to(self.device))
        return out.cpu().numpy()
