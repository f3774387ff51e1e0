"""Enhancement entry points: :class:`SincformerPipeline` (the inference half
of ``sincformer_tpu/train/agent_trainer.py``) and :class:`DCSEPipeline` (of
``sincformer_tpu/train/dcse_trainer.py``).

    wave (int16 or float) → pcm_to_float → centred STFT → model → complex
    mask × STFT → iSTFT → × output_gain

A pipeline runs on the card (``device="cuda"``, the default) unless the
caller asks for ``device="cpu"``; without CUDA the default raises instead of
running anywhere else. ``output_gain`` is read at every call, so a changed
gain takes effect at once. ``save_model`` / ``load_model`` write and read
the serving checkpoints of ``train/state.py``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Optional

import numpy as np
import torch

from sincformer_tpu_torch.agents.metacog import SincformerMetacog
from sincformer_tpu_torch.config import AudioConfig, DCSEConfig, MetacogConfig
from sincformer_tpu_torch.dsp.stft import istft, stft
from sincformer_tpu_torch.models.dcse import SpeechEnhancer
from sincformer_tpu_torch.train.state import (inference_ckpt_order,
                                              latest_step_dir,
                                              merge_train_meta,
                                              read_step_meta,
                                              resolve_output_gain,
                                              restore_checkpoint,
                                              save_checkpoint,
                                              save_checkpoint_quantized)
from sincformer_tpu_torch.utils.signal import pcm_to_float


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must be present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available. sincformer_tpu_torch runs on the GPU by "
            "default; pass device='cpu' to run on the CPU on purpose.")
    return device


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

    def _enhanced_spec(self, wav: torch.Tensor,
                       spec: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

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
        params = dict(self.model.named_parameters())
        state = {"params": params,
                 "model_state": {k: v for k, v in
                                 self.model.state_dict().items()
                                 if k not in params}}
        save = save_checkpoint_quantized if quantize else save_checkpoint
        path = save(os.path.join(self.model_dir, name), state, self.step,
                    extra={"config": dataclasses.asdict(self.model.config)})
        merge_train_meta(self.model_dir, name,
                         {"output_gain": float(self.output_gain)})
        return path

    def load_model(self, path: Optional[str] = None) -> str:
        """Restore a checkpoint (``path`` = a ``.../family/step_N``
        directory; default: the newest step of the preferred family under
        ``model_dir``). The model is rebuilt at the sizes the checkpoint's
        sidecar records; the output gain comes from the family's sidecar."""
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
        if config is not None and config != dataclasses.asdict(
                self.model.config):
            self.model = self.MODEL(self.CONFIG(**config)).to(
                self.device).eval()
        self.load_state(restored["params"], restored["model_state"])
        self.step = restored["step"]
        self.output_gain = resolve_output_gain(path)
        return path


class SincformerPipeline(_EnhancementPipeline):
    """Sincformer-metacog enhancement of (B, N) or (N,) waveforms."""

    MODEL = SincformerMetacog
    CONFIG = MetacogConfig
    FINAL_NAME = "sincformer_final"
    BEST_NAME = "best_sincformer"

    def _enhanced_spec(self, wav, spec):
        out = self.model(wav, spec.real, spec.imag)
        return torch.complex(out["enhanced_real"], out["enhanced_imag"])


class DCSEPipeline(_EnhancementPipeline):
    """DCSE (STFT → Conformer → bounded polar mask) enhancement of (B, N)
    or (N,) waveforms."""

    MODEL = SpeechEnhancer
    CONFIG = DCSEConfig
    FINAL_NAME = "conformer_final"
    BEST_NAME = "best_conformer"

    def _enhanced_spec(self, wav, spec):
        enh_real, enh_imag, _ = self.model(spec.real, spec.imag)
        return torch.complex(enh_real, enh_imag)

    @classmethod
    def from_torch_checkpoint(cls, path: str, **kwargs) -> "DCSEPipeline":
        """Reference ``.pt`` checkpoints carry BatchNorm statistics
        (``conv_norm="batch"``), which this package does not model yet."""
        raise NotImplementedError(
            f"cannot load {path}: the reference .pt import needs "
            f"conv_norm='batch', which waits for the DCSE training slice "
            f"(ROADMAP.md Queue 1)")
