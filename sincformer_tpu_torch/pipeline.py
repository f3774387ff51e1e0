"""Flagship enhancement entry points (``SincformerPipeline`` inference in
``sincformer_tpu/train/agent_trainer.py``).

    wave (int16 or float) → pcm_to_float → centred STFT → SincformerMetacog
    → complex mask × STFT → iSTFT → × output_gain

The pipeline runs on the card (``device="cuda"``, the default) unless the
caller asks for ``device="cpu"``; without CUDA the default raises instead of
running anywhere else.
"""

from __future__ import annotations

import json
import math
import os
from typing import Mapping, Optional

import numpy as np
import torch

from sincformer_tpu_torch.agents.metacog import SincformerMetacog
from sincformer_tpu_torch.config import AudioConfig
from sincformer_tpu_torch.dsp.stft import istft, stft
from sincformer_tpu_torch.utils.signal import pcm_to_float


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must be present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available. sincformer_tpu_torch runs on the GPU by "
            "default; pass device='cpu' to run on the CPU on purpose.")
    return device


def read_output_gain(step_dir: str) -> float:
    """Validation-calibrated output gain of a checkpoint ``.../family/step_N``:
    ``output_gain`` in the family's ``train_meta.json``, default 1.0."""
    meta_path = os.path.join(os.path.dirname(os.path.abspath(step_dir)),
                             "train_meta.json")
    try:
        with open(meta_path) as f:
            gain = float(json.load(f).get("output_gain", 1.0))
    except FileNotFoundError:
        return 1.0
    return gain if math.isfinite(gain) and gain > 0 else 1.0


class SincformerPipeline:
    """Sincformer-metacog enhancement of (B, N) or (N,) waveforms."""

    def __init__(self, model: Optional[SincformerMetacog] = None,
                 device="cuda", output_gain: float = 1.0,
                 audio: AudioConfig = AudioConfig()):
        self.device = resolve_device(device)
        self.audio = audio
        self.model = (model or SincformerMetacog()).to(self.device).eval()
        self.output_gain = float(output_gain)

    def load_state(self, state_dict: Mapping[str, torch.Tensor],
                   buffers: Mapping[str, torch.Tensor]) -> None:
        """Load parameters and buffers (e.g. from compat.from_jax); every
        key of the model must be given and no other."""
        self.model.load_state_dict({**state_dict, **buffers}, strict=True)

    @torch.inference_mode()
    def enhance_tensor(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, N) int16 or float tensor on ``self.device`` → (B, N) float."""
        a = self.audio
        wav = pcm_to_float(wav)
        spec = stft(wav, a.fft_size, a.hop_size, a.frame_size)
        out = self.model(wav, spec.real, spec.imag)
        enh = istft(torch.complex(out["enhanced_real"], out["enhanced_imag"]),
                    a.fft_size, a.hop_size, a.frame_size,
                    length=wav.shape[-1])
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
