"""Audio file input on the host (``load_audio`` of
``sincformer_tpu/data/audio.py``): WAV through ``scipy.io.wavfile`` with
int16/int32 scaling, mono mixdown, linear-interpolation resampling."""

from __future__ import annotations

from typing import Optional

import numpy as np

from sincformer_tpu_torch.config import AudioConfig
from sincformer_tpu_torch.utils.signal import resample_linear


def load_audio(filepath: str, target_sr: Optional[int] = None) -> np.ndarray:
    """Load a WAV file as mono float32 at ``target_sr`` (default 8 kHz)."""
    from scipy.io import wavfile
    target_sr = target_sr or AudioConfig().sample_rate
    sr, audio = wavfile.read(filepath)
    if audio.dtype == np.int16:
        audio = audio.astype(np.float32) / 32768.0
    elif audio.dtype == np.int32:
        audio = audio.astype(np.float32) / 2147483648.0
    else:
        audio = audio.astype(np.float32)
    if audio.ndim > 1:
        audio = audio.mean(axis=1)
    if sr != target_sr:
        audio = resample_linear(audio, sr, target_sr)
    return audio.astype(np.float32)
