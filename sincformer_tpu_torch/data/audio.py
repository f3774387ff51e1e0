"""Audio on the host (``sincformer_tpu/data/audio.py``): ``load_audio``
reads WAV through the native decoder (``data/native.py``) or, without it,
``scipy.io.wavfile`` with int16/int32 scaling, mono mixdown and
linear-interpolation resampling; ``add_noise_at_snr`` mixes speech and
noise at a target SNR."""

from __future__ import annotations

from typing import Optional

import numpy as np

from sincformer_tpu_torch.config import AudioConfig
from sincformer_tpu_torch.utils.signal import resample_linear


def load_audio(filepath: str, target_sr: Optional[int] = None,
               use_native: bool = True) -> np.ndarray:
    """Load a WAV file as mono float32 at ``target_sr`` (default 8 kHz):
    through the native decoder and resampler when ``use_native`` and the
    library builds, else through scipy (the same numbers)."""
    from scipy.io import wavfile
    target_sr = target_sr or AudioConfig().sample_rate
    if use_native and filepath.lower().endswith(".wav"):
        from sincformer_tpu_torch.data import native
        got = native.wav_read_mono(filepath)
        if got is not None:
            audio, sr = got
            if sr != target_sr:
                audio = native.resample_linear(audio, sr, target_sr)
            return audio.astype(np.float32)
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


def add_noise_at_snr(clean: np.ndarray, noise: np.ndarray,
                     snr_db: float) -> np.ndarray:
    """Mix ``clean`` with ``noise`` scaled to ``snr_db``: the noise is tiled
    to the clean length and cropped from its start, the scale taken from
    the power ratio (host numpy, float32 out)."""
    clean = np.asarray(clean, np.float32)
    noise = np.asarray(noise, np.float32)
    if len(noise) < len(clean):
        noise = np.tile(noise, int(np.ceil(len(clean) / len(noise))))
    noise = noise[:len(clean)]
    clean_power = np.mean(clean ** 2) + 1e-10
    noise_power = np.mean(noise ** 2) + 1e-10
    scale = np.sqrt(clean_power / (noise_power * 10.0 ** (snr_db / 10.0)))
    return (clean + scale * noise).astype(np.float32)
