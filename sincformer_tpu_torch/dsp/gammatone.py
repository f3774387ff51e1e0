"""64-channel gammatone filterbank as one convolution
(``sincformer_tpu/dsp/gammatone.py``).

ERB-spaced centre frequencies, 4th-order gammatone impulse responses of unit
energy, causal FIR filtering of all channels in one ``F.conv1d`` (the JAX
package computes the bank with one XLA convolution outside any hand-written
kernel, so a library convolution is its counterpart here), framing as a
strided view and one batched real FFT for the per-unit power and the
centre-bin phase. The taps are built in float64 with numpy and cast to
float32, as the JAX package builds them.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sincformer_tpu_torch.config import AudioConfig, GammatoneConfig
from sincformer_tpu_torch.utils.signal import frame_signal


def erb_bandwidth(cf):
    """ERB(f) = 24.7 * (4.37 * f / 1000 + 1) (Glasberg & Moore 1990)."""
    return 24.7 * (4.37 * np.asarray(cf) / 1000.0 + 1.0)


def erb_space(low_freq: float, high_freq: float,
              num_channels: int) -> np.ndarray:
    """Centre frequencies equally spaced on the ERB-number scale."""
    erb_low = 9.265 * np.log(1 + low_freq / (24.7 * 9.265))
    erb_high = 9.265 * np.log(1 + high_freq / (24.7 * 9.265))
    pts = np.linspace(erb_low, erb_high, num_channels)
    return 24.7 * 9.265 * (np.exp(pts / 9.265) - 1)


def gammatone_impulse_response(cf: float, fs: int, duration: float = 0.05,
                               order: int = 4) -> np.ndarray:
    """Unit-energy gammatone impulse response
    ``t^(order-1) * exp(-2 pi 1.019 ERB t) * cos(2 pi cf t)``."""
    t = np.arange(0, duration, 1.0 / fs)
    b = 2 * np.pi * erb_bandwidth(cf) * 1.019
    h = (t ** (order - 1)) * np.exp(-b * t) * np.cos(2 * np.pi * cf * t)
    return h / (np.sqrt(np.sum(h ** 2)) + 1e-10)


@functools.lru_cache(maxsize=8)
def _fir_bank(num_channels: int, freq_low: float, freq_high: float,
              fs: int, order: int, duration: float):
    """The (C, K) FIR bank in float32 and its centre frequencies."""
    cfs = erb_space(freq_low, freq_high, num_channels)
    bank = np.stack([gammatone_impulse_response(cf, fs, duration, order)
                     for cf in cfs]).astype(np.float32)
    return bank, cfs


class GammatoneFilterbank:
    """Waveform (..., N) → time-frequency representation; every method
    takes any leading dimensions and runs on its input's device."""

    def __init__(self, num_channels: Optional[int] = None,
                 freq_low: Optional[float] = None,
                 freq_high: Optional[float] = None,
                 sample_rate: Optional[int] = None,
                 filter_order: Optional[int] = None,
                 ir_duration: Optional[float] = None,
                 gcfg: GammatoneConfig = GammatoneConfig(),
                 acfg: AudioConfig = AudioConfig()):
        self.num_channels = num_channels or gcfg.num_channels
        self.freq_low = freq_low or gcfg.freq_low
        self.freq_high = freq_high or gcfg.freq_high
        self.sample_rate = sample_rate or acfg.sample_rate
        self.filter_order = filter_order or gcfg.filter_order
        self.ir_duration = ir_duration or gcfg.ir_duration
        self.frame_size = acfg.frame_size
        self.hop_size = acfg.hop_size
        self.fft_size = acfg.fft_size

        self.fir, self.center_freqs = _fir_bank(
            self.num_channels, self.freq_low, self.freq_high,
            self.sample_rate, self.filter_order, self.ir_duration)
        # phase bin per channel: int(cf * fft / fs), clamped to the last bin
        bins = (self.center_freqs * self.fft_size
                / self.sample_rate).astype(int)
        self.cf_bins = np.minimum(bins, self.fft_size // 2)
        self._weights = {}

    def _weight(self, device) -> torch.Tensor:
        """The flipped taps (C, 1, K) on ``device`` (conv1d correlates)."""
        key = str(device)
        if key not in self._weights:
            self._weights[key] = torch.from_numpy(
                self.fir[:, None, ::-1].copy()).to(device)
        return self._weights[key]

    def filter(self, signal: torch.Tensor) -> torch.Tensor:
        """(..., N) → (..., C, N): causal FIR filtering, equal to
        ``fftconvolve(x, ir, 'full')[:N]`` per channel (K-1 zeros on the
        left)."""
        x = signal.to(torch.float32)
        lead, n = x.shape[:-1], x.shape[-1]
        k = self.fir.shape[-1]
        y = F.conv1d(F.pad(x.reshape(-1, 1, n), (k - 1, 0)),
                     self._weight(x.device))
        return y.reshape(lead + (self.num_channels, n))

    def filter_to_frames(self, signal: torch.Tensor,
                         frame_size: Optional[int] = None,
                         hop_size: Optional[int] = None) -> torch.Tensor:
        """(..., N) → (..., C, T, frame_size), T = (N - L)//H + 1."""
        return frame_signal(self.filter(signal),
                            frame_size or self.frame_size,
                            hop_size or self.hop_size)

    def get_tf_magnitudes(self, signal: torch.Tensor,
                          frame_size: Optional[int] = None,
                          hop_size: Optional[int] = None,
                          fft_size: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-unit total power Σ|rfft|² and the phase at each channel's
        centre-frequency bin; each (..., C, T)."""
        fft_size = fft_size or self.fft_size
        frames = self.filter_to_frames(signal, frame_size, hop_size)
        spec = torch.fft.rfft(frames, n=fft_size, dim=-1)   # (..., C, T, F)
        mags = (spec.real ** 2 + spec.imag ** 2).sum(dim=-1)
        bins = torch.from_numpy(np.asarray(self.cf_bins, np.int64)).to(
            spec.device)
        index = bins.reshape((1,) * (spec.ndim - 3) + (-1, 1, 1)).expand(
            spec.shape[:-1] + (1,))
        sel = torch.gather(spec, -1, index)[..., 0]
        return mags, torch.angle(sel)
