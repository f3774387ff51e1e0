"""SincNet band-pass layer (``sincformer_tpu/agents/sincnet.py``).

Only the (low, band) cutoffs are learned; the Hamming-windowed sinc kernels
are synthesised in the forward pass in f32, step for step as the JAX module
does, and applied as one conv1d with padding k//2.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def erb_init_points(out_channels: int, sample_rate: int,
                    min_low_hz: float, min_band_hz: float) -> np.ndarray:
    """ERB-spaced cutoff frequencies (21.4·log10(1 + f/228.7) scale)."""
    erb_low = 21.4 * math.log10(1 + min_low_hz / 228.7)
    erb_high = 21.4 * math.log10(1 + (sample_rate / 2 - min_band_hz) / 228.7)
    erb_points = np.linspace(erb_low, erb_high, out_channels + 1)
    return 228.7 * (10 ** (erb_points / 21.4) - 1)


class SincConv1d(nn.Module):
    """(B, N) waveform → (B, N, C) if ``channels_last`` else (B, C, N)."""

    def __init__(self, out_channels: int = 64, kernel_size: int = 251,
                 sample_rate: int = 8000, min_low_hz: float = 50.0,
                 min_band_hz: float = 50.0, channels_last: bool = False):
        super().__init__()
        k = kernel_size + (1 - kernel_size % 2)          # force odd
        self.kernel_size = k
        self.sample_rate = sample_rate
        self.min_low_hz = min_low_hz
        self.min_band_hz = min_band_hz
        self.channels_last = channels_last
        hz = erb_init_points(out_channels, sample_rate, min_low_hz,
                             min_band_hz)
        self.low_hz = nn.Parameter(torch.tensor(hz[:-1], dtype=torch.float32))
        self.band_hz = nn.Parameter(torch.tensor(np.diff(hz),
                                                 dtype=torch.float32))
        half = (k - 1) // 2
        n_left = 2 * math.pi * np.arange(-half, 0) / sample_rate
        window = 0.54 - 0.46 * np.cos(2 * math.pi * np.arange(k) / k)
        self.register_buffer("n_left", torch.tensor(
            n_left[None, :], dtype=torch.float32), persistent=False)
        self.register_buffer("window", torch.tensor(
            window, dtype=torch.float32), persistent=False)

    def filters(self) -> torch.Tensor:
        """(C, k) band-pass kernels, L1-normalised per channel."""
        low = self.min_low_hz + torch.abs(self.low_hz)
        high = torch.clamp(low + self.min_band_hz + torch.abs(self.band_hz),
                           max=self.sample_rate / 2.0)
        f_low = (low / self.sample_rate)[:, None]
        f_high = (high / self.sample_rate)[:, None]
        n_left = self.n_left
        band_left = ((torch.sin(f_high * n_left) - torch.sin(f_low * n_left))
                     / (n_left / 2.0 + 1e-8))
        band_center = 2.0 * (f_high - f_low)
        kernel = torch.cat([band_left, band_center,
                            torch.flip(band_left, dims=[1])], dim=1)
        kernel = kernel * self.window
        return kernel / (torch.sum(torch.abs(kernel), dim=1, keepdim=True)
                         + 1e-8)

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        if waveform.ndim == 2:
            waveform = waveform[:, None, :]
        kernel = self.filters().to(waveform.dtype)
        y = F.conv1d(waveform, kernel[:, None, :], padding=self.kernel_size // 2)
        return y.transpose(1, 2) if self.channels_last else y
