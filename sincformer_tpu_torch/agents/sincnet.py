"""SincNet band-pass layer (``sincformer_tpu/agents/sincnet.py``).

Only the (low, band) cutoffs are learned; the Hamming-windowed sinc kernels
are synthesised in the forward pass in f32, step for step as the JAX module
does, and applied as one conv1d with padding k//2.

In a model cast to bfloat16 the cutoffs are bfloat16 while the tap
positions ``n_left`` and the window stay float32 constants, as in JAX
(they are not variables there): the cutoff arithmetic rounds to bfloat16,
the synthesis from the first product with ``n_left`` on is float32 by
promotion, and only the finished kernel is rounded to the waveform's
dtype for the convolution.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sincformer_tpu_torch.ops.flax_math import in_dtype


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
        self._constants = {
            "n_left": (2 * math.pi * np.arange(-half, 0) / sample_rate)[None],
            "window": 0.54 - 0.46 * np.cos(2 * math.pi * np.arange(k) / k)}
        for name, value in self._constants.items():
            self.register_buffer(name, torch.tensor(value, dtype=torch.float32),
                                 persistent=False)

    def _apply(self, fn, recurse=True):
        """Moves and casts as ``nn.Module`` does, but ``n_left`` and
        ``window`` stay float32 values of their constants on the new
        device (a cast to bfloat16 would round them)."""
        super()._apply(fn, recurse)
        for name, value in self._constants.items():
            buf = self._buffers[name]
            if buf.dtype != torch.float32:
                self._buffers[name] = torch.tensor(value, dtype=torch.float32,
                                                   device=buf.device)
        return self

    def filters(self) -> torch.Tensor:
        """(C, k) band-pass kernels, L1-normalised per channel, float32."""
        dt = self.low_hz.dtype
        low = in_dtype(self.min_low_hz, dt) + torch.abs(self.low_hz)
        high = torch.clamp(low + in_dtype(self.min_band_hz, dt)
                           + torch.abs(self.band_hz),
                           max=in_dtype(self.sample_rate / 2.0, dt))
        f_low = (low / in_dtype(self.sample_rate, dt))[:, None]
        f_high = (high / in_dtype(self.sample_rate, dt))[:, None]
        n_left = self.n_left
        band_left = ((torch.sin(f_high * n_left) - torch.sin(f_low * n_left))
                     / (n_left / 2.0 + 1e-8))
        band_center = (2.0 * (f_high - f_low)).float()
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
