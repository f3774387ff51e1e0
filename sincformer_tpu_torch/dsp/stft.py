"""Centred STFT / iSTFT and the uncentred pair of the DNN inference path
(``sincformer_tpu/dsp/stft.py``).

Frame (strided view) → window → one batched real FFT, layout (..., T, F).
The inverse overlap-adds windowed inverse FFTs and divides by the summed
squared window clamped at ``eps``, as the JAX package does; ``torch.istft``
is not used because its window-envelope check and edge handling differ.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from sincformer_tpu_torch.utils.signal import (frame_signal, hann_window,
                                               num_frames, overlap_add)


def _padded_window(window: Optional[np.ndarray], win_length: int, n_fft: int,
                   device) -> torch.Tensor:
    """Centre-pad a ``win_length`` window (default periodic Hann) to n_fft.
    The default window is made once per device: a copy from the host each
    call would wait for the card."""
    if window is None:
        return _default_window(win_length, n_fft, str(torch.device(device)))
    window = np.asarray(window, np.float32)
    left = (n_fft - window.shape[0]) // 2
    padded = np.pad(window, (left, n_fft - window.shape[0] - left))
    return torch.from_numpy(padded).to(device)


@functools.lru_cache(maxsize=32)
def _default_window(win_length: int, n_fft: int, device: str) -> torch.Tensor:
    with torch.inference_mode(False), torch.no_grad():
        return _padded_window(hann_window(win_length, periodic=True),
                              win_length, n_fft, device)


def stft(x: torch.Tensor, n_fft: int = 256, hop: int = 80,
         win_length: int = 160, window: Optional[np.ndarray] = None,
         center: bool = True) -> torch.Tensor:
    """(..., N) real → complex (..., T, n_fft//2+1), T = N//hop + 1 when
    centred (reflect padding by n_fft//2 on both sides)."""
    w = _padded_window(window, win_length, n_fft, x.device)
    if center:
        pad = n_fft // 2
        lead = x.shape[:-1]
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
        x = x.reshape(lead + (x.shape[-1],))
    frames = frame_signal(x, n_fft, hop)
    return torch.fft.rfft(frames * w, n=n_fft, dim=-1)


def istft(spec: torch.Tensor, n_fft: int = 256, hop: int = 80,
          win_length: int = 160, window: Optional[np.ndarray] = None,
          length: Optional[int] = None, center: bool = True,
          eps: float = 1e-11) -> torch.Tensor:
    """Complex (..., T, n_fft//2+1) → real (..., length)."""
    w = _padded_window(window, win_length, n_fft, spec.device)
    t = spec.shape[-2]
    # a real signal's DC and Nyquist bins are real. A mask leaves imaginary
    # parts there; pocketfft (numpy, JAX and torch on the CPU) ignores them,
    # but cuFFT's result for such input depends on the plan it picks, i.e.
    # on the batch size, so they are dropped here on every device
    frames = torch.fft.irfft(real_edge_bins(spec, n_fft), n=n_fft,
                             dim=-1) * w
    total = (t - 1) * hop + n_fft
    y = overlap_add(frames, hop, total)
    norm = overlap_add((w * w).expand(t, n_fft), hop, total)
    y = y / torch.clamp(norm, min=eps)
    if center:
        y = y[..., n_fft // 2:]
    if length is not None:
        if y.shape[-1] >= length:
            y = y[..., :length]
        else:
            y = F.pad(y, (0, length - y.shape[-1]))
    return y


def real_edge_bins(spec: torch.Tensor, n_fft: int) -> torch.Tensor:
    """``spec`` with the imaginary parts of the DC and Nyquist bins set to
    zero (see :func:`istft`)."""
    imag = spec.imag.clone()
    imag[..., 0] = 0.0
    if n_fft % 2 == 0:
        imag[..., -1] = 0.0
    return torch.complex(spec.real, imag)


def stft_uncentered(x: torch.Tensor, frame_size: int = 160, hop: int = 80,
                    n_fft: int = 256,
                    window: Optional[np.ndarray] = None) -> torch.Tensor:
    """Uncentred STFT of the DNN inference path: symmetric Hann window of
    ``frame_size``, real FFT zero-padded to ``n_fft``.

    (..., N) → complex (..., T, n_fft//2+1), T = (N - frame_size)//hop + 1.
    """
    if window is None:
        window = hann_window(frame_size, periodic=False)
    w = torch.from_numpy(np.asarray(window, np.float32)).to(x.device)
    return torch.fft.rfft(frame_signal(x, frame_size, hop) * w, n=n_fft,
                          dim=-1)


def istft_uncentered(spec: torch.Tensor, out_len: int, frame_size: int = 160,
                     hop: int = 80, n_fft: int = 256,
                     window: Optional[np.ndarray] = None,
                     eps: float = 1e-8) -> torch.Tensor:
    """Overlap-add reconstruction of the DNN inference path: inverse FFT →
    first ``frame_size`` samples → × window → overlap-add → ÷ summed
    window² (1 where that sum is under ``eps``)."""
    if window is None:
        window = hann_window(frame_size, periodic=False)
    w = torch.from_numpy(np.asarray(window, np.float32)).to(spec.device)
    frames = torch.fft.irfft(real_edge_bins(spec, n_fft), n=n_fft,
                             dim=-1)[..., :frame_size] * w
    t = spec.shape[-2]
    y = overlap_add(frames, hop, out_len)
    norm = overlap_add((w * w).expand(t, frame_size), hop, out_len)
    return y / torch.where(norm < eps, torch.ones_like(norm), norm)


def stft_frame_count(n_samples: int, hop: int = 80, center: bool = True,
                     frame_size: int = 160) -> int:
    """The frame count of :func:`stft` (``center=True``: n_samples // hop
    + 1) or of :func:`stft_uncentered` (``center=False``)."""
    if center:
        return n_samples // hop + 1
    return num_frames(n_samples, frame_size, hop)
