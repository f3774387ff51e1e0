"""Windowing, framing and PCM primitives, and the FFT-domain resampler and
Hilbert envelope of the metrics (``sincformer_tpu/utils/signal.py``).

Windows are computed in float64 with numpy and cast to float32, exactly as
the JAX package builds them, so both packages start from the same bits.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch


def hamming_window(n: int, periodic: bool = False) -> np.ndarray:
    """Hamming window; ``periodic=False`` matches
    ``scipy.signal.windows.hamming``."""
    denom = n if periodic else n - 1
    k = np.arange(n)
    return (0.54 - 0.46 * np.cos(2.0 * np.pi * k / denom)).astype(np.float32)


def hann_window(n: int, periodic: bool = True) -> np.ndarray:
    """Hann window; ``periodic=True`` matches ``torch.hann_window``."""
    denom = n if periodic else n - 1
    k = np.arange(n)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * k / denom)).astype(np.float32)


def num_frames(n_samples: int, frame_size: int, hop: int) -> int:
    """Uncentered frame count ``(N - L)//H + 1`` (never negative)."""
    return max(0, (n_samples - frame_size) // hop + 1)


def frame_signal(x: torch.Tensor, frame_size: int, hop: int) -> torch.Tensor:
    """(..., N) → (..., T, frame_size) overlapping frames (a strided view)."""
    if num_frames(x.shape[-1], frame_size, hop) == 0:
        return x.new_zeros(x.shape[:-1] + (0, frame_size))
    return x.unfold(-1, frame_size, hop)


def overlap_add(frames: torch.Tensor, hop: int, out_len: int) -> torch.Tensor:
    """Inverse of :func:`frame_signal`: sum overlapping frames.

    (..., T, L) → (..., out_len); an extra tail is dropped, a shortfall is
    zero-padded. Each frame is split into k = ceil(L/hop) hop-sized blocks
    and the sum becomes k shifted contiguous adds, with no scatter.
    """
    t, length = frames.shape[-2], frames.shape[-1]
    batch = frames.shape[:-2]
    if t == 0:
        return frames.new_zeros(batch + (out_len,))
    k = -(-length // hop)
    parts = torch.nn.functional.pad(frames, (0, k * hop - length))
    parts = parts.reshape(batch + (t, k, hop))
    pad_to = max((t - 1) * hop + length, out_len, (t + k - 1) * hop)
    out = frames.new_zeros(batch + (pad_to,))
    for j in range(k):
        out[..., j * hop:(j + t) * hop] += parts[..., :, j, :].reshape(
            batch + (t * hop,))
    return out[..., :out_len]


@functools.lru_cache(maxsize=32)
def dct_matrix(n: int, n_out: Optional[int] = None) -> np.ndarray:
    """Orthonormal DCT-II matrix (n_out, n), rows = output coefficients:
    ``D @ x`` equals ``scipy.fftpack.dct(x, type=2, norm='ortho')[:n_out]``."""
    n_out = n_out or n
    k = np.arange(n_out)[:, None]
    j = np.arange(n)[None, :]
    d = np.cos(np.pi * k * (2 * j + 1) / (2 * n)) * 2.0
    d = d * np.where(k == 0, np.sqrt(1.0 / (4.0 * n)), np.sqrt(1.0 / (2.0 * n)))
    return d.astype(np.float32)


def dct_ortho(x: torch.Tensor, n_out: Optional[int] = None) -> torch.Tensor:
    """Orthonormal DCT-II along the last axis, the first ``n_out``
    coefficients: :func:`dct_matrix` times x."""
    d = torch.from_numpy(dct_matrix(x.shape[-1], n_out)).to(x.device,
                                                           x.dtype)
    return torch.einsum("kn,...n->...k", d, x)


def pcm_to_float(wav: torch.Tensor) -> torch.Tensor:
    """int16 PCM → float32 in [-1, 1) on the tensor's device; float input
    passes through unchanged."""
    if wav.dtype == torch.int16:
        return wav.to(torch.float32) * (1.0 / 32768.0)
    return wav


def float_to_pcm(wav: torch.Tensor) -> torch.Tensor:
    """float32 audio in [-1, 1] → int16 PCM on the tensor's device: times
    32768, clipped to [-32768, 32767], rounded half to even."""
    scaled = torch.clamp(wav * 32768.0, -32768.0, 32767.0)
    return torch.round(scaled).to(torch.int16)


def resample_linear(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Linear-interpolation resampler on the host (data loading only)."""
    if sr_in == sr_out:
        return x
    new_len = int(len(x) * sr_out / sr_in)
    idx = np.linspace(0, len(x) - 1, new_len)
    return np.interp(idx, np.arange(len(x)), x).astype(np.float32)


def resample_poly_fft(x: torch.Tensor, sr_in: int, sr_out: int
                      ) -> torch.Tensor:
    """FFT-domain resampling of the last axis from ``sr_in`` to ``sr_out``
    (``scipy.signal.resample`` for real input): the spectrum cut or
    zero-padded to round(N · sr_out / sr_in) samples, the Nyquist bin of
    an even-length cut doubled; on the tensor's device."""
    if sr_in == sr_out:
        return x
    n = x.shape[-1]
    m = int(round(n * sr_out / sr_in))
    spec = torch.fft.rfft(x, dim=-1)
    n_bins_out, n_bins_in = m // 2 + 1, spec.shape[-1]
    if n_bins_out <= n_bins_in:
        spec = spec[..., :n_bins_out]
        if m % 2 == 0 and n_bins_out < n_bins_in:
            last = torch.complex(spec[..., -1].real * 2.0,
                                 torch.zeros_like(spec[..., -1].real))
            spec = torch.cat([spec[..., :-1], last[..., None]], dim=-1)
    else:
        spec = torch.cat([spec, spec.new_zeros(
            spec.shape[:-1] + (n_bins_out - n_bins_in,))], dim=-1)
    out = torch.fft.irfft(spec, n=m, dim=-1) * (m / n)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=16)
def _analytic_weights(n: int) -> np.ndarray:
    h = np.zeros(n)
    if n % 2 == 0:
        h[0] = h[n // 2] = 1.0
        h[1:n // 2] = 2.0
    else:
        h[0] = 1.0
        h[1:(n + 1) // 2] = 2.0
    return h.astype(np.float32)


def hilbert_envelope(x: torch.Tensor) -> torch.Tensor:
    """|analytic signal| along the last axis: one complex64 FFT, the
    negative frequencies dropped and the positive ones doubled, one inverse
    FFT; on the tensor's device."""
    n = x.shape[-1]
    spec = torch.fft.fft(x.to(torch.float32), dim=-1)
    h = torch.from_numpy(_analytic_weights(n)).to(x.device)
    return torch.abs(torch.fft.ifft(spec * h, dim=-1))
