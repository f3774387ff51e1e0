"""Coherence Speech Intelligibility Index
(``sincformer_tpu/evaluation/csii.py``): magnitude-squared coherence
(Welch: 16 ms Hamming frames, 50 % overlap, 256-point FFT) weighted by an
SII-like band importance, averaged over three amplitude regions. As in the
reference, every region takes the same whole-signal coherence; a region
too small for one frame scores 0."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sincformer_tpu_torch.config import AudioConfig
from sincformer_tpu_torch.evaluation.common import f32_on
from sincformer_tpu_torch.utils.signal import frame_signal, hamming_window


def _sii_weights(n_freq: int, fs: int, num_fft: int) -> np.ndarray:
    """Piecewise band-importance weights, normalised."""
    freqs = np.arange(n_freq) * fs / num_fft
    w = np.ones(n_freq)
    w[freqs < 4000] = 0.9
    w[freqs < 2000] = 1.0
    w[freqs < 1000] = 0.8
    w[freqs < 500] = 0.5
    w[freqs < 200] = 0.0
    w[freqs >= 4000] = 0.4
    return w / (np.sum(w) + 1e-10)


def msc_torch(x: torch.Tensor, y: torch.Tensor, frame_size: int, hop: int,
              num_fft: int) -> torch.Tensor:
    """Welch magnitude-squared coherence |Pxy|² / (Pxx·Pyy) of (..., N)
    signals: (..., num_fft // 2 + 1)."""
    win = torch.from_numpy(hamming_window(frame_size, periodic=False)).to(
        x.device)
    xs = torch.fft.rfft(frame_signal(x, frame_size, hop) * win, n=num_fft,
                        dim=-1)
    ys = torch.fft.rfft(frame_signal(y, frame_size, hop) * win, n=num_fft,
                        dim=-1)
    pxx = torch.mean(torch.abs(xs) ** 2, dim=-2)
    pyy = torch.mean(torch.abs(ys) ** 2, dim=-2)
    pxy = torch.mean(xs * torch.conj(ys), dim=-2)
    return torch.clamp(torch.abs(pxy) ** 2 / (pxx * pyy + 1e-10), 0.0, 1.0)


def csii_torch(clean: torch.Tensor, enhanced: torch.Tensor,
               fs: int = 8000) -> torch.Tensor:
    """CSII of equal-length (..., N) waveforms in the common case, where
    every amplitude region is large enough: Σ w·MSC, batched."""
    frame_size = int(0.016 * fs)
    num_fft = 256
    msc = msc_torch(clean, enhanced, frame_size, frame_size // 2, num_fft)
    w = torch.from_numpy(_sii_weights(num_fft // 2 + 1, fs, num_fft).astype(
        np.float32)).to(msc.device)
    return torch.clamp(torch.sum(w * msc, dim=-1), 0.0, 1.0)


def compute_csii(clean_signal, enhanced_signal, fs: Optional[int] = None,
                 num_levels: int = 3, device="cuda") -> float:
    """Three-level CSII of two host signals (cut to the shorter), with the
    rule that a region smaller than one frame scores 0; the coherence runs
    on ``device``."""
    fs = fs or AudioConfig().sample_rate
    m = min(len(clean_signal), len(enhanced_signal))
    clean = np.asarray(clean_signal[:m], np.float64)
    enhanced = np.asarray(enhanced_signal[:m], np.float64)

    frame_size = int(0.016 * fs)
    hop = frame_size // 2
    num_fft = 256
    w = _sii_weights(num_fft // 2 + 1, fs, num_fft)

    # the amplitude regions: frames sorted by the clean RMS, in thirds
    nf = (m - frame_size) // hop + 1
    if nf < num_levels:
        regions = [np.arange(m)] * num_levels
    else:
        rms = np.sqrt(np.mean(
            np.stack([clean[i * hop:i * hop + frame_size]
                      for i in range(nf)]) ** 2, axis=1))
        order = np.argsort(rms)
        per = nf // num_levels
        regions = []
        for lvl in range(num_levels):
            lo = lvl * per
            hi = nf if lvl == num_levels - 1 else (lvl + 1) * per
            idx = []
            for fi in order[lo:hi]:
                s = fi * hop
                idx.extend(range(s, min(s + frame_size, m)))
            regions.append(np.array(idx))

    if nf < 1:
        return 0.0
    msc = msc_torch(f32_on(clean, device), f32_on(enhanced, device),
                    frame_size, hop, num_fft).cpu().numpy()
    whole = float(np.clip(np.sum(w * msc), 0.0, 1.0))

    levels = []
    for idx in regions:
        idx = idx[idx < m]
        levels.append(0.0 if len(idx) < frame_size else whole)
    return float(np.mean(levels))
