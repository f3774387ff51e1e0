"""Normalized Covariance Metric (``sincformer_tpu/evaluation/ncm.py``):
both signals through the 64-channel gammatone bank (one convolution,
``dsp/gammatone.py``), the Hilbert envelope of every channel (one complex64
FFT pair), the normalised covariance per channel, clipped at 0, weighted
by speech-band importance."""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from sincformer_tpu_torch.config import AudioConfig
from sincformer_tpu_torch.dsp.gammatone import GammatoneFilterbank
from sincformer_tpu_torch.evaluation.common import f32_on
from sincformer_tpu_torch.utils.signal import hilbert_envelope


@functools.lru_cache(maxsize=4)
def _gfb(fs: int) -> GammatoneFilterbank:
    return GammatoneFilterbank(sample_rate=fs)


def _channel_weights(center_freqs: np.ndarray) -> np.ndarray:
    """Speech-band importance per channel, normalised."""
    w = np.ones(len(center_freqs))
    for i, f in enumerate(center_freqs):
        if f < 300:
            w[i] = 0.3
        elif f < 1000:
            w[i] = 0.8
        elif f < 3400:
            w[i] = 1.0
        else:
            w[i] = 0.5
    return w / np.sum(w)


def ncm_torch(clean: torch.Tensor, enhanced: torch.Tensor,
              fs: int = 8000) -> torch.Tensor:
    """NCM in [0, 1] of equal-length (..., N) waveforms, batched."""
    gfb = _gfb(fs)
    env_c = hilbert_envelope(gfb.filter(clean))       # (..., C, N)
    env_e = hilbert_envelope(gfb.filter(enhanced))
    xc = env_c - torch.mean(env_c, -1, keepdim=True)
    xe = env_e - torch.mean(env_e, -1, keepdim=True)
    cov = torch.mean(xc * xe, -1)
    denom = torch.sqrt(torch.mean(xc ** 2, -1) * torch.mean(xe ** 2, -1))
    ncc = torch.where(denom < 1e-10, torch.zeros_like(cov),
                      cov / torch.clamp(denom, min=1e-10))
    ncc = torch.clamp(ncc, -1.0, 1.0)
    w = torch.from_numpy(_channel_weights(gfb.center_freqs).astype(
        np.float32)).to(ncc.device)
    return torch.clamp(torch.sum(w * torch.clamp(ncc, min=0.0), -1), 0.0,
                       1.0)


def compute_ncm(clean_signal, enhanced_signal, fs: Optional[int] = None,
                device="cuda") -> float:
    """NCM of two host signals (cut to the shorter) on ``device``; 0.0 below
    64 samples."""
    fs = fs or AudioConfig().sample_rate
    m = min(len(clean_signal), len(enhanced_signal))
    if m < 64:
        return 0.0
    return float(ncm_torch(f32_on(np.asarray(clean_signal)[:m], device),
                           f32_on(np.asarray(enhanced_signal)[:m], device),
                           fs))
