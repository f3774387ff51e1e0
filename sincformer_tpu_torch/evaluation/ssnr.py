"""Segmental SNR (``sincformer_tpu/evaluation/ssnr.py``): per frame
10·log10(Σ clean² / Σ (clean − enh)²), clipped to [-10, 35] dB (an error
power below 1e-10 gives the upper bound), frames whose clean power is below
1e-10 left out, the mean over the rest (0 when none is left)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sincformer_tpu_torch.config import AudioConfig
from sincformer_tpu_torch.evaluation.common import f32_on
from sincformer_tpu_torch.utils.signal import frame_signal


def ssnr_torch(clean: torch.Tensor, enhanced: torch.Tensor,
               frame_size: int = 160, hop: int = 80,
               upper_bound: float = 35.0, lower_bound: float = -10.0
               ) -> torch.Tensor:
    """SSNR in dB of equal-length (..., N) waveforms, batched over the
    leading axes: shape (...)."""
    cf = frame_signal(clean, frame_size, hop)
    ef = frame_signal(enhanced, frame_size, hop)
    speech_power = torch.sum(cf ** 2, dim=-1)
    error_power = torch.sum((cf - ef) ** 2, dim=-1)
    snr = 10.0 * torch.log10(torch.clamp(speech_power, min=1e-30)
                             / torch.clamp(error_power, min=1e-30))
    snr = torch.where(error_power < 1e-10,
                      torch.full_like(snr, upper_bound), snr)
    snr = torch.clamp(snr, lower_bound, upper_bound)
    voiced = speech_power >= 1e-10
    count = torch.sum(voiced, dim=-1)
    total = torch.sum(torch.where(voiced, snr, torch.zeros_like(snr)), dim=-1)
    return torch.where(count > 0, total / torch.clamp(count, min=1),
                       torch.zeros_like(total))


def compute_ssnr(clean_signal, enhanced_signal, fs: Optional[int] = None,
                 frame_size: Optional[int] = None,
                 hop_size: Optional[int] = None, upper_bound: float = 35.0,
                 lower_bound: float = -10.0, device="cuda") -> float:
    """SSNR of two host signals (cut to the shorter), computed on
    ``device``; 0.0 when not one frame fits."""
    acfg = AudioConfig()
    frame_size = frame_size or acfg.frame_size
    hop_size = hop_size or acfg.hop_size
    m = min(len(clean_signal), len(enhanced_signal))
    if (m - frame_size) // hop_size + 1 < 1:
        return 0.0
    return float(ssnr_torch(f32_on(np.asarray(clean_signal)[:m], device),
                            f32_on(np.asarray(enhanced_signal)[:m], device),
                            frame_size, hop_size, upper_bound, lower_bound))


def compute_ssnr_improvement(clean_signal, noisy_signal, enhanced_signal,
                             fs: Optional[int] = None,
                             device="cuda") -> float:
    """Output SSNR − input SSNR."""
    return (compute_ssnr(clean_signal, enhanced_signal, fs, device=device)
            - compute_ssnr(clean_signal, noisy_signal, fs, device=device))
