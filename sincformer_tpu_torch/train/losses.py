"""Training losses of the flagship (``sincformer_tpu/train/losses.py``):
SI-SNR, multi-resolution STFT, the mask MSE and the differentiable
perceptual STOI loss. Batched and differentiable; the STFTs go through
``dsp/stft.py``.

In a data-parallel step each rank computes these on its own rows. A mean
over equal per-rank shapes stays local, and the trainer averages the
ranks' gradients: SI-SNR (a mean over rows), the log-magnitude L1 of the
MR-STFT loss, the mask MSE and the perceptual STOI loss (means over rows
and the rest). So do the magnitude L1 and the VQ loss of the trainers.
The spectral convergence of the MR-STFT loss is a ratio of norms over the
whole batch: its two norms are global (``parallel/collectives.norm``)."""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from sincformer_tpu_torch.config import AudioConfig
from sincformer_tpu_torch.dsp.stft import stft
from sincformer_tpu_torch.parallel import collectives


def si_snr_loss(estimated: torch.Tensor, target: torch.Tensor,
                sample_mask: Optional[torch.Tensor] = None,
                eps: float = 1e-8) -> torch.Tensor:
    """Negative scale-invariant SNR in dB, mean over the batch.

    ``estimated``, ``target``: (..., N); ``sample_mask``: optional (..., N)
    0/1 validity mask of padded batches.
    """
    if sample_mask is not None:
        count = torch.clamp(torch.sum(sample_mask, -1, keepdim=True), min=1.0)
        t_mean = torch.sum(target * sample_mask, -1, keepdim=True) / count
        e_mean = torch.sum(estimated * sample_mask, -1, keepdim=True) / count
        target = (target - t_mean) * sample_mask
        estimated = (estimated - e_mean) * sample_mask
    else:
        target = target - torch.mean(target, -1, keepdim=True)
        estimated = estimated - torch.mean(estimated, -1, keepdim=True)
    dot = torch.sum(estimated * target, -1, keepdim=True)
    s_energy = torch.sum(target ** 2, -1, keepdim=True) + eps
    s_target = dot * target / s_energy
    e_noise = estimated - s_target
    si_snr = 10.0 * torch.log10(
        torch.sum(s_target ** 2, -1) / (torch.sum(e_noise ** 2, -1) + eps)
        + eps)
    return -torch.mean(si_snr)


def spectral_convergence(pred_mag: torch.Tensor, tgt_mag: torch.Tensor,
                         eps: float = 1e-8) -> torch.Tensor:
    """||tgt_mag - pred_mag|| / ||tgt_mag||, both norms over every rank's
    rows (``parallel/collectives.norm``)."""
    return (collectives.norm(tgt_mag - pred_mag)
            / (collectives.norm(tgt_mag) + eps))


def multi_resolution_stft_loss(predicted: torch.Tensor, target: torch.Tensor,
                               fft_sizes: Sequence[int] = (256, 512, 1024),
                               hop_sizes: Sequence[int] = (64, 128, 256),
                               win_sizes: Sequence[int] = (256, 512, 1024),
                               eps: float = 1e-8) -> torch.Tensor:
    """Spectral convergence plus log-magnitude L1 at three resolutions,
    averaged; ``predicted``, ``target``: (B, N)."""
    loss = 0.0
    for fft, hop, win in zip(fft_sizes, hop_sizes, win_sizes):
        # the default window is the periodic Hann of ``win`` samples
        pred_mag = torch.abs(stft(predicted, fft, hop, win))
        tgt_mag = torch.abs(stft(target, fft, hop, win))
        sc = spectral_convergence(pred_mag, tgt_mag, eps)
        lm = torch.mean(torch.abs(torch.log(pred_mag + eps)
                                  - torch.log(tgt_mag + eps)))
        loss = loss + sc + lm
    return loss / len(fft_sizes)


def mse_mask_loss(predicted_mask: torch.Tensor, oracle_mask: torch.Tensor,
                  frame_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean squared error of a mask against its oracle; ``frame_mask``
    (..., T) weights frames."""
    err = (predicted_mask - oracle_mask) ** 2
    if frame_mask is not None:
        w = frame_mask[..., None]
        return torch.sum(err * w) / torch.clamp(
            torch.sum(w) * err.shape[-1], min=1.0)
    return torch.mean(err)


_CENTER_FREQS = (150, 200, 250, 315, 400, 500, 630, 800,
                 1000, 1250, 1600, 2000, 2500, 3150)


@functools.lru_cache(maxsize=8)
def _third_octave_on(fs: int, n_fft: int, device: str,
                     dtype: torch.dtype) -> torch.Tensor:
    with torch.inference_mode(False), torch.no_grad():
        return torch.from_numpy(_third_octave_weights(fs, n_fft)).to(
            device, dtype)


def _third_octave_weights(fs: int, n_fft: int) -> np.ndarray:
    """(bands, n_freq) rectangular 1/3-octave bands, each normalised to
    sum 1 (an empty band stays zero)."""
    n_freq = n_fft // 2 + 1
    freqs = np.linspace(0, fs / 2, n_freq)
    w = np.zeros((len(_CENTER_FREQS), n_freq), dtype=np.float32)
    for i, cfreq in enumerate(_CENTER_FREQS):
        lo = cfreq / (2 ** (1 / 6))
        hi = cfreq * (2 ** (1 / 6))
        w[i] = ((freqs >= lo) & (freqs <= hi)).astype(np.float32)
    sums = w.sum(axis=1, keepdims=True)
    sums[sums == 0] = 1.0
    return (w / sums).astype(np.float32)


class PerceptualSTOILoss:
    """Differentiable STOI approximation on (B, F, T) magnitudes: 1/3-octave
    band envelopes → 30-frame segments → mean removal → β = 15 dB clipping
    → per band and segment correlation → negative mean."""

    def __init__(self, sample_rate: int | None = None,
                 n_fft: int | None = None, frame_len: int = 30,
                 beta: float = 15.0):
        acfg = AudioConfig()
        self.fs = sample_rate or acfg.sample_rate
        self.n_fft = n_fft or acfg.fft_size
        self.frame_len = frame_len
        self.beta = beta

    def __call__(self, enhanced_spec: torch.Tensor, clean_spec: torch.Tensor,
                 eps: float = 1e-8) -> torch.Tensor:
        w = _third_octave_on(self.fs, self.n_fft, str(clean_spec.device),
                             clean_spec.dtype)
        clean_env = torch.einsum("bf,...ft->...bt", w, clean_spec)
        enh_env = torch.einsum("bf,...ft->...bt", w, enhanced_spec)

        t = clean_env.shape[-1]
        num_seg = max(1, t // self.frame_len)
        t_use = num_seg * self.frame_len
        shape = clean_env.shape[:-1] + (num_seg, self.frame_len)
        clean_seg = clean_env[..., :t_use].reshape(shape)
        enh_seg = enh_env[..., :t_use].reshape(shape)

        clean_seg = clean_seg - torch.mean(clean_seg, -1, keepdim=True)
        enh_seg = enh_seg - torch.mean(enh_seg, -1, keepdim=True)

        clean_energy = torch.sqrt(torch.sum(clean_seg ** 2, -1, keepdim=True)
                                  + eps)
        enh_energy = torch.sqrt(torch.sum(enh_seg ** 2, -1, keepdim=True)
                                + eps)
        clip = 10 ** (self.beta / 20.0)
        scale = torch.clamp(clip * clean_energy / (enh_energy + eps), max=1.0)
        enh_clip = enh_seg * scale

        numer = torch.sum(clean_seg * enh_clip, -1)
        denom = (torch.sqrt(torch.sum(clean_seg ** 2, -1) + eps)
                 * torch.sqrt(torch.sum(enh_clip ** 2, -1) + eps))
        return -torch.mean(numer / (denom + eps))


def perceptual_stoi_loss(enhanced_spec: torch.Tensor, clean_spec: torch.Tensor,
                         fs: int | None = None,
                         n_fft: int | None = None) -> torch.Tensor:
    """:class:`PerceptualSTOILoss` at ``fs`` and ``n_fft`` (the audio
    defaults unless given), called once."""
    return PerceptualSTOILoss(fs, n_fft)(enhanced_spec, clean_spec)
