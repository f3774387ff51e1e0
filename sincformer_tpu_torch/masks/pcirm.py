"""Phase-correlation ideal ratio mask (``sincformer_tpu/masks/pcirm.py``):
the oracle of the mask DNN's training data and of flagship training's mask
loss, and its application:

    Z = ρs·|Cs·cos φ1|² / (ρs·|Cs·cos φ1|² + ρn·|Zn·cos φ2|²)
"""

from __future__ import annotations

import torch


def compute_correlation_coefficients(noisy_frames, clean_frames, noise_frames,
                                     eps: float = 1e-10,
                                     per_unit: bool | None = None):
    """ρs, ρn per time-frequency unit, clipped to [0, 1].

    ``per_unit=True`` (the default for 2-D input) takes the elementwise
    normalised product of per-unit magnitudes, as batched (B, C, T) input
    needs too; otherwise the inner product over the last (sample) axis.
    """
    if per_unit is None:
        per_unit = noisy_frames.ndim < 3
    if not per_unit:
        inner_s = torch.sum(noisy_frames * clean_frames, dim=-1)
        norm_ns = torch.sqrt(torch.sum(noisy_frames ** 2, dim=-1) + eps)
        norm_cs = torch.sqrt(torch.sum(clean_frames ** 2, dim=-1) + eps)
        rho_s = inner_s / (norm_ns * norm_cs)
        inner_n = torch.sum(noisy_frames * noise_frames, dim=-1)
        norm_zn = torch.sqrt(torch.sum(noise_frames ** 2, dim=-1) + eps)
        rho_n = inner_n / (norm_ns * norm_zn)
    else:
        rho_s = (noisy_frames * clean_frames) / (
            torch.sqrt(noisy_frames ** 2 + eps)
            * torch.sqrt(clean_frames ** 2 + eps))
        rho_n = (noisy_frames * noise_frames) / (
            torch.sqrt(noisy_frames ** 2 + eps)
            * torch.sqrt(noise_frames ** 2 + eps))
    return (torch.clamp(torch.abs(rho_s), 0.0, 1.0),
            torch.clamp(torch.abs(rho_n), 0.0, 1.0))


def compute_phase_differences(noisy_phase, clean_phase, noise_phase):
    """φ1 = clean − noisy, φ2 = noise − noisy."""
    return clean_phase - noisy_phase, noise_phase - noisy_phase


def compute_pcirm(clean_mag, noise_mag, rho_s, rho_n, phi1, phi2,
                  eps: float = 1e-10):
    """The soft mask in [0, 1]."""
    speech = rho_s * (torch.abs(clean_mag) * torch.abs(torch.cos(phi1))) ** 2
    noise = rho_n * (torch.abs(noise_mag) * torch.abs(torch.cos(phi2))) ** 2
    return torch.clamp(speech / (speech + noise + eps), 0.0, 1.0)


def compute_pcirm_from_signals(noisy_frames, clean_frames, noise_frames,
                               noisy_phase, clean_phase, noise_phase,
                               clean_mag, noise_mag, eps: float = 1e-10):
    """The PCIRM from frames, phases and magnitudes in one call: (pcirm,
    ρs, ρn, φ1, φ2)."""
    rho_s, rho_n = compute_correlation_coefficients(
        noisy_frames, clean_frames, noise_frames, eps)
    phi1, phi2 = compute_phase_differences(noisy_phase, clean_phase,
                                           noise_phase)
    pcirm = compute_pcirm(clean_mag, noise_mag, rho_s, rho_n, phi1, phi2, eps)
    return pcirm, rho_s, rho_n, phi1, phi2


def apply_pcirm(noisy_tf, pcirm):
    """Enhanced = PCIRM ⊙ noisy."""
    return noisy_tf * pcirm
