"""Ideal ratio mask (``sincformer_tpu/masks/irm.py``):
Z = (S² / (S² + N²))^p, elementwise on any shape."""

from __future__ import annotations

import torch


def compute_irm(clean_mag: torch.Tensor, noise_mag: torch.Tensor,
                p: float = 0.5, eps: float = 1e-10) -> torch.Tensor:
    """The IRM in [0, 1] of per-unit magnitudes (squared inside)."""
    clean_power = torch.abs(clean_mag) ** 2
    noise_power = torch.abs(noise_mag) ** 2
    ratio = clean_power / (clean_power + noise_power + eps)
    return torch.clamp(ratio ** p, 0.0, 1.0)


def apply_irm(noisy_tf: torch.Tensor, irm: torch.Tensor) -> torch.Tensor:
    """Enhanced = IRM ⊙ noisy."""
    return noisy_tf * irm
