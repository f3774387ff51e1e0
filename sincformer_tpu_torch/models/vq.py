"""Scalar vector quantizer (``sincformer_tpu/models/vq.py``), forward only."""

from __future__ import annotations

import torch
from torch import nn


class VectorQuantizer(nn.Module):
    """Nearest of M learnable centroids for every mask value."""

    def __init__(self, num_centroids: int = 3, commitment_weight: float = 0.25):
        super().__init__()
        self.commitment_weight = commitment_weight
        self.centroids = nn.Parameter(torch.linspace(0.0, 1.0, num_centroids))

    def forward(self, x: torch.Tensor):
        """Returns (quantized, indices, vq_loss), as the JAX module does."""
        indices = torch.argmin((x[..., None] - self.centroids) ** 2, dim=-1)
        q = self.centroids[indices]
        err = torch.mean((x - q) ** 2)
        # x + (q - x): the straight-through form, rounded as in JAX
        return x + (q - x), indices, (1.0 + self.commitment_weight) * err
