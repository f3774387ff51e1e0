"""Scalar vector quantizer with a straight-through estimator
(``sincformer_tpu/models/vq.py``). Its codebook and commitment losses are
means over the batch's mask values, equal in shape on every rank of a
data-parallel step, so they stay local: the trainer averages the ranks'
gradients (``parallel/collectives.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class VectorQuantizer(nn.Module):
    """Nearest of M learnable centroids for every mask value."""

    def __init__(self, num_centroids: int = 3, commitment_weight: float = 0.25):
        super().__init__()
        self.commitment_weight = commitment_weight
        self.centroids = nn.Parameter(torch.linspace(0.0, 1.0, num_centroids))

    def forward(self, x: torch.Tensor):
        """Returns (quantized, indices, vq_loss), as the JAX module does:
        the codebook loss pulls the centroids, the commitment loss (weighted)
        pulls x, and the quantized values pass x's gradient straight
        through."""
        indices = torch.argmin((x[..., None] - self.centroids) ** 2, dim=-1)
        # one-hot times the centroids, summed, picks each value exactly; its
        # backward is a reduction, where indexing's backward would scatter
        # every element into M slots
        q = (F.one_hot(indices, self.centroids.shape[0]).to(x.dtype)
             * self.centroids).sum(-1)
        codebook = torch.mean((x.detach() - q) ** 2)
        commitment = self.commitment_weight * torch.mean((x - q.detach()) ** 2)
        return x + (q - x).detach(), indices, commitment + codebook
