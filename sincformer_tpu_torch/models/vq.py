"""Scalar vector quantizer with a straight-through estimator
(``sincformer_tpu/models/vq.py``). Its codebook and commitment losses are
means over the batch's mask values, equal in shape on every rank of a
data-parallel step, so they stay local: the trainer averages the ranks'
gradients (``parallel/collectives.py``).

:class:`VQMaskQuantizer` puts a mask estimator in front of it (soft mask →
VQ → quantized mask); its parameters carry the flax names
(``mask_estimator.*``, ``vq.centroids``), and
``compat.from_jax.load_vq_mask_quantizer_from_jax`` carries a flax
``VQMaskQuantizer`` across."""

from __future__ import annotations

from typing import Mapping, Union

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

    @staticmethod
    def get_utilization(indices: torch.Tensor,
                        num_centroids: int = 3) -> torch.Tensor:
        """Fraction of the assignments that went to each centroid."""
        one_hot = F.one_hot(indices.reshape(-1).long(), num_centroids)
        return one_hot.to(torch.float32).mean(0)


def sorted_centroids(params: Union[nn.Module, Mapping]) -> torch.Tensor:
    """The centroid values sorted ascending, from a module holding a
    quantizer or a state dict (the first ``...centroids`` entry)."""
    items = (params.state_dict() if isinstance(params, nn.Module)
             else params).items()
    for name, value in items:
        if name.split(".")[-1] == "centroids":
            return torch.sort(torch.as_tensor(value).detach()).values
    raise KeyError("no centroids parameter found")


class VQMaskQuantizer(nn.Module):
    """mask_estimator → soft mask → VQ → quantized mask. The forward
    passes ``**est_kwargs`` to the estimator and returns (quantized,
    vq_loss), or (quantized, soft mask, vq_loss) with ``return_soft``."""

    def __init__(self, mask_estimator: nn.Module, num_centroids: int = 3,
                 commitment_weight: float = 0.25):
        super().__init__()
        self.mask_estimator = mask_estimator
        self.vq = VectorQuantizer(num_centroids, commitment_weight)

    def forward(self, x: torch.Tensor, return_soft: bool = False,
                **est_kwargs):
        soft_mask = self.mask_estimator(x, **est_kwargs)
        quantized, _indices, vq_loss = self.vq(soft_mask)
        if return_soft:
            return quantized, soft_mask, vq_loss
        return quantized, vq_loss
