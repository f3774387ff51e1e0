"""Metacognitive arbitration agent (``sincformer_tpu/agents/maa.py``): σ
normalised by running statistics (buffers, the JAX ``maa_stats``
collection) → 3-layer MLP → a route over {SOFT_MASK, RESAMPLE, HARD_MASK,
ESCALATE}.

At inference the route is the one-hot argmax of the logits. In training the
running statistics first take an EMA step (momentum 0.1) towards the
batch's, and σ is normalised by the stepped statistics, through which the
gradient flows back to σ, as in the JAX module (the buffers keep their
values only); then the route is Gumbel-softmax straight-through
(``routing="gumbel"``: the forward value is the one-hot argmax of the
perturbed softmax, the gradient the perturbed softmax's) or the softmax
probabilities themselves (``routing="softmax"``). In a data-parallel step
the batch's statistics are the global batch's (``parallel/collectives.py``),
as in JAX's sharded step. Its Dense layers go through
``parallel/sharding.py`` (tensor parallelism: ``fc1`` and ``fc2`` split at
64 features).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from sincformer_tpu_torch.parallel import collectives
from sincformer_tpu_torch.parallel import sharding as tp

SOFT_MASK, RESAMPLE, HARD_MASK, ESCALATE = 0, 1, 2, 3
MOMENTUM = 0.1            # EMA of the running σ statistics in training


def gumbel_uniform(shape, generator: torch.Generator,
                   device=None) -> torch.Tensor:
    """Uniform draws in [1e-10, 1), as the JAX module draws them."""
    u = torch.rand(shape, generator=generator, device=device)
    return torch.clamp(u * (1.0 - 1e-10) + 1e-10, min=1e-10)


class MetacognitiveArbitrationAgent(nn.Module):
    """σ (B, 1, T) or (B, T) → routing dict."""

    def __init__(self, hidden_dim: int = 64, num_classes: int = 4,
                 initial_threshold: float = 0.5, routing: str = "gumbel"):
        super().__init__()
        self.num_classes = num_classes
        self.routing = routing
        # read by nothing, as in the JAX module; kept for checkpoint parity
        self.threshold = nn.Parameter(torch.tensor([initial_threshold]))
        self.fc1 = nn.Linear(1, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, hidden_dim)
        self.fc3 = nn.Linear(hidden_dim, num_classes)
        self.register_buffer("running_mean", torch.zeros(()))
        self.register_buffer("running_var", torch.ones(()))
        self.register_buffer("num_updates", torch.zeros((), dtype=torch.int32))

    def forward(self, sigma: torch.Tensor, train: bool = False,
                tau=None, generator: Optional[torch.Generator] = None,
                uniform: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """``tau`` is the Gumbel temperature (a float or a 0-d tensor;
        default 1). A Gumbel training forward draws its uniforms from
        ``generator``, or takes them as ``uniform`` (the logits' shape)."""
        if sigma.ndim == 3:
            sigma = sigma[:, 0, :]
        mean, var = self.running_mean, self.running_var
        if train:
            mean = (1 - MOMENTUM) * mean + MOMENTUM * collectives.mean(sigma)
            var = (1 - MOMENTUM) * var + MOMENTUM * collectives.var(sigma)
            with torch.no_grad():
                self.running_mean.copy_(mean)
                self.running_var.copy_(var)
                self.num_updates.add_(1)
        normalized = (sigma - mean) / (torch.sqrt(var) + 1e-8)
        x = F.relu(tp.linear(self.fc1, normalized[..., None]))
        x = F.relu(tp.linear(self.fc2, x))
        logits = tp.linear(self.fc3, x)                   # (B, T, 4)
        probs = F.softmax(logits, dim=-1)
        if train and self.routing == "gumbel":
            if uniform is None:
                uniform = gumbel_uniform(logits.shape, generator,
                                         logits.device)
            g = -torch.log(-torch.log(uniform + 1e-10))
            y_soft = F.softmax((logits + g) / (1.0 if tau is None else tau),
                               dim=-1)
            y_hard = F.one_hot(torch.argmax(y_soft, dim=-1),
                               self.num_classes).to(y_soft.dtype)
            route = y_soft + (y_hard - y_soft).detach()
        elif train:
            route = probs
        else:
            route = F.one_hot(torch.argmax(logits, dim=-1),
                              self.num_classes).to(logits.dtype)
        decisions = torch.argmax(probs if train else logits, dim=-1)
        return {"decisions": decisions, "probs": probs, "logits": logits,
                "route": route, "confidence": torch.sigmoid(-normalized)}
