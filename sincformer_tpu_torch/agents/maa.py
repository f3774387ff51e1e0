"""Metacognitive arbitration agent (``sincformer_tpu/agents/maa.py``),
inference branch: σ normalised by the running statistics carried over from
the JAX ``maa_stats`` collection → 3-layer MLP → one-hot argmax route over
{SOFT_MASK, RESAMPLE, HARD_MASK, ESCALATE}."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

SOFT_MASK, RESAMPLE, HARD_MASK, ESCALATE = 0, 1, 2, 3


class MetacognitiveArbitrationAgent(nn.Module):
    """σ (B, 1, T) or (B, T) → routing dict."""

    def __init__(self, hidden_dim: int = 64, num_classes: int = 4,
                 initial_threshold: float = 0.5):
        super().__init__()
        self.num_classes = num_classes
        # read by nothing, as in the JAX module; kept for checkpoint parity
        self.threshold = nn.Parameter(torch.tensor([initial_threshold]))
        self.fc1 = nn.Linear(1, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, hidden_dim)
        self.fc3 = nn.Linear(hidden_dim, num_classes)
        self.register_buffer("running_mean", torch.zeros(()))
        self.register_buffer("running_var", torch.ones(()))
        self.register_buffer("num_updates", torch.zeros((), dtype=torch.int32))

    def forward(self, sigma: torch.Tensor) -> Dict[str, torch.Tensor]:
        if sigma.ndim == 3:
            sigma = sigma[:, 0, :]
        normalized = ((sigma - self.running_mean)
                      / (torch.sqrt(self.running_var) + 1e-8))
        x = F.relu(self.fc1(normalized[..., None]))
        x = F.relu(self.fc2(x))
        logits = self.fc3(x)                              # (B, T, 4)
        decisions = torch.argmax(logits, dim=-1)
        return {"decisions": decisions,
                "probs": F.softmax(logits, dim=-1),
                "logits": logits,
                "route": F.one_hot(decisions, self.num_classes).to(logits.dtype),
                "confidence": torch.sigmoid(-normalized)}
