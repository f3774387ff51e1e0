"""Correlation-phase estimation agent (``sincformer_tpu/agents/cpea.py``),
``impl="lstm"``: a bidirectional LSTM over the PA latent, then four heads
(sigmoid correlations, tanh·π phases).

``torch.nn.LSTM`` has flax ``LSTMCell``'s gate order (i, f, g, o) and the
same cell update; the JAX cells ``LSTMCell_{0,1,2,3}`` are layer 0 forward,
layer 0 backward, layer 1 forward, layer 1 backward (compat/from_jax.py).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn


class CorrelationPhaseEstimationAgent(nn.Module):
    """z (B, D, T) channels-first → dict of (B, T, output_channels)."""

    def __init__(self, input_dim: int = 256, hidden_size: int = 128,
                 num_layers: int = 2, output_channels: int = 64):
        super().__init__()
        self.lstm = nn.LSTM(input_dim, hidden_size, num_layers,
                            batch_first=True, bidirectional=True)
        self.rho_s_head = nn.Linear(2 * hidden_size, output_channels)
        self.rho_n_head = nn.Linear(2 * hidden_size, output_channels)
        self.phi1_head = nn.Linear(2 * hidden_size, output_channels)
        self.phi2_head = nn.Linear(2 * hidden_size, output_channels)

    def forward(self, z: torch.Tensor) -> Dict[str, torch.Tensor]:
        x, _ = self.lstm(z.transpose(1, 2))               # (B, T, 2H)
        return {"rho_s": torch.sigmoid(self.rho_s_head(x)),
                "rho_n": torch.sigmoid(self.rho_n_head(x)),
                "phi1": torch.tanh(self.phi1_head(x)) * math.pi,
                "phi2": torch.tanh(self.phi2_head(x)) * math.pi}
