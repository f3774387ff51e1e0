"""Episodic key-value memory (``sincformer_tpu/agents/memory.py``), read path.

At inference the static bank (parameters) and the episodic bank (buffers
carried over from the JAX ``memory_bank`` collection) are concatenated and
read by cosine-similarity softmax; nothing is written and the usage
counters (buffers from ``memory_stats``) are carried but not updated.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from sincformer_tpu_torch.agents.perception import gelu
from sincformer_tpu_torch.models.conformer import LN_EPS


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


class EpisodicMemory(nn.Module):
    """environment embedding (B, key_dim) → {bias, gate, top_indices, similarity}."""

    def __init__(self, key_dim: int = 256, value_dim: int = 129,
                 num_slots: int = 64, episodic_slots: int = 16):
        super().__init__()
        self.keys = nn.Parameter(torch.empty(num_slots, key_dim))
        self.values = nn.Parameter(torch.empty(num_slots, value_dim))
        self.key_proj1 = nn.Linear(key_dim, key_dim)
        self.key_ln = nn.LayerNorm(key_dim, eps=LN_EPS)
        self.key_proj2 = nn.Linear(key_dim, key_dim)
        self.value_proj = nn.Linear(value_dim, value_dim)
        self.gate = nn.Linear(key_dim + value_dim, 1)
        self.episodic_slots = episodic_slots
        if episodic_slots > 0:
            self.register_buffer("bank_keys", torch.zeros(episodic_slots, key_dim))
            self.register_buffer("bank_values",
                                 torch.zeros(episodic_slots, value_dim))
            self.register_buffer("bank_age", torch.full((episodic_slots,), 1e9))
        self.register_buffer("usage_count",
                             torch.zeros(num_slots + episodic_slots))
        self.register_buffer("num_queries", torch.zeros((), dtype=torch.int32))

    def forward(self, embedding: torch.Tensor) -> Dict[str, torch.Tensor]:
        query = self.key_proj2(gelu(self.key_ln(self.key_proj1(embedding))))
        keys, values = self.keys, self.values
        if self.episodic_slots > 0:
            keys = torch.cat([keys, self.bank_keys], dim=0)
            values = torch.cat([values, self.bank_values], dim=0)
        similarity = _unit(query) @ _unit(keys).T     # temperature 1
        retrieved = F.softmax(similarity, dim=-1) @ values
        bias = torch.tanh(self.value_proj(retrieved))
        gate = torch.sigmoid(self.gate(torch.cat([query, retrieved], dim=-1)))
        return {"bias": bias * gate, "gate": gate,
                "top_indices": torch.argmax(similarity, dim=-1),
                "similarity": torch.max(similarity, dim=-1).values}
