"""Episodic key-value memory (``sincformer_tpu/agents/memory.py``).

The static bank (parameters) and the episodic bank (buffers, the JAX
``memory_bank`` collection) are concatenated and read by cosine-similarity
softmax. A training forward first writes the episodic bank, then reads the
updated bank, and counts which slot each query hit (buffers, the JAX
``memory_stats`` collection). The write takes no gradient: the batch means
of the detached query and of the written value go into the least recently
used slot when the best cosine to a stored key is below 0.7 (a new
environment), and into that best slot by an EMA of momentum 0.5 otherwise.
In a data-parallel step the means and the counts are the global batch's
(``parallel/collectives.py``), so every rank writes the same bank. Under
tensor parallelism the projections compute their column blocks and the
key bank, split on its features, is gathered before the similarity
(``parallel/sharding.py``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from sincformer_tpu_torch.agents.perception import gelu
from sincformer_tpu_torch.models.conformer import LN_EPS
from sincformer_tpu_torch.parallel import collectives
from sincformer_tpu_torch.parallel import sharding as tp


WRITE_THRESHOLD = 0.7     # best cosine below this: a new environment
WRITE_MOMENTUM = 0.5      # EMA of a write into a known environment's slot


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

    @torch.no_grad()
    def _write(self, query: torch.Tensor, write_value: torch.Tensor) -> None:
        """One write of the batch means into the episodic bank, on the
        device, with no host synchronisation."""
        emb = collectives.mean(query.detach(), dim=0)
        val = collectives.mean(write_value.detach(), dim=0)
        en = emb / (torch.linalg.vector_norm(emb) + 1e-8)
        sims = _unit(self.bank_keys) @ en                   # (ep,)
        best = torch.argmax(sims)
        is_new = sims[best] < WRITE_THRESHOLD
        slot = torch.where(is_new, torch.argmax(self.bank_age), best)
        m = torch.where(is_new, 1.0, WRITE_MOMENTUM)
        one = F.one_hot(slot, self.episodic_slots).to(emb.dtype)[:, None]
        self.bank_keys.copy_(self.bank_keys * (1 - one * m)
                             + one * m * emb[None, :])
        self.bank_values.copy_(self.bank_values * (1 - one * m)
                               + one * m * val[None, :])
        self.bank_age.copy_((self.bank_age + 1.0) * (1.0 - one[:, 0]))

    def forward(self, embedding: torch.Tensor, train: bool = False,
                write_value: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        query = tp.linear(self.key_proj2, gelu(self.key_ln(
            tp.linear(self.key_proj1, embedding))))
        keys, values = tp.whole(self.keys), tp.whole(self.values)
        if self.episodic_slots > 0:
            if write_value is not None:
                self._write(query, write_value)
            keys = torch.cat([keys, self.bank_keys], dim=0)
            values = torch.cat([values, self.bank_values], dim=0)
        similarity = _unit(query) @ _unit(keys).T     # temperature 1
        retrieved = F.softmax(similarity, dim=-1) @ values
        bias = torch.tanh(tp.linear(self.value_proj, retrieved))
        gate = torch.sigmoid(tp.linear(self.gate, torch.cat(
            [query, retrieved], dim=-1)))
        top = torch.argmax(similarity, dim=-1)
        if train:
            with torch.no_grad():
                self.usage_count.add_(collectives.sum(F.one_hot(
                    top, self.usage_count.shape[0]).sum(0).to(
                        self.usage_count.dtype)))
                # the ranks of a data-parallel step hold equal blocks
                self.num_queries.add_(top.shape[0]
                                      * collectives.world_size())
        return {"bias": bias * gate, "gate": gate, "top_indices": top,
                "similarity": torch.max(similarity, dim=-1).values}
