"""Correlation-phase estimation agent (``sincformer_tpu/agents/cpea.py``):
a bidirectional sequence mixer over the PA latent, then four heads (sigmoid
correlations, tanh·π phases). ``impl="lstm"`` mixes with a BiLSTM,
``impl="ssm"`` with the bidirectional LRU of ``agents/ssm.py`` (submodule
``bilru``, as in JAX).

The JAX cells are flax ``LSTMCell`` trees (gates i, f, g, o; input kernels
without bias, recurrent kernels K with bias b), but the JAX CPEA recurs with
the matrix ``Dense(eye(H))`` = K + 1·bᵀ and adds b once more, so each gate
gets h·K + (Σ_j h_j)·b + b (ROADMAP.md Queue 3). :class:`FlaxBiLSTM` trains
K and b as the separate parameters they are in JAX and composes that matrix
in every forward, then runs PyTorch's LSTM (cuDNN on the card) on it. The
JAX cells ``LSTMCell_{0,1,2,3}`` are layer 0 forward, layer 0 backward,
layer 1 forward, layer 1 backward (compat/from_jax.py).

Tensor parallelism (``parallel/sharding.py``): each gate's kernels split on
their H outputs, so a rank holds its part of each of the four row blocks
of a folded matrix; the LSTM gathers them and runs whole (cuDNN takes the
whole matrix), and the heads compute their column blocks.
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, List

import torch
from torch import nn

from sincformer_tpu_torch.agents.ssm import BiLRU
from sincformer_tpu_torch.parallel import sharding as tp


class FlaxBiLSTM(nn.Module):
    """Bidirectional LSTM over (B, T, D) → (B, T, 2H) with the JAX CPEA's
    recurrent matrix.

    Parameters per layer l and direction (suffix ``""`` or ``"_reverse"``):
    ``weight_ih_l{l}`` (4H, D), ``kernel_hh_l{l}`` (4H, H) = Kᵀ and
    ``bias_hh_l{l}`` (4H,) = b; ``bias_ih_l{l}`` is a zero buffer (flax has
    no input-side bias). The state dict keeps ``torch.nn.LSTM``'s keys, with
    ``weight_hh_l{l}`` = Kᵀ + b·1ᵀ, the matrix the LSTM runs with: the form
    of the serving checkpoints and of :func:`compat.from_jax.load_from_jax`.
    Loading a ``weight_hh`` sets K = weight_hh − b·1ᵀ; loading a
    ``kernel_hh`` (a full training checkpoint, keyed by parameter name) sets
    K as it is.
    """

    def __init__(self, input_size: int, hidden_size: int, num_layers: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        g = 4 * hidden_size
        for layer in range(num_layers):
            d_in = input_size if layer == 0 else 2 * hidden_size
            for sfx in self._suffixes(layer):
                self.register_parameter(f"weight_ih{sfx}",
                                        nn.Parameter(torch.empty(g, d_in)))
                self.register_parameter(
                    f"kernel_hh{sfx}",
                    nn.Parameter(torch.empty(g, hidden_size)))
                self.register_parameter(f"bias_hh{sfx}",
                                        nn.Parameter(torch.zeros(g)))
                self.register_buffer(f"bias_ih{sfx}", torch.zeros(g))

    @staticmethod
    def _suffixes(layer: int) -> List[str]:
        return [f"_l{layer}", f"_l{layer}_reverse"]

    def _all_suffixes(self) -> List[str]:
        return [s for layer in range(self.num_layers)
                for s in self._suffixes(layer)]

    def recurrent_matrix(self, sfx: str) -> torch.Tensor:
        """Kᵀ + b·1ᵀ (4H, H): row g of the JAX matrix's column g."""
        return (tp.whole(getattr(self, f"kernel_hh{sfx}"))
                + getattr(self, f"bias_hh{sfx}")[:, None])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weights = []
        for sfx in self._all_suffixes():
            weights += [tp.whole(getattr(self, f"weight_ih{sfx}")),
                        self.recurrent_matrix(sfx),
                        getattr(self, f"bias_ih{sfx}"),
                        getattr(self, f"bias_hh{sfx}")]
        h0 = x.new_zeros(2 * self.num_layers, x.shape[0], self.hidden_size)
        with warnings.catch_warnings():
            # cuDNN copies the composed weights into its layout each call
            # (2 MB at the flagship's size) and warns that it does
            warnings.filterwarnings("ignore", "RNN module weights are not")
            out, _, _ = torch.lstm(x, (h0, h0), weights, True,
                                   self.num_layers, 0.0,
                                   torch.is_grad_enabled(), True, True)
        return out

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        for sfx in self._all_suffixes():
            w_hh = self.recurrent_matrix(sfx)
            for name, value in (
                    ("weight_ih", getattr(self, f"weight_ih{sfx}")),
                    ("weight_hh", w_hh),
                    ("bias_ih", getattr(self, f"bias_ih{sfx}")),
                    ("bias_hh", getattr(self, f"bias_hh{sfx}"))):
                destination[f"{prefix}{name}{sfx}"] = (
                    value if keep_vars and name != "weight_hh"
                    else value.detach())

    def _load_from_state_dict(self, state_dict, prefix, local_metadata,
                              strict, missing_keys, unexpected_keys,
                              error_msgs):
        for sfx in self._all_suffixes():
            w_key, k_key = f"{prefix}weight_hh{sfx}", f"{prefix}kernel_hh{sfx}"
            b_key = f"{prefix}bias_hh{sfx}"
            if w_key in state_dict and k_key not in state_dict \
                    and b_key in state_dict:
                state_dict[k_key] = (state_dict.pop(w_key)
                                     - state_dict[b_key][:, None])
        super()._load_from_state_dict(state_dict, prefix, local_metadata,
                                      strict, missing_keys, unexpected_keys,
                                      error_msgs)


class CorrelationPhaseEstimationAgent(nn.Module):
    """z (B, D, T) channels-first → dict of (B, T, output_channels)."""

    def __init__(self, input_dim: int = 256, hidden_size: int = 128,
                 num_layers: int = 2, output_channels: int = 64,
                 impl: str = "lstm"):
        super().__init__()
        if impl == "ssm":
            self.bilru = BiLRU(input_dim, hidden_size, num_layers)
        elif impl == "lstm":
            self.lstm = FlaxBiLSTM(input_dim, hidden_size, num_layers)
        else:
            raise ValueError(f"impl must be 'lstm' or 'ssm', got {impl!r}")
        self.impl = impl
        self.rho_s_head = nn.Linear(2 * hidden_size, output_channels)
        self.rho_n_head = nn.Linear(2 * hidden_size, output_channels)
        self.phi1_head = nn.Linear(2 * hidden_size, output_channels)
        self.phi2_head = nn.Linear(2 * hidden_size, output_channels)

    def forward(self, z: torch.Tensor) -> Dict[str, torch.Tensor]:
        mixer = self.bilru if self.impl == "ssm" else self.lstm
        x = mixer(z.transpose(1, 2))                      # (B, T, 2H)
        return {"rho_s": torch.sigmoid(tp.linear(self.rho_s_head, x)),
                "rho_n": torch.sigmoid(tp.linear(self.rho_n_head, x)),
                "phi1": torch.tanh(tp.linear(self.phi1_head, x)) * math.pi,
                "phi2": torch.tanh(tp.linear(self.phi2_head, x)) * math.pi}
