"""Mask-estimation DNN of the original paper
(``sincformer_tpu/models/dnn.py``): 594 context features → 3 × [1024, ReLU,
dropout 0.2] → 64 sigmoid mask values, one per gammatone channel.

The layers carry the flax names (``hidden_0`` .. ``hidden_2``, ``output``),
so a torch key is the flax path joined with dots. A forward given a
``generator`` is a training forward and draws its dropout masks from it;
without one it is deterministic. :func:`load_rbm_weights` puts
RBM-pretrained weights into the hidden layers.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from sincformer_tpu_torch.config import DNNConfig
from sincformer_tpu_torch.models.conformer import dropout
from sincformer_tpu_torch.models.init import variance_scaling_


class SpeechEnhancementDNN(nn.Module):
    """features (..., input_dim) → mask (..., output_dim) in [0, 1]."""

    def __init__(self, input_dim: int = 594, hidden_dim: int = 1024,
                 output_dim: int = 64, num_hidden_layers: int = 3,
                 dropout: float = 0.2):
        super().__init__()
        self.input_dim = input_dim
        self.hidden_dim = hidden_dim
        self.output_dim = output_dim
        self.num_hidden_layers = num_hidden_layers
        width = input_dim
        for i in range(num_hidden_layers):
            setattr(self, f"hidden_{i}", nn.Linear(width, hidden_dim))
            width = hidden_dim
        self.output = nn.Linear(width, output_dim)
        # holds the rate (``dropout.p``); the masks come from the forward's
        # generator, never from the module
        self.dropout = nn.Dropout(dropout)

    @property
    def sizes(self) -> dict:
        """The constructor's size arguments (a checkpoint's sidecar records
        them)."""
        return {"input_dim": self.input_dim, "hidden_dim": self.hidden_dim,
                "output_dim": self.output_dim,
                "num_hidden_layers": self.num_hidden_layers,
                "dropout": self.dropout.p}

    def init_params(self, generator: torch.Generator) -> "SpeechEnhancementDNN":
        """Seeded weights at flax's scales: He-normal hidden kernels,
        LeCun-normal output kernel; biases small but non-zero so that a
        misplaced bias shows."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if p.ndim == 2:
                    gain = 1.0 if name.startswith("output") else 2.0
                    p.copy_(torch.randn(p.shape, generator=generator)
                            * (gain / p.shape[1]) ** 0.5)
                else:
                    p.copy_(torch.randn(p.shape, generator=generator) * 0.1)
        return self

    def training_init(self, generator: torch.Generator
                      ) -> "SpeechEnhancementDNN":
        """The weights training starts from, drawn as flax draws them:
        ``he_normal`` hidden kernels and a ``lecun_normal`` output kernel
        (both truncated at 2σ), zero biases."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if p.ndim == 2:
                    variance_scaling_(
                        p, 1.0 if name.startswith("output") else 2.0,
                        generator)
                else:
                    p.zero_()
        return self

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.num_hidden_layers):
            x = dropout(torch.relu(getattr(self, f"hidden_{i}")(x)),
                        self.dropout.p, generator)
        return torch.sigmoid(self.output(x))


def create_dnn(feature_dim: int, mask_dim: Optional[int] = None,
               dcfg: DNNConfig = DNNConfig()) -> SpeechEnhancementDNN:
    """The paper's configuration at ``feature_dim`` inputs."""
    return SpeechEnhancementDNN(input_dim=feature_dim,
                                hidden_dim=dcfg.hidden_units,
                                output_dim=mask_dim or dcfg.output_dim,
                                num_hidden_layers=dcfg.hidden_layers,
                                dropout=dcfg.dropout)


@torch.no_grad()
def load_rbm_weights(model: SpeechEnhancementDNN,
                     rbm_weights: Sequence[Tuple]) -> SpeechEnhancementDNN:
    """Overwrite the hidden layers (not the output layer) with
    RBM-pretrained weights, in place: ``rbm_weights`` holds one (W (visible,
    hidden), visible bias, hidden bias) per layer, and layer i takes W as
    its kernel (``weight`` = Wᵀ) and the hidden bias as its bias. Extra
    RBM layers are ignored."""
    for i, (w, _vb, hb) in enumerate(rbm_weights):
        if i >= model.num_hidden_layers:
            break
        layer = getattr(model, f"hidden_{i}")
        layer.weight.copy_(torch.as_tensor(w).to(layer.weight).T)
        layer.bias.copy_(torch.as_tensor(hb).to(layer.bias))
    return model
