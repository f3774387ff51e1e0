"""flax's variance-scaling initialisers (``lecun_normal``, ``he_normal``):
the weights that training from scratch starts from."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

# the std of a standard normal truncated to [-2, 2]: flax divides by it so
# that the truncated draw keeps the intended variance
TRUNC_STD = 0.87962566103423978


def variance_scaling_(p: torch.Tensor, scale: float,
                      generator: torch.Generator,
                      fan_in: Optional[int] = None) -> torch.Tensor:
    """Fill ``p`` (a torch weight (out, in, *kernel)) in place with flax's
    ``variance_scaling(scale, "fan_in", "truncated_normal")``: a standard
    normal truncated at ±2, times sqrt(scale / fan_in) / TRUNC_STD, with
    fan_in = in × prod(kernel) unless given (a matrix kept in flax's (in,
    out) layout has fan_in = shape[0]). ``scale`` 1 is ``lecun_normal``, 2
    ``he_normal``. Drawn on the CPU from ``generator`` and copied."""
    if fan_in is None:
        fan_in = math.prod(p.shape[1:])
    w = torch.empty(p.shape)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    with torch.no_grad():
        p.copy_(w * (math.sqrt(scale / fan_in) / TRUNC_STD))
    return p
