"""Context-parallel depthwise convolution: halo exchange over a mesh axis
(``sincformer_tpu/ops/cp_conv.py``).

The Conformer's depthwise conv mixes a ±(k − 1)/2 neighbourhood in time,
so a rank that holds a block of frames needs its neighbours' edge frames.
Each rank sends its last (k − 1)/2 frames to the next rank and its first
(k − 1)/2 to the previous (``parallel.collectives.hop``, whose backward
sends the gradient back), zeroes the halo at the sequence's two ends (the
SAME padding of one process), and runs a VALID depthwise ``F.conv1d`` on
its block with the halo around it. The bias is added after the
convolution in the activation's dtype, as JAX's body adds it (in bfloat16
the convolution rounds before the bias, as the one-process
``models.conformer.DepthwiseConv`` rounds).

:func:`cp_depthwise_conv_in_mesh` takes this rank's block (the model
layer's call, ``models/conformer.DepthwiseConv`` under ``ops.ring_mesh``);
:func:`cp_depthwise_conv` takes the whole sequence, as every rank holds
it, checks JAX's conditions and returns this rank's block of the output.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from sincformer_tpu_torch.parallel import collectives


def cp_depthwise_conv_in_mesh(x: torch.Tensor, weight: torch.Tensor,
                              bias: Optional[torch.Tensor], mesh,
                              seq_axis: str = "data") -> torch.Tensor:
    """SAME-padded stride-1 depthwise conv of this rank's (B, Tl, C) block
    of frames by a (C, 1, k) weight, k odd, Tl at least (k - 1) / 2."""
    halo = (weight.shape[-1] - 1) // 2
    group = mesh.get_group(seq_axis)
    n = mesh.size(mesh.mesh_dim_names.index(seq_axis))
    r = mesh.get_local_rank(seq_axis)
    if halo > 0 and n > 1:
        # rank r receives rank r-1's tail as its left halo and rank r+1's
        # head as its right halo; the sequence's ends see zeros
        left = collectives.hop(x[:, -halo:].contiguous(), group, 1)
        right = collectives.hop(x[:, :halo].contiguous(), group, -1)
        left = left * (0.0 if r == 0 else 1.0)
        right = right * (0.0 if r == n - 1 else 1.0)
        x = torch.cat([left, x, right], dim=1)
    else:
        x = F.pad(x, (0, 0, halo, halo))
    y = F.conv1d(x.transpose(1, 2), weight.to(x.dtype), None,
                 groups=weight.shape[0])
    if bias is not None:    # after the rounded convolution, in its dtype
        y = y + bias.to(y.dtype)[:, None]
    return y.transpose(1, 2)


def cp_depthwise_conv(x: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor], mesh,
                      seq_axis: str = "data") -> torch.Tensor:
    """This rank's block of the SAME-padded stride-1 depthwise conv of the
    whole (B, T, C) sequence ``x`` by ``weight`` (C, 1, k), exchanging
    (k - 1)/2 halo frames over ``mesh[seq_axis]``. Raises for an even k,
    for a T that does not divide the axis size and for a block shorter
    than the halo, as JAX asserts."""
    k = weight.shape[-1]
    if k % 2 != 1:
        raise ValueError(f"odd kernel required, got {k}")
    halo = (k - 1) // 2
    n = mesh.size(mesh.mesh_dim_names.index(seq_axis))
    t = x.shape[1]
    if t % n:
        raise ValueError(f"T={t} must divide the '{seq_axis}' axis size {n}")
    if t // n < halo:
        raise ValueError(f"local block {t // n} shorter than halo {halo}: "
                         f"use fewer devices or a shorter kernel")
    r = mesh.get_local_rank(seq_axis)
    return cp_depthwise_conv_in_mesh(x[:, r * (t // n):(r + 1) * (t // n)],
                                     weight, bias, mesh, seq_axis)
