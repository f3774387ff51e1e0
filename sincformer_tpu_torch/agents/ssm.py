"""Bidirectional linear-recurrent (LRU) sequence mixer
(``sincformer_tpu/agents/ssm.py``): the CPEA's ``impl="ssm"`` in place of
the BiLSTM, (B, T, D) → (B, T, 2·hidden).

Each ``LRULayer`` runs the diagonal complex recurrence
h_t = λ·h_{t-1} + γ·(x_t B), y_t = Re(h_t C) + D·x_t, with
λ = exp(-exp(ν) + i·exp(θ)) and γ = sqrt(1 - |λ|²), in pairs of real
planes (no complex dtype: its rounding differs from the JAX package's
real arithmetic), through :func:`associative_scan`, which combines in the
order the JAX package's ``lax.associative_scan`` does. ``B_*`` and ``C_*``
are kept in flax's (in, out) layout under flax's names, so their channel
is the last axis (``ops.quantize.channel_axis_of``), as the JAX package's
``quantize_tree`` takes it. Under tensor parallelism (``parallel/
sharding.py``) the Dense layers compute their column blocks and a split
``B_*`` or ``C_*`` is gathered before its product.
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sincformer_tpu_torch.models.conformer import LN_EPS
from sincformer_tpu_torch.parallel import sharding as tp

D_STATE = 128           # the JAX CPEA builds its BiLRU with this state size


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a0 b0 a1 b1 ... along dim 1; ``a`` may be one longer than ``b``."""
    m = b.shape[1]
    pairs = torch.stack([a[:, :m], b], 2).flatten(1, 2)
    if a.shape[1] == m:
        return pairs
    return torch.cat([pairs, a[:, m:]], 1)


def associative_scan(combine: Callable[[Sequence[torch.Tensor],
                                        Sequence[torch.Tensor]],
                                       List[torch.Tensor]],
                     elems: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Inclusive scan of the tuple ``elems`` along dim 1 under the
    associative ``combine(earlier, later)``, as ``lax.associative_scan``
    computes it: combine adjacent pairs, scan the half recursively (the odd
    results), form the even results from the odd ones and the elements
    after them (the first element passed through), and interleave; log2(T)
    levels of whole-tensor operations on strided slices."""
    n = elems[0].shape[1]
    if n < 2:
        return list(elems)
    reduced = combine([e[:, 0:n - 1:2] for e in elems],
                      [e[:, 1::2] for e in elems])
    odd = associative_scan(combine, reduced)
    after = [e[:, 2::2] for e in elems]
    if n % 2 == 0:
        even = combine([e[:, :-1] for e in odd], after)
    else:
        even = combine(odd, after)
    even = [torch.cat([e[:, :1], r], 1) for e, r in zip(elems, even)]
    return [_interleave(a, b) for a, b in zip(even, odd)]


def _combine(a, b):
    """λ = λ_b·λ_a and h = λ_b·h_a + h_b in real pairs (the JAX layer's
    expression order)."""
    alr, ali, abr, abi = a
    blr, bli, bbr, bbi = b
    return [blr * alr - bli * ali,
            blr * ali + bli * alr,
            blr * abr - bli * abi + bbr,
            blr * abi + bli * abr + bbi]


class LRULayer(nn.Module):
    """x (B, T, D) → y (B, T, D) along time (``reverse``: last to first)."""

    def __init__(self, d_model: int, d_state: int = D_STATE,
                 reverse: bool = False):
        super().__init__()
        self.reverse = reverse
        self.nu_log = nn.Parameter(torch.zeros(d_state))
        self.theta_log = nn.Parameter(torch.zeros(d_state))
        self.B_re = nn.Parameter(torch.zeros(d_model, d_state))
        self.B_im = nn.Parameter(torch.zeros(d_model, d_state))
        self.C_re = nn.Parameter(torch.zeros(d_state, d_model))
        self.C_im = nn.Parameter(torch.zeros(d_state, d_model))
        self.D = nn.Parameter(torch.ones(d_model))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mag = torch.exp(-torch.exp(self.nu_log))                  # |λ|
        theta = torch.exp(self.theta_log)
        lam_re, lam_im = mag * torch.cos(theta), mag * torch.sin(theta)
        gamma = torch.sqrt(torch.clamp(1.0 - mag * mag, min=1e-8))
        seq = torch.flip(x, dims=[1]) if self.reverse else x
        bx_re = (seq @ tp.whole(self.B_re)) * gamma                # (B,T,H)
        bx_im = (seq @ tp.whole(self.B_im)) * gamma
        lr, li = lam_re.expand_as(bx_re), lam_im.expand_as(bx_im)
        _, _, hr, hi = associative_scan(_combine, (lr, li, bx_re, bx_im))
        y = hr @ tp.whole(self.C_re) - hi @ tp.whole(self.C_im)    # Re(h·C)
        if self.reverse:
            y = torch.flip(y, dims=[1])
        return y + x * self.D

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "LRULayer":
        """flax's initialisers: |λ| uniform in [0.9, 0.999] by area, phase
        uniform in [1e-4, π/4], B and C LeCun normal over fan-in
        shape[0] (the (in, out) layout), D ones."""
        from sincformer_tpu_torch.models.init import variance_scaling_
        u = torch.rand(self.nu_log.shape, generator=generator)
        r_min, r_max = 0.9, 0.999
        radii = torch.sqrt(u * (r_max ** 2 - r_min ** 2) + r_min ** 2)
        self.nu_log.copy_(torch.log(-torch.log(radii)))
        u = torch.rand(self.theta_log.shape, generator=generator)
        self.theta_log.copy_(torch.log(1e-4 + u * (math.pi / 4 - 1e-4)))
        for w in (self.B_re, self.B_im, self.C_re, self.C_im):
            variance_scaling_(w, 1.0, generator, fan_in=w.shape[0])
        self.D.fill_(1.0)
        return self


class BiLRU(nn.Module):
    """(B, T, input_dim) → (B, T, 2·hidden): an input projection, then per
    layer LayerNorm → forward + backward LRU → GELU → Dense(4·hidden) →
    GLU, with a residual around it."""

    def __init__(self, input_dim: int = 256, hidden_size: int = 128,
                 num_layers: int = 2, d_state: int = D_STATE):
        super().__init__()
        d = 2 * hidden_size
        self.num_layers = num_layers
        self.in_proj = nn.Linear(input_dim, d)
        for i in range(num_layers):
            self.add_module(f"ln_{i}", nn.LayerNorm(d, eps=LN_EPS))
            self.add_module(f"lru_fwd_{i}", LRULayer(d, d_state, False))
            self.add_module(f"lru_bwd_{i}", LRULayer(d, d_state, True))
            self.add_module(f"glu_{i}", nn.Linear(d, 2 * d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = tp.linear(self.in_proj, x)
        for i in range(self.num_layers):
            residual = x
            x = getattr(self, f"ln_{i}")(x)
            x = getattr(self, f"lru_fwd_{i}")(x) + getattr(
                self, f"lru_bwd_{i}")(x)
            x = tp.linear(getattr(self, f"glu_{i}"),
                          F.gelu(x, approximate="tanh"))
            x = residual + F.glu(x, dim=-1)
        return x
