"""Meddis (1986) inner hair cell (``sincformer_tpu/dsp/haircell.py``): the
transmitter-reservoir ODE integrated by forward Euler over all channels and
batch elements at once.

The recurrence itself is ``ops/meddis.py``: on a CUDA tensor the hand-written
kernel K4 (the per-sample loop would be tens of thousands of dependent steps
of a dozen small launches), on a CPU tensor the plain per-sample loop.
"""

from __future__ import annotations

import torch

from sincformer_tpu_torch.ops.meddis import (A, B, G, H, L, M, R, X, Y,
                                             meddis, steady_state)
from sincformer_tpu_torch.utils.signal import frame_signal


class MeddisHairCell:
    """Meddis-1986 hair cell with the JAX package's parameter set."""

    def __init__(self, sample_rate: int = 8000):
        self.fs = sample_rate
        self.dt = 1.0 / sample_rate
        self.A, self.B, self.g = A, B, G
        self.y, self.l, self.r = Y, L, R
        self.x, self.h, self.M = X, H, M
        self.q0, self.c0, self.w0 = steady_state()

    def process(self, signal: torch.Tensor,
                backend: str = "scan") -> torch.Tensor:
        """Firing-rate probability of a (..., N) input, any leading
        dimensions (e.g. (B, C, N) filterbank output).

        ``backend`` ("scan" or "pallas" in the JAX package) chooses nothing
        here: the device does. A CUDA tensor goes through kernel K4 or
        raises, a CPU tensor through the per-sample loop.
        """
        if backend not in ("scan", "pallas"):
            raise ValueError(f"backend must be 'scan' or 'pallas', got "
                             f"{backend!r}")
        return meddis(signal.to(torch.float32).contiguous(), self.fs)

    def process_filterbank(self, filterbank_output: torch.Tensor
                           ) -> torch.Tensor:
        """(..., C, N) → (..., C, N) firing rates."""
        return self.process(filterbank_output)

    def process_to_frames(self, filterbank_output: torch.Tensor,
                          frame_size: int = 160,
                          hop_size: int = 80) -> torch.Tensor:
        """(..., C, N) → (..., C, T) mean firing rate per frame."""
        rates = self.process(filterbank_output)
        return frame_signal(rates, frame_size, hop_size).mean(dim=-1)
