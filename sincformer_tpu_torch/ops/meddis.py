"""Meddis (1986) inner-hair-cell recurrence (kernel K4). Counterpart of
``sincformer_tpu/ops/meddis_pallas.py``.

Every signal of the input (..., N) carries a transmitter state (q, c, w)
from its steady state at zero input through N forward-Euler steps; the
output is the firing-rate probability ``h * c`` per sample. On a CUDA tensor
:func:`meddis` launches the hand-written kernel ``csrc/meddis.cu``: one
thread per signal carries the state in registers, 8 signals a block, so
that 16 requests of 64 channels fill 128 SMs; three other warps of the
block stage 128-sample tiles of k = s / (s + B) (the IEEE division stays off
the recurrence's chain) through a ring of four shared-memory slots with
mbarriers, so the walking warp waits for a tile only when it is late, and
never for the whole block. The recurrence's 17 dependent operations a step
bound it, not its bytes. On a CPU tensor :func:`meddis` runs
:func:`_meddis_plain`, a per-sample loop of tensor operations and the
counterpart of the ``lax.scan`` in ``sincformer_tpu/dsp/haircell.py``. There
is no fallback from one to the other. The kernel spells every operation with
a round-to-nearest intrinsic in the plain loop's order, so the two give the
same bits.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from sincformer_tpu_torch.ops import build

# Meddis (1986) constants; csrc/meddis.cu holds the same values
A, B, G = 5.0, 300.0, 2000.0
Y, L, R = 5.05, 2500.0, 6580.0
X, H, M = 66.31, 50000.0, 1.0


def steady_state():
    """(q0, c0, w0) at zero input."""
    k_ss = G * A / (A + B)
    q0 = M * Y * k_ss / (L * k_ss + Y * (L + R))
    c0 = q0 * k_ss / Y
    w0 = c0 * R / X
    return q0, c0, w0


def _dt(sample_rate: int) -> float:
    """1 / sample_rate rounded to float32 once, as both versions use it."""
    return float(np.float32(1.0 / sample_rate))


def _meddis_plain(signal: torch.Tensor, sample_rate: int = 8000
                  ) -> torch.Tensor:
    """Plain PyTorch version: one step of tensor operations per sample,
    over all leading dimensions at once."""
    x = signal.to(torch.float32)
    dt = _dt(sample_rate)
    q0, c0, w0 = steady_state()
    lead = x.shape[:-1]
    q = torch.full(lead, q0, dtype=torch.float32, device=x.device)
    c = torch.full(lead, c0, dtype=torch.float32, device=x.device)
    w = torch.full(lead, w0, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    for t in range(x.shape[-1]):
        s = torch.clamp(x[..., t] + A, min=0.0)
        k = s / (s + B)
        q = torch.clamp(q + dt * (Y * (M - q) + X * w - k * q), min=0.0)
        c = torch.clamp(c + dt * (k * q - L * c - R * c), min=0.0)
        w = torch.clamp(w + dt * (R * c - X * w), min=0.0)
        out[..., t] = H * c
    return out


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load("meddis").meddis_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int] + [ctypes.c_float] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def wave_columns() -> int:
    """How many signals one wave of the kernel's blocks holds on the current
    CUDA device (blocks resident per SM x SMs x signals per block)."""
    fn = build.load("meddis").meddis_wave_columns
    fn.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    columns = ctypes.c_longlong(0)
    err = fn(ctypes.byref(columns))
    if err != 0:
        raise RuntimeError(f"meddis_wave_columns failed: CUDA error {err}")
    return columns.value


def meddis(signal: torch.Tensor, sample_rate: int = 8000) -> torch.Tensor:
    """Meddis firing rate of a (..., N) float32 input, same shape.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (counted in ``meddis.launches``) or raises.
    """
    if signal.device.type == "cpu":
        return _meddis_plain(signal, sample_rate)
    if signal.device.type != "cuda":
        raise ValueError(f"meddis runs on cpu or cuda, not {signal.device}")
    if signal.dtype != torch.float32:
        raise TypeError(f"meddis kernel takes float32, got {signal.dtype}")
    if not signal.is_contiguous():
        raise ValueError("meddis kernel needs a contiguous tensor")
    if signal.ndim < 1 or signal.numel() == 0:
        raise ValueError(f"meddis kernel needs a non-empty (..., N) input, "
                         f"got shape {tuple(signal.shape)}")
    n = signal.shape[-1]
    if n >= 1 << 31:
        raise ValueError(f"meddis kernel takes N < 2^31 samples, got {n}")
    out = torch.empty_like(signal)
    q0, c0, w0 = steady_state()
    fn = _kernel()
    with torch.cuda.device(signal.device):
        stream = torch.cuda.current_stream(signal.device).cuda_stream
        err = fn(signal.data_ptr(), out.data_ptr(), signal.numel() // n, n,
                 _dt(sample_rate), q0, c0, w0, stream)
    if err != 0:
        raise RuntimeError(f"meddis kernel launch failed: CUDA error {err}")
    meddis.launches += 1
    return out


meddis.launches = 0
