"""Int8 weight quantization with per-channel scales and stochastic rounding
(kernel K2). Counterpart of ``sincformer_tpu/ops/quantize.py``.

The purpose is storage: a serving checkpoint four times smaller. Stochastic
rounding keeps the rounding error zero-mean.

  * :func:`quantize_int8` - (R, C) f32 -> (int8 values, f32 scales, one per
    output channel). The scale ``max(amax, 1e-12) / 127`` is a ``torch.amax``
    (the JAX package computes it outside its kernel too); the rounding is the
    hand-written kernel ``csrc/quantize_int8.cu`` on a CUDA tensor and
    :func:`_quantize_plain` on a CPU tensor. Both draw their random bits from
    Philox-4x32-10 keyed by ``(seed, flat element index // 4)``, so they give
    the same int8 values; the JAX package's stream (the TPU's generator, or
    threefry on the CPU) cannot be matched and is not.
  * :func:`dequantize_int8` - the inverse.
  * :func:`quantize_tree` / :func:`dequantize_tree` - over a flat
    ``{name: tensor}`` dictionary of parameters: leaves with ``ndim >= 2`` and
    at least 4096 elements become ``{"q": int8, "s": f32, "axis": int}``,
    the rest stay f32.

Where the output channel lies: the JAX package keeps Dense kernels as
(in, out) and conv kernels as (k, in, out) and scales along the last axis.
The port's ``weight`` tensors are (out, in) and (out, in, k), so their
channel axis is 0 and ``s`` has the JAX package's length and values. Other
matrices (the memory banks) keep the JAX layout and scale along their last
axis.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Mapping, Tuple, Union

import torch

from sincformer_tpu_torch.ops import build

MIN_QUANT_SIZE = 4096
_M32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85

QuantLeaf = Dict[str, Union[torch.Tensor, int]]


def _mulhilo32(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """High and low 32 bits of ``m * x`` for a 32-bit constant ``m`` and
    32-bit values held in int64, without overflowing int64: the constant is
    split in 16-bit halves."""
    p0 = x * (m & 0xFFFF)               # < 2^48
    p1 = x * (m >> 16)                  # < 2^48
    hi = ((p0 >> 16) + p1) >> 16
    lo = (p0 + ((p1 & 0xFFFF) << 16)) & _M32
    return hi, lo


def _philox4x32_10(counter: torch.Tensor, seed: int) -> torch.Tensor:
    """Philox-4x32-10 (Salmon et al., SC 2011) of the counters
    ``(counter, 0, 0)`` (``counter`` int64, non-negative; low and high word)
    under the key ``seed`` (64 bits). Returns (len(counter), 4) int64 words
    in [0, 2^32)."""
    c0, c1 = counter & _M32, counter >> 32
    c2 = torch.zeros_like(counter)
    c3 = torch.zeros_like(counter)
    k0, k1 = seed & _M32, (seed >> 32) & _M32
    for _ in range(10):
        hi0, lo0 = _mulhilo32(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W0) & _M32, (k1 + _PHILOX_W1) & _M32
    return torch.stack([c0, c1, c2, c3], dim=1)


def _quantize_plain(x: torch.Tensor, scale: torch.Tensor,
                    seed: int) -> torch.Tensor:
    """Plain PyTorch stochastic rounding: ``x`` (R, C) f32, ``scale``
    broadcastable to it ((R, 1) or (1, C)); element i of the flattened
    matrix takes word ``i % 4`` of the Philox block of counter ``i // 4``."""
    n = x.numel()
    counter = torch.arange((n + 3) // 4, dtype=torch.int64, device=x.device)
    bits = _philox4x32_10(counter, seed).reshape(-1)[:n].reshape(x.shape)
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    scaled = torch.clamp(x / scale, -127.0, 127.0)
    floor = torch.floor(scaled)
    return (floor + (u < scaled - floor).to(torch.float32)).to(torch.int8)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load("quantize_int8").quantize_int8_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_ulonglong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def quantize_int8(x: torch.Tensor, seed: int = 0, channel_axis: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, C) f32 -> (int8 (R, C), f32 scales (x.shape[channel_axis],)).

    ``channel_axis=0`` scales each row (the port's (out, in) weights),
    ``channel_axis=1`` each column (the JAX package's (in, out) layout).
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (counted in ``quantize_int8.launches``) or raises.
    """
    if x.ndim != 2:
        raise ValueError(f"quantize_int8 takes a matrix, got shape "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"quantize_int8 takes float32, got {x.dtype}")
    if channel_axis not in (0, 1):
        raise ValueError(f"channel_axis must be 0 or 1, got {channel_axis}")
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed must fit 64 unsigned bits, got {seed}")
    amax = x.abs().amax(dim=1 - channel_axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    if x.device.type == "cpu":
        return _quantize_plain(x, scale, seed), scale.reshape(-1)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_int8 runs on cpu or cuda, not {x.device}")
    if not x.is_contiguous():
        raise ValueError("quantize_int8 kernel needs a contiguous matrix")
    if x.numel() == 0:
        raise ValueError("quantize_int8 kernel needs a non-empty matrix")
    scales = scale.reshape(-1).contiguous()
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), scales.data_ptr(), out.data_ptr(),
                 x.shape[0], x.shape[1], int(channel_axis == 0), seed, stream)
    if err != 0:
        raise RuntimeError(f"quantize_int8 kernel launch failed: CUDA error "
                           f"{err}")
    quantize_int8.launches += 1
    return out, scales


quantize_int8.launches = 0


def dequantize_int8(vals: torch.Tensor, scales: torch.Tensor,
                    channel_axis: int = 0,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_int8` for a matrix."""
    s = scales.to(dtype)
    return vals.to(dtype) * (s[:, None] if channel_axis == 0 else s[None, :])


def channel_axis_of(name: str, ndim: int) -> int:
    """Output-channel axis of the parameter ``name``: 0 for the port's
    ``weight`` tensors (Linear, Conv1d, LSTM ``weight_ih``/``weight_hh``),
    the last axis for matrices kept in the JAX layout."""
    leaf = name.rsplit(".", 1)[-1]
    return 0 if leaf == "weight" or leaf.startswith("weight_") else ndim - 1


def is_quantized(node) -> bool:
    return isinstance(node, Mapping) and set(node) == {"q", "s", "axis"}


def quantize_tree(params: Mapping[str, torch.Tensor], seed: int = 0
                  ) -> Dict[str, Union[torch.Tensor, QuantLeaf]]:
    """Quantize every leaf with ``ndim >= 2`` and at least 4096 elements per
    output channel; smaller leaves stay as they are. The k-th quantized leaf
    (from 1, in the dictionary's order) is rounded under ``seed + k``."""
    out, k = {}, 0
    for name, leaf in params.items():
        if leaf.ndim >= 2 and leaf.numel() >= MIN_QUANT_SIZE:
            k += 1
            axis = channel_axis_of(name, leaf.ndim)
            if axis == 0:
                mat = leaf.detach().reshape(leaf.shape[0], -1)
            else:
                mat = leaf.detach().reshape(-1, leaf.shape[-1])
            vals, scales = quantize_int8(mat.contiguous(), seed + k,
                                         channel_axis=0 if axis == 0 else 1)
            out[name] = {"q": vals.reshape(leaf.shape), "s": scales,
                         "axis": axis}
        else:
            out[name] = leaf.detach()
    return out


def dequantize_tree(tree: Mapping[str, Union[torch.Tensor, QuantLeaf]],
                    dtype: torch.dtype = torch.float32
                    ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`quantize_tree`; raw leaves pass through."""
    out = {}
    for name, node in tree.items():
        if is_quantized(node):
            q, axis = node["q"], int(node["axis"])
            shape = [1] * q.ndim
            shape[axis] = q.shape[axis]
            out[name] = q.to(dtype) * node["s"].to(dtype).reshape(shape)
        else:
            out[name] = node
    return out
