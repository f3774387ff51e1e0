"""Int8 weight quantization with per-channel scales and stochastic rounding
(kernel K2). Counterpart of ``sincformer_tpu/ops/quantize.py``.

The purpose is storage: a serving checkpoint four times smaller. Stochastic
rounding keeps the rounding error zero-mean.

  * :func:`quantize_int8` - (R, C) f32 -> (int8 values, f32 scales, one per
    output channel ``max(amax, 1e-12) / 127``). On a CPU tensor the scale
    is a ``torch.amax`` and the rounding :func:`_quantize_plain`; on a CUDA
    tensor the matrix is a tree of one leaf for the kernel below. Both draw
    their random bits from Philox-4x32-10 keyed by ``(seed, flat element
    index // 4)``, so they give the same int8 values and the same scales;
    the JAX package's stream (the TPU's generator, or threefry on the CPU)
    cannot be matched and is not.
  * :func:`dequantize_int8` - the inverse.
  * :func:`quantize_tree` / :func:`dequantize_tree` - over a flat
    ``{name: tensor}`` dictionary of parameters: leaves with ``ndim >= 2`` and
    at least 4096 elements become ``{"q": int8, "s": f32, "axis": int}``,
    the rest stay f32. On the card the whole tree is one launch of the
    hand-written kernel ``csrc/quantize_int8.cu``, amax and scale inside,
    over a table of the leaves (:func:`work_table`) copied to the card in
    one copy; on the CPU the leaves go one by one through the plain version.

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
import math
import struct
from typing import Dict, List, Mapping, NamedTuple, Sequence, Tuple, Union

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


class WorkEntry(NamedTuple):
    """One quantized leaf of a tree, as the kernel's table holds it: the
    leaf as an (rows, cols) matrix scaled along ``axis`` (0: one scale per
    row, 1: one per column), its Philox key, and its blocks: each block
    takes ``unit`` rows (axis 0) or a strip of ``unit`` columns over all
    rows (axis 1)."""
    name: str
    rows: int
    cols: int
    axis: int
    key: int
    unit: int
    first_block: int
    n_blocks: int


_BLOCK_THREADS = 256      # csrc/quantize_int8.cu: kThreads
_STRIP = 128              # csrc/quantize_int8.cu: kStrip
_ENTRY = struct.Struct("<QQQqqQiiq")      # csrc/quantize_int8.cu: Leaf


def is_quantizable(shape: Sequence[int]) -> bool:
    """A leaf with ``ndim >= 2`` and at least 4096 elements is quantized."""
    return len(shape) >= 2 and math.prod(shape) >= MIN_QUANT_SIZE


def _rows_per_block(cols: int) -> int:
    """Rows of an axis-0 leaf per block: as many as keep at most four
    float4 per thread and row (1, 2, 4 or 8)."""
    unit = 8
    while unit > 1 and (_BLOCK_THREADS // unit) * 16 < cols:
        unit //= 2
    return unit


def work_table(shapes: Mapping[str, Sequence[int]], seed: int = 0
               ) -> Tuple[List[WorkEntry], int]:
    """The kernel's work table for a tree of leaves of these shapes, in the
    dictionary's order: one entry per quantized leaf (the k-th, from 1,
    keyed by ``seed + k``), and the total number of blocks."""
    entries, k, blocks = [], 0, 0
    for name, shape in shapes.items():
        if not is_quantizable(shape):
            continue
        k += 1
        axis = channel_axis_of(name, len(shape))
        if axis == 0:
            rows = int(shape[0])
            cols = math.prod(shape) // rows
            unit = _rows_per_block(cols)
            n = -(-rows // unit)
        else:
            cols = int(shape[-1])
            rows = math.prod(shape) // cols
            unit = _STRIP
            n = -(-cols // unit)
        entries.append(WorkEntry(name, rows, cols, 0 if axis == 0 else 1,
                                 seed + k, unit, blocks, n))
        blocks += n
    return entries, blocks


def block_span(entry: WorkEntry, block: int) -> Tuple[slice, slice]:
    """(rows, columns) of the leaf's matrix that its ``block``-th block
    (counted within the leaf) rounds, as the kernel computes them."""
    lo = block * entry.unit
    if entry.axis == 0:
        return slice(lo, min(lo + entry.unit, entry.rows)), slice(0, entry.cols)
    return slice(0, entry.rows), slice(lo, min(lo + entry.unit, entry.cols))


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = build.load("quantize_int8")
    fn = lib.quantize_tree_fwd
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    launch = lib.quantize_tree_launch
    launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_void_p]
    launch.restype = ctypes.c_int
    return fn, launch


class _CardTree(NamedTuple):
    """A tree's call on the card: the packed table, its device copy, the
    leaves' matrices and outputs."""
    table: bytes
    table_dev: torch.Tensor
    n_leaves: int
    n_blocks: int
    mats: List[torch.Tensor]
    outs: List[Tuple[torch.Tensor, torch.Tensor]]


def _card_tree(mats: Sequence[torch.Tensor], entries: Sequence[WorkEntry],
               n_blocks: int) -> _CardTree:
    """Allocate each leaf's int8 values (in the leaf's shape) and scales
    (separate tensors: a view into one buffer would make ``torch.save``
    write the whole buffer with every leaf) and pack the table. ``mats``
    are the contiguous leaves, the matrix of ``entries`` in any shape."""
    device = mats[0].device
    outs, packed = [], []
    for mat, e in zip(mats, entries):
        if mat.dtype != torch.float32:
            raise TypeError(f"quantize_int8 kernel takes float32, {e.name} is "
                            f"{mat.dtype}")
        if mat.device != device:
            raise ValueError(f"{e.name} is on {mat.device}, the tree on "
                             f"{device}")
        q = torch.empty(mat.shape, dtype=torch.int8, device=device)
        s = torch.empty(e.rows if e.axis == 0 else e.cols,
                        dtype=torch.float32, device=device)
        outs.append((q, s))
        packed.append(_ENTRY.pack(mat.data_ptr(), q.data_ptr(), s.data_ptr(),
                                  e.rows, e.cols, e.key, e.axis, e.unit,
                                  e.first_block))
    table = b"".join(packed)
    table_dev = torch.empty(len(table), dtype=torch.uint8, device=device)
    return _CardTree(table, table_dev, len(entries), n_blocks, list(mats),
                     outs)


def _matrix_call(x: torch.Tensor, seed: int, channel_axis: int
                 ) -> _CardTree:
    """One (R, C) matrix on the card as a tree of one leaf keyed by
    ``seed``."""
    rows, cols = x.shape
    unit = _rows_per_block(cols) if channel_axis == 0 else _STRIP
    n = -(-(rows if channel_axis == 0 else cols) // unit)
    entry = WorkEntry("x", rows, cols, channel_axis, seed, unit, 0, n)
    return _card_tree([x], [entry], n)


def _launch(call: _CardTree) -> None:
    """One copy of the table to the card and one launch (counted in
    ``quantize_int8.launches``)."""
    fn, _ = _kernel()
    device = call.table_dev.device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(call.table, call.table_dev.data_ptr(), call.n_leaves,
                 call.n_blocks, stream)
    if err != 0:
        raise RuntimeError(f"quantize_int8 kernel launch failed: CUDA error "
                           f"{err}")
    quantize_int8.launches += 1


def _launch_on_device_table(call: _CardTree) -> None:
    """The launch alone, over a table already copied by :func:`_launch`
    (for timing the kernel from CUDA-graph replays; not counted)."""
    _, launch = _kernel()
    err = launch(call.table_dev.data_ptr(), call.n_leaves, call.n_blocks,
                 torch.cuda.current_stream(call.table_dev.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quantize_int8 kernel launch failed: CUDA error "
                           f"{err}")


def _check_seed(seed: int, last_key: int) -> None:
    if seed < 0 or last_key >= 1 << 64:
        raise ValueError(f"seed must fit 64 unsigned bits with the leaf "
                         f"count added, got {seed}")


def _plain_scale(x: torch.Tensor, channel_axis: int) -> torch.Tensor:
    amax = x.abs().amax(dim=1 - channel_axis, keepdim=True)
    return torch.clamp(amax, min=1e-12) / 127.0


def quantize_int8(x: torch.Tensor, seed: int = 0, channel_axis: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, C) f32 -> (int8 (R, C), f32 scales (x.shape[channel_axis],)).

    ``channel_axis=0`` scales each row (the port's (out, in) weights),
    ``channel_axis=1`` each column (the JAX package's (in, out) layout).
    A CPU tensor takes the plain version; a CUDA tensor is a tree of one
    leaf: one launch of the kernel, amax and scale inside (counted in
    ``quantize_int8.launches``), or an error.
    """
    if x.ndim != 2:
        raise ValueError(f"quantize_int8 takes a matrix, got shape "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"quantize_int8 takes float32, got {x.dtype}")
    if channel_axis not in (0, 1):
        raise ValueError(f"channel_axis must be 0 or 1, got {channel_axis}")
    _check_seed(seed, seed)
    if x.device.type == "cpu":
        scale = _plain_scale(x, channel_axis)
        return _quantize_plain(x, scale, seed), scale.reshape(-1)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_int8 runs on cpu or cuda, not {x.device}")
    if not x.is_contiguous():
        raise ValueError("quantize_int8 kernel needs a contiguous matrix")
    if x.numel() == 0:
        raise ValueError("quantize_int8 kernel needs a non-empty matrix")
    call = _matrix_call(x, seed, channel_axis)
    _launch(call)
    return call.outs[0]


quantize_int8.launches = 0


def dequantize_int8(vals: torch.Tensor, scales: torch.Tensor,
                    channel_axis: int = 0,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_int8` for a matrix."""
    s = scales.to(dtype)
    return vals.to(dtype) * (s[:, None] if channel_axis == 0 else s[None, :])


def channel_axis_of(name: str, ndim: int) -> int:
    """Output-channel axis of the parameter ``name``: 0 for the port's
    ``weight`` tensors (Linear, Conv1d, LSTM ``weight_ih``/``weight_hh``)
    and the CPEA's recurrent kernels ``kernel_hh`` (Kᵀ, gate units first),
    the last axis for matrices kept in the JAX layout (the memory banks,
    the BiLRU's ``B_*`` and ``C_*``)."""
    leaf = name.rsplit(".", 1)[-1]
    return 0 if leaf == "weight" or leaf.startswith(("weight_", "kernel_hh")) \
        else ndim - 1


def is_quantized(node) -> bool:
    return isinstance(node, Mapping) and set(node) == {"q", "s", "axis"}


def _contiguous(leaf: torch.Tensor) -> torch.Tensor:
    return leaf if leaf.is_contiguous() else leaf.detach().contiguous()


def _compact(leaf: torch.Tensor) -> torch.Tensor:
    """A leaf kept as it is, holding only its own bytes: a view into a
    larger storage (on the card, cuDNN's flat LSTM weights hold the LSTM
    biases) is copied, since ``torch.save`` writes a view's whole
    storage."""
    leaf = leaf.detach()
    if leaf.untyped_storage().nbytes() > leaf.numel() * leaf.element_size():
        leaf = leaf.clone()
    return leaf


def quantize_tree(params: Mapping[str, torch.Tensor], seed: int = 0
                  ) -> Dict[str, Union[torch.Tensor, QuantLeaf]]:
    """Quantize every leaf with ``ndim >= 2`` and at least 4096 elements per
    output channel; smaller leaves stay as they are (copied where they are
    views into a larger storage). The k-th quantized leaf (from 1, in the
    dictionary's order) is rounded under ``seed + k``.

    Leaves on the CPU go one by one through the plain version; leaves on
    the card go through the kernel in one launch for the whole tree."""
    entries, n_blocks = work_table(
        {name: tuple(leaf.shape) for name, leaf in params.items()}, seed)
    if entries:
        _check_seed(seed, entries[-1].key)
    leaves = [_contiguous(params[e.name]) for e in entries]
    devices = {leaf.device.type for leaf in leaves}
    if devices == {"cuda"}:
        call = _card_tree(leaves, entries, n_blocks)
        _launch(call)
        values = call.outs
    elif devices <= {"cpu"}:
        values = []
        for leaf, e in zip(leaves, entries):
            if leaf.dtype != torch.float32:
                raise TypeError(f"quantize_int8 takes float32, {e.name} is "
                                f"{leaf.dtype}")
            mat = leaf.detach().reshape(e.rows, e.cols)
            scale = _plain_scale(mat, e.axis)
            values.append((_quantize_plain(mat, scale, e.key).reshape(
                leaf.shape), scale.reshape(-1)))
    else:
        raise ValueError(f"quantize_tree takes the leaves of one device, got "
                         f"{sorted(devices)}")
    quantized = {e.name: {"q": q, "s": s,
                          "axis": 0 if e.axis == 0 else q.ndim - 1}
                 for e, (q, s) in zip(entries, values)}
    return {name: quantized.get(name) or _compact(leaf)
            for name, leaf in params.items()}


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
