"""Attention dispatch (``sincformer_tpu/ops/attention.py``).

  * ``impl="speech"``: kernel K1 (ops/speech_attention.py) at every T; the
    JAX package's ``T > 2048`` hand-off to a flash kernel is not needed,
    since K1's online softmax runs any T in fixed shared memory.
  * ``impl="flash"``: what the JAX package runs off a TPU, where its
    library flash kernel is not available: full attention, here K1 on a
    CUDA tensor and the plain attention on the CPU (the same as
    ``"speech"``).
  * ``impl="xla"``: the plain PyTorch attention, on any device.
  * ``impl="ring"``: context-parallel ring attention
    (ops/ring_attention.py) over the axis that a :func:`ring_mesh` block
    names; inside the block every tensor is this rank's block of frames.
    With no active block, or with a valid-frame mask, a training forward
    (one given a dropout generator) raises, and an inference forward warns
    with a ``RuntimeWarning`` and falls back to ``"speech"`` attention, as
    in JAX. The JAX package's third condition, a T that does not divide
    the axis, cannot arise here: each rank holds T / n frames of the
    sequence, so ``ops/ring_attention.ring_attention`` checks it where a
    whole sequence is split.
"""

from __future__ import annotations

import contextlib
import threading
import warnings
from typing import Optional

import torch

from sincformer_tpu_torch.ops.speech_attention import (
    _speech_attention_plain, speech_attention)

_NEG = -1e9

# Active (mesh, seq_axis) blocks of impl="ring", a thread-local stack:
# threads that run models at the same time do not see each other's.
_RING_MESH = threading.local()


def _ring_stack() -> list:
    stack = getattr(_RING_MESH, "stack", None)
    if stack is None:
        stack = _RING_MESH.stack = []
    return stack


@contextlib.contextmanager
def ring_mesh(mesh, seq_axis: str = "data"):
    """Run context-parallel attention over ``mesh[seq_axis]`` for every
    ``impl="ring"`` attention (and the halo-exchange depthwise conv) called
    inside this block on this thread."""
    stack = _ring_stack()
    stack.append((mesh, seq_axis))
    try:
        yield
    finally:
        stack.pop()


def active_ring_mesh():
    """The innermost active ``(mesh, seq_axis)``, or None."""
    stack = _ring_stack()
    return stack[-1] if stack else None


def _whole_sequence(x: torch.Tensor, ctx) -> torch.Tensor:
    """Every rank's block of frames of ``x`` (time on axis 1), in order,
    without a gradient (an inference fallback)."""
    from sincformer_tpu_torch.parallel import collectives
    mesh, seq_axis = ctx
    return torch.cat(collectives.all_gather(x, mesh.get_group(seq_axis)),
                     dim=1)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          impl: str = "speech",
                          train: bool = False) -> torch.Tensor:
    """(B, T, H, dh) attention; ``mask`` is an optional (B, T) boolean
    valid-frame mask applied on the key side. ``train``: this is a
    training forward, where ``impl="ring"`` without a usable ring raises
    instead of falling back."""
    if impl == "ring":
        ctx = active_ring_mesh()
        if ctx is not None and mask is None:
            from sincformer_tpu_torch.ops.ring_attention import \
                ring_attention_in_mesh
            return ring_attention_in_mesh(q, k, v, *ctx)
        why = ("no ops.ring_mesh(...) context is active" if ctx is None
               else "a valid-frame mask is present (unsupported by the "
                    "ring)")
        if train:
            raise RuntimeError(
                f"attention impl='ring' requested in a training apply but "
                f"{why}. Activate ops.ring_mesh(mesh, seq_axis) around the "
                f"train step, or set attn_impl='speech'/'xla' if "
                f"single-chip attention is intended.")
        warnings.warn(f"attention impl='ring' requested but {why}; falling "
                      f"back to single-chip 'speech' attention",
                      RuntimeWarning, stacklevel=2)
        if ctx is None:
            return dot_product_attention(q, k, v, mask=mask, impl="speech")
        # this rank's queries against every rank's keys
        n = q.shape[1]
        r = ctx[0].get_local_rank(ctx[1])
        out = dot_product_attention(
            _whole_sequence(q, ctx), _whole_sequence(k, ctx),
            _whole_sequence(v, ctx),
            mask=_whole_sequence(mask.to(torch.uint8), ctx).bool(),
            impl="speech")
        return out[:, r * n:(r + 1) * n]
    bias = None
    if mask is not None:
        bias = torch.where(mask, 0.0, _NEG).to(torch.float32).contiguous()
    if impl in ("speech", "flash"):
        return speech_attention(q, k, v, bias)
    if impl == "xla":
        return _speech_attention_plain(q, k, v, bias)
    raise ValueError(f"unknown attention impl {impl!r}")
