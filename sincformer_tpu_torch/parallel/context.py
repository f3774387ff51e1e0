"""Context parallelism at the model: a model given the whole sequence on
every rank inside ``ops.ring_mesh`` (``sincformer_tpu/ops/attention.py``
``impl="ring"``, ``ops/ring_attention.py``, ``models/conformer.py``
``DepthwiseConv``).

In JAX a model with ``attn_impl="ring"`` traced under
``ops.ring_mesh(mesh, seq_axis)`` computes the same function as without
the ring: the ring attention and the halo conv are ``shard_map`` bodies
that cut the global sequence into the axis's blocks themselves, and GSPMD
gathers what they return. Here each rank runs the model in a process of
its own, so the model cuts: :func:`split_sequence` gives the part of the
model that runs on blocks (the ring region: every layer there works frame
by frame or is ring-aware) a :class:`RingSplit`, whose :meth:`~RingSplit.cut`
takes this rank's block of frames and whose :meth:`~RingSplit.join` makes
the region's output whole again on every rank. What runs before the cut
and after the join runs whole, the same on every rank, as JAX's
replicated computation does.

Gradients. Every rank computes the same loss from the joined output, so
the join's backward takes this rank's block of the gradient without a sum
(``collectives.gather``), and the cut's backward gathers the blocks'
gradients whole: the part before the cut gets the whole gradient on every
rank. A parameter of the ring region gets only this rank's share;
:func:`ring_reduce` sums those over the ring, and averages the other
leaves' (the same on every rank up to the last bits of kernels that add by
atomics), so every rank holds the same, whole gradient. A model names
its ring region by the modules themselves (``ring_region()``), and its
forward runs those same modules between the cut and the join.

A ring that cannot run (``T`` does not divide the axis, a valid-frame mask
is present) raises in a training forward and warns in inference, as
JAX's attention does; the inference forward then runs whole on every rank
with the ring suspended (its attention's own fallback warning silenced),
the one-process function. A model whose
attention is not ``"ring"`` runs whole with the ring suspended, as JAX's
result is then the one-process function too.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from sincformer_tpu_torch.ops.attention import active_ring_mesh, ring_mesh
from sincformer_tpu_torch.parallel import collectives

# seeds of the ring ranks' dropout generators are this far apart
RING_SEED = 1_000_003


class _Cut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n, r = dist.get_world_size(group), dist.get_rank(group)
        return collectives.take(x, dim, 1, n, r)

    @staticmethod
    def backward(ctx, g):
        return (collectives.merge(collectives.all_gather(g, ctx.group),
                                  ctx.dim, 1), None, None)


class RingSplit:
    """The ring ``mesh[seq_axis]`` that a model's ring region runs on."""

    def __init__(self, mesh, seq_axis: str):
        self.group = mesh.get_group(seq_axis)

    def cut(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's block of ``x`` along ``dim``; the backward gathers
        every rank's block of the gradient."""
        return _Cut.apply(x, dim % x.ndim, self.group)

    def join(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """Every rank's block of ``x`` along ``dim``, whole; the backward
        takes this rank's block of the gradient."""
        return collectives.gather(x, dim, group=self.group)


def _ring_size(mesh, seq_axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(seq_axis))


@contextlib.contextmanager
def split_sequence(frames: int, train: bool, attn_impl: str,
                   masked: bool = False):
    """For a model given the whole sequence of ``frames`` frames: yields the
    :class:`RingSplit` of the active ``ops.ring_mesh`` block, or None where
    the model runs whole (no block, an attention other than ``"ring"``, or
    a ring that cannot run in inference: then with a warning and the ring
    suspended for the body). ``train``: a training forward, where a ring
    that cannot run raises JAX's error."""
    ctx = active_ring_mesh()
    if ctx is None:
        yield None
        return
    mesh, seq_axis = ctx
    n = _ring_size(mesh, seq_axis)
    why = None
    if masked:
        why = "a valid-frame mask is present (unsupported by the ring)"
    elif frames % n:
        why = f"T={frames} does not divide the '{seq_axis}' axis size {n}"
    if attn_impl == "ring" and why is None:
        yield RingSplit(mesh, seq_axis)
        return
    if attn_impl == "ring":
        if train:
            raise RuntimeError(
                f"attention impl='ring' requested in a training apply but "
                f"{why}. Activate ops.ring_mesh(mesh, seq_axis) around the "
                f"train step, or set attn_impl='speech'/'xla' if "
                f"single-chip attention is intended.")
        warnings.warn(f"attention impl='ring' requested but {why}; falling "
                      f"back to single-chip 'speech' attention",
                      RuntimeWarning, stacklevel=3)
    with ring_mesh(None), warnings.catch_warnings():
        # the ring's attention falls back again inside; warned once above
        warnings.filterwarnings("ignore", "attention impl='ring' requested "
                                "but no ops.ring_mesh", RuntimeWarning)
        yield None


def ring_rank() -> int:
    """This rank's place on the active ring (0 without one)."""
    ctx = active_ring_mesh()
    return 0 if ctx is None else ctx[0].get_local_rank(ctx[1])


def block_generator(generator: Optional[torch.Generator], seed: int,
                    made: dict) -> Optional[torch.Generator]:
    """The dropout generator of this rank's block of frames: ``generator``
    on ring rank 0 (and without a ring), on ring rank r one seeded
    ``seed + RING_SEED * r`` on its device, made at first use and kept in
    ``made``. So each block draws its own masks, where JAX draws the
    global sequence's."""
    r = ring_rank()
    if generator is None or r == 0:
        return generator
    if r not in made:
        made[r] = torch.Generator(device=generator.device).manual_seed(
            seed + RING_SEED * r)
    return made[r]


def ring_flags(model) -> List[bool]:
    """One flag per parameter (``parameters()`` order): True for the
    parameters of the modules of the model's ring region
    (``model.ring_region()``; none without one)."""
    region = getattr(model, "ring_region", tuple)
    inside = {id(p) for m in region() for p in m.parameters()}
    return [id(p) in inside for p in model.parameters()]


def ring_reduce(grads: Sequence[Optional[torch.Tensor]],
                flags: Sequence[bool]) -> List[Optional[torch.Tensor]]:
    """The gradients of a step taken inside an active ``ops.ring_mesh``
    block made whole and the same on every rank of the ring, in one
    all-reduce: the ring region's (``flags``; each rank's share) summed,
    the others (each rank's whole gradient) averaged. Unchanged without a
    ring or with a ring of one rank."""
    ctx = active_ring_mesh()
    if ctx is None:
        return list(grads)
    group = ctx[0].get_group(ctx[1])
    n = dist.get_world_size(group)
    summed = collectives.sum_over(grads, group)
    return [g if g is None or f or n == 1 else g / n
            for g, f in zip(summed, flags)]
