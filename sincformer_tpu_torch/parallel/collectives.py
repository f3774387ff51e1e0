"""The batch-wide reductions of a data-parallel step, global over the
mesh's data axis.

JAX's sharded step is the unsharded program split by GSPMD, so a mean over
the batch inside it is a mean over the global batch. Here each rank runs
the step on its own rows, so a reduction that must see the global batch
goes through this module. Outside a :func:`data_parallel` block, or in a
group of one rank, every function is the local operation itself (the same
call, bit for bit); inside one over several ranks it all-reduces over the
data axis.

  * :func:`mean`, :func:`var`, :func:`norm` - differentiable: the sums go
    through ``torch.distributed.nn.functional.all_reduce``, whose backward
    all-reduces the gradient, so each rank's backward carries the other
    ranks' share of a statistic's gradient to its own rows.
  * :func:`sum` - no gradient: counts. No flag needs a MAX over the ranks:
    the NaN guard reads the loss and gradients after
    :func:`average_over_ranks`, which are the same on every rank.
  * :func:`average_over_ranks`, :func:`mean_and_sum_over_ranks`,
    :func:`broadcast_`, :func:`barrier` - the trainers' collectives.

The reductions inside the model read the group of the running
:func:`data_parallel` block, so no module's forward takes a mesh; the
trainers' collectives, called outside the forward, take the trainer's
mesh.

Callers: ``agents/maa.py`` (the σ statistics), ``agents/memory.py`` (the
episodic write and the usage counts), ``models/conformer.batch_norm`` (the
"batch" statistics over B × T), ``train/losses.multi_resolution_stft_loss``
(the spectral convergence, a ratio of sums).
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn

_group = None             # the data-parallel group of the running step


def group_of(mesh, axis: str = "data"):
    """The process group of ``mesh``'s ``axis`` (None without a mesh)."""
    return None if mesh is None else mesh.get_group(axis)


@contextlib.contextmanager
def data_parallel(mesh, axis: str = "data"):
    """Within the block, the reductions of this module are global over
    ``mesh``'s ``axis``; with ``mesh`` None they stay local."""
    global _group
    previous = _group
    _group = group_of(mesh, axis)
    try:
        yield
    finally:
        _group = previous


def world_size(group=None) -> int:
    group = _group if group is None else group
    return 1 if group is None else dist.get_world_size(group)


def _active(group=None) -> bool:
    return world_size(group) > 1


def _all_reduce(x: torch.Tensor, differentiable: bool = True
                ) -> torch.Tensor:
    if differentiable and torch.is_grad_enabled() and x.requires_grad:
        return dist_nn.all_reduce(x, group=_group)
    x = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, group=_group)
    return x


def _dims(x: torch.Tensor, dim) -> tuple:
    if dim is None:
        return tuple(range(x.ndim))
    return tuple(d % x.ndim for d in ((dim,) if isinstance(dim, int)
                                      else dim))


def mean(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """``x.mean(dim)`` over the rows of every rank: the global sum over the
    global count (one all-reduce of both)."""
    if not _active():
        return x.mean() if dim is None else x.mean(dim=dim, keepdim=keepdim)
    dims = _dims(x, dim)
    s = x.sum(dim=dims, keepdim=keepdim)
    count = torch.full((1,), float(math.prod(x.shape[d] for d in dims)),
                       dtype=s.dtype, device=s.device)
    total = _all_reduce(torch.cat([s.reshape(-1), count]))
    return (total[:-1] / total[-1]).reshape(s.shape)


def var(x: torch.Tensor, dim=None) -> torch.Tensor:
    """The biased variance over the rows of every rank, in two passes as
    ``torch.var``: the global mean, then the global mean of the squared
    deviations from it."""
    if not _active():
        return (x.var(unbiased=False) if dim is None
                else x.var(dim=dim, unbiased=False))
    mu = mean(x, dim, keepdim=True)
    return mean((x - mu) ** 2, dim)


def norm(x: torch.Tensor) -> torch.Tensor:
    """The Frobenius norm of every rank's ``x`` together."""
    if not _active():
        return torch.linalg.vector_norm(x)
    return torch.sqrt(_all_reduce(torch.sum(x * x)))


def sum(x: torch.Tensor) -> torch.Tensor:        # noqa: A001
    """Elementwise sum over the ranks, without a gradient."""
    if not _active():
        return x
    return _all_reduce(x, differentiable=False)


def average_over_ranks(tensors: Sequence[Optional[torch.Tensor]],
                       mesh) -> List[Optional[torch.Tensor]]:
    """The mean over ``mesh``'s data ranks of each tensor (one all-reduce of
    them all, flattened, without a gradient). For gradients: each rank's
    loss is the mean over its rows, so the mean of the ranks' gradients is
    the gradient of the global mean. A None (a parameter nothing reads, the
    same on every rank) stays None. The identity without a mesh or with
    one rank."""
    group = group_of(mesh)
    if not _active(group):
        return list(tensors)
    flat = torch.cat([g.detach().reshape(-1) for g in tensors
                      if g is not None])
    dist.all_reduce(flat, group=group)
    flat = flat / dist.get_world_size(group)
    out, offset = [], 0
    for g in tensors:
        if g is None:
            out.append(None)
            continue
        out.append(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return out


def mean_and_sum_over_ranks(means: Sequence[torch.Tensor],
                            sums: Sequence[torch.Tensor], mesh) -> tuple:
    """Scalars of each rank's block: ``means`` averaged and ``sums``
    summed over ``mesh``'s data ranks, in one all-reduce; each keeps its
    dtype (a count comes back exact). Unchanged without a mesh or with one
    rank."""
    group = group_of(mesh)
    if not _active(group):
        return (*means, *sums)
    n = dist.get_world_size(group)
    flat = torch.stack([*(m.detach().double() / n for m in means),
                        *(s.detach().double() for s in sums)])
    dist.all_reduce(flat, group=group)
    return tuple(v.to(t.dtype) for v, t in zip(flat, (*means, *sums)))


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], mesh, src: int = 0) -> None:
    """Overwrite each tensor with rank ``src``'s, in place, over ``mesh``'s
    data ranks (one broadcast of them all, flattened per dtype)."""
    group = group_of(mesh)
    if not _active(group):
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    src = dist.get_global_rank(group, src)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, src=src, group=group)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def barrier(mesh=None) -> None:
    """Wait for every rank of ``mesh``'s data axis (of the whole group
    without a mesh); nothing to wait for in one process."""
    if mesh is not None:
        if _active(group_of(mesh)):
            dist.barrier(group=group_of(mesh))
    elif dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
