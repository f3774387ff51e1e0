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

The model axis (tensor parallelism, ``parallel/sharding.py``): inside a
:func:`model_parallel` block over a mesh whose ``"model"`` axis has
several ranks, each rank holds a slice of every split parameter.

  * :func:`gather` - the ranks' blocks of a tensor, concatenated along a
    dimension; its backward takes this rank's block of the gradient. Every
    rank computes the same (replicated) result from the gathered tensor,
    so the gradient that reaches it is the same on every rank and this
    rank's block of it is its slice's gradient. (The backward of
    ``torch.distributed.nn.functional.all_gather`` sums the ranks'
    gradients instead, which here would scale each slice's gradient by
    the axis size.)
  * :func:`copy_to_model` - the identity whose backward sums the gradient
    over the model ranks: the input of a column block, whose gradient
    each rank holds only its block's share of.
  * :func:`average_replicated` - the replicated leaves' gradients
    averaged over the model ranks, so those parameters stay bit-identical
    on every rank.
  * :func:`global_norm` - the gradient norm of a step with split leaves:
    each element once (split leaves' squares summed over the model ranks,
    replicated leaves' taken once).
  * :func:`hop` - send to the next rank of an axis and receive from the
    previous; its backward sends the gradient the other way (the ring of
    ``ops/ring_attention.py`` and the halo of ``ops/cp_conv.py``).

Context parallelism (``ops.ring_mesh``, each rank holding its block of
frames): :func:`mean_over` averages a statistic over the sequence axis,
:func:`gather` joins the blocks (``parallel/context.py``) and, with
``summed=True``, makes the whole sequence for a call that cannot run on
blocks.

Transport: under NCCL the gather is ``all_gather_into_tensor`` and the hop
a pair of ``isend``/``irecv``. Gloo gathers, reduces and broadcasts CUDA
tensors itself, but its ``send``/``recv`` take host tensors only, so under
gloo a CUDA tensor's hop is staged through host memory (copied to the CPU,
exchanged, copied back); :data:`COUNTS` counts the model-axis and ring
collectives and the stagings.
"""

from __future__ import annotations

import collections
import contextlib
import math
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn

_group = None             # the data-parallel group of the running step
_model_group = None       # the tensor-parallel group of the running step

# model-axis and ring collectives launched, and the hops of CUDA tensors
# staged through host memory (gloo): "all_gather", "all_reduce", "hop",
# "host_staged"
COUNTS: collections.Counter = collections.Counter()


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


def sum_over(tensors: Sequence[Optional[torch.Tensor]],
             group) -> List[Optional[torch.Tensor]]:
    """The sum over ``group``'s ranks of each tensor (one all-reduce of
    them all, flattened, without a gradient). A None (a parameter nothing
    reads, the same on every rank) stays None. The identity without a
    group or with one rank."""
    if not _active(group):
        return list(tensors)
    flat = torch.cat([g.detach().reshape(-1) for g in tensors
                      if g is not None])
    dist.all_reduce(flat, group=group)
    out, offset = [], 0
    for g in tensors:
        if g is None:
            out.append(None)
            continue
        out.append(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return out


def average_over_ranks(tensors: Sequence[Optional[torch.Tensor]],
                       mesh) -> List[Optional[torch.Tensor]]:
    """The mean over ``mesh``'s data ranks of each tensor (:func:`sum_over`
    divided by their number). For gradients: each rank's loss is the mean
    over its rows, so the mean of the ranks' gradients is the gradient of
    the global mean. The identity without a mesh or with one rank."""
    group = group_of(mesh)
    if not _active(group):
        return list(tensors)
    n = dist.get_world_size(group)
    return [None if g is None else g / n for g in sum_over(tensors, group)]


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
def broadcast_(tensors: Sequence[torch.Tensor], mesh, src: int = 0,
               axis: str = "data") -> None:
    """Overwrite each tensor with rank ``src``'s, in place, over ``mesh``'s
    ranks along ``axis`` (one broadcast of them all, flattened per
    dtype)."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return
    group = group_of(mesh, axis)
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
    without a mesh, or with another axis of several ranks); nothing to
    wait for in one process."""
    if mesh is not None and all(
            mesh.size(i) == 1 for i, a in enumerate(mesh.mesh_dim_names)
            if a != "data"):
        if _active(group_of(mesh)):
            dist.barrier(group=group_of(mesh))
    elif dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


# ── the model axis (tensor parallelism) and the ring's hop ──────────────

def model_group_of(mesh, axis: str = "model"):
    """The process group of ``mesh``'s ``axis`` when it has several ranks,
    else None (no mesh, no such axis, or one rank: nothing is split)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return None
    if mesh.size(mesh.mesh_dim_names.index(axis)) < 2:
        return None
    return mesh.get_group(axis)


@contextlib.contextmanager
def model_parallel(mesh, axis: str = "model"):
    """Within the block, the forwards of the modules with split parameters
    gather over ``mesh``'s ``axis`` (no mesh, or an axis of one rank:
    nothing is split and nothing is gathered)."""
    global _model_group
    previous = _model_group
    _model_group = model_group_of(mesh, axis)
    try:
        yield
    finally:
        _model_group = previous


def model_group():
    """The model-axis group of the running :func:`model_parallel` block."""
    return _model_group


def all_gather(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``x`` (the same shape on each), in the group's rank
    order, without a gradient."""
    n = dist.get_world_size(group)
    COUNTS["all_gather"] += 1
    x = x.detach().contiguous()
    out = torch.empty((n, *x.shape), dtype=x.dtype, device=x.device)
    if dist.get_backend(group) == "nccl":
        dist.all_gather_into_tensor(out, x, group=group)
        return list(out.unbind(0))
    parts = list(out.unbind(0))
    dist.all_gather(parts, x, group=group)
    return parts


def take(full: torch.Tensor, dim: int, groups: int, n: int,
         r: int) -> torch.Tensor:
    """Rank ``r``'s slice of ``full`` split in ``n`` along ``dim``: with
    ``groups`` > 1, ``dim`` holds ``groups`` equal blocks (the gates of a
    folded LSTM matrix), each split in ``n``, and the slice is rank
    ``r``'s part of every block."""
    return torch.cat([c.chunk(n, dim)[r] for c in full.chunk(groups, dim)],
                     dim) if groups > 1 else full.chunk(n, dim)[r]


def merge(parts: Sequence[torch.Tensor], dim: int,
          groups: int) -> torch.Tensor:
    """The inverse of :func:`take`: the whole tensor from every rank's
    slice, in rank order."""
    if groups == 1:
        return torch.cat(list(parts), dim)
    blocks = [p.chunk(groups, dim) for p in parts]
    return torch.cat([b[g] for g in range(groups) for b in blocks], dim)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, groups, group, summed):
        ctx.dim, ctx.groups, ctx.group = dim, groups, group
        ctx.summed = summed
        return merge(all_gather(x, group), dim, groups)

    @staticmethod
    def backward(ctx, g):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        if ctx.summed:
            g = g.contiguous().clone()
            COUNTS["all_reduce"] += 1
            dist.all_reduce(g, group=ctx.group)
        return (take(g, ctx.dim, ctx.groups, n, r).contiguous(), None, None,
                None, None)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        COUNTS["all_reduce"] += 1
        dist.all_reduce(g, group=ctx.group)
        return g, None


def gather(x: torch.Tensor, dim: int, groups: int = 1,
           group=None, summed: bool = False) -> torch.Tensor:
    """The model ranks' slices of ``x`` along ``dim`` (and ``groups``, as
    :func:`take`) made whole, on every rank; the backward takes this
    rank's slice of the gradient, after summing it over the ranks when
    ``summed`` (each rank computed something else from the whole, as a
    context-parallel rank does with its block of the output). ``group``
    defaults to the running :func:`model_parallel` block's."""
    group = _model_group if group is None else group
    dim = dim % x.ndim
    return _Gather.apply(x, dim, groups, group, summed)


def mean_over(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over ``group``'s ranks, with its gradient (the
    backward all-reduces it); ``x`` itself in a group of one rank."""
    if not _active(group):
        return x
    COUNTS["all_reduce"] += 1
    return dist_nn.all_reduce(x, group=group) / dist.get_world_size(group)


def copy_to_model(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x``, whose gradient is summed over the model ranks in the
    backward."""
    group = _model_group if group is None else group
    return _CopyToModel.apply(x, group)


def average_replicated(grads: Sequence[Optional[torch.Tensor]],
                       split: Sequence[bool], mesh,
                       axis: str = "model") -> List[Optional[torch.Tensor]]:
    """Each replicated leaf's gradient averaged over the model ranks, in one
    all-reduce; the split leaves' (this rank's slices) and the missing
    ones (None) as they are. Every rank computed a replicated leaf's
    gradient from the same gathered activations, but kernels that add by
    atomics, such as cuDNN's weight gradients, leave the ranks' copies
    apart in the last bits, and a replicated parameter must stay the same
    on every rank. Unchanged without a model axis."""
    group = model_group_of(mesh, axis)
    whole = [g for g, s in zip(grads, split) if g is not None and not s]
    if group is None or not whole:
        return list(grads)
    flat = torch.cat([g.detach().reshape(-1) for g in whole])
    COUNTS["all_reduce"] += 1
    dist.all_reduce(flat, group=group)
    flat = flat / dist.get_world_size(group)
    out, offset = [], 0
    for g, s in zip(grads, split):
        if g is None or s:
            out.append(g)
            continue
        out.append(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return out


def global_norm(grads: Sequence[torch.Tensor], split: Sequence[bool],
                mesh, axis: str = "model") -> torch.Tensor:
    """The global norm of a step's gradients whose leaves ``split`` are
    this rank's slices, each element counted once: the split leaves'
    squares summed over the model ranks (one all-reduce), the replicated
    leaves' (the same on every rank) added once. Without a model axis,
    the norm of ``grads``."""
    def squares(gs):
        if not gs:
            return torch.zeros((), dtype=grads[0].dtype,
                               device=grads[0].device)
        flat = torch.cat([g.reshape(-1) for g in gs])
        return torch.sum(flat * flat)
    group = model_group_of(mesh, axis)
    if group is None:
        return torch.sqrt(squares(list(grads)))
    sliced = squares([g for g, s in zip(grads, split) if s])
    COUNTS["all_reduce"] += 1
    dist.all_reduce(sliced, group=group)
    return torch.sqrt(sliced + squares([g for g, s in zip(grads, split)
                                        if not s]))


def _staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _exchange(x: torch.Tensor, group, to: int, frm: int) -> torch.Tensor:
    """Send ``x`` to the group's rank ``to`` and receive a tensor of its
    shape from rank ``frm``."""
    COUNTS["hop"] += 1
    x = x.detach().contiguous()
    staged = _staged(x, group)
    if staged:
        COUNTS["host_staged"] += 1
    send = x.cpu() if staged else x
    recv = torch.empty_like(send)
    reqs = [dist.isend(send, group=group, group_dst=to),
            dist.irecv(recv, group=group, group_src=frm)]
    for req in reqs:
        req.wait()
    return recv.to(x.device) if staged else recv


class _Hop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, step):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        ctx.group, ctx.step = group, step
        return _exchange(x, group, (r + step) % n, (r - step) % n)

    @staticmethod
    def backward(ctx, g):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return (_exchange(g, ctx.group, (r - ctx.step) % n,
                          (r + ctx.step) % n), None, None)


def hop(x: torch.Tensor, group, step: int = 1) -> torch.Tensor:
    """Send ``x`` to the rank ``step`` places on in ``group`` and return
    what the rank ``step`` places back sent (``ppermute`` by ``step``);
    the backward sends the gradient ``step`` places back (JAX's autodiff
    of ``ppermute``). The identity in a group of one rank."""
    if dist.get_world_size(group) == 1:
        return x
    return _Hop.apply(x, group, step)
