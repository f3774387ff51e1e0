"""Meshes and the batch split (``sincformer_tpu/parallel/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the process group, one card (or CPU process) per rank, with the JAX axis
names. :func:`shard_batch` gives a rank its block of the global batch, the
rows ``P("data")`` places on its device in JAX.

JAX's ``data_sharding`` and ``replicated`` are not ported: they name
layouts of one global array for ``device_put``, and a tensor here lives
whole on its rank. Their work is :func:`shard_batch`'s (the batch) and the
broadcast of the parameters from rank 0 when a trainer starts
(``collectives.broadcast_``).
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None):
    """A DeviceMesh over the first ``n_devices`` ranks (default: every
    rank), all on the first axis unless ``shape`` is given. Raises when the
    group has fewer ranks than asked for: a "mesh of 8" that is secretly one
    device would make every data-parallel result meaningless. The mesh's
    device type is the backend's: CUDA under NCCL, else the CPU (a gloo
    group may still reduce CUDA tensors)."""
    from torch.distributed.device_mesh import DeviceMesh
    have = dist.get_world_size() if dist.is_initialized() else 1
    want = have if n_devices is None else n_devices
    if want > have:
        raise ValueError(f"make_mesh: need {want} devices, have {have}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.init_distributed (or "
                           "torch.distributed.init_process_group) first")
    if shape is None:
        shape = [want] + [1] * (len(axis_names) - 1)
    if int(np.prod(shape)) != want:
        raise ValueError(f"make_mesh: shape {tuple(shape)} does not hold "
                         f"{want} devices")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, np.arange(want).reshape(shape).tolist(),
                      mesh_dim_names=tuple(axis_names))


def data_size(mesh, axis: str = "data") -> int:
    """Ranks along ``axis`` (1 without a mesh)."""
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(axis))


def data_rank(mesh, axis: str = "data") -> int:
    """This rank's place along ``axis`` (0 without a mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


def model_rank(mesh, axis: str = "model") -> int:
    """This rank's place along the model axis (0 without a mesh or without
    that axis)."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(axis)


def leads(mesh) -> bool:
    """True on the ranks that are first on every axis of ``mesh`` but
    "model" (a model group: every model rank takes part in a gathered
    checkpoint); True without a mesh."""
    return mesh is None or all(
        mesh.get_local_rank(a) == 0 for a in mesh.mesh_dim_names
        if a != "model")


def rank_seed(seed: int, mesh) -> int:
    """The seed of this rank's noise generators (dropout, Gumbel): each rank
    draws its own rows' noise, where JAX's sharded step draws the global
    batch's; rank 0's (and one process's) is ``seed``. Keyed on the data
    rank alone: the ranks of one model group compute the same rows and
    draw the same noise."""
    return seed + 1000 * data_rank(mesh)


def shard_batch(mesh, batch: Dict, axis: str = "data") -> Dict:
    """This rank's contiguous block of every array of ``batch`` along the
    leading (batch) axis, in rank order: rows [r·B/n, (r+1)·B/n) of n ranks.
    Raises when B does not divide by n, as ``jax.device_put`` does. Without
    a mesh the batch is returned as it is."""
    n = data_size(mesh, axis)
    if n == 1:
        return batch
    r = data_rank(mesh, axis)
    out = {}
    for k, v in batch.items():
        rows = v.shape[0]
        if rows % n:
            raise ValueError(f"shard_batch: {k} has {rows} rows, which do "
                             f"not divide over {n} devices on {axis!r}")
        step = rows // n
        out[k] = v[r * step:(r + 1) * step]
    return out


def blocks_for_ranks(batches: Iterable[Dict], mesh
                     ) -> Iterator[Tuple[Dict, object]]:
    """(batch, mesh) pairs for a validation pass: with a mesh, this rank's
    block of each batch that divides over the data ranks, and a batch that
    does not whole, without the mesh (every rank computes it, as one
    process would); without a mesh every batch whole."""
    for b in batches:
        if mesh is not None and len(b["noisy"]) % data_size(mesh) == 0:
            yield shard_batch(mesh, b), mesh
        else:
            yield b, None
