"""Multi-process set-up (``sincformer_tpu/parallel/distributed.py``): the
process group, the mesh over every rank, the evaluation grid dealt to
processes and merged again, and the rank-0 gate for host writes.

  * :func:`init_distributed` - ``torch.distributed.init_process_group``
    from what ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``, ``LOCAL_RANK``); a no-op that returns False for one
    process, so every caller may call it unconditionally.
  * :func:`make_global_mesh` - a DeviceMesh over every rank, the data axis
    leading.
  * :func:`global_batch_from_local` - each rank's own rows of a global
    batch.
  * :func:`partition_grid_cells` / :func:`merge_grid_results` - the
    (noise, SNR) cells of the evaluation grid dealt round-robin to
    processes, and the parts merged.
  * :func:`is_primary` - rank 0 (or no process group).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None,
                     device="cuda") -> bool:
    """Join the process group when running as one of several processes.

    The arguments default to the variables ``torchrun`` sets: ``WORLD_SIZE``
    and ``RANK``, the rendezvous ``env://`` (``MASTER_ADDR``,
    ``MASTER_PORT``), and ``LOCAL_RANK``, the card of this process when
    ``device`` is CUDA (``torch.cuda.set_device``). The backend is NCCL for
    a CUDA ``device`` and gloo on the CPU unless ``backend`` names one.
    Returns True once the group is up (also when it already was), False for
    one process, which needs no group. A failed init raises."""
    if dist.is_initialized():
        return True
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return False
    if rank is None:
        rank = int(os.environ["RANK"])
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """Rank 0, or a process with no group: the one that writes."""
    return process_index() == 0


def make_global_mesh(axis_names: Sequence[str] = ("data", "model"),
                     model_axis_size: int = 1):
    """A DeviceMesh over every rank of the group, shaped (world /
    ``model_axis_size``, ``model_axis_size``): the data axis leads, so
    consecutive ranks (one host's cards under ``torchrun``) share a model
    group. One name gives a 1-D mesh over every rank. Without a process
    group (one process) there is nothing to mesh: None."""
    if not dist.is_initialized():
        return None
    from sincformer_tpu_torch.parallel.mesh import make_mesh
    world = dist.get_world_size()
    if world % model_axis_size:
        raise ValueError(f"make_global_mesh: {world} ranks do not split "
                         f"into a model axis of {model_axis_size}")
    shape = ((world,) if len(axis_names) == 1
             else (world // model_axis_size, model_axis_size))
    return make_mesh(axis_names=axis_names, shape=shape)


def global_batch_from_local(local_batch: Dict) -> Dict[str, torch.Tensor]:
    """JAX's name for this rank's rows of a global batch (such as
    ``shard_batch``'s block), as tensors: a rank keeps its own rows, and a
    reduction of ``parallel.collectives`` in a ``data_parallel`` block
    sees every rank's."""
    return {k: torch.as_tensor(v) for k, v in local_batch.items()}


def partition_grid_cells(noise_names: Sequence[str],
                         snr_levels: Sequence[float],
                         process_id: Optional[int] = None,
                         num_processes: Optional[int] = None
                         ) -> List[Tuple[str, float]]:
    """The (noise, SNR) cells of this process: every cell in noise-major
    order, dealt round-robin (cell i to process i mod n), as the JAX
    package deals them. Rank and world size default to the group's."""
    if process_id is None:
        process_id = process_index()
    if num_processes is None:
        num_processes = process_count()
    cells = [(n, s) for n in noise_names for s in snr_levels]
    return cells[process_id::num_processes]


def merge_grid_results(parts: Sequence[Dict]) -> Dict:
    """Merge the processes' ``evaluate_grid`` results (disjoint cells) into
    one results[noise][method][snr][metric] = [values]."""
    merged: Dict = {}
    for part in parts:
        for noise, methods in part.items():
            mtgt = merged.setdefault(noise, {})
            for method, snrs in methods.items():
                stgt = mtgt.setdefault(method, {})
                for snr, metricvals in snrs.items():
                    ctgt = stgt.setdefault(snr, {})
                    for metric, vals in metricvals.items():
                        ctgt.setdefault(metric, []).extend(vals)
    return merged
