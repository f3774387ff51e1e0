"""The torch intra-op threads of the port's test processes.

Under pytest-xdist each of the ``PYTEST_XDIST_WORKER_COUNT`` workers would
start torch's pool of one thread per core, and the pools together
oversubscribe the host: a narrow training loop that takes 1.3 s in one
process took 230 s beside five such workers. So a worker, and each gloo
rank it starts (``tests/_torch_dp_worker.py``), takes its share of the
cores: at least one thread. Outside xdist nothing changes. Every port
test file imports this module, through ``tests/_torch_parity.py`` or
``tests/_torch_bf16.py`` or directly."""

from __future__ import annotations

import os

import torch


def share(default: int | None = None) -> int | None:
    """This process's share of the cores under xdist (``default`` outside
    it)."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers <= 1:
        return default
    return max(1, len(os.sched_getaffinity(0)) // workers)


_threads = share()
if _threads is not None:
    torch.set_num_threads(_threads)
