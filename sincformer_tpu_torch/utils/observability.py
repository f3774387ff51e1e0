"""Tracing, step timing and structured metric logging
(``sincformer_tpu/utils/observability.py``): :func:`trace`, a
``torch.profiler`` region written as a Chrome trace (Perfetto,
``chrome://tracing``); :class:`StepTimer`, EMA-smoothed wall time per step
(time only around host synchronisation points: CUDA calls return before
the card is done); and :class:`MetricsLogger`, an append-only JSONL log
with optional stdout echo (the ``--log-jsonl`` file of ``train``)."""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a region, ``with trace("/tmp/prof"): step(...)``: host
    operations, and the card's kernels when CUDA is present, written on
    exit to ``<log_dir>/trace-<pid>-<n>.json``. Yields ``log_dir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    n = len([f for f in os.listdir(log_dir) if f.startswith(
        f"trace-{os.getpid()}-")])
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{n}.json"))


class StepTimer:
    """EMA-smoothed step timing."""

    def __init__(self, momentum: float = 0.9):
        self.momentum = momentum
        self.ema: Optional[float] = None
        self.last: Optional[float] = None
        self.count = 0
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.last = dt
        self.ema = dt if self.ema is None else (
            self.momentum * self.ema + (1 - self.momentum) * dt)
        self.count += 1
        return dt

    @contextlib.contextmanager
    def measure(self):
        self.start()
        yield self
        self.stop()


class MetricsLogger:
    """Append-only JSONL metric log with optional stdout echo.

    Every record gets a wall-clock timestamp and a monotonically increasing
    sequence number; values are coerced to plain floats.
    """

    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self.path = path
        self.echo = echo
        self.seq = 0
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)

    @staticmethod
    def _coerce(v):
        try:
            import numpy as np
            if isinstance(v, (np.generic,)):
                return v.item()
        except ImportError:  # pragma: no cover
            pass
        if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
            return v.item()
        return v

    def log(self, record: dict):
        rec = {"ts": time.time(), "seq": self.seq}
        rec.update({k: self._coerce(v) for k, v in record.items()})
        self.seq += 1
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if self.echo:
            print(json.dumps(rec))
        return rec

    def read_all(self):
        if not self.path or not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]
