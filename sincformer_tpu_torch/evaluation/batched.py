"""All five metrics of a batch of (clean, enhanced) pairs in one device
sweep (``sincformer_tpu/evaluation/batched.py``): each metric is a torch
function batched over the leading axis, so the sweep replaces the serial
loop over utterances. PESQ comes from the same source as the serial path
(the C library or the native P.862 on the host), fanned over 8 host threads
while the sweep runs, so batched and serial grids agree; only
``pesq_impl="proxy"`` keeps it inside the sweep."""

from __future__ import annotations

import importlib.util
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from sincformer_tpu_torch.config import EvalConfig
from sincformer_tpu_torch.evaluation.common import f32_on
from sincformer_tpu_torch.evaluation.csii import csii_torch
from sincformer_tpu_torch.evaluation.ncm import ncm_torch
from sincformer_tpu_torch.evaluation.pesq import (compute_pesq,
                                                  pesq_proxy_torch)
from sincformer_tpu_torch.evaluation.ssnr import ssnr_torch
from sincformer_tpu_torch.evaluation.stoi import compute_stoi, stoi_torch

METRIC_TORCH = {
    "stoi": stoi_torch,
    "pesq": pesq_proxy_torch,
    "ssnr": lambda c, e, fs: ssnr_torch(c, e),
    "csii": csii_torch,
    "ncm": ncm_torch,
}


def metrics_batch(clean: np.ndarray, enhanced: np.ndarray,
                  metrics: Sequence[str] = ("stoi", "pesq", "ssnr", "csii",
                                            "ncm"),
                  fs: int = 8000, pesq_impl: Optional[str] = None,
                  device="cuda") -> Dict[str, np.ndarray]:
    """{metric: (B,) float array} for (B, N) pairs of equal length. The
    device metrics run on ``device``; PESQ (unless ``pesq_impl="proxy"``)
    and, when pystoi is installed, STOI run on host threads meanwhile,
    once over the B rows.

    ``device`` may be a list of devices: the device metrics' batch is then
    split over them in contiguous blocks, as JAX shards it over its mesh's
    "data" axis, padded cyclically to a multiple of their count
    (``np.resize``: 3 rows on 8 devices repeat them) with the padded rows
    dropped after. Every block is queued on its device before any result
    is read back, so the devices run together."""
    pesq_impl = pesq_impl or EvalConfig().pesq_impl
    host_pesq = "pesq" in metrics and pesq_impl != "proxy"
    # pystoi, when installed, is what the host entry point dispatches to
    host_stoi = ("stoi" in metrics
                 and importlib.util.find_spec("pystoi") is not None)
    device_metrics = [m for m in metrics
                      if not (m == "pesq" and host_pesq)
                      and not (m == "stoi" and host_stoi)]
    out: Dict[str, np.ndarray] = {}
    futs = {}
    pool = None
    if host_pesq or host_stoi:
        pool = ThreadPoolExecutor(max_workers=8)
        cs, es = np.asarray(clean), np.asarray(enhanced)
        if host_pesq:
            futs["pesq"] = [pool.submit(compute_pesq, c, e, fs, None,
                                        pesq_impl, device)
                            for c, e in zip(cs, es)]
        if host_stoi:
            futs["stoi"] = [pool.submit(compute_stoi, c, e, fs)
                            for c, e in zip(cs, es)]
    if device_metrics:
        devices = (list(device) if isinstance(device, (list, tuple))
                   else [device])
        n, per = len(clean), len(devices)
        cb, eb = np.asarray(clean), np.asarray(enhanced)
        if n % per:
            padded = n + (-n) % per
            cb = np.resize(cb, (padded,) + cb.shape[1:])
            eb = np.resize(eb, (padded,) + eb.shape[1:])
        step = len(cb) // per
        parts = []
        with torch.inference_mode():
            for i, dev in enumerate(devices):
                c = f32_on(cb[i * step:(i + 1) * step], dev)
                e = f32_on(eb[i * step:(i + 1) * step], dev)
                parts.append({k: METRIC_TORCH[k](c, e, fs)
                              for k in device_metrics})
        out.update({k: np.concatenate([p[k].cpu().numpy()
                                       for p in parts])[:n]
                    for k in device_metrics})
    for k, fl in futs.items():
        out[k] = np.asarray([f.result() for f in fl])
    if pool is not None:
        pool.shutdown()
    return out
