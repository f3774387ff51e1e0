"""What the metrics share: host arrays onto the device in float32 (through
float64 first, as the JAX package's host entry points convert them, so
both packages start from the same bits)."""

from __future__ import annotations

import numpy as np
import torch

from sincformer_tpu_torch.utils.device import resolve_device


def f32_on(x, device) -> torch.Tensor:
    """A host array (or a tensor) as a float32 tensor on ``device`` (a CUDA
    device must be present)."""
    device = resolve_device(device)
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.asarray(np.asarray(x, np.float64),
                                       np.float32)).to(device)
