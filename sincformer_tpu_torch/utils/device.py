"""The device an entry point runs on: the card unless the caller asks for
the CPU."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must be present. The port
    computes in float32 on the card: this turns TF32 off in cuBLAS and
    cuDNN (PyTorch leaves it on in cuDNN), for the process."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available. sincformer_tpu_torch runs on the GPU "
                "by default; pass device='cpu' to run on the CPU on purpose.")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device
