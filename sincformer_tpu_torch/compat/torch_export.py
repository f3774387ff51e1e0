"""A DCSE model of the port back into the reference's ``.pt`` format
(``sincformer_tpu/compat/torch_export.py``): the inverse of
``torch_import``, for someone still running the PyTorch reference (its
``load_model`` reads the file). Only a ``conv_norm="batch"`` model has a
reference counterpart; any other is refused.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import torch

from sincformer_tpu_torch.compat.torch_import import _BLOCK, _TOP


def _state(model_or_state) -> Mapping[str, torch.Tensor]:
    if isinstance(model_or_state, torch.nn.Module):
        return model_or_state.state_dict()
    return model_or_state


def export_dcse_state_dict(model_or_state: Union[torch.nn.Module, Mapping]
                           ) -> Dict[str, torch.Tensor]:
    """A ``SpeechEnhancer(conv_norm="batch")`` (or its state dict) → the
    reference's state dict: float32 CPU tensors, the pointwise weights as
    (out, in, 1) convolutions, the BatchNorm's ``num_batches_tracked`` 0."""
    st = {k: v.detach().to("cpu") for k, v in _state(model_or_state).items()}
    blocks = sorted({int(k.split(".")[0][len("block_"):]) for k in st
                     if k.startswith("block_")})
    sd: Dict[str, torch.Tensor] = {}
    for name in _TOP:
        for leaf in ("weight", "bias"):
            sd[f"{name}.{leaf}"] = st[f"{name}.{leaf}"].float()
    for i in blocks:
        ours, theirs = f"block_{i}", f"blocks.{i}"
        if f"{ours}.ConvolutionModule_0.bn.weight" not in st:
            raise ValueError(
                "export requires conv_norm='batch' (reference BatchNorm); "
                f"{ours} has no bn parameters")
        for o, t in _BLOCK:
            for leaf in ("weight", "bias"):
                sd[f"{theirs}.{t}.{leaf}"] = st[f"{ours}.{o}.{leaf}"].float()
        qkv = f"{ours}.MultiHeadSelfAttention_0.qkv"
        sd[f"{theirs}.mhsa.attention.in_proj_weight"] = st[
            f"{qkv}.weight"].float()
        sd[f"{theirs}.mhsa.attention.in_proj_bias"] = st[f"{qkv}.bias"].float()
        for pw in ("pointwise1", "pointwise2"):
            sd[f"{theirs}.conv.{pw}.weight"] = st[
                f"{ours}.ConvolutionModule_0.{pw}.weight"].float()[:, :, None]
            sd[f"{theirs}.conv.{pw}.bias"] = st[
                f"{ours}.ConvolutionModule_0.{pw}.bias"].float()
        bn = f"{ours}.ConvolutionModule_0.bn"
        sd[f"{theirs}.conv.batch_norm.running_mean"] = st[f"{bn}.mean"].float()
        sd[f"{theirs}.conv.batch_norm.running_var"] = st[f"{bn}.var"].float()
        sd[f"{theirs}.conv.batch_norm.num_batches_tracked"] = torch.tensor(
            0, dtype=torch.int64)
    return sd


def save_reference_checkpoint(model_or_state, path: str) -> str:
    """Write a reference-format ``.pt``: ``{"model_state": ...,
    "model_class": "SpeechEnhancer"}``."""
    sd = {k: v.contiguous() for k, v in
          export_dcse_state_dict(model_or_state).items()}
    torch.save({"model_state": sd, "model_class": "SpeechEnhancer"}, path)
    return path
