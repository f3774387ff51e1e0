"""Reference PyTorch checkpoints into the port
(``sincformer_tpu/compat/torch_import.py``).

  * ``dnn_{mask}_final.pt`` / ``best_{mask}.pt`` → :func:`import_dnn_state_dict`
    → the state dict of ``models.dnn.SpeechEnhancementDNN``;
  * ``conformer_final.pt`` / ``best_conformer.pt`` →
    :func:`import_dcse_state_dict` → the state dict (BatchNorm statistics
    included) of ``models.dcse.SpeechEnhancer`` with ``conv_norm="batch"``.

Both models are torch modules on either side, so this is a renaming, not a
transposition: the reference's ``nn.Sequential`` indices become the named
layers, ``mhsa.attention.in_proj_*`` (q, k, v stacked) becomes ``qkv``, the
k = 1 ``pointwise*`` convolutions become ``Linear`` layers (their weights
squeezed), and ``batch_norm.running_{mean,var}`` become the BatchNorm
buffers ``bn.{mean,var}`` (``num_batches_tracked`` is dropped).

The imported model computes as the JAX package's import does: every
LayerNorm at flax's eps of 1e-6, where the reference's torch modules use
1e-5 (ROADMAP.md Queue 3).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(np.asarray(t) if not isinstance(t, torch.Tensor)
                           else t).detach().to("cpu", torch.float32).clone()


def import_dnn_state_dict(state_dict: Dict,
                          num_hidden_layers: int = 3) -> Dict[str, torch.Tensor]:
    """The reference ``SpeechEnhancementDNN.network`` Sequential (Linear at
    0, 3, 6, ..., the output Linear last) → ``hidden_i`` / ``output``."""
    out = {}
    names = [f"hidden_{i}" for i in range(num_hidden_layers)] + ["output"]
    for i, name in enumerate(names):
        for leaf in ("weight", "bias"):
            out[f"{name}.{leaf}"] = _f32(state_dict[f"network.{3 * i}.{leaf}"])
    return out


# (the port's name inside a block, the reference's) for the renamed leaves
_BLOCK = (("FeedForwardModule_0.LayerNorm_0", "ff1.layer_norm"),
          ("FeedForwardModule_0.Dense_0", "ff1.linear1"),
          ("FeedForwardModule_0.Dense_1", "ff1.linear2"),
          ("FeedForwardModule_1.LayerNorm_0", "ff2.layer_norm"),
          ("FeedForwardModule_1.Dense_0", "ff2.linear1"),
          ("FeedForwardModule_1.Dense_1", "ff2.linear2"),
          ("MultiHeadSelfAttention_0.LayerNorm_0", "mhsa.layer_norm"),
          ("MultiHeadSelfAttention_0.out", "mhsa.attention.out_proj"),
          ("ConvolutionModule_0.LayerNorm_0", "conv.layer_norm"),
          ("ConvolutionModule_0.depthwise", "conv.depthwise"),
          ("ConvolutionModule_0.bn", "conv.batch_norm"),
          ("LayerNorm_0", "final_norm"))
_TOP = ("input_norm", "input_proj", "output_norm", "mag_head", "phase_head")


def import_dcse_state_dict(state_dict: Dict,
                           num_blocks: int = 4) -> Dict[str, torch.Tensor]:
    """The reference DCSE ``SpeechEnhancer`` → the state dict of the port's
    ``SpeechEnhancer(conv_norm="batch")``, BatchNorm buffers included."""
    sd = state_dict
    out = {f"{name}.{leaf}": _f32(sd[f"{name}.{leaf}"])
           for name in _TOP for leaf in ("weight", "bias")}
    for i in range(num_blocks):
        ours, theirs = f"block_{i}", f"blocks.{i}"
        for o, t in _BLOCK:
            for leaf in ("weight", "bias"):
                out[f"{ours}.{o}.{leaf}"] = _f32(sd[f"{theirs}.{t}.{leaf}"])
        mhsa = f"{ours}.MultiHeadSelfAttention_0.qkv"
        out[f"{mhsa}.weight"] = _f32(sd[f"{theirs}.mhsa.attention."
                                        f"in_proj_weight"])
        out[f"{mhsa}.bias"] = _f32(sd[f"{theirs}.mhsa.attention.in_proj_bias"])
        for pw in ("pointwise1", "pointwise2"):
            out[f"{ours}.ConvolutionModule_0.{pw}.weight"] = _f32(
                sd[f"{theirs}.conv.{pw}.weight"])[:, :, 0]
            out[f"{ours}.ConvolutionModule_0.{pw}.bias"] = _f32(
                sd[f"{theirs}.conv.{pw}.bias"])
        bn = f"{theirs}.conv.batch_norm"
        out[f"{ours}.ConvolutionModule_0.bn.mean"] = _f32(
            sd[f"{bn}.running_mean"])
        out[f"{ours}.ConvolutionModule_0.bn.var"] = _f32(
            sd[f"{bn}.running_var"])
    return out


def _torch_load_safe(path: str, allow_pickle: bool):
    """``torch.load`` without running arbitrary code by default:
    ``weights_only=True`` first, with numpy's array types allow-listed
    (the reference's DNN checkpoints carry numpy ``feat_mean`` /
    ``feat_std``). A file that fails so raises, unless the caller opts in
    to full unpickling with ``allow_pickle=True``; discovery never does."""
    safe = [np.ndarray, np.dtype]
    core = getattr(np, "_core", None) or getattr(np, "core", np)
    fn = getattr(getattr(core, "multiarray", None), "_reconstruct", None)
    if fn is not None:
        safe.append(fn)
    try:
        from numpy import dtypes as _npdtypes
        safe.extend(v for v in vars(_npdtypes).values()
                    if isinstance(v, type))
    except ImportError:     # numpy < 1.25
        pass
    try:
        with torch.serialization.safe_globals(safe):
            return torch.load(path, map_location="cpu", weights_only=True)
    except OSError:             # no such file: not a weights-only refusal
        raise
    except Exception as e:
        if not allow_pickle:
            raise ValueError(
                f"{path} could not be loaded in safe (weights-only) mode: "
                f"{e}. If you trust this checkpoint, pass "
                f"allow_pickle=True to opt in to full unpickling.") from e
    return torch.load(path, map_location="cpu", weights_only=False)


def load_reference_checkpoint(path: str, allow_pickle: bool = False) -> Dict:
    """Load a reference ``.pt`` and convert it, by content: a DCSE
    checkpoint (``model_class: "SpeechEnhancer"`` or ``blocks.*`` keys)
    gives ``{"kind": "dcse", "config": DCSEConfig fields read off the
    shapes, "state_dict"}``; any other a DNN, ``{"kind": "dnn",
    "state_dict", "sizes"}`` and the ``feat_mean``, ``feat_std``,
    ``mask_type``, ``feature_dim``, ``mask_dim`` it carries."""
    ckpt = _torch_load_safe(path, allow_pickle)
    sd = ckpt["model_state"]
    if ckpt.get("model_class") == "SpeechEnhancer" or any(
            k.startswith("blocks.") for k in sd):
        n_blocks = 1 + max(int(k.split(".")[1]) for k in sd
                           if k.startswith("blocks."))
        # the head count is not in the shapes: the reference trains DCSE
        # with 4 heads; give num_heads for another configuration
        d_model, two_f = sd["input_proj.weight"].shape
        config = {"num_blocks": n_blocks, "d_model": int(d_model),
                  "n_freq": int(two_f) // 2,
                  "ff_dim": int(sd["blocks.0.ff1.linear1.weight"].shape[0]),
                  "kernel_size": int(
                      sd["blocks.0.conv.depthwise.weight"].shape[-1])}
        return {"kind": "dcse", "config": config,
                "state_dict": import_dcse_state_dict(sd, n_blocks)}
    n_hidden = sum(1 for k in sd if k.startswith("network.")
                   and k.endswith(".weight")) - 1
    state = import_dnn_state_dict(sd, n_hidden)
    out = {"kind": "dnn", "state_dict": state, "sizes": {
        "input_dim": int(state["hidden_0.weight"].shape[1]),
        "hidden_dim": int(state["hidden_0.weight"].shape[0]),
        "output_dim": int(state["output.weight"].shape[0]),
        "num_hidden_layers": n_hidden}}
    for k in ("feat_mean", "feat_std", "mask_type", "feature_dim",
              "mask_dim"):
        if k in ckpt:
            out[k] = ckpt[k]
    return out
