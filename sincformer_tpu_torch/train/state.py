"""Serving checkpoints (the checkpoint part of
``sincformer_tpu/train/state.py``; optimizer state belongs to the training
slice).

The directory layout is the JAX package's:

    <model_dir>/<family>/step_N/           the payload
    <model_dir>/<family>/step_N.meta.json  {"quantized": true, ...}
    <model_dir>/<family>/train_meta.json   {"output_gain": ..., ...}

The payload is the port's own: ``step_N/state.pt``, a ``torch.save`` of
plain dictionaries of tensors, read back with ``weights_only=True``:

    {"params": {name: f32 tensor}, "model_state": {name: tensor}, "step": N}
    {"params_q": {name: tensor | {"q": int8, "s": f32, "axis": int}},
     "model_state": {...}, "step": N}                    (int8 serving form)

``params`` are the model's parameters and ``model_state`` its buffers, both
keyed as in ``state_dict()``.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Mapping, Optional, Tuple

import torch

from sincformer_tpu_torch.ops.quantize import dequantize_tree, quantize_tree

PAYLOAD = "state.pt"


def latest_step_dir(base: str) -> Optional[str]:
    """Newest ``step_N`` checkpoint under ``base``, by numeric step (so
    ``step_336`` beats ``step_98``); sidecars and temporary directories are
    skipped."""
    if not os.path.isdir(base):
        return None
    best, best_n = None, -1
    for d in os.listdir(base):
        if not d.startswith("step_") or d.endswith(".json") \
                or d.endswith("-tmp"):
            continue
        try:
            n = int(d[len("step_"):])
        except ValueError:
            continue
        if n > best_n:
            best, best_n = d, n
    return os.path.join(base, best) if best else None


def inference_ckpt_order(final_name: str, best_name: str) -> Tuple[str, str]:
    """Checkpoint-family preference for inference loads with no explicit
    path: the completed-run family first, or the best-validation family
    first when ``SINCFORMER_CKPT_PREF=best``."""
    pref = os.environ.get("SINCFORMER_CKPT_PREF", "final").strip().lower()
    if pref == "best":
        return (best_name, final_name)
    return (final_name, best_name)


def write_train_meta(model_dir: str, name: str, meta: dict) -> None:
    """Sidecar JSON next to a named checkpoint family."""
    os.makedirs(os.path.join(model_dir, name), exist_ok=True)
    with open(os.path.join(model_dir, name, "train_meta.json"), "w") as f:
        json.dump(meta, f)


def read_train_meta(model_dir: str, name: str) -> Optional[dict]:
    try:
        with open(os.path.join(model_dir, name, "train_meta.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def merge_train_meta(model_dir: str, name: str, updates: dict) -> dict:
    """Read-modify-write of the sidecar, so independent writers keep each
    other's keys."""
    meta = read_train_meta(model_dir, name) or {}
    meta.update(updates)
    write_train_meta(model_dir, name, meta)
    return meta


def resolve_output_gain(step_dir: str) -> float:
    """Output gain to apply at inference for the checkpoint at ``step_dir``
    (a ``.../family/step_N`` path): the validation-calibrated
    ``output_gain`` of the family's sidecar, default 1.0.
    ``SINCFORMER_OUTPUT_GAIN`` overrides: ``off`` disables calibration, a
    number forces that gain."""
    env = os.environ.get("SINCFORMER_OUTPUT_GAIN", "").strip().lower()
    if env in ("off", "none", "disable", "disabled"):
        return 1.0
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    fam = os.path.dirname(os.path.abspath(step_dir))
    meta = read_train_meta(os.path.dirname(fam), os.path.basename(fam))
    try:
        g = float((meta or {}).get("output_gain", 1.0))
    except (TypeError, ValueError):
        return 1.0
    return g if math.isfinite(g) and g > 0 else 1.0


def _cpu(tree):
    if isinstance(tree, Mapping):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def _write(ckpt_dir: str, step: int, payload: dict,
           meta: Optional[dict]) -> str:
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step}"))
    os.makedirs(path, exist_ok=True)
    torch.save(_cpu(payload), os.path.join(path, PAYLOAD))
    if meta:
        with open(os.path.join(ckpt_dir, f"step_{step}.meta.json"), "w") as f:
            json.dump(meta, f)
    return path


def save_checkpoint(ckpt_dir: str, state: Mapping, step: int,
                    extra: Optional[dict] = None) -> str:
    """Persist ``state`` = ``{"params": {...}, "model_state": {...}}`` in
    float32 under ``ckpt_dir/step_<step>``; ``extra`` goes to the
    ``step_<step>.meta.json`` sidecar. Returns the checkpoint path."""
    return _write(ckpt_dir, step, {
        "params": dict(state["params"]),
        "model_state": dict(state.get("model_state") or {}),
        "step": int(step)}, extra)


def save_checkpoint_quantized(ckpt_dir: str, state: Mapping, step: int,
                              extra: Optional[dict] = None) -> str:
    """Serving checkpoint: parameters int8-quantized per output channel
    (``ops.quantize.quantize_tree``: kernel K2 when they lie on the card),
    about four times smaller on disk. Restored by :func:`restore_checkpoint`,
    which dequantizes on load."""
    meta = dict(extra or {})
    meta["quantized"] = True
    return _write(ckpt_dir, step, {
        "params_q": quantize_tree(state["params"]),
        "model_state": dict(state.get("model_state") or {}),
        "step": int(step)}, meta)


def read_step_meta(path: str) -> dict:
    """The ``step_N.meta.json`` sidecar of the checkpoint at ``path``
    (empty when there is none)."""
    try:
        with open(os.path.abspath(path).rstrip(os.sep) + ".meta.json") as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def restore_checkpoint(path: str) -> Dict:
    """Load a checkpoint written by :func:`save_checkpoint` or
    :func:`save_checkpoint_quantized` (detected from the sidecar's
    ``"quantized": true`` and dequantized on load). Returns
    ``{"params", "model_state", "step"}`` with float32 tensors on the CPU."""
    payload = torch.load(os.path.join(os.path.abspath(path), PAYLOAD),
                         map_location="cpu", weights_only=True)
    if read_step_meta(path).get("quantized", False):
        params = dequantize_tree(payload["params_q"])
    else:
        params = payload["params"]
    return {"params": params, "model_state": payload.get("model_state", {}),
            "step": int(payload["step"])}
