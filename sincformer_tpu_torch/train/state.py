"""Training state and checkpoints (``sincformer_tpu/train/state.py``): the
warmup-cosine schedule, the AdamW optimizer of flagship and DCSE training,
the Adam optimizer of the discriminator, the mask DNN's Adam with a learning
rate set between steps (ReduceLROnPlateau), all with the gradient clip, the
NaN guard, and checkpoints.

The directory layout is the JAX package's:

    <model_dir>/<family>/step_N/           the payload
    <model_dir>/<family>/step_N.meta.json  {"quantized": true, ...}
    <model_dir>/<family>/train_meta.json   {"output_gain": ..., ...}

The payload is the port's own: ``step_N/state.pt``, a ``torch.save`` of
plain dictionaries of tensors, read back with ``weights_only=True``:

    {"params": {name: f32 tensor}, "model_state": {name: tensor}, "step": N}
    {"params_q": {name: tensor | {"q": int8, "s": f32, "axis": int}},
     "model_state": {...}, "step": N}                    (int8 serving form)
    {"params": ..., "model_state": ..., "step": N,
     "opt_state": {"mu": {...}, "nu": {...}, "count": N[, "lr": x]},
     "nan_count": n}                                     (full training state)

``params`` are the model's parameters, keyed as in ``named_parameters()``
or ``state_dict()``, and ``model_state`` its buffers.
"""

from __future__ import annotations

import json
import math
import os
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from sincformer_tpu_torch.ops.quantize import dequantize_tree, quantize_tree

PAYLOAD = "state.pt"

# Version of the validation mixing, kept in best-checkpoint sidecars: 2 =
# validation mixtures use held-out noise crops (data.loader.heldout_noises).
# A resume trusts a persisted best_val only under the same protocol.
VAL_PROTOCOL = 2


def warmup_cosine_schedule(base_lr: float, total_epochs: int,
                           steps_per_epoch: int,
                           warmup_epochs: Optional[int] = None,
                           floor: float = 0.01) -> Callable[[int], float]:
    """Learning rate at step n (the optimizer's count before the update):
    linear warmup over ``warmup_epochs`` (default clamp(total // 5, 1, 5)),
    then cosine annealing to ``floor`` × the peak, changing once per epoch.
    Computed in float32, as the JAX package's schedule is."""
    if warmup_epochs is None:
        warmup_epochs = max(1, min(5, total_epochs // 5))
    f32 = np.float32

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        if epoch < warmup_epochs:
            factor = f32(epoch + 1) / f32(warmup_epochs)
        else:
            progress = f32(epoch - warmup_epochs) / f32(
                max(1, total_epochs - warmup_epochs))
            factor = max(f32(floor), f32(0.5) * (f32(1) + np.cos(
                f32(math.pi) * progress, dtype=np.float32)))
        return float(f32(base_lr) * f32(factor))

    return schedule


BETAS = (0.9, 0.98)
EPS = 1e-8
WEIGHT_DECAY = 0.01
GRAD_CLIP = 5.0     # global gradient norm


class AdamW:
    """Global-norm gradient clipping, then AdamW with decoupled weight decay
    on every parameter: ``optax.chain(clip_by_global_norm(grad_clip),
    adamw(schedule, *betas, EPS, weight_decay))``, step for step (by
    default the recipe's BETAS, WEIGHT_DECAY and GRAD_CLIP).

    The state is ``{"mu": {name: tensor}, "nu": {...}, "count": int}``. A
    parameter without a gradient takes a zero gradient, so its moments still
    decay and weight decay still acts on it, as optax does for a parameter
    that no computation reads. The update runs on the parameters' device
    with no host synchronisation.
    """

    def __init__(self, schedule: Callable[[int], float],
                 betas: Tuple[float, float] = BETAS,
                 weight_decay: float = WEIGHT_DECAY,
                 grad_clip: float = GRAD_CLIP):
        self.schedule = schedule
        self.betas = tuple(betas)
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip

    def learning_rate(self, state: dict) -> float:
        """The rate of the step that ``state`` is about to take."""
        return self.schedule(state["count"])

    @staticmethod
    def init(params: Mapping[str, torch.Tensor]) -> dict:
        return {"mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()},
                "count": 0}

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor],
               grads: Sequence[torch.Tensor], state: dict,
               norm: Optional[torch.Tensor] = None) -> None:
        """One step, in place on ``params`` (name → tensor) and ``state``;
        ``grads`` in the order of ``params``. ``norm``: the gradients'
        global norm when this rank holds slices of some of them (tensor
        parallelism: ``parallel.collectives.global_norm``); by default the
        norm of ``grads``."""
        names = list(params)
        ps = [params[k] for k in names]
        gs = list(grads)
        if norm is None:
            # one reduction over every element: PyTorch's CPU norm kernels
            # lose accuracy on long leaves (6e-6 relative off float64 at
            # 655k elements), where the sum stays at optax's accuracy
            flat = torch.cat([g.reshape(-1) for g in gs])
            norm = torch.sqrt(torch.sum(flat * flat))
        g_norm = norm
        # optax: (g / ‖g‖) · clip when ‖g‖ ≥ clip
        keep = g_norm < self.grad_clip
        denom = torch.where(keep, torch.ones_like(g_norm), g_norm)
        numer = torch.where(keep, torch.ones_like(g_norm),
                            torch.full_like(g_norm, self.grad_clip))
        gs = torch._foreach_mul(torch._foreach_div(gs, denom), numer)
        mu = [state["mu"][k] for k in names]
        nu = [state["nu"][k] for k in names]
        b1, b2 = self.betas
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, gs, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, gs, gs, value=1.0 - b2)
        lr = self.learning_rate(state)
        state["count"] += 1
        n = np.float32(state["count"])
        bc1 = float(np.float32(1) - np.float32(b1) ** n)
        bc2 = float(np.float32(1) - np.float32(b2) ** n)
        den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(den, EPS)
        u = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        if self.weight_decay:
            torch._foreach_add_(u, ps, alpha=self.weight_decay)
        torch._foreach_mul_(u, -lr)
        torch._foreach_add_(ps, u)


class Adam(AdamW):
    """The discriminator's optimizer: ``optax.chain(clip_by_global_norm(
    GRAD_CLIP), adam(lr))``, step for step: Adam with optax's defaults
    (betas (0.9, 0.999), eps 1e-8) and bias correction, no weight decay, a
    constant learning rate. Its state, its zero gradient for a parameter
    without one and the NaN guard that feeds it are AdamW's."""

    def __init__(self, lr: float):
        super().__init__(lambda step: lr, betas=(0.9, 0.999),
                         weight_decay=0.0)


class PlateauAdam(Adam):
    """The mask DNN's optimizer: ``optax.chain(clip_by_global_norm(5.0),
    inject_hyperparams(adam)(learning_rate))``, step for step. As with
    ``inject_hyperparams``, the learning rate is part of the state
    (``state["lr"]``, applied as a float32), so the trainer can change it
    between steps (:func:`set_injected_lr`) and a checkpoint keeps it."""

    def __init__(self, lr: float):
        super().__init__(lr)
        self.base_lr = float(lr)

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        state = super().init(params)
        state["lr"] = self.base_lr
        return state

    def learning_rate(self, state: dict) -> float:
        return float(np.float32(state["lr"]))


def make_adamw(base_lr: float, total_epochs: int, steps_per_epoch: int,
               betas: Tuple[float, float] = BETAS,
               weight_decay: float = WEIGHT_DECAY,
               grad_clip: float = GRAD_CLIP) -> AdamW:
    """AdamW with gradient clipping and the warmup-cosine schedule, the
    recipe of flagship and DCSE training (DCSE passes its config's betas,
    weight decay and clip)."""
    return AdamW(warmup_cosine_schedule(base_lr, total_epochs,
                                        steps_per_epoch),
                 betas, weight_decay, grad_clip)


def make_adam_plateau(base_lr: float) -> PlateauAdam:
    """Adam with gradient clipping and an injectable learning rate, the
    mask DNN's recipe (plateau reductions are the trainer's)."""
    return PlateauAdam(base_lr)


def set_injected_lr(opt_state: dict, lr: float) -> dict:
    """Set the learning rate of a :class:`PlateauAdam` state, in place (and
    returned): the next step takes it."""
    if "lr" not in opt_state:
        raise ValueError("not a PlateauAdam state: it has no learning rate")
    opt_state["lr"] = float(lr)
    return opt_state


def guard_nan_update(grads: Sequence[Optional[torch.Tensor]],
                     loss: torch.Tensor,
                     params: Sequence[torch.Tensor],
                     norm: Optional[torch.Tensor] = None
                     ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Zero every gradient when the loss or any gradient is not finite;
    a missing gradient (a parameter nothing reads) is a zero. Returns
    (gradients, is_bad), all on the device: the optimizer then takes its
    step with zero gradients (moments decay, weight decay acts, the count
    advances), as in the JAX package, and ``is_bad`` feeds the NaN
    counter. In a data-parallel step the flag is already global: the
    trainers pass the loss and gradients after ``average_over_ranks``,
    whose all-reduce carries a non-finite value on any rank to every rank,
    so every rank zeroes its step together. Under tensor parallelism a rank
    holds slices of some gradients: ``norm``, their global norm
    (``parallel.collectives.global_norm``), carries a non-finite element
    of any rank's slice to every rank, and the flag reads it."""
    gs = [torch.zeros_like(p) if g is None else g
          for g, p in zip(grads, params)]
    if norm is not None:
        finite = torch.isfinite(loss) & torch.isfinite(norm)
    else:
        finite = torch.isfinite(loss) & torch.isfinite(torch.stack(
            torch._foreach_norm(gs, ord=float("inf")))).all()
    is_bad = ~finite
    zero = torch.zeros((), dtype=gs[0].dtype, device=gs[0].device)
    return [torch.where(~is_bad, g, zero) for g in gs], is_bad


def guarded(grads: Sequence[Optional[torch.Tensor]], loss: torch.Tensor,
            params: Mapping[str, torch.Tensor], model, mesh) -> tuple:
    """:func:`guard_nan_update` of a trainer's step and the gradients'
    global norm for its optimizer: None without a model axis (the
    optimizer takes the norm of its gradients), else the norm over every
    model rank's slices (``parallel.collectives.global_norm``), read by the
    guard and zero after a guarded step. Returns (grads, is_bad, norm)."""
    from sincformer_tpu_torch.parallel import collectives
    from sincformer_tpu_torch.parallel.sharding import (has_model_axis,
                                                        split_flags)
    norm = None
    if has_model_axis(mesh):
        norm = collectives.global_norm(
            [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, params.values())],
            split_flags(model), mesh)
    grads, is_bad = guard_nan_update(grads, loss, params.values(), norm)
    if norm is not None:
        norm = torch.where(is_bad, torch.zeros_like(norm), norm)
    return grads, is_bad, norm


def broadcast_state(model, opt_state: dict, mesh, extra=()) -> None:
    """Global rank 0's parameters, buffers and AdamW moments (and the
    ``extra`` tensors) on every rank of ``mesh``: over the data axis and
    any sequence axis (a ring's ranks hold the same slices), then over the
    model axis for every tensor this rank holds whole (a split parameter's
    slice and its moments are the rank's own)."""
    from sincformer_tpu_torch.parallel import collectives
    tensors = [*model.parameters(), *model.buffers(),
               *opt_state["mu"].values(), *opt_state["nu"].values(), *extra]
    for axis in mesh.mesh_dim_names:
        if axis != "model":
            collectives.broadcast_(tensors, mesh, axis=axis)
    split = {name for name, p in model.named_parameters()
             if getattr(p, "tp_split", None) is not None}
    whole = [p for name, p in model.named_parameters() if name not in split]
    whole += [*model.buffers(), *extra]
    for moments in (opt_state["mu"], opt_state["nu"]):
        whole += [m for name, m in moments.items() if name not in split]
    if collectives.model_group_of(mesh) is not None:
        collectives.broadcast_(whole, mesh, axis="model")


def gathered_state(state: dict, model, mesh) -> dict:
    """A checkpoint state (``{"params", "model_state"[, "opt_state"]}``)
    with every split parameter and its AdamW moments gathered whole from
    the model ranks (a collective); unchanged without a model axis."""
    from sincformer_tpu_torch.parallel.sharding import (gathered,
                                                        has_model_axis)
    if not has_model_axis(mesh):
        return state
    state = dict(state, params=gathered(state["params"], model, mesh))
    opt = state.get("opt_state")
    if opt is not None:
        state["opt_state"] = dict(opt, mu=gathered(opt["mu"], model, mesh),
                                  nu=gathered(opt["nu"], model, mesh))
    return state


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


def checkpoint_step(path: str) -> int:
    """Numeric step of a ``.../step_N`` checkpoint directory (-1 if none)."""
    tail = os.path.basename(path.rstrip(os.sep))
    try:
        return int(tail[len("step_"):]) if tail.startswith("step_") else -1
    except ValueError:
        return -1


def newest_checkpoint(model_dir: str, names) -> Optional[str]:
    """The checkpoint with the highest step across the families ``names``
    (e.g. final and best): where a resume continues from."""
    best, best_n = None, -1
    for name in names:
        p = latest_step_dir(os.path.join(model_dir, name))
        if p is not None and checkpoint_step(p) > best_n:
            best, best_n = p, checkpoint_step(p)
    return best


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


def opt_state_to(opt: Mapping, device) -> dict:
    """An optimizer state ``{"mu", "nu", "count"[, "lr"]}`` with its moments
    on ``device``."""
    out = {"mu": {k: v.to(device) for k, v in opt["mu"].items()},
           "nu": {k: v.to(device) for k, v in opt["nu"].items()},
           "count": int(opt["count"])}
    if "lr" in opt:
        out["lr"] = float(opt["lr"])
    return out


def restore_training_state(path: str, device):
    """(optimizer state on ``device`` or None, NaN count as an int32 device
    scalar) of the checkpoint at ``path``: what a full checkpoint holds
    beside the weights (a serving one has neither: None and 0)."""
    restored = restore_checkpoint(path)
    opt = restored.get("opt_state")
    return (None if opt is None else opt_state_to(opt, device),
            torch.tensor(int(restored.get("nan_count", 0)), dtype=torch.int32,
                         device=device))


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
    float32 under ``ckpt_dir/step_<step>``, with the optimizer state
    (``"opt_state"``) and ``"nan_count"`` when ``state`` holds them (a full
    training checkpoint); ``extra`` goes to the ``step_<step>.meta.json``
    sidecar. Returns the checkpoint path."""
    payload = {"params": dict(state["params"]),
               "model_state": dict(state.get("model_state") or {}),
               "step": int(step)}
    if state.get("opt_state") is not None:
        opt = state["opt_state"]
        payload["opt_state"] = {"mu": dict(opt["mu"]), "nu": dict(opt["nu"]),
                                "count": int(opt["count"])}
        if "lr" in opt:
            payload["opt_state"]["lr"] = float(opt["lr"])
    if state.get("nan_count") is not None:
        payload["nan_count"] = int(state["nan_count"])
    return _write(ckpt_dir, step, payload, extra)


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
    ``{"params", "model_state", "step"}`` with float32 tensors on the CPU,
    and ``"opt_state"`` and ``"nan_count"`` from a full training
    checkpoint."""
    payload = torch.load(os.path.join(os.path.abspath(path), PAYLOAD),
                         map_location="cpu", weights_only=True)
    if read_step_meta(path).get("quantized", False):
        params = dequantize_tree(payload["params_q"])
    else:
        params = payload["params"]
    out = {"params": params, "model_state": payload.get("model_state", {}),
           "step": int(payload["step"])}
    for key in ("opt_state", "nan_count"):
        if key in payload:
            out[key] = payload[key]
    return out
