"""Tensor-parallel parameters (``sincformer_tpu/parallel/sharding.py``):
which parameters split over a mesh's ``"model"`` axis, the split itself,
and the forwards of the split layers.

The rule is the JAX package's, applied to the JAX package's layout: a
leaf splits on its last dimension when it has at least two dimensions,
that dimension is at least 64 and the axis size divides it. JAX's Dense
kernels are (in, out) and its Conv kernels (k, in, out), so the rule
splits output features; every other leaf (biases, norm scales, small
heads, counters) is replicated. The port keeps ``nn.Linear`` weights as
(out, in), Conv weights as (out, in/groups, k) and each CPEA direction's
four LSTM gate kernels folded into one (4H, ·) matrix, so
:func:`tp_param_shardings` takes each parameter's JAX-layout shape (the
mapping of ``compat/from_jax.py`` read backwards), applies the rule, and
gives the port's split: the dimension (0 for a weight, the last for a leaf
kept in JAX's layout) and the number of equal blocks it holds (4 for a
folded gate matrix, whose gates split each on their own, as JAX splits
each gate's kernel).

A split parameter holds only this rank's slice (:func:`shard_params`).
Its layer computes its column block of the product and the ranks' blocks
are gathered before the next operation (:func:`linear`, :func:`conv1d`),
so each rank stores and multiplies 1/n of the weight, as GSPMD splits the
JAX step. Where a split weight feeds a call that takes the whole matrix
(cuDNN's LSTM, kernel K3's ``W1``/``W2``, the memory's key bank), the rank
gathers the weight first and runs the call whole (:func:`whole`), as GSPMD
does for a custom call. Every forward with split parameters runs inside
``collectives.model_parallel(mesh)``; outside one it raises, so a sharded
model never runs on a slice as if it were the whole weight.

Head-aligned (Megatron) splits would change which leaves split; they are
not the JAX package's rule and are not used.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from sincformer_tpu_torch.parallel import collectives

# the JAX package's floor: below this output width the gather's latency
# outweighs the product it splits
_MIN_SPLIT_DIM = 64


class Split(NamedTuple):
    """A parameter's split in the port's layout: along ``dim``, which holds
    ``groups`` equal blocks, each split in n."""
    dim: int
    groups: int = 1


def has_model_axis(mesh, axis: str = "model") -> bool:
    """True when ``mesh`` carries a tensor-parallel axis of size > 1."""
    return collectives.model_group_of(mesh, axis) is not None


def tp_spec(shape: Sequence[int], n_shards: int, axis: str = "model",
            min_dim: int = _MIN_SPLIT_DIM) -> tuple:
    """JAX's PartitionSpec of a leaf of JAX-layout ``shape``, as a tuple:
    ``(None, ..., axis)`` when the last dimension splits, else ``()``."""
    shape = tuple(shape)
    if (len(shape) >= 2 and shape[-1] >= min_dim
            and shape[-1] % n_shards == 0):
        return (None,) * (len(shape) - 1) + (axis,)
    return ()


def _is_lstm_gates(name: str) -> bool:
    leaf = name.rsplit(".", 1)[-1]
    return leaf.startswith(("weight_ih_l", "kernel_hh_l"))


def _jax_layout(name: str, shape: Sequence[int]) -> tuple:
    """(JAX-layout shape of one leaf, the port's split dim when the JAX
    leaf's last dim splits, blocks): a folded LSTM gate matrix (4H, d)
    counts as four (d, H) kernels; a weight of two or three dimensions is
    a transposed Dense or Conv kernel; any other leaf keeps its shape."""
    shape = tuple(shape)
    if _is_lstm_gates(name):
        return (shape[1], shape[0] // 4), 0, 4
    if name.rsplit(".", 1)[-1] == "weight" and len(shape) in (2, 3):
        return tuple(reversed(shape)), 0, 1
    return shape, len(shape) - 1, 1


def _shape(p) -> tuple:
    return tuple(getattr(p, "tp_shape", None) or p.shape)


def tp_param_shardings(params: Union[nn.Module, Mapping], mesh,
                       axis: str = "model") -> Dict[str, Optional[Split]]:
    """{parameter name: :class:`Split` or None} for ``params`` (a module or
    a mapping of name to tensor or shape), by ``tp_spec`` on each leaf's
    JAX-layout shape. ``mesh`` is a mesh with ``axis`` or the axis size."""
    n = (mesh if isinstance(mesh, int)
         else mesh.size(mesh.mesh_dim_names.index(axis)))
    items = (params.named_parameters() if isinstance(params, nn.Module)
             else params.items())
    plan = {}
    for name, p in items:
        shape = tuple(p) if isinstance(p, (tuple, list, torch.Size)) \
            else _shape(p)
        jax_shape, dim, groups = _jax_layout(name, shape)
        plan[name] = (Split(dim, groups) if tp_spec(jax_shape, n, axis)
                      else None)
    return plan


def _rank(mesh, axis: str) -> tuple:
    return (mesh.size(mesh.mesh_dim_names.index(axis)),
            mesh.get_local_rank(axis))


@torch.no_grad()
def shard_params(model: nn.Module, mesh, axis: str = "model") -> nn.Module:
    """Keep only this rank's slice of every parameter that splits (in
    place; the parameter remembers its split and whole shape). The
    identity without a model axis, or with one of size 1; a parameter
    already split stays as it is."""
    if not has_model_axis(mesh, axis):
        return model
    n, r = _rank(mesh, axis)
    plan = tp_param_shardings(model, mesh, axis)
    for name, p in model.named_parameters():
        split = plan[name]
        if split is None or getattr(p, "tp_split", None) is not None:
            continue
        shape = tuple(p.shape)
        p.data = collectives.take(p.data, split.dim, split.groups, n,
                                  r).clone()
        p.tp_split, p.tp_shape = split, shape
    return model


def shard_state_params(model: nn.Module, opt_state: Optional[dict], mesh,
                       axis: str = "model") -> Optional[dict]:
    """:func:`shard_params` on the model, and the optimizer moments
    (``opt_state["mu"]``, ``["nu"]``, keyed by parameter name) cut as
    their parameters; the count stays whole. Returns the optimizer state
    (unchanged without a model axis)."""
    if not has_model_axis(mesh, axis):
        return opt_state
    n, r = _rank(mesh, axis)
    plan = tp_param_shardings(model, mesh, axis)
    shard_params(model, mesh, axis)
    params = dict(model.named_parameters())
    if opt_state is not None:
        for moments in (opt_state["mu"], opt_state["nu"]):
            for name, split in plan.items():
                m = moments[name]
                if split is not None and tuple(m.shape) != tuple(
                        params[name].shape):
                    moments[name] = collectives.take(
                        m, split.dim, split.groups, n, r).clone()
    return opt_state


def split_flags(model: nn.Module) -> list:
    """One flag per parameter (``named_parameters`` order): True where this
    rank holds a slice."""
    return [getattr(p, "tp_split", None) is not None
            for p in model.parameters()]


@torch.no_grad()
def gathered(tensors: Mapping[str, torch.Tensor], model: nn.Module, mesh,
             axis: str = "model") -> Dict[str, torch.Tensor]:
    """Whole copies of ``tensors`` (parameters, or tensors shaped as them,
    such as optimizer moments, by parameter name), each split one gathered
    from the model ranks (a collective: every model rank calls it)."""
    group = collectives.model_group_of(mesh, axis)
    params = dict(model.named_parameters())
    out = {}
    for name, t in tensors.items():
        split = getattr(params.get(name), "tp_split", None)
        if split is None or group is None:
            out[name] = t
        else:
            out[name] = collectives.merge(collectives.all_gather(t, group),
                                          split.dim, split.groups)
    return out


# ── the forwards of split layers ─────────────────────────────────────────

def _group(p: torch.Tensor):
    group = collectives.model_group()
    if group is None:
        raise RuntimeError(
            f"a parameter of shape {tuple(p.shape)} is one model rank's "
            f"slice of {p.tp_shape}: run the forward inside "
            f"parallel.collectives.model_parallel(mesh)")
    return group


def whole(p: torch.Tensor) -> torch.Tensor:
    """``p`` made whole on every model rank (the identity for a parameter
    that is not split); its gradient reaches this rank's slice."""
    split = getattr(p, "tp_split", None)
    if split is None:
        return p
    return collectives.gather(p, split.dim, split.groups, _group(p))


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer(x)``; with a split weight, this rank's column block of the
    product, the blocks gathered, then the (replicated) bias. In bfloat16
    the product is rounded before the bias is added, as flax's Dense
    rounds (the split form does so in any dtype)."""
    w = layer.weight
    if getattr(w, "tp_split", None) is None:
        if x.dtype == torch.bfloat16 and layer.bias is not None:
            return F.linear(x, w) + layer.bias
        return layer(x)
    group = _group(w)
    y = collectives.gather(F.linear(collectives.copy_to_model(x, group), w),
                           -1, 1, group)
    return y if layer.bias is None else y + layer.bias


def conv1d(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` on (B, C, T) input already padded; with a split weight,
    this rank's block of output channels (of a depthwise conv, from this
    rank's block of input channels), the blocks gathered, then the bias.
    In bfloat16 the convolution is rounded before the bias is added, as
    flax's Conv rounds."""
    w = conv.weight
    if getattr(w, "tp_split", None) is None:
        if x.dtype == torch.bfloat16 and conv.bias is not None:
            return F.conv1d(x, w, None, conv.stride, conv.padding,
                            conv.dilation, conv.groups) + conv.bias[:, None]
        return F.conv1d(x, w, conv.bias, conv.stride, conv.padding,
                        conv.dilation, conv.groups)
    return _conv1d_split(x, w, conv.bias, conv.stride, conv.padding,
                         conv.dilation, conv.groups,
                         depthwise=conv.groups > 1)


def _conv1d_split(x, w, bias, stride=1, padding=0, dilation=1, groups=1,
                  depthwise: bool = False):
    group = _group(w)
    x = collectives.copy_to_model(x, group)
    if depthwise:            # output channel c reads input channel c only
        x = collectives.take(x, 1, 1, dist.get_world_size(group),
                             dist.get_rank(group))
        groups = w.shape[0]
    y = collectives.gather(F.conv1d(x, w, None, stride, padding, dilation,
                                    groups), 1, 1, group)
    return y if bias is None else y + bias[:, None]


def depthwise_conv1d(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Depthwise ``F.conv1d`` of padded (B, C, T) input by a (C, 1, k)
    weight, split over the model ranks when the weight is. In bfloat16 the
    convolution is rounded before the bias is added, as in the JAX
    package's ``DepthwiseConv``."""
    if getattr(weight, "tp_split", None) is None:
        if x.dtype == torch.bfloat16 and bias is not None:
            return F.conv1d(x, weight, None,
                            groups=weight.shape[0]) + bias[:, None]
        return F.conv1d(x, weight, bias, groups=weight.shape[0])
    return _conv1d_split(x, weight, bias, depthwise=True)
