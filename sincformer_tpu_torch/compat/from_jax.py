"""Carry a flax ``SincformerMetacog``, DCSE ``SpeechEnhancer`` or mask-DNN
``SpeechEnhancementDNN`` checkpoint over to the port.

``load_from_jax`` takes the flax variables as a nested dict of numpy arrays
(``params`` plus the ``maa_stats``, ``memory_bank`` and ``memory_stats``
collections of ``model_state``) and returns the torch ``state_dict``, the
buffers and the :class:`MetacogConfig` read off the tree. The port's modules
carry the flax names, so a torch key is the flax path joined with dots,
with these conversions:

  * Dense ``kernel`` (in, out) → ``weight`` (out, in);
  * Conv ``kernel`` (k, in, out) → ``weight`` (out, in, k), the depthwise
    (k, 1, D) → (D, 1, k) included;
  * norm ``scale`` → ``weight``;
  * ``cpea/LSTMCell_{2l, 2l+1}`` (layer l forward, backward) →
    ``cpea.lstm.{weight_ih, weight_hh, bias_ih, bias_hh}_l{l}[_reverse]``
    with the gates concatenated in (i, f, g, o) order and a zero input-side
    bias (flax keeps the bias on the recurrent side only). The JAX CPEA
    builds each recurrent matrix as ``Dense(eye(H))``, which is the kernel
    plus the bias in every row, and recurs with that; ``weight_hh`` is that
    same matrix, so the port gives the JAX package's numbers (a textbook
    LSTM cell would differ by (Σ_j h_j)·b per gate; ROADMAP.md Queue 3);
  * ``memory_bank/memory/x`` → ``memory.bank_x``; the other collections map
    ``<collection>/<module>/x`` → ``<module>.x``.

``load_dcse_from_jax`` does the same for the DCSE tree (Dense, LayerNorm,
GroupNorm, the depthwise conv, and BatchNorm with its ``batch_stats`` as
buffers); ``load_dcse_train_state_from_jax`` also carries optax's AdamW
state across, so that DCSE training continues in the port. ``convert_quantized_from_jax`` takes the JAX
package's int8 serving tree (``{"q": int8, "s": f32}`` nodes, scales along
the last axis) into the port's quantized form without rounding again: ``q``
is transposed like its kernel, ``s`` is kept, and the channel axis becomes
0. The CPEA recurrent matrices are the exception: they carry the folded
bias, which has no int8 form on the JAX grid, so they are dequantized,
folded and stored in float32 (1 MB of the flagship's 16 MB).

``load_dnn_from_jax`` and ``convert_quantized_dnn_from_jax`` do both for the
mask DNN (Dense layers only). ``load_vq_mask_quantizer_from_jax`` carries a
``VQMaskQuantizer``'s tree (``params/vq/centroids`` and the
``params/mask_estimator`` subtree) across: the centroids as ``vq.centroids``,
the mask DNN through ``load_dnn_from_jax``, its keys under
``mask_estimator.``.

``load_train_state_from_jax`` carries a JAX train state across so that
training continues in the port: the parameters keyed by the port's
parameter names (the CPEA's recurrent kernels K as ``kernel_hh`` and their
biases b as ``bias_hh``, separately, as the JAX tree holds them), the
``model_state`` collections as buffers, and optax's AdamW moments ``mu`` and
``nu`` mapped leaf for leaf the same way (every mapping is a transpose or a
concatenation, so a moment maps as its parameter does) with its ``count``.
``load_discriminator_from_jax`` does the same for the adversarial branch's
discriminator and its Adam moments (each (k, in, out) kernel transposed to
torch's (out, in, k)).

Every variant of the flagship carries over: the BiLRU mixer
(``cpea/bilru``: ``in_proj``, ``ln_i``, ``glu_i`` as above, and each
``lru_{fwd,bwd}_i``'s ``nu_log``, ``theta_log``, ``B_*``, ``C_*`` and ``D``
as they are, in flax's layout), the reference PA cascade (its 1×1 heads
are Conv kernels (1, in, out) → (out, in, 1)) and the dual stream
(``pa/embed_norm``; the chunk LayerNorm has no parameters).
:func:`infer_config` reads the variant off the tree as the JAX package
reads it off a checkpoint's metadata (``agents.metacog.variant_of``), and a
tree that fits no variant raises. Every leaf must be placed and every torch
parameter and buffer filled, with matching shapes, or it raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from sincformer_tpu_torch.config import DCSEConfig, MetacogConfig

_COLLECTIONS = ("maa_stats", "memory_bank", "memory_stats")
_GATES = ("i", "f", "g", "o")


def _is_q(node) -> bool:
    return isinstance(node, Mapping) and set(node) == {"q", "s"}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[tuple, Any]:
    """{path: leaf}; a quantized ``{"q", "s"}`` node counts as one leaf."""
    flat = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if _is_q(value):
            flat[path] = {"q": np.asarray(value["q"]),
                          "s": np.asarray(value["s"])}
        elif isinstance(value, Mapping):
            flat.update(_flatten(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def _dequantized(tree: Mapping) -> Dict:
    """The tree with every quantized node replaced by ``q * s`` in float32,
    the product the JAX package's ``dequantize_tree`` forms."""
    out = {}
    for key, value in tree.items():
        if _is_q(value):
            q, s = np.asarray(value["q"]), np.asarray(value["s"])
            out[key] = q.astype(np.float32) * s.astype(np.float32)
        elif isinstance(value, Mapping):
            out[key] = _dequantized(value)
        else:
            out[key] = value
    return out


def _count(names, prefix: str) -> int:
    return sum(1 for n in names if n.startswith(prefix))


def infer_config(variables: Mapping, **overrides: Any) -> MetacogConfig:
    """Sizes and variant of the model that ``variables`` belong to.

    ``num_heads``, ``sample_rate`` and ``sinc_kernel_size`` leave no trace
    in the tree, nor does ``hop`` in the reference cascade (it has no
    frame-rate parameters): they take the flagship's values unless
    overridden. The mxu encoder's own fields (blocks, envelope pool, fine
    activation and streams) keep their defaults for the reference cascade.
    """
    from sincformer_tpu_torch.agents.metacog import variant_of

    params = variables["params"]
    pa, cpea, msa = params["pa"], params["cpea"], params["msa"]
    variant = variant_of(".".join(path) for path in _flatten(
        {"pa": pa, "cpea": cpea}))
    if not {"pa_impl", "cpea_impl"} <= set(variant):
        raise ValueError(
            f"params fit no SincformerMetacog variant: the CPEA needs "
            f"'bilru' (ssm) or LSTMCell_* (lstm), has {sorted(cpea)}; the "
            f"PA needs 'downsample' (reference) or 'embed' (mxu), has "
            f"{sorted(pa)}")
    found: Dict[str, Any] = dict(variant)
    c_sinc = np.shape(pa["sinc"]["low_hz"])[0]
    if variant["pa_impl"] == "mxu":
        d = np.shape(pa["embed"]["bias"])[0]
        hop = np.shape(pa["embed"]["kernel"])[1] // c_sinc
        env_in = np.shape(pa["embed_env"]["kernel"])[1]
        found.update(hop=hop, pa_num_blocks=_count(pa, "block_"),
                     pa_env_pool=hop * c_sinc // env_in)
    else:
        d = np.shape(pa["downsample"]["bias"])[0]
    if variant["cpea_impl"] == "ssm":
        bilru = cpea["bilru"]
        found.update(cpea_hidden=np.shape(bilru["in_proj"]["bias"])[0] // 2,
                     cpea_layers=_count(bilru, "ln_"))
    else:
        found.update(
            cpea_hidden=np.shape(cpea["LSTMCell_0"]["hi"]["kernel"])[0],
            cpea_layers=_count(cpea, "LSTMCell_") // 2)
    blocks = [k for k in msa if k.startswith("block_")]
    block0 = msa["block_0"]
    found.update(
        encoder_channels=d,
        cpea_channels=np.shape(cpea["rho_s_head"]["bias"])[0],
        d_model=np.shape(msa["fusion2"]["bias"])[0],
        n_freq=np.shape(msa["mag_head"]["bias"])[0],
        msa_blocks=len(blocks),
        d_ff=np.shape(block0["FeedForwardModule_0"]["Dense_0"]["bias"])[0],
        kernel_size=np.shape(
            block0["ConvolutionModule_0"]["depthwise"]["kernel"])[0],
        vq_centroids=np.shape(params["vq"]["centroids"])[0],
        memory_slots=np.shape(params["memory"]["keys"])[0],
        episodic_slots=np.shape(variables.get("memory_bank", {}).get(
            "memory", {}).get("keys", np.zeros((0,))))[0],
    )
    if c_sinc * 4 != d:
        raise ValueError(f"SincConv has {c_sinc} channels, expected "
                         f"encoder_channels/4 = {d // 4}")
    fields = {f.name for f in dataclasses.fields(MetacogConfig)}
    unknown = set(overrides) - fields
    if unknown:
        raise TypeError(f"unknown MetacogConfig fields: {sorted(unknown)}")
    clash = {k for k in overrides if k in found and overrides[k] != found[k]}
    if clash:
        raise ValueError(f"overrides {sorted(clash)} contradict the "
                         f"checkpoint: {({k: found[k] for k in clash})}")
    return MetacogConfig(**{**{k: int(v) if not isinstance(v, str) else v
                               for k, v in found.items()}, **overrides})


def _param_leaf(path: tuple, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    leaf = path[-1]
    if leaf == "kernel":
        if arr.ndim == 2:
            return "weight", arr.T
        if arr.ndim == 3:
            return "weight", arr.transpose(2, 1, 0)
        raise ValueError(f"kernel of rank {arr.ndim} at {'/'.join(path)}")
    if leaf == "scale":
        return "weight", arr
    return leaf, arr


def _lstm(cpea: Mapping, num_layers: int) -> Dict[str, np.ndarray]:
    out = {}
    for layer in range(num_layers):
        for direction, suffix in ((0, ""), (1, "_reverse")):
            cell = cpea[f"LSTMCell_{2 * layer + direction}"]
            w_ih = np.concatenate([cell[f"i{g}"]["kernel"] for g in _GATES], 1)
            # the JAX cell materialises its recurrent matrix as
            # Dense(eye(H)) = kernel + bias in every row (agents/cpea.py,
            # _LSTMCellParams), so that is the matrix the port must use
            w_hh = np.concatenate([cell[f"h{g}"]["kernel"]
                                   + cell[f"h{g}"]["bias"][None, :]
                                   for g in _GATES], 1)
            b_hh = np.concatenate([cell[f"h{g}"]["bias"] for g in _GATES])
            key = f"cpea.lstm.{{}}_l{layer}{suffix}"
            out[key.format("weight_ih")] = w_ih.T
            out[key.format("weight_hh")] = w_hh.T
            out[key.format("bias_hh")] = b_hh
            out[key.format("bias_ih")] = np.zeros_like(b_hh)
    return out


def load_from_jax(variables: Mapping, **overrides: Any
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor],
                             MetacogConfig]:
    """flax variables (numpy leaves) → (state_dict, buffers, config).

    ``variables`` holds ``params`` and, when the model has them, the
    ``maa_stats``, ``memory_bank`` and ``memory_stats`` collections.
    ``overrides`` set the config fields the tree does not record.
    """
    from sincformer_tpu_torch.agents.metacog import SincformerMetacog

    params = variables["params"]
    config = infer_config(variables, **overrides)
    state = {}
    for path, arr in _flatten(params).items():
        if path[0] == "cpea" and path[1].startswith("LSTMCell_"):
            continue
        leaf, value = _param_leaf(path, arr)
        state[".".join(path[:-1] + (leaf,))] = value
    if config.cpea_impl == "lstm":
        state.update(_lstm(params["cpea"], config.cpea_layers))

    buffers = {}
    for collection in _COLLECTIONS:
        for path, arr in _flatten(variables.get(collection, {})).items():
            module, leaf = path[0], path[-1]
            if collection == "memory_bank":
                leaf = f"bank_{leaf}"
            buffers[f"{module}.{leaf}"] = arr

    with torch.device("meta"):
        skeleton = SincformerMetacog(config)
    _check_filled(skeleton, {**state, **buffers})

    return ({k: _tensor(v) for k, v in state.items()},
            {k: _tensor(v) for k, v in buffers.items()}, config)


def _named_params(params: Mapping, num_layers: int) -> Dict[str, np.ndarray]:
    """A flax parameter tree (or a tree of its shape, e.g. an Adam moment)
    → {port parameter name: array}, CPEA K and b separately."""
    out = {}
    for path, arr in _flatten(params).items():
        if path[0] == "cpea" and path[1].startswith("LSTMCell_"):
            continue
        leaf, value = _param_leaf(path, arr)
        out[".".join(path[:-1] + (leaf,))] = value
    cpea = params["cpea"]
    if not any(k.startswith("LSTMCell_") for k in cpea):
        return out                      # the BiLRU: every leaf as it is
    for layer in range(num_layers):
        for direction, suffix in ((0, ""), (1, "_reverse")):
            cell = cpea[f"LSTMCell_{2 * layer + direction}"]
            key = f"cpea.lstm.{{}}_l{layer}{suffix}"
            out[key.format("weight_ih")] = np.concatenate(
                [cell[f"i{g}"]["kernel"] for g in _GATES], 1).T
            out[key.format("kernel_hh")] = np.concatenate(
                [cell[f"h{g}"]["kernel"] for g in _GATES], 1).T
            out[key.format("bias_hh")] = np.concatenate(
                [cell[f"h{g}"]["bias"] for g in _GATES])
    return out


def _adam_state(opt_state):
    """The ``ScaleByAdamState`` (fields count, mu, nu) inside an optax
    state, e.g. ``make_adamw``'s chain; a dict with those keys passes."""
    if isinstance(opt_state, Mapping):
        return opt_state["count"], opt_state["mu"], opt_state["nu"]
    if all(hasattr(opt_state, f) for f in ("count", "mu", "nu")):
        return opt_state.count, opt_state.mu, opt_state.nu
    if isinstance(opt_state, (tuple, list)):
        for part in opt_state:
            found = _adam_state(part)
            if found is not None:
                return found
    return None


def load_train_state_from_jax(params: Mapping,
                              model_state: Optional[Mapping] = None,
                              opt_state: Any = None, **overrides: Any):
    """A JAX train state (numpy leaves) → (params, buffers, opt_state,
    config) for ``SincformerPipeline``: ``params`` keyed as the model's
    ``named_parameters()``, ``buffers`` as its buffers, ``opt_state`` in the
    form of ``train.state.AdamW`` (``{"mu", "nu", "count"}``, None when
    ``opt_state`` is None). ``opt_state`` is optax's state (the
    ``ScaleByAdamState`` in it is found) or ``{"count", "mu", "nu"}``."""
    from sincformer_tpu_torch.agents.metacog import SincformerMetacog

    _, buffers, config = load_from_jax({"params": params,
                                        **(model_state or {})}, **overrides)
    named = {k: _tensor(v) for k, v in _named_params(
        params, config.cpea_layers).items()}
    with torch.device("meta"):
        skeleton = SincformerMetacog(config)
    want = {k: tuple(p.shape) for k, p in skeleton.named_parameters()}
    got = {k: tuple(v.shape) for k, v in named.items()}
    if want != got:
        raise ValueError(f"train state does not fill the port's parameters: "
                         f"{sorted(set(want) ^ set(got))} "
                         f"{ {k: (got[k], want[k]) for k in want if k in got and got[k] != want[k]} }")
    for name, b in skeleton.named_buffers():
        if name.startswith("cpea.lstm.bias_ih"):
            buffers[name] = torch.zeros(b.shape)
    opt = None
    if opt_state is not None:
        count, mu, nu = _adam_state(opt_state)
        opt = {"mu": {k: _tensor(v) for k, v in _named_params(
                   mu, config.cpea_layers).items()},
               "nu": {k: _tensor(v) for k, v in _named_params(
                   nu, config.cpea_layers).items()},
               "count": int(np.asarray(count))}
    return named, buffers, opt, config


def _disc_named(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``MultiScaleDiscriminator`` tree (or one of its shape, e.g.
    an Adam moment; with or without the top ``params`` level) → {port
    parameter name: tensor}, each (k, in, out) kernel as (out, in, k)."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out = {}
    for path, arr in _flatten(tree).items():
        if path[-1] == "kernel_v":
            arr = np.transpose(arr, (2, 1, 0))
        out[".".join(path)] = _tensor(arr)
    return out


def load_discriminator_from_jax(params: Mapping, opt_state: Any = None):
    """The adversarial branch's JAX train state → (params, opt_state) for
    ``SincformerTrainer.load_disc_state``: the discriminator's parameters
    keyed as ``MultiScaleDiscriminator.named_parameters()`` and, given
    optax's state (the ``ScaleByAdamState`` in it is found) or
    ``{"count", "mu", "nu"}``, its Adam moments in the form of
    ``train.state.Adam`` (None when ``opt_state`` is None)."""
    from sincformer_tpu_torch.train.adversarial import \
        MultiScaleDiscriminator
    named = _disc_named(params)
    with torch.device("meta"):
        skeleton = MultiScaleDiscriminator(
            named["disc_0.conv_0.kernel_v"].shape[1])
    _check_filled(skeleton, named)
    opt = None
    if opt_state is not None:
        count, mu, nu = _adam_state(opt_state)
        opt = {"mu": _disc_named(mu), "nu": _disc_named(nu),
               "count": int(np.asarray(count))}
    return named, opt


def _tensor(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, copy=True))


def _check_filled(skeleton: torch.nn.Module, given: Mapping) -> None:
    expected = {k: tuple(v.shape) for k, v in skeleton.state_dict().items()}
    missing = sorted(set(expected) - set(given))
    extra = sorted(set(given) - set(expected))
    if missing or extra:
        raise ValueError(f"checkpoint does not fill the port's model: "
                         f"missing {missing}, not placed {extra}")
    wrong = {k: (tuple(np.shape(v)), expected[k]) for k, v in given.items()
             if tuple(np.shape(v)) != expected[k]}
    if wrong:
        raise ValueError(f"shape mismatch (checkpoint, port): {wrong}")


def infer_dcse_config(variables: Mapping, **overrides: Any) -> DCSEConfig:
    """Sizes and conv-module norm of the ``SpeechEnhancer`` that
    ``variables`` belong to (``bn`` parameters: "batch", ``gn``: "group",
    else "layer"). ``num_heads``, ``phase_bound_div``, ``attn_impl``,
    ``fused_ffn`` and the training fields leave no trace in the tree (the
    fused and unfused feed-forward modules share their parameters):
    defaults unless overridden."""
    params = variables["params"]
    if set(variables) - {"params", "batch_stats"}:
        raise ValueError(f"a SpeechEnhancer has params and batch_stats "
                         f"only, got {sorted(variables)}")
    block0 = params["block_0"]
    conv = block0["ConvolutionModule_0"]
    norm = "batch" if "bn" in conv else "group" if "gn" in conv else "layer"
    if (norm == "batch") != ("batch_stats" in variables):
        raise ValueError("a conv_norm='batch' tree needs its batch_stats "
                         "collection, and no other tree has one")
    found = dict(
        d_model=np.shape(params["input_proj"]["bias"])[0],
        num_blocks=_count(params, "block_"),
        ff_dim=np.shape(block0["FeedForwardModule_0"]["Dense_0"]["bias"])[0],
        kernel_size=np.shape(conv["depthwise"]["kernel"])[0],
        n_freq=np.shape(params["mag_head"]["bias"])[0])
    return DCSEConfig(**{**{k: int(v) for k, v in found.items()},
                         "conv_norm": norm, **overrides})


def _dcse_named(params: Mapping) -> Dict[str, np.ndarray]:
    """A flax ``SpeechEnhancer`` parameter tree (or one of its shape, e.g.
    an Adam moment) → {port parameter name: array}."""
    out = {}
    for path, arr in _flatten(params).items():
        leaf, value = _param_leaf(path, arr)
        out[".".join(path[:-1] + (leaf,))] = value
    return out


def _dcse_buffers(batch_stats: Optional[Mapping]) -> Dict[str, np.ndarray]:
    """flax ``batch_stats`` (``block_i/ConvolutionModule_0/bn/{mean,
    var}``) → the BatchNorm buffers, keyed by the same path."""
    return {".".join(path): arr
            for path, arr in _flatten(batch_stats or {}).items()}


def load_dcse_from_jax(variables: Mapping, **overrides: Any
                       ) -> Tuple[Dict[str, torch.Tensor], DCSEConfig]:
    """flax ``SpeechEnhancer`` variables (numpy leaves: ``params`` and, for
    ``conv_norm="batch"``, ``batch_stats``) → (state_dict with the
    BatchNorm buffers, config). ``overrides`` set the config fields the
    tree does not record, e.g. ``fused_ffn=True``."""
    from sincformer_tpu_torch.models.dcse import SpeechEnhancer

    config = infer_dcse_config(variables, **overrides)
    state = {**_dcse_named(variables["params"]),
             **_dcse_buffers(variables.get("batch_stats"))}
    with torch.device("meta"):
        skeleton = SpeechEnhancer(config)
    _check_filled(skeleton, state)
    return {k: _tensor(v) for k, v in state.items()}, config


def load_dcse_train_state_from_jax(params: Mapping,
                                   batch_stats: Optional[Mapping] = None,
                                   opt_state: Any = None, **overrides: Any):
    """A JAX DCSE train state (numpy leaves) → (params, buffers, opt_state,
    config) for ``train.dcse_trainer.DCSETrainer``: the parameters keyed
    as the model's ``named_parameters()``, the ``batch_stats`` as its
    BatchNorm buffers, and optax's AdamW moments and count (the
    ``ScaleByAdamState`` inside ``make_adamw``'s chain, or ``{"count",
    "mu", "nu"}``) in the form of ``train.state.AdamW`` (None when
    ``opt_state`` is None); each moment maps as its parameter does."""
    variables = {"params": params}
    if batch_stats:
        variables["batch_stats"] = batch_stats
    state, config = load_dcse_from_jax(variables, **overrides)
    buffers = {k: state.pop(k) for k in _dcse_buffers(batch_stats)}
    opt = None
    if opt_state is not None:
        count, mu, nu = _adam_state(opt_state)
        opt = {"mu": {k: _tensor(v) for k, v in _dcse_named(mu).items()},
               "nu": {k: _tensor(v) for k, v in _dcse_named(nu).items()},
               "count": int(np.asarray(count))}
    return state, buffers, opt, config


def _quantized_leaves(flat: Mapping[tuple, Any]) -> Dict[str, Any]:
    """The ``{"q", "s"}`` nodes of a flattened JAX int8 tree in the port's
    form: ``q`` transposed like its kernel, ``s`` kept, the channel axis 0
    for a kernel and the last axis otherwise."""
    out = {}
    for path, node in flat.items():
        if not _is_q(node):
            continue
        q = node["q"]
        if path[-1] == "kernel":
            _, q = _param_leaf(path, q)
            axis = 0
        else:
            axis = q.ndim - 1
        leaf = "weight" if path[-1] == "kernel" else path[-1]
        out[".".join(path[:-1] + (leaf,))] = {
            "q": _tensor(q), "s": _tensor(node["s"]), "axis": axis}
    return out


def _dnn_params(variables: Mapping) -> Mapping:
    params = variables.get("params", variables)
    if set(variables) - {"params"} and "params" in variables:
        raise ValueError(f"the mask DNN has parameters only, got collections "
                         f"{sorted(set(variables) - {'params'})}")
    hidden = sorted(k for k in params if k.startswith("hidden_"))
    if not hidden or "output" not in params or set(params) - set(hidden) - {
            "output"}:
        raise ValueError(f"not a SpeechEnhancementDNN tree: {sorted(params)}")
    return params


def load_dnn_from_jax(variables: Mapping, dropout: float = 0.2
                      ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """flax ``SpeechEnhancementDNN`` variables (numpy leaves; ``{"params":
    ...}`` or the parameter tree itself, f32 or the int8 serving form) →
    (state_dict, the model's size arguments). Dense ``hidden_i`` / ``output``
    kernels (in, out) become ``nn.Linear`` weights (out, in). ``dropout``
    leaves no trace in the tree."""
    from sincformer_tpu_torch.models.dnn import SpeechEnhancementDNN

    params = _dequantized(_dnn_params(variables))
    state = {}
    for path, arr in _flatten(params).items():
        leaf, value = _param_leaf(path, arr)
        state[".".join(path[:-1] + (leaf,))] = value
    n_hidden = _count(params, "hidden_")
    sizes = {"input_dim": int(np.shape(params["hidden_0"]["kernel"])[0]),
             "hidden_dim": int(np.shape(params["hidden_0"]["kernel"])[1]),
             "output_dim": int(np.shape(params["output"]["bias"])[0]),
             "num_hidden_layers": n_hidden, "dropout": dropout}
    with torch.device("meta"):
        skeleton = SpeechEnhancementDNN(**sizes)
    _check_filled(skeleton, state)
    return {k: _tensor(v) for k, v in state.items()}, sizes


def load_vq_mask_quantizer_from_jax(
        variables: Mapping) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """flax ``VQMaskQuantizer`` variables around the mask DNN (``init``'s
    ``{"params": ...}``, numpy leaves) → (the state_dict of the port's
    ``models.vq.VQMaskQuantizer``, the DNN's size arguments)."""
    params = variables["params"]
    if set(params) != {"mask_estimator", "vq"} or set(params["vq"]) != {
            "centroids"}:
        raise ValueError(f"not a VQMaskQuantizer tree: {sorted(params)}")
    state, sizes = load_dnn_from_jax({"params": params["mask_estimator"]})
    out = {f"mask_estimator.{k}": v for k, v in state.items()}
    out["vq.centroids"] = _tensor(params["vq"]["centroids"])
    return out, sizes


def convert_quantized_dnn_from_jax(params_q: Mapping, dropout: float = 0.2):
    """The JAX package's int8 serving tree of a ``SpeechEnhancementDNN`` →
    (params_q in the port's form, the model's size arguments), without
    rounding again: ``ops.quantize.dequantize_tree`` of the result equals
    :func:`load_dnn_from_jax` of the same tree bit for bit."""
    state, sizes = load_dnn_from_jax(params_q, dropout)
    out: Dict[str, Any] = dict(state)
    out.update(_quantized_leaves(_flatten(_dnn_params(params_q))))
    return out, sizes


def convert_quantized_from_jax(params_q: Mapping,
                               model_state: Optional[Mapping] = None,
                               **overrides: Any):
    """The JAX package's int8 serving tree of a ``SincformerMetacog`` →
    (params_q, buffers, config) in the port's form (see the module
    docstring); ``ops.quantize.dequantize_tree(params_q)`` equals
    :func:`load_from_jax` of the JAX package's own dequantized tree bit for
    bit. No value is rounded again."""
    state, buffers, config = load_from_jax(
        {"params": _dequantized(params_q), **(model_state or {})},
        **overrides)
    out: Dict[str, Any] = dict(state)
    flat = _flatten(params_q)
    out.update(_quantized_leaves({
        path: node for path, node in flat.items()
        if not (path[0] == "cpea" and path[1].startswith("LSTMCell_"))}))
    # input-side LSTM matrices: the four gates' int8 kernels stacked
    for layer in range(config.cpea_layers if config.cpea_impl == "lstm"
                       else 0):
        for direction, suffix in ((0, ""), (1, "_reverse")):
            gates = [flat[("cpea", f"LSTMCell_{2 * layer + direction}",
                           f"i{g}", "kernel")] for g in _GATES]
            if all(_is_q(g) for g in gates):
                out[f"cpea.lstm.weight_ih_l{layer}{suffix}"] = {
                    "q": _tensor(np.concatenate([g["q"].T for g in gates])),
                    "s": _tensor(np.concatenate([g["s"] for g in gates])),
                    "axis": 0}
    return out, buffers, config
