"""Convert a JAX int8 serving artifact of the flagship into the port's format.

    python scripts/torch_convert_artifact.py \
        [--src artifacts/r5/sincformer_v4s0_best_serving] \
        [--dst artifacts/r5/sincformer_v4s0_best_serving_torch]

Reads ``<src>/sincformer_final/step_N`` (an orbax tree with ``params_q`` and
``model_state``) with the JAX package, carries the int8 values over without
rounding them again (``compat.from_jax.convert_quantized_from_jax``) and
writes ``<dst>/sincformer_final/step_N/state.pt`` with the same sidecars:
``step_N.meta.json`` (``quantized``, the model's config) and
``train_meta.json`` (the source's keys, ``output_gain`` included, plus
``converted_from``). The result loads with torch and numpy alone. This
script is the one place outside the tests that imports both packages; it
runs on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
FAMILY = "sincformer_final"


def jax_state_for(step_dir: str):
    """A JAX TrainState of the model variant the checkpoint holds."""
    import tempfile

    from sincformer_tpu.train.agent_trainer import SincformerPipeline

    with tempfile.TemporaryDirectory() as scratch:
        pipe = SincformerPipeline(model_dir=scratch)
        pipe._match_model_to_checkpoint(step_dir)
        return pipe.init_state(epochs=1, steps_per_epoch=1)


def read_jax_serving_tree(step_dir: str, state):
    """(params_q, model_state, step) of a JAX int8 serving checkpoint, as
    numpy trees. ``state`` is a JAX TrainState of the same model; the
    restore template is built from it as the JAX package's own
    ``restore_checkpoint`` builds it (zeros in the quantized structure),
    but the tree is returned as it was saved, not dequantized."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import orbax.checkpoint as ocp

    from sincformer_tpu.ops.quantize import quantize_tree

    abstract = jax.eval_shape(quantize_tree, state.params)
    template = {"params_q": jax.tree.map(
        lambda s: jnp.zeros(s.shape, s.dtype), abstract),
        "step": jnp.asarray(state.step)}
    if state.model_state is not None:
        template["model_state"] = state.model_state
    restored = ocp.StandardCheckpointer().restore(os.path.abspath(step_dir),
                                                  template)
    tree = jax.tree.map(np.asarray, restored)
    return tree["params_q"], tree.get("model_state") or {}, int(tree["step"])


def convert(src: str, dst: str) -> str:
    import torch

    from sincformer_tpu.train.state import latest_step_dir
    from sincformer_tpu_torch.compat.from_jax import \
        convert_quantized_from_jax
    from sincformer_tpu_torch.train.state import PAYLOAD

    step_dir = latest_step_dir(os.path.join(src, FAMILY))
    if step_dir is None:
        raise FileNotFoundError(f"no {FAMILY}/step_N under {src}")
    params_q, model_state, step = read_jax_serving_tree(
        step_dir, jax_state_for(step_dir))
    params, buffers, config = convert_quantized_from_jax(params_q, model_state)
    out = os.path.join(dst, FAMILY, f"step_{step}")
    os.makedirs(out, exist_ok=True)
    torch.save({"params_q": params, "model_state": buffers, "step": step},
               os.path.join(out, PAYLOAD))
    with open(out + ".meta.json", "w") as f:
        json.dump({"quantized": True,
                   "config": dataclasses.asdict(config)}, f)
    with open(os.path.join(src, FAMILY, "train_meta.json")) as f:
        meta = json.load(f)
    meta["converted_from"] = os.path.relpath(step_dir, REPO)
    with open(os.path.join(dst, FAMILY, "train_meta.json"), "w") as f:
        json.dump(meta, f)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    base = os.path.join(REPO, "artifacts", "r5", "sincformer_v4s0_best_serving")
    ap.add_argument("--src", default=base)
    ap.add_argument("--dst", default=base + "_torch")
    args = ap.parse_args()
    out = convert(args.src, args.dst)
    size = sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(args.dst) for f in fs) / 1e6
    print(f"wrote {out} ({size:.1f} MB under {args.dst})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
