"""Does the port's bf16 forward of the committed artifact run the JAX
package's bf16 CPEA recurrence matrix?

    JAX_PLATFORMS=cpu python scripts/torch_bf16_artifact_cpea.py

The JAX CPEA's bf16 recurrent matrix is round(round(K) + round(b)), from
the separate kernel K and bias b of each gate's Dense. The port's serving
checkpoint stores the composed f32 matrix K + b·1ᵀ, and loading it
recovers K by subtraction, which can leave K an f32 ulp from JAX's. This
script loads the JAX int8 artifact (about half a minute) and the
converted one, and counts the elements of K, and of the bf16 matrix, that
differ between the two in f32 and after rounding to bf16. Runs on the
CPU; the one script besides the converter that imports both packages.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
JAX_ARTIFACT = os.path.join(REPO, "artifacts", "r5",
                            "sincformer_v4s0_best_serving", "sincformer_final")
PORT_ARTIFACT = os.path.join(REPO, "artifacts", "r5",
                             "sincformer_v4s0_best_serving_torch")
SUFFIXES = ("_l0", "_l0_reverse", "_l1", "_l1_reverse")   # LSTMCell_0..3
GATES = ("hi", "hf", "hg", "ho")


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


def main() -> int:
    import jax

    import sincformer_tpu_torch as port
    from sincformer_tpu.train.agent_trainer import SincformerPipeline
    from sincformer_tpu.train.state import latest_step_dir
    with tempfile.TemporaryDirectory() as scratch:
        jp = SincformerPipeline(model_dir=scratch)
        jp.load_model(latest_step_dir(JAX_ARTIFACT))
        params = jax.tree.map(np.asarray, jp.state.params)
    tp = port.SincformerPipeline(device="cpu", model_dir=PORT_ARTIFACT)
    tp.load_model()
    lstm = tp.model.cpea.lstm
    total = k_f32 = k_bf16 = matrix_bf16 = 0
    for i, sfx in enumerate(SUFFIXES):
        cell = params["cpea"][f"LSTMCell_{i}"]
        k = np.concatenate([cell[g]["kernel"] for g in GATES], -1)  # (H, 4H)
        b = np.concatenate([cell[g]["bias"] for g in GATES])
        k_port = getattr(lstm, f"kernel_hh{sfx}").detach().numpy().T
        b_port = getattr(lstm, f"bias_hh{sfx}").detach().numpy()
        if not np.array_equal(b, b_port):
            raise AssertionError(f"the biases of {sfx} differ")
        total += k.size
        k_f32 += int(np.sum(k != k_port))
        k_bf16 += int((_bf16(k) != _bf16(k_port)).sum())
        matrix_bf16 += int(((_bf16(k) + _bf16(b)[None])
                            != (_bf16(k_port) + _bf16(b)[None])).sum())
    print(f"CPEA recurrent kernels of the committed artifact: K differs "
          f"from JAX's at {k_f32} of {total} elements in f32, at {k_bf16} "
          f"rounded to bf16; the bf16 matrix round(round(K) + round(b)) "
          f"differs at {matrix_bf16}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
