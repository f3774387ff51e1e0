"""Score the committed flagship artifact with the JAX package's evaluation
grid on the CPU: the reference that the port's ``evaluate`` verb is held
against.

    JAX_PLATFORMS=cpu python scripts/torch_eval_reference.py \
        [--model-dir artifacts/r5/sincformer_v4s0_best_serving] \
        [--json-out artifacts/r5/eval_grid_jax_cpu.json]

Runs ``sincformer_tpu.evaluation.grid.run_grid_evaluation`` with the
``evaluate`` verb's defaults (``--max-eval 50``, ``--ckpt final``): without
TIMIT and NOISEX-92 that is 8 synthetic utterances of 2 s drawn from seed
99, one white noise, the SNRs -5, 0, 5 and 10 dB, and the five metrics
(the simplified STOI, PESQ from the native P.862, SSNR, CSII, NCM). It
writes the grid's ``--json-out`` record: the protocol, every per-cell value
and the grand summary. This script is one of the places outside the tests
that import the JAX package; it pins JAX to the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model-dir", default=os.path.join(
        "artifacts", "r5", "sincformer_v4s0_best_serving"),
                    help="relative to the repository's root")
    ap.add_argument("--json-out", default=os.path.join(
        "artifacts", "r5", "eval_grid_jax_cpu.json"))
    args = ap.parse_args()
    json_out = os.path.abspath(args.json_out)
    os.chdir(REPO)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["SINCFORMER_CKPT_PREF"] = "final"
    import jax
    jax.config.update("jax_default_device", jax.devices("cpu")[0])

    from sincformer_tpu.evaluation.grid import run_grid_evaluation
    summary = run_grid_evaluation(max_eval=50, model_dir=args.model_dir,
                                  json_out=json_out)
    return 0 if summary is not None else 1


if __name__ == "__main__":
    sys.exit(main())
