"""Compare two ``evaluate --json-out`` records of the same protocol, e.g.
the port's against the JAX package's committed reference:

    python scripts/torch_eval_compare.py GOT.json \
        [artifacts/r5/eval_grid_jax_cpu.json] [--methods noisy sincformer]

Prints, per method and metric, both means, the absolute difference of the
means and the largest difference of one utterance
(``sincformer_tpu_torch.evaluation.grid.grid_differences``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("got")
    ap.add_argument("ref", nargs="?", default=os.path.join(
        REPO, "artifacts", "r5", "eval_grid_jax_cpu.json"))
    ap.add_argument("--methods", nargs="+", default=["noisy", "sincformer"])
    args = ap.parse_args()
    from sincformer_tpu_torch.evaluation.grid import grid_differences
    with open(args.got) as f:
        got = json.load(f)
    with open(args.ref) as f:
        ref = json.load(f)
    for method in args.methods:
        for k, d in grid_differences(got, ref, method).items():
            print(f"{method:>10} {k:<5} mean {got['summary'][f'{method}.{k}'][0]:.6f}"
                  f" vs {ref['summary'][f'{method}.{k}'][0]:.6f}: "
                  f"|Δ mean| {d['mean']:.3e}, largest |Δ| of one utterance "
                  f"{d['utterance']:.3e} ({d['where']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
