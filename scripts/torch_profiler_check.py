"""Which kernels torch.profiler records in successive profiles of one
process, on one CUDA card. The port's kernels are launched through ctypes
from libraries that carry their own copy of the CUDA runtime (nvcc links it
statically); PyTorch's through its own.

    python3 scripts/torch_profiler_check.py [--out profiler_check.json]

Builds the kernels (sincformer_tpu_torch/ops/build.py), then runs each
sequence of ``SEQUENCES`` in a process of its own, once with the
environment as it is and once with ``TEARDOWN_CUPTI=0`` (the profiler then
keeps CUPTI attached between profiles). A step is

  * ``port``: K6 (``env_act``, f32) and K5's bf16 form (``conv1d_gn``),
    no PyTorch kernel;
  * ``mixed``: a PyTorch multiply, K1 (``speech_attention``), K3
    (``fused_ffn``), K6 and K5's bf16 form;
  * ``torch``: the PyTorch multiply alone;
  * ``graph``: K6 and K5's bf16 form captured in a CUDA graph and replayed
    (not profiled).

Each profiled step is one ``torch.profiler.profile`` with CPU and CUDA
activities around the calls and a synchronisation, as chip_smoke.py's
``profile_once`` takes it. For each it prints the device kernels that
``key_averages()`` lists, their device time, and which of the kernels the
step launched it lacks.
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SEQUENCES = {
    "ports_first": ("port", "port", "mixed", "torch", "port", "graph", "port",
                    "mixed"),
    "torch_first": ("torch", "port", "mixed"),
    "graph_first": ("graph", "port", "mixed"),
}
# name fragments of the kernels each step launches
EXPECTED = {
    "port": ("envact_kernel", "conv_bf16_kernel"),
    "mixed": ("elementwise", "speech_attention_kernel", "fused_ffn_kernel",
              "envact_kernel", "conv_bf16_kernel"),
    "torch": ("elementwise",),
}


def child(sequence) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sincformer_tpu_torch.ops.conv_gn import conv1d_gn
    from sincformer_tpu_torch.ops.envact import env_act
    from sincformer_tpu_torch.ops.fused_ffn import fused_ffn
    from sincformer_tpu_torch.ops.speech_attention import speech_attention
    g = torch.Generator(device="cuda").manual_seed(0)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=g) * scale
    x6, s6 = r(2, 800, 64), r(64).abs() + 0.5
    a5 = [r(2, 400, 64).bfloat16(), r(7, 64, 64, scale=0.05).bfloat16(),
          r(64, scale=0.1).bfloat16(), (1 + r(64, scale=0.1)).bfloat16(),
          r(64, scale=0.1).bfloat16(), None]
    qkv = [r(2, 100, 4, 64) for _ in range(3)]
    ffn = [r(2, 100, 256), 1 + r(256, scale=0.1), r(256, scale=0.1),
           r(256, 1024, scale=0.06), r(1024, scale=0.1),
           r(1024, 256, scale=0.03), r(256, scale=0.1)]

    def port():
        env_act(x6, s6)
        conv1d_gn(*a5, 1, 16)

    def mixed():
        x6.mul(2.0)
        speech_attention(*qkv)
        fused_ffn(*ffn)
        port()
    steps = {"port": port, "mixed": mixed, "torch": lambda: x6.mul(2.0)}
    for fn in steps.values():       # warm: caches, shared-memory limits
        fn()
    torch.cuda.synchronize()
    out = []
    for step in sequence:
        if step == "graph":
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                port()
            graph.replay()
            torch.cuda.synchronize()
            out.append({"step": step})
            continue
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            steps[step]()
            torch.cuda.synchronize()
        kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        try:
            raw = [e.name() for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA]
        except AttributeError:
            raw = None
        out.append({"step": step, "kernels": kernels, "raw_device_events":
                    raw, "missing": [f for f in EXPECTED[step]
                                     if not any(f in k[0] for k in kernels)]})
    return {"sequence": list(sequence), "steps": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(SEQUENCES[args.child])), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from sincformer_tpu_torch.ops import build
    build.build_all()
    result = {}
    for teardown in (None, "0"):
        env = dict(os.environ)
        if teardown is not None:
            env["TEARDOWN_CUPTI"] = teardown
        for name in SEQUENCES:
            key = f"{name}, TEARDOWN_CUPTI={teardown or 'unset'}"
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", name],
                env=env, capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                print(f"[profiler] {key}: failed\n{proc.stderr[-4000:]}")
                return 1
            result[key] = json.loads(proc.stdout.strip().splitlines()[-1])
            for i, st in enumerate(result[key]["steps"]):
                if "kernels" not in st:
                    print(f"[profiler] {key} step {i} graph (not profiled)")
                    continue
                print(f"[profiler] {key} step {i} {st['step']}: "
                      f"{len(st['kernels'])} kernels listed, device "
                      f"{sum(k[1] for k in st['kernels']):.4f} ms, raw "
                      f"device events "
                      f"{'n/a' if st['raw_device_events'] is None else len(st['raw_device_events'])}"
                      f", missing {st['missing'] or 'none'}: "
                      + ", ".join(k[0][:40] for k in st["kernels"]),
                      flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
