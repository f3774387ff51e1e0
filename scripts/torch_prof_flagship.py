"""Where the time goes in the port's enhancement requests, on one CUDA card.

    python3 scripts/torch_prof_flagship.py [--seed 0] [--out prof.json]

Full-width SincformerMetacog with random weights from a seeded
torch.Generator (the same model as chip_smoke.py). For each request shape
it reports the host wall time per request after warm-up (20 requests,
each ending in the copy of the result to the host), then profiles one
request with torch.profiler: device time by kernel, the device's busy
share of the unprofiled request's wall time, and the time of the
hand-written kernels (K1 speech attention, K3 fused feed-forward, K4 Meddis
hair cell). The same is done for the serving requests of chip_smoke.py: a
60 s int16 file through StreamingEnhancer's whole-file and segmented paths
(flagship, and DCSE with the fused and the unfused feed-forward), one step
of an OnlineEnhancerPool of 8 streams, the full-width mask DNN's
enhance_batch (16, 32000) and 60 s file (host path), and the auditory
front-end (gammatone bank and hair cell) on 16 signals of 4 s. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SHAPES = ((1, 8000), (1, 32000), (4, 32000), (16, 32000))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import sincformer_tpu_torch as port

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = port.SincformerMetacog().init_params(
        torch.Generator().manual_seed(args.seed))
    pipe = port.SincformerPipeline(model, device="cuda")
    rng = np.random.default_rng(args.seed)

    def measure(label, fn, audio_s, reps=20):
        """Wall per call after warm-up, then one profiled call."""
        for _ in range(3):
            fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        wall_ms = (time.perf_counter() - t0) / reps * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            prof_wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                          for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA),
                         key=lambda k: -k[1])
        busy_ms = sum(k[1] for k in kernels)
        k1_ms = sum(k[1] for k in kernels if "speech_attention" in k[0])
        k3_ms = sum(k[1] for k in kernels if "fused_ffn" in k[0])
        k4_ms = sum(k[1] for k in kernels if "meddis" in k[0])
        row = {"request": label, "audio_s": audio_s,
               "wall_ms": wall_ms, "rtf_x": audio_s / (wall_ms / 1e3),
               "profiled_wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
               "device_busy_share": busy_ms / wall_ms,
               "kernel_launches": sum(k[2] for k in kernels),
               "k1_ms": k1_ms, "k3_ms": k3_ms, "k4_ms": k4_ms, "top": [
                   {"kernel": k[0][:90], "ms": k[1], "calls": k[2]}
                   for k in kernels[:12]]}
        print(f"[{label}] {wall_ms:.3f} ms per request, "
              f"{row['rtf_x']:.1f}x real time; profiled request "
              f"{prof_wall_ms:.3f} ms wall, device busy {busy_ms:.3f} ms "
              f"({row['device_busy_share']:.3f} of the unprofiled "
              f"{wall_ms:.3f} ms), {row['kernel_launches']} "
              f"kernel launches, K1 {k1_ms:.4f} ms, K3 {k3_ms:.4f} ms, K4 "
              f"{k4_ms:.4f} ms",
              flush=True)
        for k in row["top"]:
            print(f"    {k['ms']:9.4f} ms {k['calls']:5d}x  {k['kernel']}")
        return row

    results = []
    for b, n in SHAPES:
        wav = np.round(rng.uniform(-0.3, 0.3, (b, n)) * 32767).astype(np.int16)
        row = measure(f"flagship enhance_batch ({b}, {n})",
                      lambda: pipe.enhance_batch(wav), b * n / 8000)
        row.update(batch=b, samples=n)
        results.append(row)

    # the serving requests: a 60 s file, and one step of a pool of 8 streams
    from sincformer_tpu_torch.serve import (OnlineEnhancerPool,
                                            StreamingEnhancer)
    pcm60 = np.round(rng.uniform(-0.3, 0.3, 480000) * 32767).astype(np.int16)
    gen = torch.Generator().manual_seed(args.seed)
    fused = port.DCSEPipeline(port.SpeechEnhancer(
        port.DCSEConfig(fused_ffn=True)).init_params(gen), device="cuda")
    unfused = port.DCSEPipeline(port.SpeechEnhancer(port.DCSEConfig()),
                                device="cuda")
    unfused.load_state(fused.model.state_dict())
    for name, p in (("flagship", pipe), ("dcse fused", fused),
                    ("dcse unfused", unfused)):
        for path, kw in (("whole-file", dict(pipelined=False)),
                         ("segmented", dict(pipelined=True, chunk_batch=4))):
            se = StreamingEnhancer(p, **kw)
            results.append(measure(f"{name} 60 s file, {path} path",
                                   lambda se=se: se.enhance(pcm60), 60.0,
                                   reps=5))
    pool = OnlineEnhancerPool(pipe, n_streams=8)
    live = rng.uniform(-0.3, 0.3, (8, 160)).astype(np.float32)

    def pool_step():
        for i in range(8):
            pool.push(i, live[i])
        pool.step()

    for i in range(8):                      # first chunks: fill the lookahead
        pool.push(i, np.zeros(240, np.float32))
    results.append(measure("flagship online pool, 8 streams, one 20 ms step",
                           pool_step, 8 * 0.02))

    # the original paper's mask DNN at full width, seeded weights, and the
    # auditory front-end
    dnn = port.DNNPipeline("pcirm", device="cuda", model=port.create_dnn(
        port.FeatureConfig().dim).init_params(gen))
    wav16 = np.round(rng.uniform(-0.3, 0.3, (16, 32000)) * 32767).astype(
        np.int16)
    results.append(measure("dnn enhance_batch (16, 32000)",
                           lambda: dnn.enhance_batch(wav16), 64.0))
    host_path = StreamingEnhancer(dnn)
    results.append(measure("dnn 60 s file, host path",
                           lambda: host_path.enhance(pcm60), 60.0, reps=5))
    gfb, hair = port.GammatoneFilterbank(), port.MeddisHairCell()
    drive = rng.uniform(-100.0, 100.0, (16, 32000)).astype(np.float32)
    results.append(measure(
        "auditory front-end, 16 x 4 s",
        lambda: hair.process_to_frames(gfb.filter(
            torch.from_numpy(drive).cuda())).cpu(), 64.0))
    report = {"card": card, "shapes": results}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
