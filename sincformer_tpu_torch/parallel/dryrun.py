"""The port's multi-device dry run (``__graft_entry__.py``
``dryrun_multichip``): n processes in one gloo group on a
("data", "model") mesh of (n/2, 2) for an even n, else (n, 1), run the JAX
dry run's four checks at its tiny widths, in its order, with its bars:

  1. one training step of a tiny flagship, the batch split over the data
     axis and the parameters over the model axis (the rule must split
     some); the loss must be finite;
  2. ring attention over the data axis against full attention, within
     5e-5;
  3. a context-parallel training step of a ConformerBlock (the frames
     split over the data axis, ``attn_impl="ring"``): its loss must fall
     after one SGD step, and its gradients must be within 5e-4 of the
     one-process block's with plain attention;
  4. a grid cell of 3 utterances through ``evaluate_grid`` with the metric
     sweep split over the data axis's devices (3 rows over 2 or more: the
     uneven split), enhanced by the trained pipeline.

Rank 0 prints JAX's tail line (``mesh=... loss=... ring_attn_delta=...
cp_train_loss=...->... ring_grad_delta=... eval_cell_stoi=...
eval_cell_ssnr=... OK``). Run as ``python -m
sincformer_tpu_torch.parallel.dryrun 4`` (on the card; ``--device cpu``
on the CPU). The processes are fresh interpreters with their own
environment, whatever the caller's; several ranks share one card through
gloo (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import argparse
import math
import os
import socket
import subprocess
import sys
import tempfile
from typing import Optional

import numpy as np
import torch

_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout: float = 900.0) -> str:
    """Run the dry run on ``n_devices`` processes; returns rank 0's tail
    line. Raises when a rank fails or outlives ``timeout`` seconds."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the dry run on the CPU")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env["PYTHONPATH"] = os.pathsep.join(
        [_PACKAGE_ROOT] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "sincformer_tpu_torch.parallel.dryrun",
         str(n_devices), "--rank", str(r), "--port", str(port),
         "--device", str(device)], env=env, cwd=_PACKAGE_ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n_devices)]
    outs, failed = [], []
    try:
        for r, proc in enumerate(procs):
            out, err = proc.communicate(timeout=timeout)
            outs.append(out)
            if proc.returncode != 0:
                failed.append(f"rank {r} exited {proc.returncode}:\n"
                              f"{err[-3000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError(f"dryrun_multichip({n_devices}) failed:\n"
                           + "\n".join(failed))
    tail = [line for line in outs[0].splitlines()
            if line.startswith("dryrun_multichip(")]
    if not tail or not tail[-1].endswith(" OK"):
        raise RuntimeError(f"dryrun_multichip({n_devices}): no OK line in "
                           f"rank 0's output:\n{outs[0][-2000:]}")
    return tail[-1]


def _init_like_flax(module: torch.nn.Module, seed: int) -> None:
    """Seeded weights at flax's initialiser scales: N(0, 1/fan_in)
    matrices and kernels, zero biases, unit norm scales."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.ndim >= 2:
                p.copy_(torch.randn(p.shape, generator=g)
                        / math.sqrt(p[0].numel()))
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)


def _max_over_ranks(x: float) -> float:
    import torch.distributed as dist
    t = torch.tensor([x], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t[0])


def _run_rank(rank: int, world: int, port: int, device) -> Optional[str]:
    import torch.distributed as dist

    from sincformer_tpu_torch.data.synthetic import (synthetic_noise,
                                                     synthetic_speech)
    from sincformer_tpu_torch.evaluation.grid import evaluate_grid
    from sincformer_tpu_torch.models.conformer import ConformerBlock
    from sincformer_tpu_torch.ops.attention import ring_mesh
    from sincformer_tpu_torch.ops.ring_attention import ring_attention
    from sincformer_tpu_torch.ops.speech_attention import \
        _speech_attention_plain
    from sincformer_tpu_torch.parallel import make_mesh, shard_batch
    from sincformer_tpu_torch.parallel.sharding import (has_model_axis,
                                                        split_flags)
    from sincformer_tpu_torch.pipeline import resolve_device
    from sincformer_tpu_torch.train.agent_trainer import (SincformerTrainer,
                                                          default_metacog)
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    torch.set_num_threads(max(1, min(4, (os.cpu_count() or 4) // world)))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    shape = (world // 2, 2) if world % 2 == 0 and world > 1 else (world, 1)
    mesh = make_mesh(world, ("data", "model"), shape=shape)
    n_data = shape[0]

    # 1. the tiny flagship's step, data × model parallel
    model = default_metacog(
        encoder_channels=32, cpea_hidden=16, cpea_channels=8, d_model=32,
        msa_blocks=1, num_heads=2, d_ff=128, kernel_size=7, dropout=0.0,
        memory_slots=4, sinc_kernel_size=65)
    pipe = SincformerTrainer(model, device=device, mesh=mesh,
                             model_dir=tempfile.mkdtemp(prefix="dryrun_"))
    batch, n = max(2, n_data), 4000
    pipe.init_state(epochs=1, steps_per_epoch=1)
    if has_model_axis(mesh):
        assert any(split_flags(pipe.model)), \
            "the TP rule split no parameter: the dry run is vacuous"
    rng = np.random.default_rng(0)
    noisy = rng.standard_normal((batch, n)).astype(np.float32)
    clean = rng.standard_normal((batch, n)).astype(np.float32)
    part = shard_batch(mesh, {"noisy": noisy, "clean": clean})
    loss, _ = pipe.train_step(*(torch.from_numpy(part[k]).to(device)
                                for k in ("noisy", "clean")), 1.0, 1.0, 1.0)
    loss = float(loss)
    assert np.isfinite(loss), f"non-finite loss {loss} in the dry run"

    # 2. ring attention over the data axis against full attention
    t = 16 * n_data
    q, k, v = (torch.from_numpy(rng.standard_normal((2, t, 2, 8)).astype(
        np.float32)).to(device) for _ in range(3))
    ring = ring_attention(q, k, v, mesh, "data")
    tl, r = t // n_data, mesh.get_local_rank("data")
    ref = _speech_attention_plain(q, k, v, None)[:, r * tl:(r + 1) * tl]
    ring_delta = _max_over_ranks(float((ring - ref).abs().max()))
    assert ring_delta <= 5e-5, ring_delta

    # 3. a context-parallel training step of a ConformerBlock
    kw = dict(d_model=32, num_heads=2, d_ff=64, kernel_size=7, dropout=0.0)
    blk_ring = ConformerBlock(**kw, attn_impl="ring").to(device)
    blk_ref = ConformerBlock(**kw, attn_impl="xla").to(device)
    _init_like_flax(blk_ring, 3)
    blk_ref.load_state_dict(blk_ring.state_dict())
    x, y = (torch.from_numpy(rng.standard_normal((2, t, 32)).astype(
        np.float32)).to(device) for _ in range(2))
    rows = slice(r * tl, (r + 1) * tl)
    seq = mesh.get_group("data")

    def cp_loss():
        with ring_mesh(mesh, "data"):
            part = torch.sum((blk_ring(x[:, rows]) - y[:, rows]) ** 2) \
                / y.numel()
        total = part.detach().clone()
        dist.all_reduce(total, group=seq)
        return part, float(total)
    part, cl0 = cp_loss()
    cg = list(torch.autograd.grad(part, list(blk_ring.parameters())))
    for g in cg:
        dist.all_reduce(g, group=seq)
    ref_loss = torch.mean((blk_ref(x) - y) ** 2)
    rg = torch.autograd.grad(ref_loss, list(blk_ref.parameters()))
    grad_delta = _max_over_ranks(max(float((a - b).abs().max())
                                     for a, b in zip(cg, rg)))
    with torch.no_grad():
        for p, g in zip(blk_ring.parameters(), cg):
            p.sub_(1e-2 * g)
        _, cl1 = cp_loss()
    assert np.isfinite(cl0) and np.isfinite(cl1) and cl1 < cl0, (cl0, cl1)
    assert grad_delta < 5e-4, grad_delta

    # 4. a grid cell of 3 utterances, the metric sweep over the data axis
    cleans = [synthetic_speech(0.5) * s for s in (0.9, 0.7, 0.8)]
    ev = evaluate_grid(cleans, {"white": synthetic_noise(8000, seed=5)},
                       {"sincformer": pipe}, snr_levels=[0],
                       metrics=("stoi", "ssnr"), verbose=False,
                       device=device, mesh=[device] * n_data)
    cell = ev["white"]["sincformer"][0]
    assert len(cell["stoi"]) == 3, cell
    eval_stoi = float(np.mean(cell["stoi"]))
    eval_ssnr = float(np.mean(cell["ssnr"]))
    assert np.isfinite(eval_stoi) and 0.0 <= eval_stoi <= 1.0, eval_stoi
    assert np.isfinite(eval_ssnr), eval_ssnr

    dist.barrier()
    dist.destroy_process_group()
    if rank != 0:
        return None
    return (f"dryrun_multichip({world}): mesh="
            f"{{'data': {shape[0]}, 'model': {shape[1]}}} loss={loss:.4f} "
            f"ring_attn_delta={ring_delta:.2e} "
            f"cp_train_loss={cl0:.4f}->{cl1:.4f} "
            f"ring_grad_delta={grad_delta:.2e} "
            f"eval_cell_stoi={eval_stoi:.4f} eval_cell_ssnr={eval_ssnr:.2f} "
            f"OK")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sincformer_tpu_torch.parallel.dryrun",
        description="The multi-device dry run: data, tensor and context "
                    "parallelism and a split grid cell on n gloo processes")
    parser.add_argument("n_devices", type=int)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; every rank on the card) or "
                             "cpu")
    parser.add_argument("--rank", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--port", type=int, default=None,
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank is None:
        print(dryrun_multichip(args.n_devices, args.device), flush=True)
        return 0
    line = _run_rank(args.rank, args.n_devices, args.port, args.device)
    if line:
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
