"""One rank of the port's data-parallel tests (tests/test_torch_parallel.py,
tests/test_torch_data_parallel.py), started by :func:`spawn` with the
``spawn`` start method: it joins a gloo group on 127.0.0.1, builds a
one-axis mesh, runs its job on its block of the batch
(``parallel.shard_batch``) and saves what the test compares to
``<out_dir>/out_<rank>.pt``. A failure writes the traceback to
``<out_dir>/err_<rank>.txt``. Imports torch and the port only, never JAX.

Jobs (a dict saved with ``torch.save``, key ``"kind"``):

  * ``"flagship"``: one adversarial training step of the narrow flagship
    (dropout 0, softmax routing) from the given flax variables, the same
    step with the MAA and memory statistics per rank (``"fault"``: what
    gradient averaging alone computes), and an epoch of ``train``;
  * ``"dcse"``: per ``conv_norm``, the whole loss and its global
    gradient norm and one step without the MR-STFT term; for "batch" the
    same step with a per-rank BatchNorm; a step with a NaN in the last
    rank's rows; an epoch of ``train``;
  * ``"evaluate"``: ``cli.main(["evaluate", "--distributed", ...])`` with
    an identity enhancer and no speech files.
"""

from __future__ import annotations

import contextlib
import multiprocessing
import os
import socket
import sys
import traceback
from types import SimpleNamespace
from unittest import mock

import numpy as np
import torch

LR_EPOCHS, LR_STEPS = 3, 2       # the schedule of the parity tests


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(job: dict, world: int, out_dir: str, timeout: float = 240.0):
    """Run ``job`` on ``world`` ranks; returns each rank's saved output.
    Every process gets ``timeout`` seconds; one that fails, or is still
    running then, fails the caller with its traceback."""
    os.makedirs(out_dir, exist_ok=True)
    job_path = os.path.join(out_dir, "job.pt")
    torch.save(job, job_path)
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=run, args=(r, world, port, job_path, out_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    failed = []
    for r, p in enumerate(procs):
        p.join(timeout)
        if p.is_alive():
            for q in procs:
                q.kill()
            failed.append(f"rank {r} timed out after {timeout} s")
        elif p.exitcode != 0:
            err = os.path.join(out_dir, f"err_{r}.txt")
            tail = open(err).read() if os.path.exists(err) else ""
            failed.append(f"rank {r} exited {p.exitcode}:\n{tail}")
    if failed:
        raise AssertionError("\n".join(failed))
    return [torch.load(os.path.join(out_dir, f"out_{r}.pt"),
                       weights_only=False) for r in range(world)]


def run(rank: int, world: int, port: int, job_path: str, out_dir: str):
    try:
        torch.set_num_threads(2)
        from sincformer_tpu_torch.parallel import (init_distributed,
                                                   make_mesh)
        job = torch.load(job_path, weights_only=False)
        if job["kind"] == "evaluate":
            # the verb joins the group itself, from torchrun's variables
            os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                              LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                              MASTER_PORT=str(port))
            mesh = None
        else:
            assert init_distributed(f"tcp://127.0.0.1:{port}", world, rank,
                                    device="cpu")
            mesh = make_mesh()
        out = JOBS[job["kind"]](job, mesh, out_dir)
        torch.save(out, os.path.join(out_dir, f"out_{rank}.pt"))
        import torch.distributed as dist
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"err_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)


# ── per-rank statistics: what averaging the gradients alone computes ─────

LOCAL = SimpleNamespace(
    mean=lambda x, dim=None, keepdim=False: (
        x.mean() if dim is None else x.mean(dim=dim, keepdim=keepdim)),
    var=lambda x, dim=None: (x.var(unbiased=False) if dim is None
                             else x.var(dim=dim, unbiased=False)),
    sum=lambda x: x, world_size=lambda: 1)


@contextlib.contextmanager
def per_rank(*modules):
    """The batch-wide reductions of ``modules`` (module paths) left local."""
    with contextlib.ExitStack() as stack:
        for m in modules:
            stack.enter_context(mock.patch(m + ".collectives", LOCAL))
        yield


def _recorder(tx):
    """Keep the gradients that ``tx.update`` is given (after the rank
    average and the NaN guard, before the clip)."""
    seen = {}
    update = tx.update

    def record(params, grads, state):
        seen["grads"] = {k: g.detach().clone()
                         for k, g in zip(params, grads)}
        return update(params, grads, state)
    tx.update = record
    return seen


def _flagship_trainer(job, mesh):
    """From the job's flax variables and discriminator, or, when it has
    none, with weights drawn from seed 0 at the job's ``config`` sizes."""
    from sincformer_tpu_torch import MetacogConfig, SincformerMetacog
    from sincformer_tpu_torch.compat.from_jax import (
        load_discriminator_from_jax, load_train_state_from_jax)
    from sincformer_tpu_torch.train.agent_trainer import SincformerTrainer
    v = job.get("variables")
    if v is None:
        pipe = SincformerTrainer(
            SincformerMetacog(MetacogConfig(**job["config"], dropout=0.0,
                                            routing="softmax")),
            device="cpu", use_adversarial=True, mesh=mesh)
        pipe.init_state(LR_EPOCHS, LR_STEPS)
        return pipe
    named, buffers, _, config = load_train_state_from_jax(
        v["params"], {k: v[k] for k in ("maa_stats", "memory_bank",
                                        "memory_stats")},
        None, num_heads=job["num_heads"],
        sinc_kernel_size=job["sinc_kernel_size"], dropout=0.0,
        routing="softmax")
    pipe = SincformerTrainer(SincformerMetacog(config), device="cpu",
                             use_adversarial=True, mesh=mesh)
    pipe.load_state(named, buffers)
    pipe.load_disc_state(load_discriminator_from_jax(job["dvars"])[0])
    pipe.init_state(LR_EPOCHS, LR_STEPS, init_params=False)
    return pipe


def _flagship_step(job, mesh):
    from sincformer_tpu_torch.parallel import shard_batch
    pipe = _flagship_trainer(job, mesh)
    seen, dseen = _recorder(pipe.tx), _recorder(pipe.disc_tx)
    batch = shard_batch(mesh, {"noisy": job["noisy"], "clean": job["clean"]})
    loss, _ = pipe.train_step(torch.from_numpy(batch["noisy"]),
                              torch.from_numpy(batch["clean"]),
                              1.0, 1.0, None, 1.0, 1.0)
    clone = lambda named: {k: t.detach().clone() for k, t in named}  # noqa
    return {"loss": float(loss), "grads": seen["grads"],
            "buffers": clone(pipe.model.named_buffers()),
            "params": clone(pipe.model.named_parameters()),
            "disc_loss": float(pipe.disc_loss), "disc_grads": dseen["grads"],
            "disc_params": clone(pipe.disc.named_parameters()),
            "disc_mu": dict(pipe.disc_opt_state["mu"]),
            "disc_nu": dict(pipe.disc_opt_state["nu"]),
            "nan_count": int(pipe.nan_count)}


def _trained(pipe, history, model_dir):
    """What a data-parallel ``train`` leaves: its history, the parameters
    and buffers, and the files written under its model directory."""
    written = sorted(os.path.relpath(os.path.join(d, f), model_dir)
                     for d, _, files in os.walk(model_dir) for f in files)
    return {"history": [{k: v for k, v in e.items() if k != "epoch_seconds"}
                        for e in history],
            "params": {k: p.detach().clone() for k, p in
                       pipe.model.named_parameters()},
            "buffers": {k: b.clone() for k, b in pipe.model.named_buffers()},
            "written": written}


def _train_flagship(job, mesh, out_dir):
    """One epoch of the narrow flagship's curriculum loop from seeded
    weights: two steps of two utterances, a validation pass whose last
    batch of one utterance runs whole on every rank."""
    from sincformer_tpu_torch import MetacogConfig, SincformerMetacog
    from sincformer_tpu_torch.train.agent_trainer import SincformerTrainer
    model_dir = os.path.join(out_dir, f"flagship_{mesh.get_local_rank()}")
    pipe = SincformerTrainer(
        SincformerMetacog(MetacogConfig(**job["config"], dropout=0.0)),
        device="cpu", model_dir=model_dir, mesh=mesh)
    clean_train, clean_test, noises = job["train_data"]
    history = pipe.train(clean_train, clean_test, noises, epochs=1,
                         batch_size=2, max_len=4000, verbose=False)
    return _trained(pipe, history, model_dir)


def flagship(job, mesh, out_dir):
    out = {"dp": _flagship_step(job, mesh)}
    with per_rank("sincformer_tpu_torch.agents.maa",
                  "sincformer_tpu_torch.agents.memory"):
        out["fault"] = _flagship_step(job, mesh)
    out["train"] = _train_flagship(job, mesh, out_dir)
    return out


def _dcse_step(job, norm, mesh):
    from sincformer_tpu_torch.compat.from_jax import \
        load_dcse_train_state_from_jax
    from sincformer_tpu_torch.models.dcse import SpeechEnhancer
    from sincformer_tpu_torch.parallel import shard_batch
    import sincformer_tpu_torch.train.dcse_trainer as port_dcse
    from sincformer_tpu_torch.config import DCSEConfig
    if job.get("variables") is None:       # weights drawn from seed 0
        pipe = port_dcse.DCSETrainer(
            SpeechEnhancer(DCSEConfig(**job["config"], conv_norm=norm,
                                      dropout=0.0)),
            device="cpu", model_dir=job["model_dir"], mesh=mesh)
        pipe.init_state(LR_EPOCHS, LR_STEPS)
    else:
        v = job["variables"][norm]
        named, buffers, _, config = load_dcse_train_state_from_jax(
            v["params"], v.get("batch_stats"), None,
            num_heads=job["num_heads"], dropout=0.0)
        pipe = port_dcse.DCSETrainer(SpeechEnhancer(config), device="cpu",
                                     model_dir=job["model_dir"], mesh=mesh)
        pipe.load_state(named, buffers)
        pipe.init_state(LR_EPOCHS, LR_STEPS, init_params=False)
    batch = shard_batch(mesh, {"noisy": job["noisy"], "clean": job["clean"]})
    noisy = torch.from_numpy(batch["noisy"])
    clean = torch.from_numpy(batch["clean"])
    saved = {k: b.clone() for k, b in pipe.model.named_buffers()}
    whole, _, grads = pipe.loss_and_grads(noisy, clean)
    whole_norm = float(torch.sqrt(sum(torch.sum(g.double() ** 2)
                                      for g in grads if g is not None)))
    for k, b in pipe.model.named_buffers():
        b.copy_(saved[k])
    seen = _recorder(pipe.tx)
    with mock.patch.object(port_dcse, "multi_resolution_stft_loss",
                           lambda pred, target: pred.sum() * 0.0):
        loss, _ = pipe.train_step(noisy, clean)
    return {"whole": float(whole), "whole_norm": whole_norm,
            "loss": float(loss), "grads": seen["grads"],
            "buffers": {k: b.clone() for k, b in
                        pipe.model.named_buffers()},
            "params": {k: p.detach().clone() for k, p in
                       pipe.model.named_parameters()}}


def _train_dcse(job, mesh, out_dir):
    """One epoch of the narrow DCSE's loop ("batch" norm) from seeded
    weights, on the flagship job's utterances."""
    from sincformer_tpu_torch.config import DCSEConfig
    from sincformer_tpu_torch.data.loader import WaveformDataset
    from sincformer_tpu_torch.models.dcse import SpeechEnhancer
    from sincformer_tpu_torch.train.dcse_trainer import DCSETrainer
    model_dir = os.path.join(out_dir, f"dcse_{mesh.get_local_rank()}")
    pipe = DCSETrainer(SpeechEnhancer(DCSEConfig(**job["config"],
                                                 conv_norm="batch",
                                                 dropout=0.0)),
                       device="cpu", model_dir=model_dir, mesh=mesh)
    clean_train, clean_test, noises = job["train_data"]
    train_ds, test_ds = (WaveformDataset.from_arrays(c, noises, max_len=4000)
                         for c in (clean_train, clean_test))
    history = pipe.train(train_ds, test_ds, epochs=1, batch_size=2,
                         verbose=False)
    return _trained(pipe, history, model_dir)


def _nan_step(job, mesh):
    """A step of the narrow DCSE from seeded weights on the job's batch
    with one NaN, in the last rank's rows: the NaN guard must zero the
    step on every rank."""
    from sincformer_tpu_torch.config import DCSEConfig
    from sincformer_tpu_torch.models.dcse import SpeechEnhancer
    from sincformer_tpu_torch.parallel import shard_batch
    from sincformer_tpu_torch.train.dcse_trainer import DCSETrainer
    pipe = DCSETrainer(SpeechEnhancer(DCSEConfig(**job["config"],
                                                 dropout=0.0)),
                       device="cpu", model_dir=job["model_dir"], mesh=mesh)
    pipe.init_state(LR_EPOCHS, LR_STEPS)
    noisy = job["noisy"].copy()
    noisy[-1, 100] = np.nan
    batch = shard_batch(mesh, {"noisy": noisy, "clean": job["clean"]})
    pipe.train_step(torch.from_numpy(batch["noisy"]),
                    torch.from_numpy(batch["clean"]))
    return {"nan_count": int(pipe.nan_count),
            "params": {k: p.detach().clone() for k, p in
                       pipe.model.named_parameters()}}


def dcse(job, mesh, out_dir):
    out = {norm: _dcse_step(job, norm, mesh) for norm in ("batch", "layer")}
    out["nan"] = _nan_step(job, mesh)
    with per_rank("sincformer_tpu_torch.models.conformer"):
        out["fault"] = _dcse_step(job, "batch", mesh)
    out["train"] = _train_dcse(job, mesh, out_dir)
    return out


class Identity:
    """A pass-through enhancer: enough to drive the whole grid."""

    def enhance_batch(self, noisy):
        return np.asarray(noisy, np.float32)


def evaluate(job, mesh, out_dir):
    import io

    import sincformer_tpu_torch.evaluation.grid as grid
    from sincformer_tpu_torch import cli
    from sincformer_tpu_torch.parallel import is_primary
    rank = int(os.environ["RANK"])
    os.environ["SINCFORMER_MODEL_DIR"] = job["model_dir"]
    printed = io.StringIO()
    with mock.patch.object(grid, "discover_pipelines",
                           lambda *a, **k: {"identity": Identity()}), \
            mock.patch.object(grid, "find_speech_files", lambda *a, **k: []), \
            contextlib.redirect_stdout(printed):
        code = cli.main(["evaluate", "--distributed", "--max-eval",
                         str(job["max_eval"]), "--device", "cpu",
                         "--json-out",
                         os.path.join(out_dir, f"grid_{rank}.json")])
    return {"code": code, "stdout": printed.getvalue(),
            "primary": is_primary()}


JOBS = {"flagship": flagship, "dcse": dcse, "evaluate": evaluate}
