"""The ranks of the port's multi-process tests (tests/test_torch_parallel.py,
tests/test_torch_data_parallel.py, tests/test_torch_tp.py,
tests/test_torch_cp.py): :func:`pool` starts two processes once per test
process, with the ``spawn`` start method; they join a gloo group on
127.0.0.1 and then run job after job, in the order submitted, on the same
group, so the tests of several files pay for one start. A job (a dict
saved with ``torch.save``, key ``"kind"``) builds its mesh (one data axis
over both ranks unless it names ``"mesh"``: axis names and shape), runs,
and saves what the test compares to ``<out_dir>/out_<rank>.pt``; a failure
reports the traceback to the test, which raises it. Imports torch and the
port only, never JAX.

Jobs:

  * ``"flagship"``: one adversarial training step of the narrow flagship
    (dropout 0, softmax routing) from the given flax variables, the same
    step with the MAA and memory statistics per rank (``"fault"``: what
    gradient averaging alone computes), and an epoch of ``train``;
  * ``"dcse"``: per ``conv_norm``, the whole loss and its global
    gradient norm and one step without the MR-STFT term; for "batch" the
    same step with a per-rank BatchNorm; a step with a NaN in the last
    rank's rows; an epoch of ``train``;
  * ``"evaluate"``: ``cli.main(["evaluate", "--distributed", ...])`` with
    an identity enhancer and no speech files;
  * ``"tp"`` and ``"cp"``: tensor and context parallelism
    (tests/_torch_tp_jobs.py).
"""

from __future__ import annotations

import atexit
import contextlib
import datetime
import itertools
import multiprocessing
import os
import queue
import socket
import traceback
from types import SimpleNamespace
from unittest import mock

import numpy as np
import torch

LR_EPOCHS, LR_STEPS = 3, 2       # the schedule of the parity tests
GROUP_TIMEOUT = 120              # seconds a collective waits for a rank


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Pool:
    """``world`` ranks that run the jobs given to :meth:`submit`, each job
    on every rank, in order."""

    def __init__(self, world: int):
        ctx = multiprocessing.get_context("spawn")
        self.world = world
        self.inboxes = [ctx.Queue() for _ in range(world)]
        self.outbox = ctx.Queue()
        self.reports = {}
        self.tickets = itertools.count()
        port = free_port()
        self.procs = [ctx.Process(target=serve,
                                  args=(r, world, port, self.inboxes[r],
                                        self.outbox), daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def submit(self, job: dict, out_dir: str) -> "Ticket":
        """Queue ``job`` on every rank; its outputs go to ``out_dir``."""
        os.makedirs(out_dir, exist_ok=True)
        job_path = os.path.join(out_dir, "job.pt")
        torch.save(job, job_path)
        ticket = next(self.tickets)
        for inbox in self.inboxes:
            inbox.put((ticket, job_path, out_dir))
        return Ticket(self, ticket, out_dir)

    def wait(self, ticket: int, out_dir: str, timeout: float) -> list:
        deadline = timeout
        while len(self.reports.get(ticket, {})) < self.world:
            try:
                t, rank, err = self.outbox.get(timeout=5.0)
            except queue.Empty:
                deadline -= 5.0
                dead = [r for r, p in enumerate(self.procs)
                        if not p.is_alive()]
                if dead or deadline <= 0:
                    self.close()
                    raise AssertionError(
                        f"ranks {dead} died" if dead else
                        f"job {ticket} still running after {timeout} s")
                continue
            self.reports.setdefault(t, {})[rank] = err
        errs = self.reports.pop(ticket)
        failed = [f"rank {r}:\n{e}" for r, e in sorted(errs.items()) if e]
        if failed:
            self.close()        # a rank that failed may hold a collective
            raise AssertionError("\n".join(failed))
        return [torch.load(os.path.join(out_dir, f"out_{r}.pt"),
                           weights_only=False) for r in range(self.world)]

    def alive(self) -> bool:
        return all(p.is_alive() for p in self.procs)

    def close(self) -> None:
        for inbox in self.inboxes:
            with contextlib.suppress(Exception):
                inbox.put(None)
        for p in self.procs:
            p.join(2.0)
            if p.is_alive():
                p.kill()
                p.join()


class Ticket:
    """A submitted job: :meth:`result` waits for every rank's output."""

    def __init__(self, pool_: Pool, ticket: int, out_dir: str):
        self.pool, self.ticket, self.out_dir = pool_, ticket, out_dir
        self._outs = None

    def result(self, timeout: float = 300.0) -> list:
        if self._outs is None:
            self._outs = self.pool.wait(self.ticket, self.out_dir, timeout)
        return self._outs


_POOLS = {}


def pool(world: int = 2) -> Pool:
    """The test process's pool of ``world`` ranks, started at first use
    (again after a failure closed it)."""
    p = _POOLS.get(world)
    if p is None or not p.alive():
        p = _POOLS[world] = Pool(world)
    return p


@atexit.register
def _close_pools() -> None:
    for p in _POOLS.values():
        p.close()


def _mesh(job: dict):
    from sincformer_tpu_torch.parallel import make_mesh
    names, shape = job.get("mesh", (("data",), None))
    return make_mesh(axis_names=names, shape=shape)


def serve(rank: int, world: int, port: int, inbox, outbox) -> None:
    torch.set_num_threads(2)
    import torch.distributed as dist
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    except Exception:
        outbox.put((-1, rank, traceback.format_exc()))
        return
    parent = multiprocessing.parent_process()
    while True:
        try:
            item = inbox.get(timeout=5.0)
        except queue.Empty:
            if parent is not None and not parent.is_alive():
                break           # the test process is gone: so are we
            continue
        if item is None:
            break
        ticket, job_path, out_dir = item
        try:
            job = torch.load(job_path, weights_only=False)
            if job["kind"] == "evaluate":
                # the verb joins the group itself, from torchrun's
                # variables: here it finds the pool's group
                os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                                  LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                                  MASTER_PORT=str(port))
                mesh = None
            else:
                mesh = _mesh(job)
            out = JOBS[job["kind"]](job, mesh, out_dir)
            torch.save(out, os.path.join(out_dir, f"out_{rank}.pt"))
            outbox.put((ticket, rank, None))
        except Exception:       # reported to the test, which raises it
            outbox.put((ticket, rank, traceback.format_exc()))
    dist.destroy_process_group()


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

    def record(params, grads, state, **norm):
        seen["grads"] = {k: g.detach().clone()
                         for k, g in zip(params, grads)}
        return update(params, grads, state, **norm)
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
    return {"loss": float(loss), "grads": _whole(seen["grads"], pipe, mesh),
            "buffers": clone(pipe.model.named_buffers()),
            "params": _whole(clone(pipe.model.named_parameters()), pipe,
                             mesh),
            "disc_loss": float(pipe.disc_loss), "disc_grads": dseen["grads"],
            "disc_params": clone(pipe.disc.named_parameters()),
            "disc_mu": dict(pipe.disc_opt_state["mu"]),
            "disc_nu": dict(pipe.disc_opt_state["nu"]),
            "nan_count": int(pipe.nan_count)}


def _whole(tensors, pipe, mesh):
    """Parameter-shaped ``tensors`` made whole over a model axis (split
    leaves gathered); unchanged without one."""
    from sincformer_tpu_torch.parallel.sharding import gathered
    return gathered(tensors, pipe.model, mesh)


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


def _dcse_trainer(job, norm, mesh):
    """The DCSE trainer of a job: from its flax variables for ``norm`` or,
    when it has none, with weights drawn from seed 0 at its sizes."""
    from sincformer_tpu_torch.compat.from_jax import \
        load_dcse_train_state_from_jax
    from sincformer_tpu_torch.models.dcse import SpeechEnhancer
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
    return pipe


def _dcse_step(job, norm, mesh, pipe=None):
    """The whole loss, its gradients' global norm, and one step without
    the MR-STFT term, of the job's trainer for ``norm`` (or ``pipe``) on
    this rank's block of the job's batch."""
    from sincformer_tpu_torch.parallel import shard_batch
    import sincformer_tpu_torch.train.dcse_trainer as port_dcse
    if pipe is None:
        pipe = _dcse_trainer(job, norm, mesh)
    batch = shard_batch(mesh, {"noisy": job["noisy"], "clean": job["clean"]})
    noisy = torch.from_numpy(batch["noisy"])
    clean = torch.from_numpy(batch["clean"])
    saved = {k: b.clone() for k, b in pipe.model.named_buffers()}
    whole, _, grads = pipe.loss_and_grads(noisy, clean)
    grads = _whole({k: g for k, g in zip(pipe.params(), grads)
                    if g is not None}, pipe, mesh)
    whole_norm = float(torch.sqrt(sum(torch.sum(g.double() ** 2)
                                      for g in grads.values())))
    for k, b in pipe.model.named_buffers():
        b.copy_(saved[k])
    seen = _recorder(pipe.tx)
    with mock.patch.object(port_dcse, "multi_resolution_stft_loss",
                           lambda pred, target: pred.sum() * 0.0):
        loss, _ = pipe.train_step(noisy, clean)
    return {"whole": float(whole), "whole_norm": whole_norm,
            "loss": float(loss), "grads": _whole(seen["grads"], pipe, mesh),
            "buffers": {k: b.clone() for k, b in
                        pipe.model.named_buffers()},
            "params": _whole({k: p.detach().clone() for k, p in
                              pipe.model.named_parameters()}, pipe, mesh)}


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


def _tp_jobs():
    from tests import _torch_tp_jobs
    return _torch_tp_jobs


JOBS = {"flagship": flagship, "dcse": dcse, "evaluate": evaluate,
        "tp": lambda job, mesh, out_dir: _tp_jobs().tp(job, mesh, out_dir),
        "cp": lambda job, mesh, out_dir: _tp_jobs().cp(job, mesh, out_dir)}
