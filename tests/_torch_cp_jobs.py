"""The jobs of tests/test_torch_cp_models.py on the port's gloo ranks
(tests/_torch_dp_worker.py runs them). Imports torch and the port only,
never JAX. Every model here is given the whole sequence on every rank
inside ``ops.ring_mesh`` and returns the whole output.

  * :func:`models` on a 2-rank ring ("data"): the narrow flagship's and the
    narrow DCSE model's inference forwards; the flagship trainer's
    training loss and gradients without the MR-STFT term, its buffers after,
    one AdamW step, the adversarial branch's gradients and the
    discriminator's; the refusal of T' = 51; a training loss with dropout
    on; ``enhance_signal`` and ``enhance_batch`` of both pipelines.
  * :func:`mesh_steps` on four ranks: the narrow DCSE trainer on a (2, 2)
    ("data", "seq") and a (1, 2, 2) ("data", "model", "seq") mesh with the
    ring on "seq": the step without the MR-STFT term in float32 and bf16
    (the split leaves gathered), a "batch"-norm step and its running
    statistics, ``eval_step`` and an epoch of ``train``, in float32 and
    bf16; on the (2, 2) mesh the step on the MR-STFT loss's spectral
    convergence alone, also with its norms planted over the ring instead
    of the data ranks, and over data × ring.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import warnings
from types import SimpleNamespace
from unittest import mock

import numpy as np
import torch

from tests import _torch_dp_worker as worker

MESHES = {"data_seq": (("data", "seq"), (2, 2)),
          "data_model_seq": (("data", "model", "seq"), (1, 2, 2))}


def no_stft_term(module):
    """``module``'s multi-resolution STFT loss replaced by 0 (its float32
    gradient is ill-conditioned: ROADMAP.md Queue 3)."""
    return mock.patch.object(module, "multi_resolution_stft_loss",
                             lambda pred, target: pred.sum() * 0.0)


def flagship_trainer(variables, narrow: dict, attn_impl: str,
                     dropout: float = 0.0, adversarial: bool = False):
    """The narrow flagship trainer on the CPU from flax ``variables``
    (softmax routing), the discriminator drawn from its seed."""
    from sincformer_tpu_torch import SincformerMetacog
    from sincformer_tpu_torch.compat.from_jax import \
        load_train_state_from_jax
    from sincformer_tpu_torch.train.agent_trainer import SincformerTrainer
    named, buffers, _, config = load_train_state_from_jax(
        variables["params"], {k: variables[k] for k in (
            "maa_stats", "memory_bank", "memory_stats")}, None,
        num_heads=narrow["num_heads"],
        sinc_kernel_size=narrow["sinc_kernel_size"], dropout=dropout,
        routing="softmax", attn_impl=attn_impl)
    pipe = SincformerTrainer(SincformerMetacog(config), device="cpu",
                             model_dir=tempfile.mkdtemp(),
                             use_adversarial=adversarial)
    pipe.load_state(named, buffers)
    pipe.init_state(worker.LR_EPOCHS, worker.LR_STEPS, init_params=False)
    return pipe


def dcse_trainer(params, num_heads: int, attn_impl: str, mesh=None,
                 dtype=None):
    """The narrow DCSE trainer on the CPU from flax ``params``."""
    from sincformer_tpu_torch.compat.from_jax import \
        load_dcse_train_state_from_jax
    from sincformer_tpu_torch.models.dcse import SpeechEnhancer
    from sincformer_tpu_torch.train.dcse_trainer import DCSETrainer
    named, buffers, _, config = load_dcse_train_state_from_jax(
        params, None, None, num_heads=num_heads, dropout=0.0,
        attn_impl=attn_impl)
    pipe = DCSETrainer(SpeechEnhancer(config), device="cpu", mesh=mesh,
                       model_dir=tempfile.mkdtemp(), compute_dtype=dtype)
    pipe.load_state(named, buffers)
    pipe.init_state(worker.LR_EPOCHS, worker.LR_STEPS, init_params=False)
    return pipe


def seeded_dcse_trainer(config: dict, attn_impl: str, mesh=None,
                        model_dir=None, dtype=None):
    """The narrow DCSE trainer with "batch" norm and weights drawn from
    seed 0, its compute dtype ``dtype``."""
    from sincformer_tpu_torch.config import DCSEConfig
    from sincformer_tpu_torch.models.dcse import SpeechEnhancer
    from sincformer_tpu_torch.train.dcse_trainer import DCSETrainer
    pipe = DCSETrainer(SpeechEnhancer(DCSEConfig(
        **config, conv_norm="batch", dropout=0.0, attn_impl=attn_impl)),
        device="cpu", mesh=mesh, model_dir=model_dir or tempfile.mkdtemp(),
        compute_dtype=dtype)
    pipe.init_state(worker.LR_EPOCHS, worker.LR_STEPS)
    return pipe


def flagship_step(pipe, noisy, clean, use_adv=None) -> dict:
    """The flagship trainer's training loss without the MR-STFT term and
    its gradients (with the adversarial term when ``use_adv`` is given,
    and then the discriminator's loss and gradients on the step's
    magnitudes), then the buffers. A parameter nothing reads gets a zero
    gradient, as in JAX."""
    from sincformer_tpu_torch.train import agent_trainer
    with no_stft_term(agent_trainer):
        loss, _, grads = pipe.loss_and_grads(
            torch.from_numpy(noisy), torch.from_numpy(clean), 1.0, 1.0,
            None, 1.0, use_adv)
    out = {"loss": float(loss),
           "grads": {k: torch.zeros_like(p) if g is None else g
                     for (k, p), g in zip(pipe.params().items(), grads)},
           "buffers": {k: b.clone() for k, b in
                       pipe.model.named_buffers()}}
    if use_adv is not None:
        dl, dgrads = pipe.disc_loss_and_grads(*pipe.last_mags)
        out["disc_loss"] = float(dl)
        out["disc_grads"] = dict(zip(
            (k for k, _ in pipe.disc.named_parameters()), dgrads))
    return out


def adamw_step(pipe, noisy, clean) -> dict:
    """One AdamW step of the flagship trainer on the loss without the
    MR-STFT term: the parameters after it."""
    from sincformer_tpu_torch.train import agent_trainer
    with no_stft_term(agent_trainer):
        pipe.train_step(torch.from_numpy(noisy), torch.from_numpy(clean),
                        1.0, 1.0, None, 1.0)
    return {k: p.detach().clone() for k, p in pipe.params().items()}


def serve(pipe, signal: np.ndarray, batch: np.ndarray) -> dict:
    """``enhance_signal`` of ``signal`` and ``enhance_batch`` of ``batch``
    through ``pipe``, and the warnings raised."""
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = {"signal": pipe.enhance_signal(signal),
               "batch": pipe.enhance_batch(batch)}
    out["warned"] = [str(x.message) for x in w
                     if issubclass(x.category, RuntimeWarning)]
    return out


def serving_pipelines(job, attn_impl: str) -> list:
    """The flagship and DCSE serving pipelines on the CPU from the job's
    flax variables."""
    from sincformer_tpu_torch import SincformerMetacog
    from sincformer_tpu_torch.compat.from_jax import (load_dcse_from_jax,
                                                      load_from_jax)
    from sincformer_tpu_torch.models.dcse import SpeechEnhancer
    from sincformer_tpu_torch.pipeline import (DCSEPipeline,
                                               SincformerPipeline)
    named, buffers, config = load_from_jax(
        job["variables"], num_heads=job["narrow"]["num_heads"],
        sinc_kernel_size=job["narrow"]["sinc_kernel_size"],
        attn_impl=attn_impl)
    flag = SincformerPipeline(SincformerMetacog(config), device="cpu",
                              model_dir=tempfile.mkdtemp())
    flag.load_state(named, buffers)
    state, dconfig = load_dcse_from_jax(
        {"params": job["dcse"]}, num_heads=job["dcse_heads"],
        attn_impl=attn_impl)
    dcse = DCSEPipeline(SpeechEnhancer(dconfig), device="cpu",
                        model_dir=tempfile.mkdtemp())
    dcse.load_state(state)
    return [flag, dcse]


def models(job, mesh, out_dir):
    from sincformer_tpu_torch.ops.attention import ring_mesh
    from sincformer_tpu_torch.train import agent_trainer
    ring = lambda: ring_mesh(mesh, "data")  # noqa: E731
    out = {}
    flag, dcse = serving_pipelines(job, "ring")
    wav = torch.from_numpy(job["noisy"])
    with torch.no_grad(), ring():
        got = flag.model(wav, *(torch.from_numpy(job[k])
                                for k in ("stft_re", "stft_im")))
        out["flagship"] = {k: v for k, v in got.items()
                           if isinstance(v, torch.Tensor)}
        out["dcse"] = dcse.model(*(torch.from_numpy(job[k])
                                   for k in ("dcse_re", "dcse_im")))
    with ring():
        out["serve"] = {
            "flagship": serve(flag, job["signal"], job["noisy"]),
            "dcse": serve(dcse, job["signal"], job["dcse_batch"])}

    pipe = flagship_trainer(job["variables"], job["narrow"], "ring")
    with ring():
        out["step"] = flagship_step(pipe, job["noisy"], job["clean"])
        out["adamw"] = adamw_step(pipe, job["noisy"], job["clean"])
    adv = flagship_trainer(job["variables"], job["narrow"], "ring",
                           adversarial=True)
    with ring():
        out["adv"] = flagship_step(adv, job["noisy"], job["clean"], 1.0)
    drop = flagship_trainer(job["variables"], job["narrow"], "ring",
                            dropout=0.1)
    with ring(), no_stft_term(agent_trainer):
        out["dropout_loss"] = float(drop.loss_and_grads(
            torch.from_numpy(job["noisy"]), torch.from_numpy(job["clean"]),
            1.0, 1.0, None, 1.0)[0])
    try:
        long = torch.from_numpy(job["long"])
        with ring():
            pipe.loss_and_grads(long, long, 1.0, 1.0, None, 1.0)
        out["raised"] = None
    except RuntimeError as e:
        out["raised"] = str(e)
    return out


# ── four ranks: a data-parallel mesh inside the ring ─────────────────────

# the MR-STFT loss's resolutions: (FFT size, hop, window)
STFT_RESOLUTIONS = ((256, 64, 256), (512, 128, 512), (1024, 256, 1024))


def spectral_convergence_loss(pred: torch.Tensor, target: torch.Tensor
                              ) -> torch.Tensor:
    """The MR-STFT loss without its log-magnitude term: the mean of
    ``losses.spectral_convergence`` (both norms over the data ranks) at
    the loss's three resolutions. Well conditioned: |stft|'s gradient is
    bounded, where the log-magnitude's grows as 1 / |stft|."""
    from sincformer_tpu_torch.dsp.stft import stft
    from sincformer_tpu_torch.train import losses
    terms = [losses.spectral_convergence(torch.abs(stft(pred, f, h, w)),
                                         torch.abs(stft(target, f, h, w)))
             for f, h, w in STFT_RESOLUTIONS]
    return sum(terms) / len(terms)


def norms_over(mesh, axis: str):
    """A stand-in for ``losses.collectives`` whose norm sums over
    ``mesh``'s ``axis`` in place of the trainer's data axis."""
    from sincformer_tpu_torch.parallel import collectives

    def norm(x):
        with collectives.data_parallel(mesh, axis):
            return collectives.norm(x)
    return SimpleNamespace(norm=norm)


def _whole(named: dict, pipe, mesh) -> dict:
    from sincformer_tpu_torch.parallel.sharding import gathered
    return gathered({k: g for k, g in named.items() if g is not None},
                    pipe.model, mesh)


def dcse_mesh_step(pipe, mesh, batch: dict, stft_term: bool = False
                   ) -> dict:
    """The DCSE trainer's training loss without the MR-STFT term (with
    the trainer's own where ``stft_term``) and its gradients (split
    leaves gathered whole) on this rank's rows of ``batch``, under
    ``ring_mesh`` on the mesh's "seq" axis (one process when ``mesh`` is
    None), and the buffers after it."""
    from sincformer_tpu_torch.ops.attention import ring_mesh
    from sincformer_tpu_torch.parallel import shard_batch
    from sincformer_tpu_torch.train import dcse_trainer
    part = shard_batch(mesh, batch)
    with (contextlib.nullcontext() if stft_term
          else no_stft_term(dcse_trainer)), (
            contextlib.nullcontext() if mesh is None
            else ring_mesh(mesh, "seq")):
        loss, sisnr, grads = pipe.loss_and_grads(
            *(torch.from_numpy(part[k]) for k in ("noisy", "clean")))
    return {"loss": float(loss), "sisnr": float(sisnr),
            "grads": _whole(dict(zip(pipe.params(), grads)), pipe, mesh),
            "buffers": {k: b.clone() for k, b in
                        pipe.model.named_buffers()}}


def dcse_sc_step(pipe, mesh, batch: dict, over=None) -> dict:
    """:func:`dcse_mesh_step` on the spectral convergence alone
    (:func:`spectral_convergence_loss`; SI-SNR and the magnitude L1 set
    to 0), its norms over ``over`` = (mesh, axis) where given."""
    from sincformer_tpu_torch.train import dcse_trainer, losses
    pipe.model.config = dataclasses.replace(pipe.model.config,
                                            mag_loss_weight=0.0)
    with mock.patch.object(dcse_trainer, "si_snr_loss",
                           lambda est, ref: est.sum() * 0.0), \
            mock.patch.object(dcse_trainer, "multi_resolution_stft_loss",
                              spectral_convergence_loss), \
            (contextlib.nullcontext() if over is None else
             mock.patch.object(losses, "collectives", norms_over(*over))):
        return dcse_mesh_step(pipe, mesh, batch, stft_term=True)


def dcse_eval(pipe, mesh, batch: dict) -> list:
    """``eval_step`` on this rank's rows of ``batch`` under the ring (one
    process when ``mesh`` is None): (loss, sisnr, Σ log α, count)."""
    from sincformer_tpu_torch.ops.attention import ring_mesh
    from sincformer_tpu_torch.parallel import shard_batch
    part = shard_batch(mesh, batch)
    with (contextlib.nullcontext() if mesh is None
          else ring_mesh(mesh, "seq")):
        return [float(x) for x in pipe.eval_step(
            *(torch.from_numpy(part[k]) for k in
              ("noisy", "clean", "lengths")))]


def dcse_epoch(job, mesh, model_dir, dtype=None) -> dict:
    """One epoch of ``train`` of the "batch"-norm DCSE from seeded weights
    on the job's utterances (batches of four), in ``dtype`` (the compute
    dtype), under the ring on "seq" (one process when ``mesh`` is None):
    the history, the parameters and buffers after it, and the files
    written."""
    from sincformer_tpu_torch.data.loader import WaveformDataset
    from sincformer_tpu_torch.ops.attention import ring_mesh
    pipe = seeded_dcse_trainer(job["config"], "speech" if mesh is None
                               else "ring", mesh, model_dir, dtype)
    clean_train, clean_test, noises = job["train_data"]
    train_ds, test_ds = (WaveformDataset.from_arrays(
        c, noises, max_len=job["max_len"]) for c in (clean_train,
                                                     clean_test))
    with (contextlib.nullcontext() if mesh is None
          else ring_mesh(mesh, "seq")):
        history = pipe.train(train_ds, test_ds, epochs=1, batch_size=4,
                             verbose=False)
    return worker._trained(pipe, history, model_dir)


def mesh_steps(job, mesh, out_dir):
    from sincformer_tpu_torch.parallel import make_mesh
    out = {"steps": {}}
    batch = {k: job[k] for k in ("noisy", "clean", "lengths")}
    meshes = {name: make_mesh(axis_names=names, shape=shape)
              for name, (names, shape) in MESHES.items()}
    for name, m in meshes.items():
        for dname, dtype in (("f32", None), ("bf16", torch.bfloat16)):
            pipe = dcse_trainer(job["dcse"], job["dcse_heads"], "ring", m,
                                dtype)
            out["steps"][name, dname] = dcse_mesh_step(pipe, m, batch)
    m = meshes["data_seq"]
    # the fault: the norms over the ring, not the data ranks; over data
    # × ring every row counts once per ring rank, which leaves the ratio
    # and its all-reduced backward as they are
    for key, over in (("sc", None), ("sc_ring", (m, "seq")),
                      ("sc_world", (make_mesh(), "data"))):
        out[key] = dcse_sc_step(dcse_trainer(
            job["dcse"], job["dcse_heads"], "ring", m), m, batch, over)
    pipe = seeded_dcse_trainer(job["config"], "ring", m)
    out["batch_norm"] = dcse_mesh_step(pipe, m, batch)
    out["eval"] = dcse_eval(pipe, m, batch)
    out["eval_bf16"] = dcse_eval(seeded_dcse_trainer(
        job["config"], "ring", m, dtype=torch.bfloat16), m, batch)
    rank = torch.distributed.get_rank()
    out["train"] = dcse_epoch(job, m, os.path.join(out_dir, f"dcse_{rank}"))
    out["train_bf16"] = dcse_epoch(
        job, m, os.path.join(out_dir, f"dcse_bf16_{rank}"), torch.bfloat16)
    out["coords"] = {a: m.get_local_rank(a) for a in m.mesh_dim_names}
    return out
