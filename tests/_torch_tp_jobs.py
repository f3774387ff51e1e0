"""The tensor- and context-parallel jobs of the port's gloo ranks
(tests/_torch_dp_worker.py runs them; tests/test_torch_tp.py and
tests/test_torch_cp.py compare what they return). Imports torch and the
port only, never JAX.

  * :func:`tp` on a (1, 2) ("data", "model") mesh: the narrow DCSE step of
    JAX's tensor-parallel test and the narrow flagship's adversarial step,
    with the split leaves gathered; each rank's storage of its split
    leaves; the DCSE step again with a gather whose backward sums the
    ranks' gradients (``torch.distributed.nn``'s, planted); a checkpoint
    written by the two ranks and a resume from it.
  * :func:`cp` on a 2-rank sequence axis: ring attention, a ConformerBlock
    with ``attn_impl="ring"`` and its halo conv under ``ring_mesh`` (loss,
    input and parameter gradients, one SGD step), the same block with a
    hop whose backward keeps the gradient where it arrived (planted), and
    ``cp_depthwise_conv`` on a (2, 1) and a (1, 2) mesh with its
    gradients; the ring and the halo conv on bf16 inputs; the narrow
    ``DCSETrainer``'s step under ``ring_mesh`` in float32 and bf16
    (:func:`cp_trainer`); the depthwise conv where the halo cannot run
    (an even kernel, a block shorter than the halo) and the conv module
    with "batch" and "group" norm under ``ring_mesh``.
  * :func:`cp_bf16` on a 2-rank sequence axis: the narrow DCSE model in
    bf16 (the trainer's bf16 copies of float32 masters) with
    ``attn_impl="ring"`` under ``ring_mesh``, given the whole STFT, its
    loss over this rank's half of the frames (:func:`dcse_bf16_step`),
    against which the test runs the same model in one process.
"""

from __future__ import annotations

import os
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from tests import _torch_dp_worker as worker


def _summing_gather_backward(ctx, g):
    """What ``torch.distributed.nn.functional.all_gather``'s backward
    gives: the ranks' gradients summed, then this rank's slice."""
    from sincformer_tpu_torch.parallel import collectives
    g = g.contiguous().clone()
    dist.all_reduce(g, group=ctx.group)
    n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
    return (collectives.take(g, ctx.dim, ctx.groups, n, r), None, None, None,
            None)


def _storage(model) -> dict:
    """{split parameter: (elements this rank holds, elements of the whole
    leaf)}."""
    return {name: (p.numel(), int(np.prod(p.tp_shape)))
            for name, p in model.named_parameters()
            if getattr(p, "tp_split", None) is not None}


def tp(job, mesh, out_dir):
    from sincformer_tpu_torch.parallel import collectives
    from sincformer_tpu_torch.parallel.sharding import gathered
    from sincformer_tpu_torch.train.state import restore_checkpoint
    dcse_job = dict(job["dcse"], model_dir=os.path.join(out_dir, "models"))
    pipe = worker._dcse_trainer(dcse_job, "layer", mesh)
    out = {"storage": _storage(pipe.model)}
    try:        # a split model outside model_parallel must not run
        spec = torch.zeros(1, 11, 129)
        pipe.model(spec, spec)
        out["outside"] = None
    except RuntimeError as e:
        out["outside"] = str(e)
    out["dcse"] = worker._dcse_step(dcse_job, "layer", mesh, pipe)
    # the checkpoint: every rank gathers, the first writes; a resume
    # re-shards it
    out["saved"] = pipe.save_model("tp_ckpt")
    opt = {k: gathered(pipe.opt_state[k], pipe.model, mesh)
           for k in ("mu", "nu")}
    out["opt"] = opt
    collectives.barrier(mesh)
    again = worker._dcse_trainer(dcse_job, "layer", mesh)
    again.load_model(os.path.join(dcse_job["model_dir"], "tp_ckpt",
                                  f"step_{pipe.step}"))
    again.init_state(worker.LR_EPOCHS, worker.LR_STEPS, init_params=False,
                     reset_optimizer=False)
    out["resumed"] = {
        "params": gathered(dict(again.model.named_parameters()),
                           again.model, mesh),
        "mu": gathered(again.opt_state["mu"], again.model, mesh),
        "storage": _storage(again.model), "step": again.step}
    out["written"] = (restore_checkpoint(out["saved"])
                      if out["saved"] else None)
    with mock.patch.object(collectives._Gather, "backward",
                           staticmethod(_summing_gather_backward)):
        out["summing_gather"] = worker._dcse_step(dcse_job, "layer", mesh)
    out["flagship"] = worker._flagship_step(job["flagship"], mesh)
    return out


# ── context parallelism ──────────────────────────────────────────────────

def _block(job):
    from sincformer_tpu_torch.models.conformer import ConformerBlock
    blk = ConformerBlock(**job["block"], attn_impl="ring")
    blk.load_state_dict({k: torch.from_numpy(v)
                         for k, v in job["block_params"].items()})
    return blk


def _ring_block(job, mesh, x_np, loss_of):
    """Each rank's share of the loss ``loss_of(out_block, rows)`` of the
    ring block on its block of frames, and its gradients with respect to
    the whole input and the parameters (the sums over the ranks are the
    one-process gradients)."""
    from sincformer_tpu_torch.ops.attention import ring_mesh
    blk = _block(job)
    n, r = mesh.size(0), mesh.get_local_rank("data")
    x = torch.from_numpy(x_np).requires_grad_(True)
    tl = x.shape[1] // n
    rows = slice(r * tl, (r + 1) * tl)
    with ring_mesh(mesh, "data"):
        loss = loss_of(blk(x[:, rows]), rows)
    params = [p for _, p in blk.named_parameters()]
    gx, *gp = torch.autograd.grad(loss, [x, *params])
    return {"loss": float(loss.detach()), "x_grad": gx,
            "grads": {k: g for (k, _), g in zip(blk.named_parameters(), gp)}}


def _sgd_step(job, mesh):
    """JAX's dry-run regression: the mean squared error of the ring block
    against targets, one SGD step of 1e-2 on the gradients summed over
    the ranks, and the loss after it."""
    from sincformer_tpu_torch.ops.attention import ring_mesh
    x, y = (torch.from_numpy(job[k]) for k in ("x", "y"))
    group = mesh.get_group("data")
    n, r = mesh.size(0), mesh.get_local_rank("data")
    tl = x.shape[1] // n
    rows = slice(r * tl, (r + 1) * tl)
    blk = _block(job)

    def loss_now():
        with ring_mesh(mesh, "data"):
            part = torch.sum((blk(x[:, rows]) - y[:, rows]) ** 2) / y.numel()
        total = part.detach().clone()
        dist.all_reduce(total, group=group)
        return part, float(total)
    part, before = loss_now()
    grads = torch.autograd.grad(part, list(blk.parameters()))
    with torch.no_grad():
        for p, g in zip(blk.parameters(), grads):
            g = g.clone()
            dist.all_reduce(g, group=group)
            p.sub_(1e-2 * g)
        _, after = loss_now()
    return before, after


def cp(job, mesh, out_dir):
    from sincformer_tpu_torch.ops.cp_conv import cp_depthwise_conv
    from sincformer_tpu_torch.ops.ring_attention import ring_attention
    from sincformer_tpu_torch.parallel import collectives, make_mesh
    q, k, v = (torch.from_numpy(job[n]) for n in ("q", "k", "v"))
    out = {"ring": ring_attention(q, k, v, mesh)}
    sq = lambda o, rows: torch.sum(o ** 2)  # noqa: E731
    out["block"] = _ring_block(job, mesh, job["x"], sq)
    out["sgd"] = _sgd_step(job, mesh)
    with mock.patch.object(collectives._Hop, "backward",
                           staticmethod(lambda ctx, g: (g, None, None))):
        out["kept_hop"] = _ring_block(job, mesh, job["x"], sq)
    conv = {}
    for shape in ((2, 1), (1, 2)):
        cmesh = make_mesh(axis_names=("data", "model"), shape=shape)
        x = torch.from_numpy(job["conv_x"]).requires_grad_(True)
        w = torch.from_numpy(job["conv_w"]).requires_grad_(True)
        b = torch.from_numpy(job["conv_b"]).requires_grad_(True)
        y = cp_depthwise_conv(x, w, b, cmesh, "data")
        n, r = cmesh.size(0), cmesh.get_local_rank("data")
        tl = x.shape[1] // n
        cot = torch.from_numpy(job["conv_cot"])[:, r * tl:(r + 1) * tl]
        gx, gw, gb = torch.autograd.grad(torch.sum(y * cot), [x, w, b])
        conv[shape] = {"y": y.detach(), "x_grad": gx, "w_grad": gw,
                       "b_grad": gb, "n": n, "r": r}
    out["conv"] = conv
    # the ring and the halo conv on bf16 inputs, forward only
    conv16 = [torch.from_numpy(job[n]).bfloat16()
              for n in ("conv_x", "conv_w", "conv_b")]
    out["bf16"] = {"ring": ring_attention(q.bfloat16(), k.bfloat16(),
                                          v.bfloat16(), mesh),
                   "conv": cp_depthwise_conv(*conv16, mesh)}
    out["raises"] = _raises(mesh)
    out["masked"] = _masked_fallback(job, mesh)
    out["modules"] = {name: _module_under_ring(case, mesh)
                      for name, case in job["modules"].items()}
    out["trainer"] = cp_trainer(job, mesh)
    return out


def module_of(spec, state=None):
    """The module of a ``job["modules"]`` case's ``spec``,
    ``("depthwise", features, k, None)`` or ``("conv", d_model, k, norm)``
    (a ConvolutionModule, dropout 0), in float64 with the parameters and
    buffers ``state`` (name → float64 array) when given."""
    from sincformer_tpu_torch.models.conformer import (ConvolutionModule,
                                                       DepthwiseConv)
    kind, d, k, norm = spec
    mod = (DepthwiseConv(d, k) if kind == "depthwise"
           else ConvolutionModule(d, k, 0.0, norm))
    if state is not None:
        mod.to(torch.float64).load_state_dict(
            {k: torch.from_numpy(v) for k, v in state.items()})
    return mod


def apply_module(mod, case, x):
    """A "batch" conv module in a training forward (it is given a
    generator, and dropout 0 draws nothing); every other case as is."""
    if case["spec"][3] == "batch":
        return mod(x, torch.Generator().manual_seed(0))
    return mod(x)


def _module_under_ring(case, mesh):
    """This rank's block of a module's output under ``ring_mesh`` and its
    gradients for the cotangent's block, in the whole input and the
    parameters; the buffers after the forward."""
    from sincformer_tpu_torch.ops.attention import ring_mesh
    n, r = mesh.size(0), mesh.get_local_rank("data")
    mod = module_of(case["spec"], case["state"])
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    tl = x.shape[1] // n
    rows = slice(r * tl, (r + 1) * tl)
    with ring_mesh(mesh, "data"):
        y = apply_module(mod, case, x[:, rows])
    names = [k for k, _ in mod.named_parameters()]
    gx, *gp = torch.autograd.grad(
        torch.sum(y * torch.from_numpy(case["cot"])[:, rows]),
        [x, *mod.parameters()])
    return {"y": y.detach(), "x_grad": gx, "grads": dict(zip(names, gp)),
            "buffers": {k: b.clone() for k, b in mod.named_buffers()}}


def _masked_fallback(job, mesh):
    """``impl="ring"`` with a valid-frame mask inside ``ring_mesh``, in
    inference: the warning and this rank's block of the whole sequence's
    masked attention."""
    import warnings

    from sincformer_tpu_torch.ops.attention import (dot_product_attention,
                                                    ring_mesh)
    n, r = mesh.size(0), mesh.get_local_rank("data")
    tl = job["q"].shape[1] // n
    q, k, v = (torch.from_numpy(job[x])[:, r * tl:(r + 1) * tl]
               for x in ("q", "k", "v"))
    mask = torch.from_numpy(job["mask"])[:, r * tl:(r + 1) * tl]
    with ring_mesh(mesh, "data"), warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = dot_product_attention(q, k, v, mask=mask, impl="ring")
    return {"out": out, "warned": [str(x.message) for x in w
                                   if issubclass(x.category,
                                                 RuntimeWarning)]}


def _raises(mesh) -> dict:
    """The messages of the CP ops' refusals on the 2-rank axis: a T that
    does not divide it, an even kernel, a block shorter than the halo."""
    from sincformer_tpu_torch.ops.cp_conv import cp_depthwise_conv
    from sincformer_tpu_torch.ops.ring_attention import ring_attention
    out = {}
    q = torch.zeros(1, 63, 2, 8)
    cases = {
        "ring_t": lambda: ring_attention(q, q, q, mesh),
        "conv_even_k": lambda: cp_depthwise_conv(
            torch.zeros(1, 40, 4), torch.zeros(4, 1, 6), None, mesh),
        "conv_t": lambda: cp_depthwise_conv(
            torch.zeros(1, 41, 4), torch.zeros(4, 1, 7), None, mesh),
        "conv_block": lambda: cp_depthwise_conv(
            torch.zeros(1, 4, 4), torch.zeros(4, 1, 7), None, mesh)}
    for name, call in cases.items():
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def dcse_model(config: dict, attn_impl: str):
    """The DCSE SpeechEnhancer of ``config`` with ``attn_impl``, float32
    weights drawn from seed 0 (the same weights for every impl)."""
    from sincformer_tpu_torch.config import DCSEConfig
    from sincformer_tpu_torch.models.dcse import SpeechEnhancer
    return SpeechEnhancer(DCSEConfig(**config, attn_impl=attn_impl)
                          ).init_params(torch.Generator().manual_seed(0))


def dcse_bf16_step(model, job, rows=slice(None), dtype=torch.bfloat16):
    """A training forward (dropout 0, BatchNorm on the batch's statistics)
    of ``model`` in ``dtype`` on bf16 (``dtype``) copies of its float32
    masters, as ``DCSETrainer(compute_dtype=...)`` runs it, on the job's
    noisy STFT: the loss sum(weight · |enhanced|²) over ``rows`` of the
    frames, the masters' gradients (under a ring, this rank's share) and
    the enhanced STFT of those frames (float32)."""
    from sincformer_tpu_torch.train.dcse_trainer import compute_copies
    re, im = (torch.from_numpy(job[k]) for k in ("re", "im"))
    wt = torch.from_numpy(job["weight"])[:, rows]
    params = dict(model.named_parameters())
    er, ei, _ = torch.func.functional_call(
        model, compute_copies(model, dtype), (re.to(dtype), im.to(dtype)),
        {"generator": torch.Generator().manual_seed(0)})
    er, ei = er[:, rows], ei[:, rows]
    loss = torch.sum(wt * (er.float() ** 2 + ei.float() ** 2))
    grads = torch.autograd.grad(loss, list(params.values()))
    return {"loss": float(loss.detach()),
            "out": torch.stack([er, ei]).detach().float(),
            "grads": dict(zip(params, grads))}


def cp_trainer(job, mesh=None):
    """The narrow ``DCSETrainer`` with JAX's weights (``job["dcse"]``):
    ``loss_and_grads`` without the multi-resolution STFT term, in float32
    and bf16, with ``attn_impl="ring"`` under ``ring_mesh`` on ``mesh``, or
    in one process with ``attn_impl="speech"`` when ``mesh`` is None: the
    loss and the gradients by parameter name."""
    import contextlib
    import tempfile

    import sincformer_tpu_torch.train.dcse_trainer as port_dcse
    from sincformer_tpu_torch.compat.from_jax import \
        load_dcse_train_state_from_jax
    from sincformer_tpu_torch.models.dcse import SpeechEnhancer
    from sincformer_tpu_torch.ops.attention import ring_mesh
    out = {}
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        named, buffers, _, config = load_dcse_train_state_from_jax(
            job["dcse"], None, None, num_heads=job["block"]["num_heads"],
            dropout=0.0, attn_impl="speech" if mesh is None else "ring")
        pipe = port_dcse.DCSETrainer(SpeechEnhancer(config), device="cpu",
                                     model_dir=tempfile.mkdtemp(),
                                     compute_dtype=dtype)
        pipe.load_state(named, buffers)
        pipe.init_state(worker.LR_EPOCHS, worker.LR_STEPS, init_params=False)
        with mock.patch.object(port_dcse, "multi_resolution_stft_loss",
                               lambda pred, target: pred.sum() * 0.0), \
                (contextlib.nullcontext() if mesh is None
                 else ring_mesh(mesh, "data")):
            loss, _, grads = pipe.loss_and_grads(
                *(torch.from_numpy(job[k]) for k in ("noisy", "clean")))
        out[name] = {"loss": float(loss),
                     "grads": dict(zip(pipe.params(), grads))}
    return out


def cp_bf16(job, mesh, out_dir):
    from sincformer_tpu_torch.ops.attention import ring_mesh
    n, r = mesh.size(0), mesh.get_local_rank("data")
    tl = job["re"].shape[1] // n
    model = dcse_model(job["config"], "ring")
    with ring_mesh(mesh, "data"):
        return dcse_bf16_step(model, job, slice(r * tl, (r + 1) * tl))
