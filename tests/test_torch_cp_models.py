"""Context parallelism at the model in the port against the JAX package, on
the CPU: models and trainers called inside ``ops.ring_mesh`` with the whole
sequence on every rank, as JAX runs them (``parallel/context.py``).

Two gloo ranks on a 2-rank "data" ring (``tests/_torch_cp_jobs.models``),
each given the whole input, against JAX's models traced under
``ring_mesh`` on 2 devices:

  * (a) the narrow flagship's and the narrow DCSE model's inference
    forwards, within 1e-5 of the output's scale (before the model cut the
    sequence itself, each rank took the whole sequence for its block of
    one twice as long);
  * (b) the flagship trainer's training loss without the multi-resolution
    STFT term (its float32 gradient is ill-conditioned, ROADMAP.md Queue
    3) and every gradient leaf against JAX's, at ``tests/test_torch_cp.py``'s
    bars (the loss 1e-5 relative, each leaf 5e-4); the MAA statistics
    and the episodic bank after it against JAX's; one AdamW step; the
    adversarial branch and the discriminator's gradients against the
    port's one-process trainer at the same bars;
  * (c) a T' of 51 frames (4,080 samples) raises JAX's error;
  * two ring ranks with dropout on return the same loss;
  * ``enhance_signal`` and ``enhance_batch`` of both pipelines against one
    process.

Four gloo ranks (``tests/_torch_cp_jobs.mesh_steps``, one job on a pool of
four): the narrow DCSE trainer on a (2, 2) ("data", "seq") and a (1, 2, 2)
("data", "model", "seq") mesh, the ring on "seq", batch (4, 4,080) = 52
frames: in float32 against JAX's step on the same meshes at the ring bars;
in bf16 by each leaf's noise against the port's one-process steps
(``RING_NOISE_MEDIAN`` / ``_WORST`` of ``tests/test_torch_cp.py``); a
"batch"-norm step (statistics over data × ring) with its running
statistics; the step on the MR-STFT loss's spectral convergence alone
(global over the data ranks) against one process, where norms planted
over the ring must fail; ``eval_step``
and an epoch of ``train`` against one process, in float32 and bf16."""

import functools
import tempfile
import threading
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sincformer_tpu_torch.train.agent_trainer import LR
from tests import _torch_cp_jobs as jobs
from tests import _torch_dp_worker as worker
from tests._torch_bf16 import distance
from tests._torch_parity import (NARROW, NARROW_DCSE, Ahead, narrow_dcse,
                                 narrow_model, wave)
from tests.test_torch_cp import (LOSS_RTOL, P_GRAD_TOL, RING_NOISE_MEDIAN,
                                 RING_NOISE_WORST, STEP_LOSS_REL)

FWD_TOL = 1e-5            # a forward, of the output's scale
STATE_TOL = 1e-6          # the MAA statistics and the bank, of their scale
EVAL_RTOL = 1e-5          # eval_step's sums and means
EPOCH_RTOL = 1e-4         # an epoch's losses (two AdamW steps in)
N_RING = 4080             # samples: 52 STFT frames, two blocks of 26
N_LONG = 4080             # the flagship's T' = 51: refused on two ranks
_PATCH_LOCK = threading.Lock()


def _stft(x: np.ndarray):
    from sincformer_tpu_torch.dsp.stft import stft
    s = stft(torch.from_numpy(x), 256, 80, 160)
    return s.real.numpy(), s.imag.numpy()


def _batch4():
    """(4, 4,080) noisy and clean and their lengths: 52 frames."""
    rng = np.random.default_rng(53)
    clean = (rng.standard_normal((4, N_RING)) * 0.2).astype(np.float32)
    noisy = (clean + rng.standard_normal((4, N_RING)) * 0.1).astype(
        np.float32)
    return {"noisy": noisy, "clean": clean,
            "lengths": np.array([N_RING, 3000, N_RING, 3500], np.int32)}


def _train_data():
    """Eight training and five validation utterances of 0.6 s and a white
    noise: two steps of four, a validation batch of four (split over the
    data ranks) and one of one (whole on every rank)."""
    rng = np.random.default_rng(59)
    utt = lambda: (rng.standard_normal(4800) * 0.2).astype(np.float32)  # noqa
    return ([utt() for _ in range(8)], [utt() for _ in range(5)],
            {"white": (rng.standard_normal(40000) * 0.1).astype(np.float32)})


@functools.lru_cache(maxsize=None)
def _job_models():
    _, v, _ = narrow_model()
    noisy, clean = wave(61), (wave(62) * 0.5).astype(np.float32)
    re, im = _stft(noisy)
    dre, dim = ((0.5 * np.random.default_rng(seed).standard_normal(
        (2, 52, 129))).astype(np.float32) for seed in (67, 71))
    return {"kind": "cp_models", "variables": v,
            "narrow": {"num_heads": NARROW["num_heads"],
                       "sinc_kernel_size": NARROW["sinc_kernel_size"]},
            "noisy": noisy, "clean": clean, "stft_re": re, "stft_im": im,
            "dcse": narrow_dcse()["params"],
            "dcse_heads": NARROW_DCSE["num_heads"],
            "dcse_re": dre, "dcse_im": dim,
            "long": wave(63, (2, N_LONG)),
            "signal": wave(64, (1, 4000))[0],
            "dcse_batch": wave(65, (2, N_RING))}


@functools.lru_cache(maxsize=None)
def _job_mesh():
    return {"kind": "cp_mesh", **_batch4(), "dcse": narrow_dcse()["params"],
            "dcse_heads": NARROW_DCSE["num_heads"],
            "config": {"d_model": 32, "num_blocks": 2, "num_heads": 2,
                       "ff_dim": 64, "kernel_size": 7},
            "train_data": _train_data(), "max_len": N_RING}


# ── JAX's side ───────────────────────────────────────────────────────────

def _ring2():
    from sincformer_tpu.ops.attention import ring_mesh
    from sincformer_tpu.parallel.mesh import make_mesh
    return ring_mesh(make_mesh(2, ("data",)), "data")


def _jax_forwards():
    """JAX's narrow flagship and DCSE models with ``attn_impl="ring"``, in
    inference, under ``ring_mesh`` on 2 devices."""
    job = _job_models()
    from sincformer_tpu.agents.metacog import SincformerMetacog as JaxModel
    from sincformer_tpu.models.dcse import SpeechEnhancer
    flag = JaxModel(**NARROW, dropout=0.0, attn_impl="ring",
                    pa_fine_act="mulaw")
    dcse = SpeechEnhancer(n_freq=129, dropout=0.0, attn_impl="ring",
                          **NARROW_DCSE)
    with _ring2():
        out = jax.jit(lambda v, w, r, i: flag.apply(v, w, r, i, train=False))(
            job["variables"], job["noisy"], job["stft_re"], job["stft_im"])
        d = jax.jit(lambda p, r, i: dcse.apply({"params": p}, r, i))(
            job["dcse"], job["dcse_re"], job["dcse_im"])
    return ({k: np.asarray(out[k]) for k in ("enhanced_real",
                                             "enhanced_imag", "mask_mag")},
            [np.asarray(x) for x in d])


def _jax_flagship_pipe():
    from sincformer_tpu.agents.metacog import SincformerMetacog as JaxModel
    from sincformer_tpu.train.agent_trainer import SincformerPipeline
    model = JaxModel(**NARROW, dropout=0.0, attn_impl="ring",
                     pa_fine_act="mulaw", routing="softmax")
    return SincformerPipeline(model=model, model_dir=tempfile.mkdtemp())


def _jax_flagship_step():
    """JAX's flagship training loss without the MR-STFT term traced under
    ``ring_mesh`` on 2 devices: (loss, {port name: gradient}, {buffer:
    value after})."""
    import sincformer_tpu.train.agent_trainer as jax_agents
    from tests.test_torch_train_step import COLLECTIONS, _buffers, _named
    job = _job_models()
    pipe = _jax_flagship_pipe()
    v = job["variables"]
    params = v["params"]
    state = {k: v[k] for k in COLLECTIONS}

    def f(p, ms):
        return jax.value_and_grad(lambda p_: pipe._loss(
            p_, ms, job["noisy"], job["clean"], jax.random.PRNGKey(0),
            True, 1.0, 1.0, use_mask_mse=1.0), has_aux=True)(p)
    with _PATCH_LOCK, mock.patch.object(
            jax_agents, "multi_resolution_stft_loss",
            lambda pred, target: jnp.sum(pred) * 0.0), _ring2():
        lowered = jax.jit(f).lower(params, state)
    (loss, aux), grads = lowered.compile()(params, state)
    return (float(loss), _named(grads),
            {k: np.asarray(b) for k, b in
             _buffers(aux["model_state"]).items()})


def _jax_refusal():
    """JAX's error for the flagship's training forward with T' = 51 under
    the 2-device ring (a trace, nothing compiled)."""
    from tests.test_torch_train_step import COLLECTIONS
    job = _job_models()
    pipe = _jax_flagship_pipe()
    v = job["variables"]
    try:
        with _ring2():
            jax.eval_shape(lambda p: pipe._loss(
                p, {k: v[k] for k in COLLECTIONS}, job["long"], job["long"],
                jax.random.PRNGKey(0), True, 1.0, 1.0), v["params"])
    except RuntimeError as e:
        return str(e)
    return None


def _jax_mesh_step(name: str):
    """JAX's narrow DCSE training loss without the MR-STFT term
    (``DCSEPipeline._loss_fn``) with ``attn_impl="ring"``, the batch
    placed by ``shard_batch`` on "data", the parameters by
    ``shard_params`` on "model", traced under ``ring_mesh`` on "seq":
    (loss, {port name: gradient})."""
    import sincformer_tpu.train.dcse_trainer as jax_dcse
    from sincformer_tpu.models.dcse import SpeechEnhancer
    from sincformer_tpu.ops.attention import ring_mesh
    from sincformer_tpu.parallel.mesh import make_mesh, shard_batch
    from sincformer_tpu.parallel.sharding import shard_params
    from sincformer_tpu_torch.compat.from_jax import _dcse_named
    names, shape = jobs.MESHES[name]
    mesh = make_mesh(int(np.prod(shape)), names, shape=shape)
    pipe = jax_dcse.DCSEPipeline(
        model=SpeechEnhancer(n_freq=129, dropout=0.0, attn_impl="ring",
                             **NARROW_DCSE), model_dir=tempfile.mkdtemp())
    params = shard_params(narrow_dcse()["params"], mesh)
    b = _batch4()
    b = shard_batch(mesh, {k: b[k] for k in ("noisy", "clean")})

    def f(p, noisy, clean):
        return jax.value_and_grad(lambda p_: pipe._loss_fn(
            p_, None, noisy, clean, jax.random.PRNGKey(0), True)[0])(p)
    with _PATCH_LOCK, mock.patch.object(
            jax_dcse, "multi_resolution_stft_loss",
            lambda pred, target: jnp.sum(pred) * 0.0), \
            ring_mesh(mesh, "seq"):
        lowered = jax.jit(f).lower(params, b["noisy"], b["clean"])
    loss, grads = lowered.compile()(params, b["noisy"], b["clean"])
    return float(loss), _dcse_named(jax.tree.map(np.asarray, grads))


# ── the port in one process ──────────────────────────────────────────────

@functools.lru_cache(maxsize=None)
def _one_dcse(dtype_name: str):
    """The port's one-process DCSE step on the whole batch of four."""
    dtype = {"f32": None, "bf16": torch.bfloat16}[dtype_name]
    pipe = jobs.dcse_trainer(narrow_dcse()["params"],
                             NARROW_DCSE["num_heads"], "speech", None, dtype)
    return jobs.dcse_mesh_step(pipe, None, _batch4())


@functools.lru_cache(maxsize=None)
def _one_sc():
    """The port's one-process step on the spectral convergence alone."""
    pipe = jobs.dcse_trainer(narrow_dcse()["params"],
                             NARROW_DCSE["num_heads"], "speech")
    return jobs.dcse_sc_step(pipe, None, _batch4())


@functools.lru_cache(maxsize=None)
def _one_batch_norm():
    job = _job_mesh()
    pipe = jobs.seeded_dcse_trainer(job["config"], "speech")
    step = jobs.dcse_mesh_step(pipe, None, _batch4())
    bf16 = jobs.seeded_dcse_trainer(job["config"], "speech",
                                    dtype=torch.bfloat16)
    return step, {"f32": jobs.dcse_eval(pipe, None, _batch4()),
                  "bf16": jobs.dcse_eval(bf16, None, _batch4())}


@pytest.fixture(scope="module")
def ahead(tmp_path_factory):
    """Both ranks' jobs first, the JAX references meanwhile."""
    import sincformer_tpu.agents.metacog  # noqa: F401
    import sincformer_tpu.train.agent_trainer  # noqa: F401
    import sincformer_tpu.train.dcse_trainer  # noqa: F401
    job2, job4 = _job_models(), _job_mesh()
    two = worker.pool().submit(job2, str(tmp_path_factory.mktemp("cpm")))
    four = worker.pool(4).submit(job4, str(tmp_path_factory.mktemp("cp4")))
    a = Ahead()
    with a.start([(_jax_forwards,), (_jax_flagship_step,),
                  (_jax_mesh_step, "data_seq"),
                  (_jax_mesh_step, "data_model_seq"), (_jax_refusal,)]):
        a.two, a.four, a.job2, a.job4 = two, four, job2, job4
        yield a


def _np(t) -> np.ndarray:
    return t.detach().float().numpy().astype(np.float64) \
        if isinstance(t, torch.Tensor) else np.asarray(t, np.float64)


def _scaled(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def _worst(got: dict, want: dict) -> tuple:
    assert set(got) == set(want)
    errs = {k: float(np.abs(_np(got[k]) - _np(w)).max())
            for k, w in want.items()}
    k = max(errs, key=errs.get)
    return errs[k], k


def _same_on_ranks(outs, key):
    a = [o[key] for o in outs]
    assert all(x["loss"] == a[0]["loss"] for x in a), key
    for name, g in a[0]["grads"].items():
        assert all(torch.equal(x["grads"][name], g) for x in a), (key, name)


# ── two ranks ───────────────────────────────────────────────────────────

@pytest.mark.parametrize("model", ["flagship", "dcse"])
def test_models_under_a_ring_match_jax(ahead, model):
    """(a) Each rank's whole output of the model under ``ring_mesh`` with
    the whole input against JAX's model under the same context, within
    1e-5 of the output's scale; both ranks return the same."""
    outs = ahead.two.result()
    flag, dcse = ahead(_jax_forwards)
    for o in outs:
        if model == "flagship":
            errs = {k: _scaled(o["flagship"][k], w) for k, w in flag.items()}
        else:
            errs = {i: _scaled(g, w) for i, (g, w) in enumerate(
                zip(o["dcse"], dcse))}
        print(f"{model} under a 2-rank ring vs JAX's: {errs}")
        assert max(errs.values()) <= FWD_TOL, errs


def test_flagship_step_under_a_ring_matches_jax(ahead):
    """(b) The flagship trainer's loss without the MR-STFT term and every
    gradient leaf under the ring against JAX's on 2 devices (loss 1e-5
    relative, each leaf 5e-4); the MAA statistics and the episodic bank
    after it against JAX's; both ranks the same, also after one AdamW
    step, which is the one-process trainer's step of those gradients
    (within two steps of the rate, where a near-zero gradient's sign is
    rounding's, and 1e-5 of the scale)."""
    outs = ahead.two.result()
    _same_on_ranks(outs, "step")
    loss, grads, buffers = ahead(_jax_flagship_step)
    got = outs[0]["step"]
    worst, leaf = _worst({k: g for k, g in got["grads"].items()}, grads)
    print(f"flagship step on a 2-rank ring vs JAX's: loss "
          f"{abs(got['loss'] - loss) / abs(loss):.3g} relative, gradients "
          f"{worst:.3g} ({leaf})")
    assert abs(got["loss"] - loss) <= LOSS_RTOL * abs(loss)
    assert worst <= P_GRAD_TOL, leaf
    for k, w in buffers.items():
        for o in outs:
            err = float(np.abs(_np(o["step"]["buffers"][k]) - w).max())
            assert err <= STATE_TOL * max(1.0, float(np.abs(w).max())), k

    for name, p in outs[0]["adamw"].items():
        assert torch.equal(outs[1]["adamw"][name], p), name
    one = jobs.flagship_trainer(ahead.job2["variables"],
                                ahead.job2["narrow"], "speech")
    want = jobs.adamw_step(one, ahead.job2["noisy"], ahead.job2["clean"])
    for name, w in want.items():
        scale = float(w.abs().max())
        assert float((outs[0]["adamw"][name] - w).abs().max()) \
            <= 2 * LR + 1e-5 * scale, name


def test_adversarial_step_under_a_ring_matches_one_process(ahead):
    """The adversarial branch under the ring: the generator's loss and
    gradients with the LSGAN and feature-matching terms, and the
    discriminator's loss and gradients on the step's magnitudes, against
    the port's one-process trainer (held against JAX in
    ``tests/test_torch_adversarial.py``) at the ring bars."""
    outs = ahead.two.result()
    _same_on_ranks(outs, "adv")
    one = jobs.flagship_step(jobs.flagship_trainer(
        ahead.job2["variables"], ahead.job2["narrow"], "speech",
        adversarial=True), ahead.job2["noisy"], ahead.job2["clean"], 1.0)
    got = outs[0]["adv"]
    worst, leaf = _worst(got["grads"], one["grads"])
    dworst, dleaf = _worst(got["disc_grads"], one["disc_grads"])
    print(f"adversarial step on a 2-rank ring vs one process: generator "
          f"gradients {worst:.3g} ({leaf}), discriminator {dworst:.3g} "
          f"({dleaf})")
    assert abs(got["loss"] - one["loss"]) <= LOSS_RTOL * abs(one["loss"])
    assert abs(got["disc_loss"] - one["disc_loss"]) \
        <= LOSS_RTOL * abs(one["disc_loss"])
    assert worst <= P_GRAD_TOL and dworst <= P_GRAD_TOL


def test_ring_that_does_not_divide_raises_as_jax(ahead):
    """(c) The flagship's training forward at 4,080 samples (T' = 51) on
    the 2-rank ring raises JAX's error, on both ranks."""
    want = ahead(_jax_refusal)
    assert want is not None and "T=51 does not divide" in want
    for o in ahead.two.result():
        assert o["raised"] is not None
        assert "T=51 does not divide the 'data' axis size 2" in o["raised"]
        assert "training apply" in o["raised"] and "training apply" in want


def test_dropout_under_a_ring_gives_one_loss(ahead):
    """With dropout 0.1 the two ring ranks' training losses are the same:
    the part every rank repeats draws no mask and the blocks' masks are
    joined into one forward; dropout moved the loss."""
    outs = ahead.two.result()
    losses = [o["dropout_loss"] for o in outs]
    assert np.isfinite(losses[0]) and losses[0] == losses[1]
    assert losses[0] != outs[0]["step"]["loss"]


@pytest.mark.parametrize("pipeline", ["flagship", "dcse"])
def test_serving_under_a_ring_matches_one_process(ahead, pipeline):
    """``enhance_signal`` (4,000 samples) and ``enhance_batch`` of both
    pipelines under the ring against one process, within 1e-5 of the
    peak: the DCSE signal's 51 frames do not divide the ring, so that
    request warns and runs whole; the others run on the ring without a
    warning."""
    flag, dcse = jobs.serving_pipelines(ahead.job2, "speech")
    one = {"flagship": jobs.serve(flag, ahead.job2["signal"],
                                  ahead.job2["noisy"]),
           "dcse": jobs.serve(dcse, ahead.job2["signal"],
                              ahead.job2["dcse_batch"])}[pipeline]
    for o in ahead.two.result():
        got = o["serve"][pipeline]
        for k in ("signal", "batch"):
            assert got[k].shape == one[k].shape
            assert _scaled(got[k], one[k]) <= FWD_TOL, k
        fell_back = [w for w in got["warned"] if "does not divide" in w]
        assert len(fell_back) == (pipeline == "dcse"), got["warned"]


# ── four ranks: a data-parallel mesh inside the ring ────────────────────

@pytest.mark.parametrize("mesh", list(jobs.MESHES))
def test_dcse_trainer_on_a_mesh_inside_a_ring_matches_jax(ahead, mesh):
    """(d) The DCSE trainer's step in float32 on the mesh, the ring on
    "seq", against JAX's on the same mesh: the loss 1e-5 relative, each
    gradient leaf 5e-4; every rank returns the same step."""
    outs = [o["steps"] for o in ahead.four.result()]
    for o in outs[1:]:
        assert o[mesh, "f32"]["loss"] == outs[0][mesh, "f32"]["loss"]
        for k, g in o[mesh, "f32"]["grads"].items():
            assert torch.equal(g, outs[0][mesh, "f32"]["grads"][k]), k
    loss, grads = ahead(_jax_mesh_step, mesh)
    got = outs[0][mesh, "f32"]
    worst, leaf = _worst(got["grads"], grads)
    print(f"DCSE step on {jobs.MESHES[mesh]} vs JAX's: loss "
          f"{abs(got['loss'] - loss) / abs(loss):.3g} relative, gradients "
          f"{worst:.3g} ({leaf})")
    assert abs(got["loss"] - loss) <= LOSS_RTOL * abs(loss)
    assert worst <= P_GRAD_TOL, leaf


@pytest.mark.parametrize("mesh", list(jobs.MESHES))
def test_dcse_trainer_on_a_mesh_inside_a_ring_in_bf16(ahead, mesh):
    """(d) The bf16 step on the mesh against the port's one-process steps
    on the whole batch: each leaf's noise |ring bf16 - one f32| / |one
    bf16 - one f32| at most ``RING_NOISE_MEDIAN`` in the median and
    ``RING_NOISE_WORST`` at worst; the loss finite and the same on every
    rank."""
    outs = [o["steps"][mesh, "bf16"] for o in ahead.four.result()]
    assert all(o["loss"] == outs[0]["loss"] for o in outs)
    one16, one32 = _one_dcse("bf16"), _one_dcse("f32")
    noise = [distance(outs[0]["grads"][k], g)
             / distance(one16["grads"][k], g)
             for k, g in one32["grads"].items()]
    print(f"bf16 DCSE step on {jobs.MESHES[mesh]} vs one process: noise "
          f"median {np.median(noise):.3f}, worst {max(noise):.3f}")
    assert np.isfinite(outs[0]["loss"])
    assert np.median(noise) <= RING_NOISE_MEDIAN
    assert max(noise) <= RING_NOISE_WORST


def test_spectral_convergence_over_data_and_ring_matches_one_process(
        ahead):
    """The DCSE trainer's step on the MR-STFT loss's spectral convergence
    alone on the (2, 2) mesh: its two norms are global over the data ranks
    and each ring rank holds the same gathered waveform. The loss 1e-5
    relative and each gradient leaf 5e-4 of its scale from one process
    with the whole batch, every rank the same. Planted: the norms over the
    ring in place of the data ranks must leave one process's; over data ×
    ring every row counts once per ring rank, which leaves the ratio and
    its all-reduced backward unchanged, within the same bars."""
    four = ahead.four.result()
    one = _one_sc()
    got = {}
    for key in ("sc", "sc_ring", "sc_world"):
        _same_on_ranks(four, key)
        errs = {k: _scaled(four[0][key]["grads"][k], g)
                for k, g in one["grads"].items()}
        leaf = max(errs, key=errs.get)
        got[key] = (abs(four[0][key]["loss"] - one["loss"])
                    / abs(one["loss"]), errs[leaf], leaf)
        print(f"spectral convergence on (2, 2), {key}, vs one process: "
              f"loss {got[key][0]:.3g} relative, gradients "
              f"{got[key][1]:.3g} of their scale ({leaf})")
    for key in ("sc", "sc_world"):
        assert got[key][0] <= LOSS_RTOL, key
        assert got[key][1] <= P_GRAD_TOL, got[key]
    assert got["sc_ring"][0] > LOSS_RTOL or got["sc_ring"][1] > P_GRAD_TOL


def test_batch_norm_over_data_and_ring_matches_one_process(ahead):
    """A "batch"-norm DCSE step on the (2, 2) mesh: its statistics are
    means over the data ranks and then over the ring, so every frame
    counts once. The loss, the gradients and the running statistics after
    it against one process with the whole batch (1e-5 relative, 5e-4,
    1e-6 of their scale); every rank holds the same statistics."""
    outs = [o["batch_norm"] for o in ahead.four.result()]
    one, _ = _one_batch_norm()
    worst, leaf = _worst(outs[0]["grads"], one["grads"])
    assert abs(outs[0]["loss"] - one["loss"]) <= LOSS_RTOL * abs(one["loss"])
    assert worst <= P_GRAD_TOL, leaf
    for k, b in one["buffers"].items():
        for o in outs:
            err = float((o["buffers"][k] - b).abs().max())
            assert err <= STATE_TOL * max(1.0, float(b.abs().max())), k


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_eval_step_on_a_mesh_inside_a_ring(ahead, dtype):
    """``eval_step`` of the "batch"-norm model on the (2, 2) mesh (each data
    rank its two rows, each ring rank its 26 frames): the loss, SI-SNR, Σ
    log α and the count of the global batch, the same on every rank, as
    one process computes them (bf16: within the bf16 step's loss bar of
    ``tests/test_torch_cp.py``, the ring a different bf16 function)."""
    key = "eval" if dtype == "f32" else "eval_bf16"
    outs = [o[key] for o in ahead.four.result()]
    want = _one_batch_norm()[1][dtype]
    tol = EVAL_RTOL if dtype == "f32" else STEP_LOSS_REL
    assert all(got == outs[0] for got in outs)
    got = outs[0]
    assert got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        assert abs(g - w) <= tol * max(1.0, abs(w)), (got, want)


@functools.lru_cache(maxsize=None)
def _one_epoch(dtype_name: str):
    dtype = {"f32": None, "bf16": torch.bfloat16}[dtype_name]
    return jobs.dcse_epoch(_job_mesh(), None, tempfile.mkdtemp(), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_train_epoch_on_a_mesh_inside_a_ring(ahead, dtype):
    """An epoch of ``train`` on the (2, 2) mesh inside the ring: the same
    history and parameters on every rank, and only the rank first on every
    axis wrote the checkpoint and its sidecar, as one process writes them.
    The losses against one process's epoch: float32 1e-4 relative; bf16
    by their noise, |ring bf16 - one f32| / |one bf16 - one f32|, at most
    ``RING_NOISE_WORST`` (two AdamW steps in, the two bf16 functions'
    gradients have moved the weights apart)."""
    outs = ahead.four.result()
    runs = [o["train" if dtype == "f32" else "train_bf16"] for o in outs]
    for r in runs[1:]:
        assert r["history"] == runs[0]["history"]
        for k, p in runs[0]["params"].items():
            assert torch.equal(r["params"][k], p), k
    one, one32 = _one_epoch(dtype), _one_epoch("f32")
    for key in ("train_loss", "val_loss", "val_sisnr"):
        got, want = runs[0]["history"][0][key], one["history"][0][key]
        if dtype == "f32":
            print(f"f32 epoch on (2, 2) vs one process: {key} "
                  f"{abs(got - want) / abs(want):.3g} relative")
            assert abs(got - want) <= EPOCH_RTOL * abs(want), key
        else:
            w32 = one32["history"][0][key]
            noise = abs(got - w32) / abs(want - w32)
            print(f"bf16 epoch on (2, 2) vs one process: {key} noise "
                  f"{noise:.3f}")
            assert noise <= RING_NOISE_WORST, key
    writers = [o["coords"] for o, r in zip(outs, runs) if r["written"]]
    assert writers == [{"data": 0, "seq": 0}]
    assert sorted(runs[0]["written"]) == sorted(one["written"])
