"""Data-parallel training in the port against the JAX package's step on the
whole batch, on the CPU: two gloo processes (``tests/_torch_dp_worker.py``)
take two rows each of a batch of four, and JAX's single-process step takes
all four. JAX's sharded step is the unsharded program split by GSPMD, so
that one program is the reference of a data-parallel step.

The flagship: one adversarial step of the narrow model (dropout 0, softmax
routing) from ``tests/_torch_parity.py``'s weights and
``tests/test_torch_adversarial.py``'s discriminator, held at the training
bars of ``tests/test_torch_train_step.py`` (the loss 1e-5 relative; each
gradient leaf 1e-4 of its largest magnitude, floored at 1e-4 of the step's
largest; ``model_state``, the MAA statistics and the episodic bank among
it, 1e-6; the parameters after AdamW 1e-5 of their scale where the
gradient passes the gradient bar, within twice the step elsewhere, at most
1 % of the elements) and the discriminator at
``tests/test_torch_adversarial.py``'s (its loss 1e-5 relative, its
parameters and Adam moments 1e-5 of their scale, the parameters within
twice the step where the first moment is below 1e-5 of its leaf's
largest). DCSE, with ``conv_norm`` "batch" and "layer", at
``tests/test_torch_dcse_train.py``'s bars (the whole loss 1e-5 relative;
its global gradient norm and AdamW's clip factor, which the spectral
convergence's global norms and their all-reduced backward reach, within
1e-4 relative of JAX's plus twice the one-process port's float32 distance
from its own float64 norm; the loss without the MR-STFT term, its
gradients and the AdamW step as above; ``batch_stats`` 1e-6 against JAX's
over the whole padded batch).
The ranks' parameters and buffers are bit-equal after the step. Between
the two, ``evaluate --distributed`` through the real CLI in two processes
against the single-process grid (while JAX compiles the flagship's step on
a background thread).

Each test also runs a planted fault through the same bars, and it must
miss them: the flagship with the MAA statistics and the memory write and
counts per rank (what averaging the gradients alone computes), DCSE with
a per-rank BatchNorm. Its largest error over its bar is printed."""

import functools
import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import _torch_dp_worker as worker
from tests._torch_parity import (NARROW, NARROW_DCSE, Ahead, narrow_model,
                                 wave)

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
GRAD_FLOOR = 1e-4
STATE_TOL = 1e-6
NORM_TOL = 1e-4
GRAD_CLIP = 5.0          # DCSEConfig().grad_clip
PARAM_TOL = 1e-5
DISC_TOL = 1e-5
SIGN_TOL = 1e-5
N = 4000
COLLECTIONS = ("maa_stats", "memory_bank", "memory_stats")


def _np(x):
    return (x.detach().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x)).astype(np.float64)


def _flagship_batch():
    """Four rows of tests/test_torch_train_step.py's kind; the second
    rank's two are twice as loud, so the halves' statistics differ as two
    recordings' would."""
    noisy, clean = wave(5, (4, N)), (wave(6, (4, N)) * 0.5).astype(
        np.float32)
    noisy[2:] *= 2.0
    return noisy, clean


def _dcse_batch():
    """Four rows, the last 3,000 samples padded with zeros."""
    rng = np.random.default_rng(43)
    clean = (rng.standard_normal((4, N)) * 0.2).astype(np.float32)
    noisy = (clean + rng.standard_normal((4, N)) * 0.1).astype(np.float32)
    noisy[2:] *= 2.0
    clean[3, 3000:] = 0.0
    noisy[3, 3000:] = 0.0
    return noisy, clean


@functools.lru_cache(maxsize=None)
def _jax_flagship_fn():
    """One jitted adversarial step of the JAX pipeline: the generator's
    loss, gradients, new model_state and AdamW parameters, then the
    discriminator's loss and Adam step (on raveled parameters)."""
    import optax
    from jax.flatten_util import ravel_pytree

    from sincformer_tpu.agents.metacog import SincformerMetacog as JaxModel
    from sincformer_tpu.train.adversarial import discriminator_loss
    from sincformer_tpu.train.agent_trainer import SincformerPipeline
    from sincformer_tpu.train.state import guard_nan_update, make_adamw
    from tests.test_torch_adversarial import _jax_disc
    model = JaxModel(**NARROW, dropout=0.0, attn_impl="speech",
                     pa_fine_act="mulaw", routing="softmax")
    pipe = SincformerPipeline(model=model, model_dir=tempfile.mkdtemp(),
                              use_adversarial=True)
    dtx = optax.chain(optax.clip_by_global_norm(pipe.grad_clip),
                      optax.adam(2e-4))
    tx = make_adamw(5e-4, worker.LR_EPOCHS, worker.LR_STEPS)
    disc, dvars = _jax_disc()
    pipe.disc = disc
    unravel_d = ravel_pytree(dvars)[1]

    @jax.jit
    def step(params, model_state, flat_d, opt, dopt, noisy, clean):
        dparams = unravel_d(flat_d)
        (loss, aux), grads = jax.value_and_grad(
            lambda p: pipe._loss(p, model_state, noisy, clean,
                                 jax.random.PRNGKey(0), True, 1.0, 1.0,
                                 jax.lax.stop_gradient(dparams), 1.0, None,
                                 1.0), has_aux=True)(params)
        flat, unravel = ravel_pytree(params)
        g, _ = guard_nan_update(ravel_pytree(grads)[0], loss)
        upd, _ = tx.update(g, opt, flat)
        new_params = unravel(optax.apply_updates(flat, upd))
        enh = jax.lax.stop_gradient(aux["enh_mag"])
        cln = jax.lax.stop_gradient(aux["clean_mag"])
        dl, dgrads = jax.value_and_grad(
            lambda dp: discriminator_loss(disc.apply(unravel_d(dp), cln),
                                          disc.apply(unravel_d(dp), enh)))(
            flat_d)
        dgrads, _ = guard_nan_update(dgrads, dl)
        dupd, dopt = dtx.update(dgrads, dopt, flat_d)
        return (loss, grads, aux["model_state"], new_params, dl,
                optax.apply_updates(flat_d, dupd), dopt)

    def run(noisy, clean):
        _, v, _ = narrow_model()
        params = jax.tree.map(jnp.asarray, v["params"])
        ms = {k: jax.tree.map(jnp.asarray, v[k]) for k in COLLECTIONS}
        flat_d = ravel_pytree(dvars)[0]
        return step(params, ms, flat_d, tx.init(ravel_pytree(params)[0]),
                    dtx.init(flat_d), jnp.asarray(noisy), jnp.asarray(clean))
    return run, unravel_d


def _jax_flagship():
    run, _ = _jax_flagship_fn()
    return jax.tree.map(np.asarray, run(*_flagship_batch()))


def _jax_dcse(norm: str):
    """JAX's DCSE step on the whole batch for ``norm`` (its trace takes
    ``tests/test_torch_dcse_train.py``'s trace lock: it patches the JAX
    module's MR-STFT loss)."""
    from tests.test_torch_dcse_train import _jax_fns, _variables
    value_and_grad, _, init, update = _jax_fns(norm)
    v = _variables(norm)
    params = jax.tree.map(jnp.asarray, v["params"])
    ms = ({"batch_stats": jax.tree.map(jnp.asarray, v["batch_stats"])}
          if norm == "batch" else None)
    noisy, clean = _dcse_batch()
    ((loss, (_, new_ms, _)), grads), (whole, whole_norm) = \
        value_and_grad(params, ms, jnp.asarray(noisy), jnp.asarray(clean))
    new_params, _, _ = update(params, grads, loss, init(params))
    return jax.tree.map(np.asarray, (
        float(loss), float(whole), float(whole_norm), grads, new_ms,
        new_params))


def _exact_norm(norm):
    """The port's whole-loss global gradient norm in float64 on the whole
    batch in one process, and its float32 one: their distance measures
    the batch's float32 conditioning (tests/test_torch_dcse_train.py)."""
    from tests.test_torch_dcse_train import _global_norm, _port, _variables
    v = _variables(norm)
    noisy, clean = (torch.from_numpy(a) for a in _dcse_batch())
    pipe = _port(v["params"], v.get("batch_stats"))
    f32 = _global_norm(pipe.loss_and_grads(noisy, clean)[2])
    pipe.model.to(torch.float64)
    return f32, _global_norm(pipe.loss_and_grads(noisy.double(),
                                                 clean.double())[2])


def _dcse_job(model_dir: str) -> dict:
    from tests.test_torch_dcse_train import _variables
    noisy, clean = _dcse_batch()
    return {"kind": "dcse", "noisy": noisy, "clean": clean,
            "variables": {n: _variables(n) for n in ("batch", "layer")},
            "num_heads": NARROW_DCSE["num_heads"], "model_dir": model_dir,
            "train_data": _train_data(),
            "config": {"d_model": NARROW_DCSE["d_model"],
                       "num_blocks": NARROW_DCSE["num_blocks"],
                       "num_heads": NARROW_DCSE["num_heads"],
                       "ff_dim": NARROW_DCSE["d_ff"],
                       "kernel_size": NARROW_DCSE["kernel_size"]}}


def _flagship_job() -> dict:
    _, v, _ = narrow_model()
    noisy, clean = _flagship_batch()
    return {"kind": "flagship", "variables": v, "dvars": _jax_disc_vars(),
            "noisy": noisy, "clean": clean,
            "num_heads": NARROW["num_heads"],
            "sinc_kernel_size": NARROW["sinc_kernel_size"],
            "config": NARROW, "train_data": _train_data()}


@pytest.fixture(scope="module")
def ahead(tmp_path_factory):
    """The three jobs queued on the ranks first, in the tests' order, so
    they run while JAX compiles its references on two threads and the
    tests compute the port's one-process side."""
    # the JAX modules are imported here, once, before the threads would
    # import them at the same time (a module half initialised by one
    # thread is seen by the other)
    import sincformer_tpu.train.agent_trainer  # noqa: F401
    import sincformer_tpu.train.dcse_trainer  # noqa: F401
    import tests.test_torch_adversarial  # noqa: F401
    import tests.test_torch_dcse_train  # noqa: F401
    ranks = worker.pool()
    out = {kind: str(tmp_path_factory.mktemp(kind))
           for kind in ("dcse", "evaluate", "flagship")}
    a = Ahead()
    a.ranks = {
        "dcse": ranks.submit(_dcse_job(os.path.join(out["dcse"], "models")),
                             out["dcse"]),
        "evaluate": ranks.submit(
            {"kind": "evaluate", "max_eval": 2,
             "model_dir": os.path.join(out["evaluate"], "models")},
            out["evaluate"])}
    a.out = out
    with a.start([(_jax_flagship,), (_jax_dcse, "batch"),
                  (_jax_dcse, "layer")], threads=3):
        a.ranks["flagship"] = ranks.submit(_flagship_job(), out["flagship"])
        yield a


# ── the bars, as the ratio of each error to its bar (≤ 1 passes) ────────

def _grad_ratio(got, want):
    """Largest leaf error over 1e-4 of the leaf's largest magnitude,
    floored at 1e-4 of the step's largest."""
    floor = GRAD_FLOOR * max(float(np.max(np.abs(g))) for g in want.values())
    return max(float(np.max(np.abs(_np(got[k]) - g)))
               / (GRAD_TOL * max(float(np.max(np.abs(g))), floor))
               for k, g in want.items())


def _state_ratio(got, want):
    return max(float(np.max(np.abs(_np(got[k]) - _np(w))))
               / (STATE_TOL * max(1.0, float(np.max(np.abs(_np(w))))))
               for k, w in want.items())


def _param_ratio(got, want, before, grads, skip=()):
    """AdamW's parameters: 1e-5 of their scale where the gradient passes
    the gradient bar, within twice the step elsewhere (asserted, with the
    1 % limit on such elements); returns the settled elements' ratio."""
    floor = GRAD_FLOOR * max(float(np.max(np.abs(g))) for g in grads.values())
    worst, loose, total = 0.0, 0, 0
    for k, w in want.items():
        g = np.abs(grads[k]) * (k not in skip)
        settled = g > GRAD_TOL * max(float(np.max(g)), floor)
        diff = np.abs(_np(got[k]) - w)
        scale = float(np.max(np.abs(w)))
        before_k = np.asarray(before[k], np.float64)
        if settled.any():
            worst = max(worst, float(diff[settled].max())
                        / (PARAM_TOL * scale))
        step = float(np.max(np.abs(w - before_k)))
        assert np.all(diff[~settled] <= 2 * step + PARAM_TOL * scale), k
        loose += int(np.sum(~settled))
        total += w.size
    assert loose <= 0.01 * total, (loose, total)
    return worst


def _flagship_ratios(got, want):
    from sincformer_tpu_torch.compat.from_jax import (_disc_named,
                                                      _named_params)
    from tests.test_torch_train_step import _buffers
    (loss, grads, model_state, new_params, dl, dparams, dopt) = want
    _, unravel_d = _jax_flagship_fn()
    _, v, _ = narrow_model()
    named = lambda tree: _named_params(tree, 2)  # noqa: E731
    want_grads = {k: np.asarray(g, np.float64)
                  for k, g in named(grads).items()}
    mu, nu = _disc_moments(dopt, unravel_d)
    d_want = _disc_named(jax.tree.map(np.asarray, unravel_d(dparams)))
    d_before = _disc_named(jax.tree.map(np.asarray, _jax_disc_vars()))
    ratios = {
        "loss": abs(got["loss"] - float(loss)) / (LOSS_TOL * abs(float(loss))),
        "grads": _grad_ratio(got["grads"], want_grads),
        "model_state": _state_ratio(got["buffers"], _buffers(model_state)),
        "params": _param_ratio(got["params"], {
            k: np.asarray(w, np.float64) for k, w in
            named(new_params).items()}, named(v["params"]), want_grads),
        "disc_loss": abs(got["disc_loss"] - float(dl))
        / (LOSS_TOL * abs(float(dl))),
        "disc_moments": max(
            float((_np(got[g][k]) - _np(w[k])).__abs__().max())
            / (DISC_TOL * float(np.abs(_np(w[k])).max()))
            for g, w in (("disc_mu", mu), ("disc_nu", nu)) for k in w),
    }
    worst = 0.0
    for k, w in d_want.items():
        w, m = _np(w), np.abs(_np(mu[k]))
        settled = m > SIGN_TOL * float(m.max())
        diff = np.abs(_np(got["disc_params"][k]) - w)
        scale = float(np.abs(w).max())
        worst = max(worst, float(diff[settled].max()) / (DISC_TOL * scale))
        step = float(np.abs(w - _np(d_before[k])).max())
        assert np.all(diff[~settled] <= 2 * step + DISC_TOL * scale), k
    ratios["disc_params"] = worst
    return ratios


def _disc_moments(dopt, unravel_d):
    from sincformer_tpu_torch.compat.from_jax import _adam_state, _disc_named
    _, mu, nu = _adam_state(dopt)
    return (_disc_named(jax.tree.map(np.asarray, unravel_d(t)))
            for t in (mu, nu))


def _jax_disc_vars():
    from tests.test_torch_adversarial import _jax_disc
    return _jax_disc()[1]


def _ranks_equal(outs, keys):
    for key in keys:
        a, b = outs[0][key], outs[1][key]
        assert set(a) == set(b)
        bad = [k for k in a if not torch.equal(a[k], b[k])]
        assert not bad, (key, bad)


def _train_data():
    """Five training and three validation utterances of 0.5 s and a white
    noise: an epoch of two steps of two utterances, and a validation pass
    of a batch of two (split) and one of one (whole on each rank)."""
    rng = np.random.default_rng(47)
    utt = lambda: (rng.standard_normal(N) * 0.2).astype(np.float32)  # noqa
    return ([utt() for _ in range(5)], [utt() for _ in range(3)],
            {"white": (rng.standard_normal(40000) * 0.1).astype(np.float32)})


def _check_training_loop(outs, family):
    """An epoch of ``train`` on two ranks: the same history on both, the
    parameters and buffers bit-equal after it, and only rank 0 wrote (the
    best checkpoint and its sidecar)."""
    runs = [o["train"] for o in outs]
    assert runs[0]["history"] == runs[1]["history"]
    assert np.isfinite(runs[0]["history"][0]["val_loss"])
    _ranks_equal(runs, ("params", "buffers"))
    assert any(f.startswith(family) for f in runs[0]["written"])
    assert runs[1]["written"] == []


def _dcse_ratios(got, want, norm, exact):
    from sincformer_tpu_torch.compat.from_jax import (_dcse_buffers,
                                                      _dcse_named)
    from tests.test_torch_dcse_train import _variables
    loss, whole, whole_norm, grads, new_ms, new_params = want
    f32_norm, f64_norm = exact
    norm_bar = NORM_TOL + 2 * abs(f32_norm - f64_norm) / f64_norm
    clip = lambda n: min(1.0, GRAD_CLIP / n)  # noqa: E731
    want_grads = {k: np.asarray(g, np.float64)
                  for k, g in _dcse_named(grads).items()}
    zero = {k for k in want_grads
            if k.endswith("depthwise.bias") and norm == "batch"}
    for k in zero:          # gradient 0 in exact arithmetic (module doc)
        floor = GRAD_FLOOR * max(float(np.max(np.abs(g)))
                                 for g in want_grads.values())
        assert float(got["grads"][k].abs().max()) <= 1e-2 * floor, k
    ratios = {
        "whole": abs(got["whole"] - whole) / (LOSS_TOL * abs(whole)),
        "whole_norm": abs(got["whole_norm"] - whole_norm)
        / (norm_bar * whole_norm),
        "clip": abs(clip(got["whole_norm"]) - clip(whole_norm))
        / (norm_bar * clip(whole_norm)),
        "loss": abs(got["loss"] - loss) / (LOSS_TOL * abs(loss)),
        "grads": _grad_ratio(got["grads"], {k: g for k, g in
                                            want_grads.items()
                                            if k not in zero}),
        "params": _param_ratio(
            got["params"], {k: np.asarray(w, np.float64) for k, w in
                            _dcse_named(new_params).items()},
            _dcse_named(_variables(norm)["params"]), want_grads, zero),
    }
    if norm == "batch":
        ratios["batch_stats"] = _state_ratio(
            got["buffers"], _dcse_buffers(new_ms["batch_stats"]))
    return ratios


def test_dcse_step_over_two_ranks(ahead):
    """Two ranks give JAX's DCSE step on the whole padded batch, for
    "batch" and "layer", at the DCSE training bars, the whole loss's
    gradient norm and clip factor and the BatchNorm statistics included
    and equal on both ranks; a NaN in one rank's rows zeroes the step on
    both; a per-rank BatchNorm
    misses the bars. An epoch of ``train`` on the two ranks keeps them
    bit-equal, and rank 0 alone writes."""
    exact = {norm: _exact_norm(norm) for norm in ("batch", "layer")}
    outs = ahead.ranks["dcse"].result()
    _check_training_loop(outs, "best_conformer")
    # one NaN in rank 1's rows: the averaged loss and gradients carry it to
    # rank 0, so both ranks' guards zero the step
    assert [o["nan"]["nan_count"] for o in outs] == [1, 1]
    _ranks_equal([o["nan"] for o in outs], ("params",))
    for norm in ("batch", "layer"):
        _ranks_equal([o[norm] for o in outs], ("params", "buffers"))
        assert outs[0][norm]["whole_norm"] == outs[1][norm]["whole_norm"]
        ratios = _dcse_ratios(outs[0][norm], ahead(_jax_dcse, norm), norm,
                              exact[norm])
        print(f"{norm}: {ratios}")
        assert max(ratios.values()) <= 1.0, (norm, ratios)
    fault = _dcse_ratios(outs[0]["fault"], ahead(_jax_dcse, "batch"),
                         "batch", exact["batch"])
    print(f"per-rank BatchNorm: {fault}")
    assert fault["batch_stats"] > 1.0, fault


def test_evaluate_distributed_over_two_processes(ahead):
    """``evaluate --distributed`` through the CLI in two processes that
    join their group from torchrun's variables: each prints the merged
    tables, rank 0 alone writes ``--json-out``, and the merged grid equals
    the single-process ``evaluate_grid`` cell by cell, value for value."""
    from sincformer_tpu_torch.evaluation.grid import evaluate_grid
    from tests.test_torch_parallel import _grid_inputs
    cleans, noises = _grid_inputs(2)
    want = evaluate_grid(cleans, noises, {"identity": worker.Identity()},
                         device="cpu", verbose=False)
    outs = ahead.ranks["evaluate"].result()
    tmp_path = ahead.out["evaluate"]
    assert [o["code"] for o in outs] == [0, 0]
    assert [o["primary"] for o in outs] == [True, False]
    for r, o in enumerate(outs):
        assert f"process {r} of 2" in o["stdout"]
        assert "GRAND SUMMARY" in o["stdout"]
    assert os.path.exists(os.path.join(tmp_path, "grid_0.json"))
    assert not os.path.exists(os.path.join(tmp_path, "grid_1.json"))
    with open(os.path.join(tmp_path, "grid_0.json")) as f:
        got = json.load(f)["results"]
    for noise, methods in want.items():
        for method, cells in methods.items():
            assert set(got[noise][method]) == {str(s) for s in cells}
            for snr, vals in cells.items():
                assert got[noise][method][str(snr)] == vals, (method, snr)


def test_flagship_step_over_two_ranks(ahead):
    """Two ranks with two rows each give JAX's adversarial step on the
    four at the training and adversarial bars, with bit-equal parameters,
    buffers and discriminators on both ranks; the per-rank statistics miss
    the bars. An epoch of ``train`` on the two ranks keeps them bit-equal,
    and rank 0 alone writes."""
    outs = ahead.ranks["flagship"].result()
    _check_training_loop(outs, "best_sincformer")
    dp = [o["dp"] for o in outs]
    _ranks_equal(dp, ("params", "buffers", "disc_params"))
    assert dp[0]["loss"] == dp[1]["loss"] and dp[0]["nan_count"] == 0
    want = ahead(_jax_flagship)
    ratios = _flagship_ratios(dp[0], want)
    assert max(ratios.values()) <= 1.0, ratios
    fault = _flagship_ratios(outs[0]["fault"], want)
    print(f"per-rank MAA/memory statistics: {fault}")
    assert fault["model_state"] > 1.0, fault
