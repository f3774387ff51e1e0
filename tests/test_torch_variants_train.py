"""Training the flagship's variants in the port: one training step of the
``reference`` + ``ssm`` combination (the stride-2 cascade PerceptionAgent
and the bidirectional LRU CPEA) against the JAX package's step at narrow
width on the CPU in float32, the AdamW step after it, and the ``train``
verb with ``--pa reference --cpea ssm`` in-process, whose checkpoint serves,
resumes as its variant and is found by the evaluation grid.

The JAX step is ``SincformerPipeline._loss`` under one jitted
``value_and_grad`` (a module-level cache), dropout 0 and softmax routing, so
nothing is drawn, with the multi-resolution STFT term zeroed in both
packages: its log-magnitude L1 makes the float32 gradient rounding-dominated
(ROADMAP.md Queue 3). Bars: the loss 1e-5 relative; each gradient leaf 1e-4
of its scale, floored at 1e-4 of the step's largest; ``model_state`` 1e-6;
optax's AdamW on JAX's gradients 1e-5 of each parameter's scale; the
parameters after each package's own step 1e-5 of their scale, but where
the gradient lies within its bar of zero: there (at most 1 % of the
elements off the 1e-5 bar) within twice the step, as
tests/test_torch_train_step.py holds them. (Elements whose gradient is 0
in both, as behind the MAA's inactive ReLUs, step alike and are not
counted.) The conv
biases that a GroupNorm of one channel per group removes (the narrow
cascade's first two blocks) have a true gradient of 0: both packages'
rounding there is held below 1e-4 of the largest gradient, and AdamW's
step there, whose sign is rounding's, counts among the elements held within
twice the step (the model's largest, about the learning rate there)."""

import functools
import json
import os
import tempfile
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from tests._torch_parity import NARROW, cancelled_biases, narrow_model, wave

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
GRAD_FLOOR = 1e-4
STATE_TOL = 1e-6
PARAM_TOL = 1e-5
LR, EPOCHS, STEPS = 5e-4, 3, 2
VARIANT = dict(pa_impl="reference", cpea_impl="ssm")
SCALARS = (1.0, 1.0, 1.0)      # use_perceptual, use_vq, use_mask_mse


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _named(tree):
    from sincformer_tpu_torch.compat.from_jax import _named_params
    return _named_params(jax.tree.map(np.asarray, tree), 2)


@functools.lru_cache(maxsize=None)
def _zero_gradients():
    _, _, tm = narrow_model(**VARIANT)
    zero = cancelled_biases(tm)
    assert zero
    return frozenset(zero)


def _batch():
    return wave(60), (wave(61) * 0.5).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_step():
    """JAX's loss without the MR-STFT term, its gradients and model_state
    after the training forward, and the parameters after optax's AdamW
    with the NaN guard, from the narrow variant's seeded state."""
    from jax.flatten_util import ravel_pytree

    import sincformer_tpu.train.agent_trainer as jax_trainer
    from sincformer_tpu.train.state import guard_nan_update, make_adamw
    model, v, _ = narrow_model(**VARIANT)
    pipe = jax_trainer.SincformerPipeline(model=model.clone(routing="softmax"),
                                          model_dir=tempfile.mkdtemp())

    def loss(params, model_state, noisy, clean):
        # traced under the patch: the jitted program has no MR-STFT term
        with mock.patch.object(jax_trainer, "multi_resolution_stft_loss",
                               lambda pred, target: jnp.sum(pred) * 0.0):
            return pipe._loss(params, model_state, noisy, clean,
                              jax.random.PRNGKey(0), True, *SCALARS[:2],
                              use_mask_mse=SCALARS[2])

    params = jax.tree.map(jnp.asarray, v["params"])
    model_state = {k: jax.tree.map(jnp.asarray, x) for k, x in v.items()
                   if k != "params"}
    noisy, clean = _batch()
    (value, aux), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params, model_state, jnp.asarray(noisy), jnp.asarray(clean))
    tx = make_adamw(LR, EPOCHS, STEPS)
    flat, unravel = ravel_pytree(params)

    @jax.jit
    def update(flat_params, flat_grads, loss):
        g, _ = guard_nan_update(flat_grads, loss)
        updates, opt = tx.update(g, tx.init(flat_params), flat_params)
        return optax.apply_updates(flat_params, updates), opt
    new, opt = update(flat, ravel_pytree(grads)[0], value)
    adam = opt[1][0]                     # make_adamw's ScaleByAdamState
    moments = {"count": np.asarray(adam.count),
               "mu": jax.tree.map(np.asarray, unravel(adam.mu)),
               "nu": jax.tree.map(np.asarray, unravel(adam.nu))}
    return (float(value), _named(grads), aux["model_state"],
            _named(unravel(new)), _named(params), moments)


def _port():
    from sincformer_tpu_torch import SincformerMetacog
    from sincformer_tpu_torch.compat.from_jax import \
        load_train_state_from_jax
    from sincformer_tpu_torch.train.agent_trainer import SincformerTrainer
    _, v, _ = narrow_model(**VARIANT)
    named, buffers, _, config = load_train_state_from_jax(
        v["params"], {k: x for k, x in v.items() if k != "params"},
        num_heads=NARROW["num_heads"],
        sinc_kernel_size=NARROW["sinc_kernel_size"], dropout=0.0,
        routing="softmax")
    assert (config.pa_impl, config.cpea_impl) == ("reference", "ssm")
    pipe = SincformerTrainer(SincformerMetacog(config), device="cpu")
    pipe.load_state(named, buffers)
    pipe.init_state(EPOCHS, STEPS, init_params=False)
    return pipe


@functools.lru_cache(maxsize=None)
def _port_step():
    """The port's loss (the same term zeroed), gradients, buffers after the
    forward, and parameters after its NaN guard and AdamW."""
    import sincformer_tpu_torch.train.agent_trainer as port_trainer
    from sincformer_tpu_torch.train.state import guard_nan_update
    pipe = _port()
    noisy, clean = (torch.from_numpy(x) for x in _batch())
    with mock.patch.object(port_trainer, "multi_resolution_stft_loss",
                           lambda pred, target: pred.sum() * 0.0):
        loss, _, grads = pipe.loss_and_grads(noisy, clean, *SCALARS[:2],
                                             None, SCALARS[2])
    params = pipe.params()
    guarded, _ = guard_nan_update(grads, loss, params.values())
    pipe.tx.update(params, guarded, pipe.opt_state)
    return (float(loss), dict(zip(params, grads)),
            {k: b.clone() for k, b in pipe.model.named_buffers()},
            {k: p.detach().clone() for k, p in params.items()})


def test_step_loss_gradients_and_state_match_jax():
    """The training forward through the cascade and the BiLRU (two MSA
    passes, the memory write, the MAA statistics) and its backward: the
    loss, every gradient leaf in the port's names, and every buffer."""
    from sincformer_tpu_torch.compat.from_jax import load_from_jax
    want_loss, want_grads, want_state, _, _, _ = _jax_step()
    loss, grads, buffers, _ = _port_step()
    assert abs(loss - want_loss) <= LOSS_TOL * abs(want_loss)
    assert set(grads) == set(want_grads)
    largest = max(float(np.max(np.abs(g))) for g in want_grads.values())
    floor = GRAD_FLOOR * largest
    bad = []
    for k in _zero_gradients():
        assert max(float(np.max(np.abs(_np(grads[k])))),
                   float(np.max(np.abs(want_grads[k])))) <= floor, k
    for k, w in want_grads.items():
        if k in _zero_gradients():
            continue
        g = grads[k] if grads[k] is not None else torch.zeros(w.shape)
        scale = max(float(np.max(np.abs(w))), floor)
        if float(np.max(np.abs(_np(g) - w))) > GRAD_TOL * scale:
            bad.append(k)
    assert not bad, bad
    _, v, _ = narrow_model(**VARIANT)
    _, want_buffers, _ = load_from_jax(
        {"params": v["params"], **jax.tree.map(np.asarray, want_state)},
        num_heads=NARROW["num_heads"],
        sinc_kernel_size=NARROW["sinc_kernel_size"])
    for k, w in want_buffers.items():
        w = _np(w)
        assert np.allclose(_np(buffers[k]), w, rtol=0, atol=STATE_TOL * max(
            1.0, float(np.max(np.abs(w))))), k


def test_adamw_step_matches_optax():
    """The AdamW step after it: the port's optimizer given JAX's gradients
    lands on optax's parameters and moments (1e-5 of each leaf's scale,
    everywhere; optax's moments carried over by
    ``load_train_state_from_jax``, the BiLRU's and the cascade's leaves
    included); the port's own step lands there too, but where the gradient
    is within its bar of zero, where the step's sign is rounding's."""
    import copy

    from sincformer_tpu_torch.compat.from_jax import \
        load_train_state_from_jax
    from sincformer_tpu_torch.train.state import guard_nan_update
    want_loss, want_grads, _, want_params, before, moments = _jax_step()
    pipe = _port()
    named = {k: torch.from_numpy(np.array(p)) for k, p in before.items()}
    opt = copy.deepcopy(pipe.opt_state)
    guarded, _ = guard_nan_update(
        [torch.from_numpy(np.array(want_grads[k])) for k in named],
        torch.tensor(want_loss), named.values())
    pipe.tx.update(named, guarded, opt)
    for k, w in want_params.items():
        assert np.max(np.abs(_np(named[k]) - w)) <= PARAM_TOL * np.max(
            np.abs(w)), k
    _, v, _ = narrow_model(**VARIANT)
    _, _, want_opt, _ = load_train_state_from_jax(
        v["params"], {k: x for k, x in v.items() if k != "params"}, moments,
        num_heads=NARROW["num_heads"],
        sinc_kernel_size=NARROW["sinc_kernel_size"])
    assert want_opt["count"] == opt["count"] == 1
    for m in ("mu", "nu"):
        assert set(want_opt[m]) == set(opt[m]) == set(named)
        for k, w in want_opt[m].items():
            assert float((opt[m][k] - w).abs().max()) <= PARAM_TOL * float(
                w.abs().max()), (m, k)

    _, _, _, params = _port_step()
    floor = GRAD_FLOOR * max(float(np.max(np.abs(g)))
                             for g in want_grads.values())
    # AdamW's first step is about lr x sign(g) past eps: the largest step
    # of the model bounds where a sign set by rounding may take it
    lr_step = max(float(np.max(np.abs(w - before[k])))
                  for k, w in want_params.items())
    loose = total = 0
    for k, w in want_params.items():
        g = np.abs(want_grads[k])
        scale = float(np.max(np.abs(w)))
        settled = g > GRAD_TOL * max(float(np.max(g)), floor)
        step = float(np.max(np.abs(w - before[k])))
        if k in _zero_gradients():
            settled, step = np.zeros_like(settled), lr_step
        diff = np.abs(_np(params[k]).astype(np.float64) - w)
        off = diff > PARAM_TOL * scale
        assert not np.any(off & settled), k
        assert np.all(diff[off] <= 2 * step + PARAM_TOL * scale), k
        loose += int(np.sum(off))
        total += w.size
    assert loose <= 0.01 * total, (loose, total)


def test_train_verb_reference_ssm_in_process(tmp_path, monkeypatch, capsys):
    """``train --pipeline agents --pa reference --cpea ssm --synthetic 6
    --epochs 2 --device cpu`` at narrow width with 0.5 s utterances; then
    ``--resume`` without the flags for a third epoch, which carries on as
    the checkpoint's variant. The checkpoint serves as the variant it is,
    and ``discover_pipelines`` finds and loads it, and the grid scores it
    (two 1 s utterances at 5 dB: STOI and SSNR finite)."""
    from sincformer_tpu_torch import SincformerPipeline, cli
    from sincformer_tpu_torch.evaluation.grid import (discover_pipelines,
                                                      evaluate_grid)
    from sincformer_tpu_torch.train import agent_trainer
    factory = agent_trainer.default_metacog
    monkeypatch.setattr(agent_trainer, "default_metacog",
                        lambda **kw: factory(**{**NARROW, **kw}))
    monkeypatch.setenv("SINCFORMER_MAX_WAVE_SECONDS", "0.5")
    monkeypatch.setenv("SINCFORMER_MODEL_DIR", str(tmp_path))
    monkeypatch.setenv("SINCFORMER_CKPT_PREF", "final")
    log = str(tmp_path / "log.jsonl")
    argv = ["train", "--pipeline", "agents", "--synthetic", "6", "--device",
            "cpu", "--log-jsonl", log]
    assert cli.main(argv + ["--epochs", "2", "--pa", "reference",
                            "--cpea", "ssm"]) == 0
    assert "Variant: pa reference, cpea ssm" in capsys.readouterr().out
    assert cli.main(argv + ["--epochs", "3", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "Variant: pa mxu, cpea lstm" in out        # the flags' default
    assert "Resuming from" in out and "Epoch   3/3" in out
    records = [json.loads(line) for line in open(log)]
    assert [r["epoch"] for r in records] == [0, 1, 2]
    assert all(np.isfinite(r["train_loss"]) for r in records)

    served = SincformerPipeline(device="cpu")
    assert served.load_model().endswith(os.path.join("sincformer_final",
                                                     "step_3"))
    c = served.model.config
    assert (c.pa_impl, c.cpea_impl, c.d_model) == ("reference", "ssm",
                                                   NARROW["d_model"])
    assert np.all(np.isfinite(served.enhance_signal(wave(62, (3993,)))))
    found = discover_pipelines(str(tmp_path), names=["sincformer"],
                               device="cpu")
    assert found["sincformer"].model.config == c
    clean = [wave(63, (8000,)) * 0.5, wave(64, (8000,)) * 0.5]
    noise = {"white": wave(65, (8000 * 3,)) * 0.1}
    grid = evaluate_grid(clean, noise, found, [5], ("stoi", "ssnr"),
                         verbose=False, device="cpu")
    cells = grid["white"]["sincformer"][5]
    assert set(cells) == {"stoi", "ssnr"}
    assert all(len(v) == 2 and np.all(np.isfinite(v))
               for v in cells.values())
