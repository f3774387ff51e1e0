"""DCSE training in the port against the JAX package at narrow width
(``tests/_torch_parity.NARROW_DCSE``: d_model 32, 2 blocks, 2 heads, ff 64,
kernel 7, 129 bins), on the CPU in float32: the conv module's BatchNorm and
GroupNorm, the ComplexConformer, the loss and eval step, one training step
and a second from JAX's carried state with ``conv_norm`` "layer" and
"batch", the NaN guard, dropout and the training init.

The JAX step is ``DCSEPipeline._loss_fn`` under one jitted
``value_and_grad`` per norm (a module-level cache), dropout 0, and optax's
``make_adamw`` on the parameters raveled into one vector. Bars (those of
``tests/test_torch_train_step.py``):
the loss 1e-5 relative; each gradient leaf 1e-4 of its largest magnitude,
floored at 1e-4 of the step's largest; the parameters after AdamW 1e-5 of
their scale where the gradient passes the gradient bar (elsewhere AdamW's
step of about lr may take rounding's sign: within the step there, at most
1 % of the elements); ``batch_stats`` 1e-6.

The gradients and the step are held on the loss without the
multi-resolution STFT term, patched out of both packages, as
``chip_smoke.py`` holds its gradient bar: that term's log-magnitude L1 is
ill-conditioned in float32 wherever a bin of the enhanced STFT is near zero
(ROADMAP.md Queue 3). On these batches one 256-point bin of magnitude 1e-5
puts both packages' whole-loss gradients about 1e-2 of a leaf's scale from
the same step in float64, the port's no further than twice JAX's. The whole
loss is held at 1e-5. Its global gradient norm and AdamW's clip factor
are held within 1e-4 relative of JAX's plus twice the port's own float32
distance from the same norm in float64, which measures that conditioning
(on the first step's batch: "batch" 8.6e-6 from JAX and 1.1e-6 from
float64, "layer" 7.4e-3 from JAX and 1.5e-2 from float64). The
depthwise convolution's bias in front of a training-mode BatchNorm has a
gradient of zero in exact arithmetic (the batch mean takes it out); both
packages must leave it below 1e-6 of the step's largest gradient. The eval
step's batch holds a row padded with zeros."""

import functools
import tempfile
import threading
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests._torch_parity import NARROW_DCSE, _fill, max_abs, narrow_dcse

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
GRAD_FLOOR = 1e-4
PARAM_TOL = 1e-5
STATS_TOL = 1e-6
NORM_TOL = 1e-4
OUT_TOL = 1e-5
LR, EPOCHS, STEPS = 5e-4, 3, 2
# held while a program of _jax_fns traces: the trace patches the JAX
# module's MR-STFT loss, which a trace on another thread must not see
_TRACE_LOCK = threading.Lock()


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jax_model(norm: str, sizes: tuple = (), remat: bool = False):
    """The narrow JAX model; ``sizes`` ((field, value) pairs) override
    NARROW_DCSE's."""
    from sincformer_tpu.models.dcse import SpeechEnhancer
    return SpeechEnhancer(n_freq=129, dropout=0.0, attn_impl="speech",
                          conv_norm=norm, remat=remat,
                          **{**NARROW_DCSE, **dict(sizes)})


@functools.lru_cache(maxsize=None)
def _variables(norm: str, sizes: tuple = ()):
    """Seeded numpy variables of the narrow model (at ``sizes``): every
    bias and norm offset non-zero, and for "batch" moved running
    statistics."""
    if norm == "layer" and not sizes:
        return narrow_dcse()
    shapes = jax.eval_shape(lambda: _jax_model(norm, sizes).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 11, 129)),
        jnp.zeros((1, 11, 129))))
    rng = np.random.default_rng(11)
    params = jax.tree_util.tree_map_with_path(
        lambda p, s: _fill(p, s, rng).astype(np.float32), shapes["params"])
    if norm != "batch":
        return {"params": params}
    stats = jax.tree_util.tree_map_with_path(
        lambda p, s: (rng.uniform(0.5, 1.5, s.shape) if p[-1].key == "var"
                      else 0.1 * rng.standard_normal(s.shape)
                      ).astype(np.float32), shapes["batch_stats"])
    return {"params": params, "batch_stats": stats}


@functools.lru_cache(maxsize=None)
def _jax_fns(norm: str, sizes: tuple = (), remat: bool = False):
    """(jitted value_and_grad of _loss_fn(train=True) without the MR-STFT
    term, with the whole loss and its global gradient norm; jitted eval
    step; optax init and update with the NaN guard), for the model of
    :func:`_jax_model`."""
    from jax.flatten_util import ravel_pytree

    from sincformer_tpu.train.dcse_trainer import DCSEPipeline
    from sincformer_tpu.train.state import guard_nan_update, make_adamw
    import sincformer_tpu.train.dcse_trainer as jax_dcse
    pipe = DCSEPipeline(model=_jax_model(norm, sizes, remat),
                        model_dir=tempfile.mkdtemp())

    def loss(params, model_state, noisy, clean):
        return pipe._loss_fn(params, model_state, noisy, clean,
                             jax.random.PRNGKey(0), True)

    def loss_without_mrstft(*args):
        # traced under the patch: the jitted program has no MR-STFT term
        with mock.patch.object(jax_dcse, "multi_resolution_stft_loss",
                               lambda pred, target: jnp.sum(pred) * 0.0):
            return loss(*args)

    def steps(params, model_state, noisy, clean):
        """The loss without the term and its gradients, and the whole loss
        and its global gradient norm: one forward, and one backward for
        both cotangents (the term reads the parameters only through the
        enhanced waveform). Runs only while tracing, under
        _TRACE_LOCK."""
        with _TRACE_LOCK:
            return _steps(params, model_state, noisy, clean)

    def _steps(params, model_state, noisy, clean):
        def outputs(p):
            total, (sisnr, new_ms, enh) = loss_without_mrstft(
                p, model_state, noisy, clean)
            return (total, enh), (sisnr, new_ms)
        (total, enh), pull, (sisnr, new_ms) = jax.vjp(outputs, params,
                                                      has_aux=True)
        term, g_enh = jax.value_and_grad(jax_dcse.multi_resolution_stft_loss)(
            enh, clean)
        (both,) = jax.vmap(pull)((jnp.ones(2, total.dtype),
                                  jnp.stack([jnp.zeros_like(g_enh), g_enh])))
        return (((total, (sisnr, new_ms, enh)),
                 jax.tree.map(lambda g: g[0], both)),
                (total + term,
                 optax.global_norm(jax.tree.map(lambda g: g[1], both))))
    value_and_grad = jax.jit(steps)
    tx = make_adamw(LR, EPOCHS, STEPS)

    @jax.jit
    def flat_update(flat_params, flat_grads, loss, opt_state):
        grads, bad = guard_nan_update(flat_grads, loss)
        updates, opt_state = tx.update(grads, opt_state, flat_params)
        return optax.apply_updates(flat_params, updates), opt_state, bad

    def update(params, grads, loss, opt_state):
        flat, unravel = ravel_pytree(params)
        new, opt_state, bad = flat_update(flat, ravel_pytree(grads)[0], loss,
                                          opt_state)
        return unravel(new), opt_state, bad

    def init(params):
        return tx.init(ravel_pytree(params)[0])
    return value_and_grad, pipe._make_eval_step(), init, update


def _without_mrstft():
    """The port's DCSE loss with the MR-STFT term zeroed, as above."""
    import sincformer_tpu_torch.train.dcse_trainer as port_dcse
    return mock.patch.object(port_dcse, "multi_resolution_stft_loss",
                             lambda pred, target: pred.sum() * 0.0)


def _unravel_opt(opt_state, params):
    from jax.flatten_util import ravel_pytree
    unravel = ravel_pytree(params)[1]
    adam = opt_state[1][0]
    return {"count": np.asarray(adam.count),
            "mu": jax.tree.map(np.asarray, unravel(adam.mu)),
            "nu": jax.tree.map(np.asarray, unravel(adam.nu))}


def _port(params, batch_stats=None, opt_state=None, **config):
    """The port's DCSETrainer on the CPU from a JAX train state; ``config``
    sets the fields the tree does not record (``remat``)."""
    from sincformer_tpu_torch.compat.from_jax import \
        load_dcse_train_state_from_jax
    from sincformer_tpu_torch.models.dcse import SpeechEnhancer
    from sincformer_tpu_torch.train.dcse_trainer import DCSETrainer
    named, buffers, opt, config = load_dcse_train_state_from_jax(
        jax.tree.map(np.asarray, params),
        None if batch_stats is None else jax.tree.map(np.asarray,
                                                      batch_stats),
        opt_state, num_heads=NARROW_DCSE["num_heads"], dropout=0.0,
        **config)
    pipe = DCSETrainer(SpeechEnhancer(config), device="cpu",
                       model_dir=tempfile.mkdtemp())
    pipe.load_state(named, buffers)
    pipe.init_state(EPOCHS, STEPS, init_params=False)
    if opt is not None:
        pipe.opt_state = opt
    return pipe


def _batch(seed, nan=False, padded=False):
    """(2, 4000) noisy and clean; ``padded``: row 1 is 3,000 samples
    padded with zeros."""
    rng = np.random.default_rng(seed)
    clean = (rng.standard_normal((2, 4000)) * 0.2).astype(np.float32)
    noisy = (clean + rng.standard_normal((2, 4000)) * 0.1).astype(np.float32)
    if padded:
        clean[1, 3000:] = 0.0
        noisy[1, 3000:] = 0.0
    if nan:
        noisy[0, 100] = np.nan
    return noisy, clean


def _named(tree):
    from sincformer_tpu_torch.compat.from_jax import _dcse_named
    return _dcse_named(jax.tree.map(np.asarray, tree))


def _global_norm(grads) -> float:
    return float(torch.sqrt(sum(torch.sum(g.double() ** 2)
                                for g in grads if g is not None)))


def _leaf_close(got, want, tol, floor=0.0) -> bool:
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.max(np.abs(want), initial=0.0)), floor)
    return float(np.max(np.abs(got - want), initial=0.0)) <= tol * scale


def _check_step(norm, pipe, params, model_state, opt_state, noisy, clean,
                remat: bool = False):
    """One step in both packages from the same state (``remat``: both
    models recompute their blocks); returns JAX's new (params,
    model_state, opt_state)."""
    from sincformer_tpu_torch.compat.from_jax import _dcse_buffers
    from sincformer_tpu_torch.train.state import guard_nan_update
    value_and_grad, _, _, update = (_jax_fns(norm, (), True) if remat
                                    else _jax_fns(norm))
    ((loss, (_, new_ms, _)), grads), whole = value_and_grad(
        params, model_state, jnp.asarray(noisy), jnp.asarray(clean))
    want_whole, want_norm = (float(x) for x in whole)
    want_clip = min(1.0, 5.0 / want_norm)
    saved = {k: b.clone() for k, b in pipe.model.named_buffers()}
    # the training forward with every term, statistics restored
    got_whole, _, got = pipe.loss_and_grads(torch.from_numpy(noisy),
                                            torch.from_numpy(clean))
    for k, b in pipe.model.named_buffers():
        b.copy_(saved[k])
    assert abs(float(got_whole) - want_whole) <= LOSS_TOL * abs(want_whole)
    got_norm = _global_norm(got)
    # the port in float64 measures the batch's float32 conditioning
    exact = _port(params, (model_state or {}).get("batch_stats"))
    exact.model.to(torch.float64)
    exact_norm = _global_norm(exact.loss_and_grads(
        torch.from_numpy(noisy).double(), torch.from_numpy(clean).double())[2])
    bar = NORM_TOL + 2 * abs(got_norm - exact_norm) / exact_norm
    assert abs(got_norm - want_norm) <= bar * want_norm, (got_norm, want_norm,
                                                          exact_norm)
    assert abs(min(1.0, 5.0 / got_norm) - want_clip) <= bar * want_clip
    new_params, new_opt, _ = update(params, grads, loss, opt_state)

    with _without_mrstft():
        got_loss, _, got = pipe.loss_and_grads(torch.from_numpy(noisy),
                                               torch.from_numpy(clean))
    names = pipe.params()
    guarded, bad = guard_nan_update(got, got_loss, names.values())
    pipe.tx.update(names, guarded, pipe.opt_state)
    pipe.nan_count += bad.to(torch.int32)
    pipe.step += 1

    assert abs(float(got_loss) - float(loss)) <= LOSS_TOL * abs(float(loss))
    want_grads = _named(grads)
    got_grads = dict(zip(names, got))
    assert set(want_grads) == set(got_grads)
    floor = GRAD_FLOOR * max(float(np.max(np.abs(g)))
                             for g in want_grads.values())
    zero = {k for k in want_grads
            if k.endswith("depthwise.bias") and norm == "batch"}
    bad = [k for k, g in want_grads.items() if k not in zero
           and not _leaf_close(got_grads[k], g, GRAD_TOL, floor)]
    assert not bad, bad
    for k in zero:
        assert max(float(np.abs(want_grads[k]).max()),
                   float(got_grads[k].abs().max())) <= 1e-2 * floor, k
    if norm == "batch":
        want_stats = _dcse_buffers(jax.tree.map(np.asarray,
                                                new_ms["batch_stats"]))
        got_stats = dict(pipe.model.named_buffers())
        assert set(want_stats) == set(got_stats)
        for k, w in want_stats.items():
            assert max_abs(got_stats[k], w) <= STATS_TOL * max(
                1.0, float(np.abs(w).max())), k
    want_params, before = _named(new_params), _named(params)
    loose = total = 0
    for k, w in want_params.items():
        g = np.abs(want_grads[k]) * (k not in zero)
        scale = float(np.max(np.abs(w)))
        settled = g > GRAD_TOL * max(float(np.max(g)), floor)
        diff = np.abs(_np(names[k]).astype(np.float64) - w)
        assert np.all(diff[settled] <= PARAM_TOL * scale), k
        step = float(np.max(np.abs(w - before[k])))
        assert np.all(diff[~settled] <= 2 * step + PARAM_TOL * scale), k
        loose += int(np.sum(~settled))
        total += w.size
    assert loose <= 0.01 * total, (loose, total)
    assert int(pipe.opt_state["count"]) == int(
        np.asarray(new_opt[1][0].count))
    return new_params, new_ms, new_opt


@pytest.mark.parametrize("norm", ["layer", "batch"])
def test_two_adamw_steps_and_the_nan_guard(norm):
    """Step 1 from the shared start; step 2 from JAX's carried state (the
    parameters, batch_stats and AdamW moments bridged); then a batch with a
    NaN: every gradient is zeroed, the NaN count grows, the step count
    advances, and the parameters move as optax moves them."""
    variables = _variables(norm)
    params = jax.tree.map(jnp.asarray, variables["params"])
    ms = ({"batch_stats": jax.tree.map(jnp.asarray,
                                       variables["batch_stats"])}
          if norm == "batch" else None)
    _, _, init, update = _jax_fns(norm)
    pipe = _port(params, (ms or {}).get("batch_stats"))
    p1, s1, o1 = _check_step(norm, pipe, params, ms, init(params),
                             *_batch(5))
    s1 = s1 if norm == "batch" else None
    pipe = _port(p1, (s1 or {}).get("batch_stats"), _unravel_opt(o1, p1))
    pipe.step = 1
    p2, s2, o2 = _check_step(norm, pipe, p1, s1, o1, *_batch(7))
    assert pipe.step == 2 and int(pipe.nan_count) == 0

    value_and_grad = _jax_fns(norm)[0]
    noisy, clean = _batch(9, nan=True)
    s2 = s2 if norm == "batch" else None
    ((loss, _), grads), _ = value_and_grad(p2, s2, jnp.asarray(noisy),
                                           jnp.asarray(clean))
    p3, o3, bad = update(p2, grads, loss, o2)
    assert bool(bad)
    pipe = _port(p2, (s2 or {}).get("batch_stats"), _unravel_opt(o2, p2))
    with _without_mrstft():
        loss_port, _ = pipe.train_step(torch.from_numpy(noisy),
                                       torch.from_numpy(clean))
    assert not torch.isfinite(loss_port) and int(pipe.nan_count) == 1
    assert pipe.opt_state["count"] == int(np.asarray(o3[1][0].count)) == 3
    got = pipe.params()
    bad = [k for k, w in _named(p3).items()
           if not _leaf_close(got[k], w, PARAM_TOL)]
    assert not bad, bad


def test_config_recipe_reaches_adamw():
    """``DCSEConfig``'s betas, weight decay and clip reach the trainer's
    AdamW as the JAX package's ``make_adamw`` takes them: two steps with
    values other than the defaults (the second clipped) equal optax's
    within 1e-5 of the parameters' scale."""
    import dataclasses

    from sincformer_tpu.train.state import make_adamw as jax_make_adamw
    from sincformer_tpu_torch.config import DCSEConfig
    from sincformer_tpu_torch.models.dcse import SpeechEnhancer
    from sincformer_tpu_torch.train.dcse_trainer import DCSETrainer
    recipe = dict(betas=(0.8, 0.95), weight_decay=0.1, grad_clip=0.5)
    cfg = dataclasses.replace(DCSEConfig(n_freq=129, **{
        k: v for k, v in NARROW_DCSE.items() if k != "d_ff"}),
        ff_dim=NARROW_DCSE["d_ff"], **recipe)
    pipe = DCSETrainer(SpeechEnhancer(cfg), device="cpu",
                       model_dir=tempfile.mkdtemp())
    pipe.init_state(EPOCHS, STEPS)
    rng = np.random.default_rng(21)
    params = {"a": rng.standard_normal((6, 5)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32)}
    tx = jax_make_adamw(LR, EPOCHS, STEPS, **recipe)
    update = jax.jit(tx.update)
    want = jax.tree.map(jnp.asarray, params)
    got = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state, opt = pipe.tx.init(got), tx.init(want)
    for scale in (0.1, 10.0):     # a norm below the clip, then above
        grads = {k: (scale * rng.standard_normal(v.shape)).astype(
            np.float32) for k, v in params.items()}
        updates, opt = update(jax.tree.map(jnp.asarray, grads), opt, want)
        want = optax.apply_updates(want, updates)
        pipe.tx.update(got, [torch.from_numpy(grads[k]) for k in got], state)
    for k, w in want.items():
        assert _leaf_close(got[k], w, PARAM_TOL), k


def test_eval_step_matches_jax():
    """The deterministic loss (``_loss_fn(train=False)``, BatchNorm on its
    running statistics) and the eval step's log-gain sum: 1e-5 relative;
    the count of valid utterances equal."""
    variables = _variables("batch")
    eval_step = _jax_fns("batch")[1]
    noisy, clean = _batch(13, padded=True)
    lengths = np.array([4000, 3000], np.int32)
    want = eval_step(jax.tree.map(jnp.asarray, variables["params"]),
                     {"batch_stats": variables["batch_stats"]},
                     jnp.asarray(noisy), jnp.asarray(clean),
                     jnp.asarray(lengths))
    pipe = _port(variables["params"], variables["batch_stats"])
    stats = {k: v.clone() for k, v in pipe.model.named_buffers()}
    got = pipe.eval_step(torch.from_numpy(noisy), torch.from_numpy(clean),
                         torch.from_numpy(lengths))
    for g, w in zip(got[:3], want[:3]):
        assert abs(float(g) - float(w)) <= LOSS_TOL * abs(float(w))
    assert int(got[3]) == int(want[3]) == 2
    for k, v in pipe.model.named_buffers():       # eval leaves them
        assert torch.equal(v, stats[k])


@pytest.mark.parametrize("norm", ["batch", "group"])
@pytest.mark.parametrize("train", [False, True])
def test_conv_module_norms_match_flax(norm, train):
    """``ConvolutionModule(norm=...)`` against flax on a padded batch: the
    output within 1e-5 of its scale; in train mode BatchNorm normalises by
    the batch and its running statistics after 1 and after 3 forwards are
    within 1e-6 of flax's (momentum 0.99, biased variance, E[x²] - E[x]²)."""
    from sincformer_tpu.models.conformer import ConvolutionModule as JaxConv

    from sincformer_tpu_torch.compat.from_jax import (_dcse_buffers,
                                                      _dcse_named)
    from sincformer_tpu_torch.models.conformer import ConvolutionModule
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 40, 32)).astype(np.float32) + 0.5
    x[2, 25:] = 0.0                                  # a padded row
    jm = JaxConv(32, 7, 0.0, norm)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x))
    params = jax.tree_util.tree_map_with_path(
        lambda p, s: _fill(p, s, rng).astype(np.float32), shapes["params"])
    variables = {"params": params}
    if norm == "batch":
        variables["batch_stats"] = {"bn": {
            "mean": (0.1 * rng.standard_normal(32)).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, 32).astype(np.float32)}}
    tm = ConvolutionModule(32, 7, 0.0, norm)
    tm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in {
        **_dcse_named(params),
        **_dcse_buffers(variables.get("batch_stats"))}.items()}, strict=True)
    gen = torch.Generator().manual_seed(0) if train else None
    for n in range(3 if train else 1):
        if train and norm == "batch":
            want, upd = jm.apply(variables, x, deterministic=False,
                                 mutable=["batch_stats"])
            variables = {**variables, **upd}
        else:
            want = jm.apply(variables, x, deterministic=not train)
        with torch.no_grad():
            got = tm(torch.from_numpy(x), gen)
        want = np.asarray(want)
        assert max_abs(got, want) <= OUT_TOL * float(np.abs(want).max())
        if train and norm == "batch" and n in (0, 2):
            for k, w in _dcse_buffers(jax.tree.map(
                    np.asarray, variables["batch_stats"])).items():
                assert max_abs(dict(tm.named_buffers())[k], w) <= STATS_TOL


def test_complex_conformer_matches_jax():
    """``ComplexConformer`` (two narrow blocks, global skip, the split
    output projection) with bridged weights: both mask halves within 1e-5
    of their scale; the default configuration has 6 blocks and dropout
    0.1."""
    from sincformer_tpu.models.conformer import ComplexConformer as JaxCC

    from sincformer_tpu_torch.compat.from_jax import _dcse_named
    from sincformer_tpu_torch.models.conformer import (
        ComplexConformer, default_complex_conformer)
    kw = dict(n_freq=129, d_model=32, num_blocks=2, num_heads=2, d_ff=64,
              kernel_size=7, dropout=0.0)
    rng = np.random.default_rng(4)
    re, im = (rng.standard_normal((2, 21, 129)).astype(np.float32)
              for _ in range(2))
    jm = JaxCC(**kw, attn_impl="speech")
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), re, im))
    params = jax.tree_util.tree_map_with_path(
        lambda p, s: _fill(p, s, rng).astype(np.float32), shapes["params"])
    want = jax.jit(jm.apply)({"params": params}, re, im)
    tm = ComplexConformer(**kw).eval()
    tm.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in _dcse_named(params).items()}, strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(re), torch.from_numpy(im))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert max_abs(g, w) <= OUT_TOL * float(np.abs(w).max())
    full = default_complex_conformer()
    assert full.num_blocks == 6 and full.block_0.FeedForwardModule_0.dropout \
        == 0.1


def test_dropout_draws_from_its_generator():
    """The same seed gives the same mask; kept units are scaled by
    1/(1 - p); the dropped share is within 1 % of p on 10⁵ elements; no
    generator, no dropout. A DCSE training forward with dropout is
    reproducible from its seed and differs from the serving forward."""
    from sincformer_tpu_torch.config import DCSEConfig
    from sincformer_tpu_torch.models.conformer import dropout
    from sincformer_tpu_torch.models.dcse import SpeechEnhancer
    x = torch.ones(100_000)
    a = dropout(x, 0.15, torch.Generator().manual_seed(4))
    b = dropout(x, 0.15, torch.Generator().manual_seed(4))
    assert torch.equal(a, b)
    kept = a[a != 0]
    assert torch.allclose(kept, torch.full_like(kept, 1 / 0.85))
    assert abs(float((a == 0).float().mean()) - 0.15) <= 0.01 * 0.15
    assert torch.equal(dropout(x, 0.15, None), x)
    model = SpeechEnhancer(DCSEConfig(num_heads=2, **{
        k: v for k, v in NARROW_DCSE.items() if k not in ("num_heads",
                                                          "d_ff")},
        ff_dim=64)).init_params(torch.Generator().manual_seed(0))
    re = torch.randn(1, 11, 129)
    with torch.no_grad():
        t1, t2 = (model(re, re, generator=torch.Generator().manual_seed(5))[0]
                  for _ in range(2))
        serve = model(re, re)[0]
    assert torch.equal(t1, t2) and not torch.equal(t1, serve)


def _check_training_init(named, biases_zero):
    """Each weight leaf's std within 2 % of sqrt(scale / fan_in), nothing
    past the 2σ truncation, every bias zero."""
    from sincformer_tpu_torch.models.init import TRUNC_STD
    for name, (p, scale) in named.items():
        p = p.detach().double()
        if p.ndim >= 2:
            fan_in = int(np.prod(p.shape[1:]))
            want = (scale / fan_in) ** 0.5
            assert abs(float(p.std()) / want - 1.0) <= 0.02, name
            assert float(p.abs().max()) <= 2.0 * want / TRUNC_STD, name
        elif name.endswith("bias"):
            assert biases_zero and float(p.abs().max()) == 0.0, name
        else:
            assert torch.all(p == 1.0), name


def test_training_init_statistics():
    """``training_init`` on the full-width DCSE model (lecun_normal
    everywhere, unit norm scales, BatchNorm statistics 0 and 1) and the
    full-width mask DNN (he_normal hidden, lecun_normal output): flax's
    truncated variance-scaling draws. The parity tests' ``init_params``
    stays as it was."""
    from sincformer_tpu_torch.config import DCSEConfig
    from sincformer_tpu_torch.models.dcse import SpeechEnhancer
    from sincformer_tpu_torch.models.dnn import create_dnn
    model = SpeechEnhancer(DCSEConfig(conv_norm="batch")).training_init(
        torch.Generator().manual_seed(0))
    _check_training_init({k: (p, 1.0) for k, p in model.named_parameters()},
                         True)
    for k, b in model.named_buffers():
        assert torch.all(b == (1.0 if k.endswith("var") else 0.0)), k
    dnn = create_dnn(594).training_init(torch.Generator().manual_seed(0))
    _check_training_init({k: (p, 1.0 if k.startswith("output") else 2.0)
                          for k, p in dnn.named_parameters()}, True)
    again = create_dnn(594).init_params(torch.Generator().manual_seed(0))
    assert float(again.hidden_0.bias.detach().abs().max()) > 0.0


def test_unported_training_options_raise():
    """bf16 ``compute_dtype`` raises (kernels K1 and K3 are float32);
    ``remat`` is ported and a trainer takes it; a wrong norm raises."""
    from sincformer_tpu_torch.config import DCSEConfig
    from sincformer_tpu_torch.models.dcse import SpeechEnhancer
    from sincformer_tpu_torch.train.dcse_trainer import DCSETrainer
    assert DCSETrainer(SpeechEnhancer(DCSEConfig(remat=True)),
                       device="cpu").model.config.remat
    with pytest.raises(NotImplementedError, match="compute_dtype"):
        DCSETrainer(device="cpu", compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="conv_norm"):
        DCSEConfig(conv_norm="instance")
