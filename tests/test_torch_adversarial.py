"""The adversarial branch of flagship training in the port against the JAX
package on the CPU in float32: the multi-scale discriminator and its LSGAN
losses, one adversarial training step at narrow width (generator and
discriminator), and the ``_disc`` checkpoint on ``resume``.

The discriminator's weights fill flax's parameter tree with seeded values:
fan-in normal kernels and non-zero gains and biases (flax starts them at 1
and 0, which would hide a misplaced one), carried across by
``compat.from_jax``. T = 40 and 41 take
both parities of the SAME paddings and the pools. Bars: logits and every
feature 1e-5 of their scale, the three losses 1e-6 relative, the
discriminator's gradients 1e-4 of their largest magnitude.

The step runs JAX's ``SincformerPipeline._loss`` with the discriminator's
parameters frozen and its gradients, then the discriminator's loss, its
gradients gated by ``use_adv``, JAX's NaN guard and the Adam of the JAX
pipeline's ``init_state`` (on the parameters raveled into one vector: the
same arithmetic element by element, one small compile), in one jitted
function (the gate is a traced argument, so one compile serves both
steps), with the narrow model of ``tests/_torch_parity.py``, dropout 0 and
softmax routing. The generator's AdamW step is tests/test_torch_train_step.py's
subject and is not repeated. Bars: the
generator's loss 1e-5 relative and its gradients 1e-4 of each leaf's
largest magnitude (floored at 1e-4 of the step's largest: the bars of
tests/test_torch_train_step.py); the discriminator's loss 1e-5 relative;
its parameters and Adam moments after the step 1e-5 of their scale.

Adam turns a gradient into a step of about ±lr whatever its size, so an
element whose gradient lies within rounding of zero steps by rounding's
sign, in either package. As in tests/test_torch_train_step.py, the
discriminator's parameters are held to 1e-5 of their scale on every other
element, and on those (at most 1 % of the elements) to twice the step's
size; the moments are held everywhere. Here "within rounding of zero" is
JAX's first moment, which carries the gradient's sign, below SIGN_TOL =
1e-5 of its leaf's largest (0.09 % of the elements here): the
discriminator's gradients agree to about 3e-6 of their leaf's largest
(measured), and below the gradient bar of 1e-4 lie 0.9 % of the elements
here and 1.2 % with flax's initialisation, too close to the 1 % limit."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import NARROW, narrow_model, wave

FEAT_TOL = 1e-5
LOSS_REL = 1e-6
DGRAD_TOL = 1e-4
STEP_LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
GRAD_FLOOR = 1e-4
DISC_TOL = 1e-5
SIGN_TOL = 1e-5
EPOCHS, STEPS = 3, 2


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol, floor: float = 0.0) -> bool:
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.max(np.abs(want), initial=0.0)), floor)
    return float(np.max(np.abs(got - want), initial=0.0)) <= tol * scale


def _filled(shapes):
    """flax's parameter tree filled with seeded values: fan-in normal
    kernels (flax's LeCun scale) and non-zero gains and biases."""
    rng = np.random.default_rng(31)

    def fill(path, leaf):
        name = getattr(path[-1], "key", str(path[-1]))
        if name == "gain":
            value = 1.0 + 0.2 * rng.standard_normal(leaf.shape)
        elif name == "bias":
            value = 0.1 * rng.standard_normal(leaf.shape)
        else:
            value = (rng.standard_normal(leaf.shape)
                     / np.sqrt(np.prod(leaf.shape[:-1])))
        return value.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.lru_cache(maxsize=None)
def _jax_disc():
    from sincformer_tpu.train.adversarial import MultiScaleDiscriminator
    disc = MultiScaleDiscriminator()
    shapes = jax.eval_shape(lambda: disc.init(jax.random.PRNGKey(5),
                                              jnp.zeros((1, 40, 129))))
    return disc, _filled(shapes)


def _port_disc(dvars):
    from sincformer_tpu_torch.compat.from_jax import \
        load_discriminator_from_jax
    from sincformer_tpu_torch.train.adversarial import \
        MultiScaleDiscriminator
    named, _ = load_discriminator_from_jax(dvars)
    disc = MultiScaleDiscriminator()
    disc.load_state_dict(named, strict=True)
    return disc


def _mags(seed, t):
    rng = np.random.default_rng(seed)
    return (np.abs(rng.standard_normal((2, t, 129))) * 0.5).astype(np.float32)


@pytest.mark.parametrize("t", [40, 41])
def test_discriminator_and_losses_match_jax(t):
    """Logits and features at the three scales, the three losses, and the
    discriminator loss's gradients."""
    from sincformer_tpu.train import adversarial as jadv
    from sincformer_tpu_torch.train import adversarial as padv
    disc, dvars = _jax_disc()
    pdisc = _port_disc(dvars)
    real, fake = _mags(1, t), _mags(2, t)

    @jax.jit
    def run(dv):
        def d_loss(dv):
            return jadv.discriminator_loss(disc.apply(dv, real),
                                           disc.apply(dv, fake))
        j_real, j_fake = disc.apply(dv, real), disc.apply(dv, fake)
        return (j_real, j_fake, jadv.generator_loss(j_fake),
                jadv.feature_matching_loss(j_real, j_fake),
                *jax.value_and_grad(d_loss)(dv))
    j_real, j_fake, g_loss, fm_loss, dl, dgrads = run(dvars)
    p_real = pdisc(torch.from_numpy(real))
    p_fake = pdisc(torch.from_numpy(fake))
    for (jl, jf), (pl, pf) in zip(j_fake, p_fake):
        assert _close(pl, jl, FEAT_TOL)
        assert len(pf) == len(jf)
        for a, b in zip(pf, jf):
            assert _close(a, b, FEAT_TOL)
    losses = (
        (padv.discriminator_loss(p_real, p_fake), dl),
        (padv.generator_loss(p_fake), g_loss),
        (padv.feature_matching_loss(p_real, p_fake), fm_loss))
    for got, want in losses:
        got = got.detach()
        assert abs(float(got) - float(want)) <= LOSS_REL * abs(float(want))
    pl = padv.discriminator_loss(pdisc(torch.from_numpy(real)),
                                 pdisc(torch.from_numpy(fake)))
    names = [n for n, _ in pdisc.named_parameters()]
    got = dict(zip(names, torch.autograd.grad(pl, list(pdisc.parameters()))))
    from sincformer_tpu_torch.compat.from_jax import _disc_named
    want = _disc_named(jax.tree.map(np.asarray, dgrads))
    assert set(want) == set(got)
    bad = [k for k in want if not _close(got[k], want[k], DGRAD_TOL)]
    assert not bad, bad


@functools.lru_cache(maxsize=None)
def _jax_adv_step():
    """(the discriminator's Adam of the JAX pipeline's init_state, the
    unravel of its raveled parameters, the jitted step)."""
    import tempfile

    import optax
    from jax.flatten_util import ravel_pytree

    from sincformer_tpu.agents.metacog import SincformerMetacog as JaxModel
    from sincformer_tpu.train.adversarial import discriminator_loss
    from sincformer_tpu.train.agent_trainer import SincformerPipeline
    from sincformer_tpu.train.state import guard_nan_update
    model = JaxModel(**NARROW, dropout=0.0, attn_impl="speech",
                     pa_fine_act="mulaw", routing="softmax")
    pipe = SincformerPipeline(model=model, model_dir=tempfile.mkdtemp(),
                              use_adversarial=True)
    # the discriminator's optimizer of the JAX pipeline's init_state,
    # without its jitted weight initialisation (the weights are the tests')
    dtx = optax.chain(optax.clip_by_global_norm(pipe.grad_clip),
                      optax.adam(2e-4))
    disc = pipe.disc = _jax_disc()[0]
    unravel = ravel_pytree(_jax_disc()[1])[1]

    @jax.jit
    def step(params, model_state, flat_dparams, dopt, noisy, clean,
             use_adv):
        dparams = unravel(flat_dparams)
        (loss, aux), grads = jax.value_and_grad(
            lambda p: pipe._loss(p, model_state, noisy, clean,
                                 jax.random.PRNGKey(0), True, 1.0, 1.0,
                                 jax.lax.stop_gradient(dparams), use_adv,
                                 None, 1.0), has_aux=True)(params)
        enh = jax.lax.stop_gradient(aux["enh_mag"])
        cln = jax.lax.stop_gradient(aux["clean_mag"])
        dl, dgrads = jax.value_and_grad(
            lambda dp: discriminator_loss(disc.apply(unravel(dp), cln),
                                          disc.apply(unravel(dp), enh)))(
            flat_dparams)
        dgrads, _ = guard_nan_update(use_adv * dgrads, dl)
        dupd, dopt = dtx.update(dgrads, dopt, flat_dparams)
        return loss, grads, dl, optax.apply_updates(flat_dparams, dupd), dopt

    return dtx, unravel, step


def _port_trainer(params, model_state, opt_state=None):
    from sincformer_tpu_torch import SincformerMetacog
    from sincformer_tpu_torch.compat.from_jax import \
        load_train_state_from_jax
    from sincformer_tpu_torch.train.agent_trainer import SincformerTrainer
    named, buffers, opt, config = load_train_state_from_jax(
        params, model_state, opt_state, num_heads=NARROW["num_heads"],
        sinc_kernel_size=NARROW["sinc_kernel_size"], dropout=0.0,
        routing="softmax")
    pipe = SincformerTrainer(SincformerMetacog(config), device="cpu",
                             use_adversarial=True)
    pipe.load_state(named, buffers)
    return pipe, opt


def _disc_state_close(pipe, before, dparams, dopt, unravel):
    """The port's discriminator and Adam state against JAX's (raveled)
    after a step from ``before`` (the parameters by name): the moments 1e-5
    of their scale, the parameters too where JAX's first moment is settled,
    and within twice the step elsewhere."""
    from sincformer_tpu_torch.compat.from_jax import (
        _adam_state, _disc_named)
    count, mu, nu = _adam_state(dopt)
    assert pipe.disc_opt_state["count"] == int(np.asarray(count))
    mu, nu = (_disc_named(jax.tree.map(np.asarray, unravel(t)))
              for t in (mu, nu))
    dparams = unravel(dparams)
    for got, want in ((pipe.disc_opt_state["mu"], mu),
                      (pipe.disc_opt_state["nu"], nu)):
        bad = [k for k in want if not _close(got[k], want[k], DISC_TOL)]
        assert not bad, bad
    got = dict(pipe.disc.named_parameters())
    loose = total = 0
    for k, w in _disc_named(jax.tree.map(np.asarray, dparams)).items():
        w, m = w.double(), mu[k].double().abs()
        settled = m > SIGN_TOL * float(m.max())
        diff = (got[k].detach().double() - w).abs()
        scale = float(w.abs().max())
        assert bool((diff[settled] <= DISC_TOL * scale).all()), k
        step = float((w - before[k].double()).abs().max())
        assert bool((diff[~settled] <= 2 * step + DISC_TOL * scale).all()), k
        loose += int((~settled).sum())
        total += w.numel()
    assert loose <= 0.01 * total, (loose, total)


def test_adversarial_step_matches_jax():
    """Step 1 from JAX's state with use_adv = 1: the generator's loss and
    gradients, the discriminator's loss, parameters and Adam moments. Step
    2 with use_adv = 0 on another batch, the discriminator carried over in
    each package: the port's Adam count advances and its parameters and
    moments still equal JAX's."""
    from jax.flatten_util import ravel_pytree

    from sincformer_tpu_torch.compat.from_jax import (
        _disc_named, _named_params, load_discriminator_from_jax)
    from sincformer_tpu_torch.train.state import guard_nan_update
    dtx, unravel, step = _jax_adv_step()
    _, v, _ = narrow_model()
    _, dvars = _jax_disc()
    params = jax.tree.map(jnp.asarray, v["params"])
    model_state = {k: jax.tree.map(jnp.asarray, v[k])
                   for k in ("maa_stats", "memory_bank", "memory_stats")}
    dflat = ravel_pytree(dvars)[0]
    noisy, clean = wave(5), (wave(6) * 0.5).astype(np.float32)
    loss, grads, dl, dp1, do1 = step(params, model_state, dflat,
                                     dtx.init(dflat), jnp.asarray(noisy),
                                     jnp.asarray(clean), 1.0)

    pipe, _ = _port_trainer(v["params"], {k: v[k] for k in model_state})
    d0, _ = load_discriminator_from_jax(dvars)
    pipe.load_disc_state(d0)
    pipe.init_state(EPOCHS, STEPS, init_params=False)
    assert pipe.disc_opt_state["count"] == 0
    got_loss, _, got_grads = pipe.loss_and_grads(
        torch.from_numpy(noisy), torch.from_numpy(clean), 1.0, 1.0, None,
        1.0, 1.0)
    assert abs(float(got_loss) - float(loss)) <= STEP_LOSS_TOL * abs(
        float(loss))
    want = _named_params(jax.tree.map(np.asarray, grads), 2)
    got = dict(zip(pipe.params(), got_grads))
    floor = GRAD_FLOOR * max(float(np.max(np.abs(g))) for g in want.values())
    bad = [k for k, g in want.items()
           if not _close(got[k] if got[k] is not None else torch.zeros(
               g.shape), g, GRAD_TOL, floor)]
    assert not bad, bad
    params_t = pipe.params()
    guarded, _ = guard_nan_update(got_grads, got_loss, params_t.values())
    pipe.tx.update(params_t, guarded, pipe.opt_state)
    pipe.step += 1
    got_dl = pipe.disc_step(1.0)
    assert abs(float(got_dl) - float(dl)) <= STEP_LOSS_TOL * abs(float(dl))
    _disc_state_close(pipe, d0, dp1, do1, unravel)

    # step 2, the gate at 0: the Adam step is still taken
    p_disc = {k: t.detach().clone() for k, t in
              pipe.disc.named_parameters()}
    pipe2, _ = _port_trainer(v["params"], {k: v[k] for k in model_state})
    pipe2.load_disc_state(p_disc, pipe.disc_opt_state)
    pipe2.init_state(EPOCHS, STEPS, init_params=False, reset_optimizer=False)
    noisy2, clean2 = wave(7), (wave(8) * 0.5).astype(np.float32)
    _, _, dl2, dp2, do2 = step(params, model_state, dp1, do1,
                               jnp.asarray(noisy2), jnp.asarray(clean2), 0.0)
    pipe2.train_step(torch.from_numpy(noisy2), torch.from_numpy(clean2),
                     1.0, 1.0, None, 1.0, 0.0)
    assert pipe2.disc_opt_state["count"] == 2
    assert abs(float(pipe2.disc_loss) - float(dl2)) \
        <= STEP_LOSS_TOL * abs(float(dl2))
    moved = max(float((p_disc[k] - t.detach()).abs().max())
                for k, t in pipe2.disc.named_parameters())
    assert moved > 0.0
    _disc_state_close(pipe2, _disc_named(jax.tree.map(
        np.asarray, unravel(dp1))), dp2, do2, unravel)


def _adv_trainer(model_dir):
    from sincformer_tpu_torch import MetacogConfig, SincformerMetacog
    from sincformer_tpu_torch.train.agent_trainer import SincformerTrainer
    model = SincformerMetacog(MetacogConfig(**NARROW))
    return SincformerTrainer(model, device="cpu", model_dir=str(model_dir),
                             use_adversarial=True)


def test_disc_checkpoint_resume_and_legacy_warning(tmp_path):
    """A full checkpoint of the adversarial trainer writes the ``_disc``
    sibling at the generator's step; ``train(resume=True)`` restores the
    discriminator and its Adam state bit for bit, and warns and restarts
    it from its initialisation when the sibling is missing."""
    import shutil

    from sincformer_tpu_torch.cli import _synthetic_corpus
    a = _adv_trainer(tmp_path)
    a.init_state(1, 1)
    a.train_step(torch.from_numpy(wave(1)), torch.from_numpy(wave(2) * 0.5),
                 1.0, 1.0, None, 1.0, 1.0)
    path = a.save_model("sincformer_final")
    sibling = tmp_path / "sincformer_final_disc" / "step_1"
    assert path.endswith("step_1") and sibling.is_dir()
    clean, noises = _synthetic_corpus(2)
    b = _adv_trainer(tmp_path)
    b.train(clean[:1], clean[1:], noises, epochs=1, max_len=4000,
            verbose=False, resume=True)
    assert b.step == 1 and b.disc_opt_state["count"] == 1
    for (k, x), (_, y) in zip(a.disc.named_parameters(),
                              b.disc.named_parameters()):
        assert torch.equal(x, y), k
        for m in ("mu", "nu"):
            assert torch.equal(a.disc_opt_state[m][k],
                               b.disc_opt_state[m][k]), k
    shutil.rmtree(tmp_path / "sincformer_final_disc")
    c = _adv_trainer(tmp_path)
    with pytest.warns(RuntimeWarning, match="discriminator"):
        c.train(clean[:1], clean[1:], noises, epochs=1, max_len=4000,
                verbose=False, resume=True)
    assert c.disc_opt_state["count"] == 0 and c.step == 1
