"""The oracle masks (``masks/irm.py``, ``masks/pcirm.py``,
``masks/opt_pcirm.py``), the particle swarm (``optim/pso.py``) and RBM
pretraining (``models/rbm.py``) of the port against the JAX package on the
same inputs, on the CPU.

Bars: the masks 1e-6 absolute (a quantized cell may differ only where the
PCIRM lies within 1e-6 of a step boundary), the scalar-gain waveform 1e-5
of its peak, the swarm bit for bit, the PSO-optimised middle step 1e-6;
a CD-1 step on the uniforms JAX draws (``jax.random.split(key, 2k + 1)``,
then ``jax.random.uniform`` in the order of ``RBM._cd_step``) 1e-6 of each
leaf's scale and the reconstruction error 1e-6 relative, a Bernoulli sample
flipping only where |prob - u| < 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

MASK_TOL = 1e-6
WAVE_TOL = 1e-5


def _tf_units(seed, shape=(64, 99)):
    """(clean, noise, noisy) magnitudes and phases of the shape of a
    gammatone analysis."""
    rng = np.random.default_rng(seed)
    mags = [(rng.gamma(1.0, 1.0, shape) * s).astype(np.float32)
            for s in (1.0, 0.7, 1.3)]
    phases = [rng.uniform(-np.pi, np.pi, shape).astype(np.float32)
              for _ in range(3)]
    return mags, phases


def _t(x):
    return torch.from_numpy(np.array(x))


def test_irm_pcirm_and_fixed_step_opt_pcirm_match_jax():
    import sincformer_tpu.masks as J

    import sincformer_tpu_torch.masks.irm as irm
    import sincformer_tpu_torch.masks.opt_pcirm as opt
    import sincformer_tpu_torch.masks.pcirm as pcirm
    (cm, nm, ym), (cp, np_, yp) = _tf_units(0)
    want = J.compute_irm(cm, nm)
    assert np.max(np.abs(irm.compute_irm(_t(cm), _t(nm)).numpy()
                         - np.asarray(want))) <= MASK_TOL
    want_all = J.compute_pcirm_from_signals(ym, cm, nm, yp, cp, np_, cm, nm)
    got_all = pcirm.compute_pcirm_from_signals(*map(_t, (ym, cm, nm, yp, cp,
                                                         np_, cm, nm)))
    for g, w in zip(got_all, want_all):
        assert np.max(np.abs(g.numpy() - np.asarray(w))) <= MASK_TOL
    p = np.asarray(want_all[0])
    steps_j, n_j = J.compute_snr_boundaries()
    steps, n_exp = opt.compute_snr_boundaries()
    assert np.array_equal(steps, steps_j) and n_exp == n_j
    want_q, _, mid_j = J.compute_opt_pcirm(p, use_pso=False)
    got_q, _, mid = opt.compute_opt_pcirm(_t(p), use_pso=False)
    assert mid == mid_j
    bounds = np.concatenate([steps[1:], [1.0]]).astype(np.float32)
    near = np.min(np.abs(p[..., None] - bounds), axis=-1) < 1e-6
    differ = got_q.numpy() != np.asarray(want_q)
    assert not np.any(differ & ~near)
    assert set(np.unique(got_q.numpy())) <= set(steps.astype(np.float32))
    noisy_tf = np.random.default_rng(1).standard_normal(p.shape).astype(
        np.float32)
    for f, fj in ((irm.apply_irm, J.apply_irm),
                  (pcirm.apply_pcirm, J.apply_pcirm),
                  (opt.apply_opt_pcirm, J.apply_opt_pcirm)):
        assert np.array_equal(f(_t(noisy_tf), _t(p)).numpy(),
                              np.asarray(fj(noisy_tf, p)))


def test_reconstruct_scalar_gain_matches_jax():
    """One mask and a batch of candidate masks (the swarm's form) against
    the JAX function of each: 1e-5 of the waveform's peak."""
    from sincformer_tpu.masks.opt_pcirm import \
        reconstruct_scalar_gain as jax_recon

    from sincformer_tpu_torch.masks.opt_pcirm import reconstruct_scalar_gain
    rng = np.random.default_rng(2)
    noisy = rng.standard_normal(8000).astype(np.float32)
    masks = rng.uniform(0, 1, (3, 64, 99)).astype(np.float32)
    got = reconstruct_scalar_gain(_t(masks), _t(noisy)).numpy()
    assert got.shape == (3, 8000)
    for i in range(3):
        want = np.asarray(jax_recon(jnp.asarray(masks[i]),
                                    jnp.asarray(noisy)))
        assert np.max(np.abs(got[i] - want)) <= WAVE_TOL * np.max(
            np.abs(want))


def _numpy_fitness(xs):
    return -np.cos(3.0 * np.asarray(xs)) * (np.asarray(xs) - 0.37) ** 2


@pytest.mark.parametrize("maximize", [True, False])
def test_pso_is_bit_equal_to_jax(maximize):
    from sincformer_tpu.optim.pso import ParticleSwarmOptimizer as JaxPSO

    from sincformer_tpu_torch.optim.pso import ParticleSwarmOptimizer
    kw = dict(batched_fitness=_numpy_fitness, num_particles=9, max_iter=25,
              maximize=maximize)
    want = JaxPSO(**kw)
    got = ParticleSwarmOptimizer(**kw)
    assert want.optimize(np.random.default_rng(4)) == got.optimize(
        np.random.default_rng(4))
    assert got.get_convergence_history() == want.get_convergence_history()
    scalar = ParticleSwarmOptimizer(fitness_fn=lambda x: -(x - 0.2) ** 2,
                                    num_particles=5, max_iter=5)
    assert 0.0 <= scalar.optimize(np.random.default_rng(0))[0] <= 1.0


def test_opt_pcirm_with_the_swarm_matches_jax():
    """``compute_opt_pcirm(use_pso=True)``, 4 particles × 3 iterations from
    the same ``np.random.default_rng``, simplified-STOI fitness over a
    speech-like signal: the best middle step within 1e-6, the optimised
    mask equal where the PCIRM is not within 1e-6 of a boundary."""
    import sincformer_tpu.masks as J
    from sincformer_tpu.dsp.gammatone import GammatoneFilterbank as JGFB

    from sincformer_tpu_torch.masks.opt_pcirm import compute_opt_pcirm
    from tests._torch_parity import speechlike
    clean = speechlike(3, 8000)
    rng = np.random.default_rng(5)
    noise = (rng.standard_normal(8000) * 0.1).astype(np.float32)
    noisy = clean + noise
    gfb = JGFB(sample_rate=8000)
    (cm, cp), (nm, np_), (ym, yp) = (gfb.get_tf_magnitudes(jnp.asarray(x))
                                     for x in (clean, noise, noisy))
    p, *_ = J.compute_pcirm_from_signals(ym, cm, nm, yp, cp, np_, cm, nm)
    p = np.asarray(p)
    cfg = dict(num_particles=4, max_iter=3)
    want_q, _, want_mid = J.compute_opt_pcirm(
        p, noisy, clean, pso_config=cfg, rng=np.random.default_rng(6))
    got_q, _, got_mid = compute_opt_pcirm(
        _t(p), noisy, clean, pso_config=cfg, rng=np.random.default_rng(6))
    assert abs(got_mid - want_mid) <= 1e-6
    assert np.max(np.abs(got_q.numpy() - np.asarray(want_q))) <= 1e-6


def test_opt_pcirm_full_stoi_fitness():
    """``fitness="full"`` scores each particle with ``stoi_full_torch``
    (held against JAX's ``stoi_full_jax`` in test_torch_evaluation.py): the
    fitness of each position is the full STOI of the reconstruction there,
    and the swarm's best lies in the bounds."""
    from sincformer_tpu_torch.evaluation.stoi import stoi_full_torch
    from sincformer_tpu_torch.masks.opt_pcirm import (
        compute_opt_pcirm, compute_snr_boundaries, opt_pcirm_fitness,
        quantize_pcirm, reconstruct_scalar_gain)
    from tests._torch_parity import speechlike
    clean = speechlike(4, 12000)
    noisy = clean + np.random.default_rng(3).standard_normal(12000).astype(
        np.float32) * 0.1
    p = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 1, (64, 149)).astype(np.float32))
    steps = compute_snr_boundaries()[0]
    xs = np.array([0.05, 0.3])
    got = opt_pcirm_fitness(p, noisy, clean, fitness="full")(xs)
    for x, g in zip(xs, got):
        enh = reconstruct_scalar_gain(quantize_pcirm(p, steps, x),
                                      torch.from_numpy(noisy))
        assert abs(float(g) - float(stoi_full_torch(
            torch.from_numpy(clean), enh, 8000, device="cpu"))) <= 1e-6
    _, _, mid = compute_opt_pcirm(
        p, noisy, clean, pso_config=dict(num_particles=3, max_iter=2),
        rng=np.random.default_rng(1), fitness="full")
    assert 0.0 <= mid <= 1.0


def test_cd1_step_matches_jax_on_its_uniforms():
    from sincformer_tpu.models.rbm import RBM as JaxRBM

    from sincformer_tpu_torch.models.rbm import RBM, cd_uniform_shapes
    b, vis, hid = 32, 40, 24
    rng = np.random.default_rng(9)
    v = rng.uniform(0, 1, (b, vis)).astype(np.float32)
    params = (rng.standard_normal((vis, hid)).astype(np.float32) * 0.3,
              (0.1 * rng.standard_normal(vis)).astype(np.float32),
              (0.1 * rng.standard_normal(hid)).astype(np.float32))
    jrbm = JaxRBM(vis, hid, learning_rate=0.05)
    key = jax.random.PRNGKey(17)
    (w, vb, hb), err = jax.jit(lambda p, x, k: jrbm._cd_step(
        p, x, k, 0.05, 1))(tuple(map(jnp.asarray, params)), jnp.asarray(v),
                           key)
    keys = jax.random.split(key, 3)
    shapes = cd_uniform_shapes(b, vis, hid, 1)
    u = [np.asarray(jax.random.uniform(kk, s)) for kk, s in zip(keys, shapes)]

    rbm = RBM(vis, hid, learning_rate=0.05, device="cpu")
    tp = tuple(map(_t, params))
    # the samples of the data's hidden layer, and of the Gibbs step
    prob0, s0 = rbm.sample_hidden(tp, _t(v), _t(u[0]))
    jprob0, js0 = JaxRBM._sample_hidden(params, jnp.asarray(v), keys[0])
    flips = s0.numpy() != np.asarray(js0)
    assert np.all(np.abs(prob0.numpy() - u[0])[flips] < 1e-6)
    (gw, gvb, ghb), gerr = rbm.cd_step(tp, _t(v), [_t(x) for x in u])
    for g, want in ((gw, w), (gvb, vb), (ghb, hb)):
        want = np.asarray(want)
        assert np.max(np.abs(g.numpy() - want)) <= MASK_TOL * np.max(
            np.abs(want))
    assert abs(float(gerr) - float(err)) <= 1e-6 * abs(float(err))


def test_load_rbm_weights_and_pretraining():
    """``load_rbm_weights`` puts each RBM layer where the JAX package puts
    it (its W as the kernel, its hidden bias as the bias; the output layer
    untouched); stacked pretraining yields one (W, v_bias, h_bias) per
    layer and lowers the first layer's reconstruction error."""
    from sincformer_tpu.models.dnn import create_dnn as jax_create
    from sincformer_tpu.models.dnn import load_rbm_weights as jax_load
    from sincformer_tpu import config as jcfg

    from sincformer_tpu_torch.config import DNNConfig, RBMConfig
    from sincformer_tpu_torch.models.dnn import create_dnn, load_rbm_weights
    from sincformer_tpu_torch.models.rbm import RBM, pretrain_dnn_with_rbm
    import dataclasses
    rng = np.random.default_rng(12)
    data = rng.uniform(0, 1, (300, 594)).astype(np.float32)
    weights = pretrain_dnn_with_rbm(data, [594, 16, 16], verbose=False,
                                    device="cpu",
                                    rcfg=RBMConfig(epochs=2, batch_size=64))
    assert [tuple(a.shape) for t in weights for a in t] == [
        (594, 16), (594,), (16,), (16, 16), (16,), (16,)]
    dcfg = DNNConfig(hidden_layers=2, hidden_units=16)
    model = create_dnn(594, dcfg=dcfg).init_params(
        torch.Generator().manual_seed(0))
    out_before = model.output.weight.detach().clone()
    load_rbm_weights(model, weights)
    jm = jax_create(594, dcfg=dataclasses.replace(jcfg.DEFAULT.dnn,
                                                  hidden_layers=2,
                                                  hidden_units=16))
    jp = jax_load(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 594))),
                  weights)
    for i in range(2):
        layer = getattr(model, f"hidden_{i}")
        assert np.array_equal(layer.weight.detach().numpy().T,
                              np.asarray(jp["params"][f"hidden_{i}"]
                                         ["kernel"]))
        assert np.array_equal(layer.bias.detach().numpy(),
                              np.asarray(jp["params"][f"hidden_{i}"]["bias"]))
    assert torch.equal(model.output.weight, out_before)
    rbm = RBM(594, 16, rcfg=RBMConfig(epochs=4, batch_size=64), device="cpu")
    errors = rbm.train(data, verbose=False)
    assert len(errors) == 4 and errors[-1] < errors[0]
