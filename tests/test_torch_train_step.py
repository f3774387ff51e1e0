"""One training step of the flagship in the port against the JAX package at
narrow width, on the CPU in float32, and the pieces that make a step: the
MAA's Gumbel and softmax routing with its EMA statistics, the episodic
memory's write path, dropout, the orthogonal recurrent init, and the
backward of kernels K1 and K3.

The whole step runs JAX's ``SincformerPipeline._loss`` under one jitted
``value_and_grad`` (a module fixture, the stage scalars traced), with the
model built with ``routing="softmax"`` and dropout 0, so nothing is drawn.
The weights are ``tests/_torch_parity.py``'s (non-zero biases, a filled
``model_state``), carried across by ``compat.from_jax``. Bars: the loss
1e-5 relative; each gradient leaf 1e-4 of its largest magnitude (K1's
gradient bar in tests/test_pallas_ops.py), the CPEA's recurrent kernels K
and biases b compared as separate leaves; ``model_state`` 1e-6; the
parameters after an AdamW step 1e-5 of their scale.

A leaf's scale is floored at 1e-4 of the largest gradient of the step
(GRAD_FLOOR). Two leaves need it: the SincConv cutoffs ``low_hz`` and
``band_hz``, whose gradients are ~1e-9 against O(1) elsewhere. The JAX
SincConv divides by the sample rate twice (cycles per sample times radians
over the sample rate), so its sinc arguments stay below 1e-2 rad, every band
is the same flat kernel after the L1 normalisation, and the cutoffs' true
gradient is ~0: both packages return float32 rounding there (ROADMAP.md
Queue 3).

AdamW turns a gradient into a step of about ±lr whatever its size, so an
element whose gradient lies within the gradient bar of zero (the key
projection's bias, whose gradient is 0 under the softmax's shift
invariance, holds a third of such elements) steps by rounding's sign. The
parameters after a step are held to 1e-5 of their scale on every other
element, and on those (at most 1 % of the elements) to the step's size;
the optimizer alone, given JAX's gradients, is held to 1e-5 everywhere."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests._torch_parity import NARROW, narrow_model, wave

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
STATE_TOL = 1e-6
PARAM_TOL = 1e-5
GRAD_FLOOR = 1e-4
LR, EPOCHS, STEPS = 5e-4, 3, 2
ALL_ON = (1.0, 1.0, 1.0)        # use_perceptual, use_vq, use_mask_mse
STAGE1 = (0.0, 0.0, 1.0)
COLLECTIONS = ("maa_stats", "memory_bank", "memory_stats")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _leaf_close(got, want, tol, floor: float = 0.0) -> bool:
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.max(np.abs(want), initial=0.0))
    return (float(np.max(np.abs(got - want), initial=0.0))
            <= tol * max(scale, floor))


@functools.lru_cache(maxsize=None)
def _jax_step():
    """(jitted value_and_grad of the JAX pipeline's _loss, init and
    update of optax's make_adamw with the NaN guard)."""
    import tempfile

    from jax.flatten_util import ravel_pytree

    from sincformer_tpu.agents.metacog import SincformerMetacog as JaxModel
    from sincformer_tpu.train.agent_trainer import SincformerPipeline
    from sincformer_tpu.train.state import guard_nan_update, make_adamw
    model = JaxModel(**NARROW, dropout=0.0, attn_impl="speech",
                     pa_fine_act="mulaw", routing="softmax")
    pipe = SincformerPipeline(model=model, model_dir=tempfile.mkdtemp())

    def loss(params, model_state, noisy, clean, perc, vq, mmse):
        return pipe._loss(params, model_state, noisy, clean,
                          jax.random.PRNGKey(0), True, perc, vq,
                          use_mask_mse=mmse)

    value_and_grad = jax.jit(jax.value_and_grad(loss, has_aux=True))
    tx = make_adamw(LR, EPOCHS, STEPS)

    # optax on the parameters raveled into one vector: the same arithmetic
    # element by element (one global norm, one finiteness check), one
    # small compile instead of one per leaf
    @jax.jit
    def flat_update(flat_params, flat_grads, loss, opt_state):
        grads, bad = guard_nan_update(flat_grads, loss)
        updates, opt_state = tx.update(grads, opt_state, flat_params)
        return optax.apply_updates(flat_params, updates), opt_state, bad

    def update(params, grads, loss, opt_state):
        flat, unravel = ravel_pytree(params)
        new, opt_state, bad = flat_update(flat, ravel_pytree(grads)[0],
                                          loss, opt_state)
        return unravel(new), opt_state, bad

    def init(params):
        return tx.init(ravel_pytree(params)[0])
    return value_and_grad, init, update


def _port(params, model_state, opt_state=None):
    """The port's SincformerTrainer on the CPU from a JAX train state."""
    from sincformer_tpu_torch import SincformerMetacog
    from sincformer_tpu_torch.train.agent_trainer import SincformerTrainer
    from sincformer_tpu_torch.compat.from_jax import \
        load_train_state_from_jax
    named, buffers, opt, config = load_train_state_from_jax(
        params, model_state, opt_state, num_heads=NARROW["num_heads"],
        sinc_kernel_size=NARROW["sinc_kernel_size"], dropout=0.0,
        routing="softmax")
    pipe = SincformerTrainer(SincformerMetacog(config), device="cpu")
    pipe.load_state(named, buffers)
    pipe.init_state(EPOCHS, STEPS, init_params=False)
    if opt is not None:
        pipe.opt_state = opt
    return pipe


def _unravel_opt(opt_state, params):
    """optax's state of the raveled vector, with its moments unraveled into
    the parameter tree, as ``load_train_state_from_jax`` takes it."""
    from jax.flatten_util import ravel_pytree
    unravel = ravel_pytree(params)[1]
    adam = opt_state[1][0]
    return {"count": np.asarray(adam.count),
            "mu": jax.tree.map(np.asarray, unravel(adam.mu)),
            "nu": jax.tree.map(np.asarray, unravel(adam.nu))}


def _batch(seed, nan=False):
    noisy, clean = wave(seed), (wave(seed + 1) * 0.5).astype(np.float32)
    if nan:
        noisy = noisy.copy()
        noisy[1, 100] = np.nan
    return noisy, clean


def _named(tree):
    from sincformer_tpu_torch.compat.from_jax import _named_params
    return _named_params(jax.tree.map(np.asarray, tree), 2)


def _buffers(model_state):
    from sincformer_tpu_torch.compat.from_jax import load_from_jax
    _, v, _ = narrow_model()
    _, buffers, _ = load_from_jax(
        {"params": v["params"], **jax.tree.map(np.asarray, model_state)},
        num_heads=NARROW["num_heads"],
        sinc_kernel_size=NARROW["sinc_kernel_size"])
    return buffers


def _port_step(pipe, noisy, clean, scalars):
    """The port's train step, keeping the gradients for the comparison."""
    from sincformer_tpu_torch.train.state import guard_nan_update
    perc, vq, mmse = scalars
    loss, _, grads = pipe.loss_and_grads(torch.from_numpy(noisy),
                                         torch.from_numpy(clean), perc, vq,
                                         None, mmse)
    params = pipe.params()
    guarded, bad = guard_nan_update(grads, loss, params.values())
    pipe.tx.update(params, guarded, pipe.opt_state)
    pipe.nan_count += bad.to(torch.int32)
    pipe.step += 1
    return loss, dict(zip(params, grads))


def _check_optimizer(pipe, params, grads, loss, opt_state, want):
    """The port's NaN guard and AdamW, given JAX's gradients on a copy of
    the port's state, against optax's parameters: 1e-5 of their scale."""
    import copy

    from sincformer_tpu_torch.train.state import guard_nan_update
    named = {k: torch.from_numpy(np.array(v)) for k, v in
             _named(params).items()}
    opt = copy.deepcopy(pipe.opt_state)
    g = _named(grads)
    guarded, _ = guard_nan_update([torch.from_numpy(np.array(g[k]))
                                   for k in named],
                                  torch.tensor(float(loss)), named.values())
    pipe.tx.update(named, guarded, opt)
    bad = [k for k, w in _named(want).items()
           if not _leaf_close(named[k], w, PARAM_TOL)]
    assert not bad, bad


def _check_step(pipe, params, model_state, opt_state, noisy, clean,
                scalars):
    """One step in both packages from the same state; returns JAX's new
    (params, model_state, opt_state)."""
    value_and_grad, _, update = _jax_step()
    (loss, aux), grads = value_and_grad(
        params, model_state, jnp.asarray(noisy), jnp.asarray(clean),
        *scalars)
    new_params, new_opt, _ = update(params, grads, loss, opt_state)
    _check_optimizer(pipe, params, grads, loss, opt_state, new_params)
    got_loss, got_grads = _port_step(pipe, noisy, clean, scalars)
    assert abs(float(got_loss) - float(loss)) <= LOSS_TOL * abs(float(loss))
    want_grads = _named(grads)
    assert set(want_grads) == set(got_grads)
    floor = GRAD_FLOOR * max(float(np.max(np.abs(g))) for g in
                             want_grads.values())
    bad = [k for k, g in want_grads.items()
           if not _leaf_close(got_grads[k] if got_grads[k] is not None
                              else torch.zeros(g.shape), g, GRAD_TOL, floor)]
    assert not bad, bad
    want_state = _buffers(aux["model_state"])
    got_state = dict(pipe.model.named_buffers())
    for k, w in want_state.items():
        assert np.allclose(_np(got_state[k]), _np(w), rtol=0,
                           atol=STATE_TOL * max(1.0, float(np.max(np.abs(
                               _np(w)))))), k
    want_params, before = _named(new_params), _named(params)
    got_params = pipe.params()
    loose = total = 0
    for k, w in want_params.items():
        g, p0 = np.abs(want_grads[k]), before[k]
        scale = float(np.max(np.abs(w)))
        settled = g > GRAD_TOL * max(float(np.max(g)), floor)
        diff = np.abs(_np(got_params[k]).astype(np.float64) - w)
        assert np.all(diff[settled] <= PARAM_TOL * scale), k
        step = float(np.max(np.abs(w - p0)))
        assert np.all(diff[~settled] <= 2 * step + PARAM_TOL * scale), k
        loose += int(np.sum(~settled))
        total += w.size
    assert loose <= 0.01 * total, (loose, total)
    return new_params, aux["model_state"], new_opt, grads


@pytest.fixture(scope="module")
def start():
    _, v, _ = narrow_model()
    params = jax.tree.map(jnp.asarray, v["params"])
    model_state = {k: jax.tree.map(jnp.asarray, v[k]) for k in COLLECTIONS}
    return params, model_state


def test_stage1_loss_and_gradients(start):
    """The stage-1 setting (perceptual and VQ terms weighted 0, mask MSE
    on): loss and every gradient leaf, CPEA K and b separately."""
    params, model_state = start
    _, init, _ = _jax_step()
    pipe = _port(*start)
    noisy, clean = _batch(3)
    _check_step(pipe, params, model_state, init(params), noisy, clean,
                STAGE1)


def test_two_adamw_steps_and_the_nan_guard(start):
    """Every term on. Step 1 from the shared start, step 2 from JAX's
    carried state (parameters, model_state and AdamW moments bridged), then
    a batch holding a NaN: the gradients are zeroed, the NaN count grows,
    and the parameters move as optax moves them (the moments decay and the
    weight decay acts). The MAA threshold, which no computation reads,
    decays as optax decays it."""
    params, model_state = start
    _, init, _ = _jax_step()
    pipe = _port(params, model_state)
    p1, s1, o1, _ = _check_step(pipe, params, model_state, init(params),
                                *_batch(5), ALL_ON)
    pipe = _port(jax.tree.map(np.asarray, p1), jax.tree.map(np.asarray, s1),
                 _unravel_opt(o1, p1))
    assert pipe.opt_state["count"] == 1
    pipe.step = 1
    p2, s2, o2, _ = _check_step(pipe, p1, s1, o1, *_batch(7), ALL_ON)
    value_and_grad, _, update = _jax_step()
    noisy, clean = _batch(9, nan=True)
    (loss, _), grads = value_and_grad(p2, s2, jnp.asarray(noisy),
                                      jnp.asarray(clean), *ALL_ON)
    p3, _, bad = update(p2, grads, loss, o2)
    assert bool(bad) and not np.isfinite(float(loss))
    pipe = _port(jax.tree.map(np.asarray, p2), jax.tree.map(np.asarray, s2),
                 _unravel_opt(o2, p2))
    before = pipe.params()["maa.threshold"].detach().clone()
    loss_port, _ = _port_step(pipe, noisy, clean, ALL_ON)
    assert not torch.isfinite(loss_port) and int(pipe.nan_count) == 1
    want = _named(p3)
    got = pipe.params()
    bad = [k for k, w in want.items()
           if not _leaf_close(got[k], w, PARAM_TOL)]
    assert not bad, bad
    threshold = float(got["maa.threshold"].detach()[0])
    assert threshold != float(before[0])
    assert abs(threshold - float(np.asarray(p3["maa"]["threshold"])[0])) \
        <= 1e-7


# ── the pieces of a step ───────────────────────────────────────────────────

def _maa_inputs():
    _, v, tm = narrow_model()
    sigma = np.random.default_rng(20).uniform(0.2, 2.0, (2, 1, 50)).astype(
        np.float32)
    weight = np.random.default_rng(21).standard_normal((2, 50, 4)).astype(
        np.float32)
    return v, tm, sigma, weight


@pytest.mark.parametrize("routing", ["gumbel", "softmax"])
def test_maa_training_routing(routing):
    """Gumbel straight-through on the same uniforms (the port is given the
    JAX draw), or softmax: the route identical, the probabilities and the
    gradients of Σ route·w within 1e-5, the EMA statistics after two
    training calls within 1e-6."""
    import copy

    from sincformer_tpu.agents.maa import MetacognitiveArbitrationAgent
    v, tm, sigma, weight = _maa_inputs()
    key = jax.random.PRNGKey(3)
    jmaa = MetacognitiveArbitrationAgent(routing=routing)
    pmaa = copy.deepcopy(tm.maa)
    pmaa.routing = routing
    stats = v["maa_stats"]["maa"]

    def jax_f(params, stats, sigma):
        out, new = jmaa.apply({"params": params, "maa_stats": stats}, sigma,
                              train=True, rng_key=key, tau=0.7,
                              mutable=["maa_stats"])
        return jnp.sum(out["route"] * weight), (out, new["maa_stats"])

    (f1, (out1, st1)), g1 = jax.jit(jax.value_and_grad(
        jax_f, argnums=(0, 2), has_aux=True))(v["params"]["maa"], stats,
                                               sigma)
    uniform = torch.from_numpy(np.array(jax.random.uniform(
        key, (2, 50, 4), minval=1e-10, maxval=1.0)))
    s = torch.from_numpy(sigma).requires_grad_(True)
    out = pmaa(s, train=True, tau=0.7, uniform=uniform)
    f = torch.sum(out["route"] * torch.from_numpy(weight))
    grads = torch.autograd.grad(f, [s] + [pmaa.get_parameter(n) for n in
                                          ("fc1.weight", "fc2.weight",
                                           "fc3.weight", "fc3.bias")])
    np.testing.assert_array_equal(_np(out["route"]).argmax(-1),
                                  np.asarray(out1["route"]).argmax(-1))
    assert np.max(np.abs(_np(out["route"]) - np.asarray(out1["route"]))) \
        <= 1e-6
    np.testing.assert_array_equal(_np(out["decisions"]),
                                  np.asarray(out1["decisions"]))
    assert _leaf_close(out["probs"], out1["probs"], 1e-5)
    assert abs(float(f.detach()) - float(f1)) <= 1e-5 * max(1.0,
                                                            abs(float(f1)))
    want = [g1[1], g1[0]["fc1"]["kernel"].T, g1[0]["fc2"]["kernel"].T,
            g1[0]["fc3"]["kernel"].T, g1[0]["fc3"]["bias"]]
    for got_g, want_g in zip(grads, want):
        assert _leaf_close(got_g, want_g, 1e-5)
    (_, (_, st2)), _ = jax.jit(jax.value_and_grad(
        jax_f, argnums=(0, 2), has_aux=True))(v["params"]["maa"], st1,
                                               sigma * 1.3)
    pmaa(torch.from_numpy(sigma * 1.3), train=True, tau=0.7,
         uniform=uniform)
    for name in ("running_mean", "running_var"):
        assert abs(float(getattr(pmaa, name)) - float(st2[name])) \
            <= STATE_TOL
    assert int(pmaa.num_updates) == int(st2["num_updates"]) == 11


def test_memory_write_path():
    """Two training calls: the first embedding is far from every stored key
    (the least recently used slot is overwritten), the second is the same
    environment again (an EMA into that slot). Bank, ages and usage
    counters within 1e-6, the read outputs within 1e-5."""
    import copy

    from sincformer_tpu.agents.memory import EpisodicMemory
    _, v, tm = narrow_model()
    d = NARROW["encoder_channels"]
    jmem = EpisodicMemory(d, 129, NARROW["memory_slots"],
                          episodic_slots=NARROW["episodic_slots"])
    pmem = copy.deepcopy(tm.memory)
    rng = np.random.default_rng(22)
    emb = rng.standard_normal((2, d)).astype(np.float32)
    value = rng.uniform(0, 1, (2, 129)).astype(np.float32)
    state = {"memory_bank": v["memory_bank"]["memory"],
             "memory_stats": v["memory_stats"]["memory"]}
    call = jax.jit(lambda st, e, w: jmem.apply(
        {"params": v["params"]["memory"], **st}, e, train=True,
        write_value=w, mutable=["memory_bank", "memory_stats"]))
    for e, w in ((emb, value), (emb * 1.01, value * 0.5)):
        out, new = call(state, e, w)
        state = dict(new)
        got = pmem(torch.from_numpy(e), train=True,
                   write_value=torch.from_numpy(w))
        for k in ("bias", "gate"):
            assert _leaf_close(got[k], out[k], 1e-5), k
        np.testing.assert_array_equal(_np(got["top_indices"]),
                                      np.asarray(out["top_indices"]))
        for port_name, jax_name, coll in (
                ("bank_keys", "keys", "memory_bank"),
                ("bank_values", "values", "memory_bank"),
                ("bank_age", "age", "memory_bank"),
                ("usage_count", "usage_count", "memory_stats"),
                ("num_queries", "num_queries", "memory_stats")):
            want = np.asarray(state[coll][jax_name], np.float64)
            diff = np.abs(_np(getattr(pmem, port_name)) - want)
            assert np.max(diff) <= STATE_TOL * max(1.0, np.max(np.abs(want))
                                                   ), port_name
    ages = _np(pmem.bank_age)
    assert ages[3] == 0 and np.all(ages[:3] == np.arange(3) + 2)


def test_dropout_masks():
    """The same generator seed draws the same mask; the keep rate is within
    3σ of 1 - p and the kept values are scaled by 1/(1 - p); p = 0 and no
    generator are the identity."""
    from sincformer_tpu_torch.models.conformer import dropout
    x = torch.ones(64, 1000)
    p = 0.1
    a = dropout(x, p, torch.Generator().manual_seed(5))
    b = dropout(x, p, torch.Generator().manual_seed(5))
    c = dropout(x, p, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = (a != 0).float()
    n = kept.numel()
    assert abs(float(kept.mean()) - (1 - p)) <= 3 * (p * (1 - p) / n) ** 0.5
    assert torch.allclose(a[a != 0], torch.full_like(a[a != 0], 1 / (1 - p)))
    y = torch.randn(4, 5)
    assert dropout(y, 0.0, torch.Generator()) is y and dropout(y, p, None) is y


def test_recurrent_init_is_orthogonal():
    """Each (H, H) gate block of the CPEA's recurrent kernels is orthogonal,
    as flax draws it; the input kernels keep the N(0, 1/fan_in) scale and
    the biases start at zero."""
    from sincformer_tpu_torch import MetacogConfig, SincformerMetacog
    cfg = MetacogConfig(**NARROW)
    model = SincformerMetacog(cfg).init_params(torch.Generator().manual_seed(1))
    h = cfg.cpea_hidden
    blocks = 0
    for name, p in model.named_parameters():
        if ".kernel_hh" in name:
            for g in range(4):
                w = p[g * h:(g + 1) * h].double()
                assert torch.allclose(w.T @ w, torch.eye(h, dtype=w.dtype),
                                      atol=1e-5), name
                blocks += 1
        elif name.startswith("cpea.lstm.bias"):
            assert torch.count_nonzero(p) == 0
        elif name.startswith("cpea.lstm.weight_ih"):
            assert 0.5 < float(p.detach().std()) * p.shape[1] ** 0.5 < 1.5
    assert blocks == 4 * 4
    sd = model.state_dict()
    assert torch.equal(sd["cpea.lstm.weight_hh_l0"],
                       model.cpea.lstm.kernel_hh_l0)


# ── the backward of K1 and K3 ──────────────────────────────────────────────

@pytest.mark.parametrize("masked", [False, True])
def test_speech_attention_gradients_match_jax(masked):
    """The port's K1 under autograd (the plain formulation's backward, as
    the JAX custom VJP) against jax.grad of the JAX function on the CPU."""
    from sincformer_tpu.ops.speech_attention import speech_attention as jsa
    from sincformer_tpu_torch.ops.speech_attention import speech_attention
    rng = np.random.default_rng(30)
    q, k, v = (rng.standard_normal((2, 50, 2, 16)).astype(np.float32) * 0.5
               for _ in range(3))
    w = rng.standard_normal(q.shape).astype(np.float32)
    bias = (np.where(np.arange(50)[None] < np.array([[50], [31]]), 0.0, -1e9)
            .astype(np.float32) if masked else None)
    jb = None if bias is None else jnp.asarray(bias)
    want = jax.jit(jax.grad(lambda q, k, v: jnp.sum(jsa(q, k, v, jb) * w),
                            argnums=(0, 1, 2)))(q, k, v)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = speech_attention(*leaves, None if bias is None
                           else torch.from_numpy(bias))
    got = torch.autograd.grad(torch.sum(out * torch.from_numpy(w)), leaves)
    for g, want_g in zip(got, want):
        assert _leaf_close(g, want_g, GRAD_TOL)


def test_fused_ffn_gradients_match_jax():
    """FeedForwardModule(fused=True) under autograd: every parameter gets
    its gradient (the weights reach the kernel's function with their
    gradient, not as detached copies), within 1e-5 of jax.grad of the JAX
    package's fused_ffn."""
    from sincformer_tpu.ops.fused_ffn import fused_ffn as jffn
    from sincformer_tpu_torch.models.conformer import FeedForwardModule
    rng = np.random.default_rng(31)
    d, d_ff = 32, 64
    ffn = FeedForwardModule(d, d_ff, fused=True)
    with torch.no_grad():
        for p in ffn.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(
                np.float32)) * 0.2 + (1.0 if p.ndim == 1 and p is
                                      ffn.LayerNorm_0.weight else 0.0))
    x = rng.standard_normal((2, 40, d)).astype(np.float32)
    w = rng.standard_normal((2, 40, d)).astype(np.float32)
    names = ("LayerNorm_0.weight", "LayerNorm_0.bias", "Dense_0.weight",
             "Dense_0.bias", "Dense_1.weight", "Dense_1.bias")
    p = {n: ffn.get_parameter(n).detach().numpy() for n in names}
    want = jax.jit(jax.grad(lambda x, g, b, w1, b1, w2, b2: jnp.sum(
        jffn(x, g, b, w1, b1, w2, b2) * w), argnums=tuple(range(7))))(
        x, p[names[0]], p[names[1]], p[names[2]].T, p[names[3]],
        p[names[4]].T, p[names[5]])
    xt = torch.from_numpy(x).requires_grad_(True)
    got = torch.autograd.grad(torch.sum(ffn(xt) * torch.from_numpy(w)),
                              [xt] + [ffn.get_parameter(n) for n in names])
    want = list(want)
    want[3], want[5] = want[3].T, want[5].T
    for g, want_g in zip(got, want):
        assert _leaf_close(g, want_g, 1e-5)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
def test_cuda_speech_attention_autograd(masked):
    """On the card: the kernel's forward under autograd, one launch per
    forward, and q/k/v gradients equal to the plain version's autograd (the
    same plain backward on the same inputs)."""
    _cuda_or_skip()
    from sincformer_tpu_torch.ops.speech_attention import (
        _speech_attention_plain, speech_attention)
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(4, 400, 4, 64, device="cuda", generator=g)
               for _ in range(3))
    bias = None
    if masked:
        valid = torch.arange(400, device="cuda")[None] < torch.tensor(
            [[400], [390], [200], [1]], device="cuda")
        bias = torch.where(valid, 0.0, -1e9).float().contiguous()
    cot = torch.randn(q.shape, device="cuda", generator=g)
    before = speech_attention.launches
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = speech_attention(*leaves, bias)
    got = torch.autograd.grad(out, leaves, cot)
    assert speech_attention.launches == before + 1
    ref_leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = _speech_attention_plain(*ref_leaves, bias)
    want = torch.autograd.grad(ref, ref_leaves, cot)
    assert float((out - ref).abs().max()) <= 1e-5
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_fused_ffn_autograd():
    """On the card: K3's forward under autograd and the plain formula's
    gradients, equal to the plain version's autograd."""
    _cuda_or_skip()
    from sincformer_tpu_torch.ops.fused_ffn import _fused_ffn_plain, fused_ffn
    g = torch.Generator(device="cuda").manual_seed(1)
    d, d_ff = 256, 1024
    args = [torch.randn(8, 400, d, device="cuda", generator=g),
            1.0 + 0.1 * torch.randn(d, device="cuda", generator=g),
            0.1 * torch.randn(d, device="cuda", generator=g),
            torch.randn(d, d_ff, device="cuda", generator=g) / d ** 0.5,
            0.1 * torch.randn(d_ff, device="cuda", generator=g),
            torch.randn(d_ff, d, device="cuda", generator=g) / d_ff ** 0.5,
            0.1 * torch.randn(d, device="cuda", generator=g)]
    cot = torch.randn(8, 400, d, device="cuda", generator=g)
    before = fused_ffn.launches
    leaves = [a.clone().requires_grad_(True) for a in args]
    out = fused_ffn(*leaves)
    got = torch.autograd.grad(out, leaves, cot)
    assert fused_ffn.launches == before + 1
    ref_leaves = [a.clone().requires_grad_(True) for a in args]
    ref = _fused_ffn_plain(*ref_leaves)
    want = torch.autograd.grad(ref, ref_leaves, cot)
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    for a, b in zip(got, want):
        assert torch.equal(a, b)
