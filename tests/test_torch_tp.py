"""Tensor parallelism and ``remat`` in the port against the JAX package, on
the CPU.

The plan: ``parallel/sharding.py`` splits exactly the leaves that JAX's
``tp_param_shardings`` splits (``tp_spec`` on each JAX-layout leaf), on
the narrow and the full-width flagship and DCSE (94 of 268 and 37 of 130
leaves at full width, the JAX trees from ``jax.eval_shape``), each split
on the port's dimension of the JAX leaf's output features.

Two gloo ranks on a (1, 2) ("data", "model") mesh
(``tests/_torch_dp_worker.py``, jobs in ``tests/_torch_tp_jobs.py``), each
with the whole batch, against JAX's unsharded step: the narrow DCSE of
JAX's tensor-parallel test (``tests/test_distributed.py``: 1 block, d 64,
d_ff 128, 2 heads, k 7, 8 × 4000) with the whole loss within 1e-4 (JAX's
bar) and the loss, gradients and AdamW step at
``tests/test_torch_dcse_train.py``'s bars; the narrow flagship's
adversarial step at ``tests/test_torch_data_parallel.py``'s bars (those
of ``tests/test_torch_train_step.py`` and
``tests/test_torch_adversarial.py``). Each rank holds half of each split
leaf; the gathered parameters are bit-equal on the two ranks; a gather
whose backward sums the ranks' gradients (``torch.distributed.nn``'s
all_gather) misses the gradient bar. A checkpoint the two ranks write is
the unsharded format with the gathered values, and a resume re-shards
it.

``remat`` (one process): the narrow DCSE ("batch" norm) with
``remat=True`` against JAX's ``remat=True`` step at
``tests/test_torch_dcse_train.py``'s bars (dropout 0: JAX's dropout masks
come from another generator), and, with dropout 0.15, bit-equal to the
port's ``remat=False`` step; a recompute that does not replay the dropout
generator must differ."""

import tempfile
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import _torch_dp_worker as worker
from tests._torch_parity import NARROW, NARROW_DCSE, Ahead, narrow_dcse, \
    narrow_model

# JAX's tensor-parallel DCSE case (tests/test_distributed.py:130)
TP_SIZES = (("d_model", 64), ("num_blocks", 1), ("d_ff", 128))
TP_BATCH = (8, 4000)
JAX_LOSS_TOL = 1e-4


def _tp_batch():
    rng = np.random.default_rng(0)
    return (rng.standard_normal(TP_BATCH).astype(np.float32),
            rng.standard_normal(TP_BATCH).astype(np.float32))


def _jax_tp_dcse():
    """JAX's unsharded DCSE step at TP_SIZES on the whole batch: (loss
    without the MR-STFT term, whole loss, its global gradient norm,
    gradients, new parameters)."""
    from tests.test_torch_dcse_train import _jax_fns, _variables
    value_and_grad, _, init, update = _jax_fns("layer", TP_SIZES)
    params = jax.tree.map(jnp.asarray, _variables("layer",
                                                  TP_SIZES)["params"])
    noisy, clean = _tp_batch()
    ((loss, _), grads), (whole, whole_norm) = value_and_grad(
        params, None, jnp.asarray(noisy), jnp.asarray(clean))
    new_params, _, _ = update(params, grads, loss, init(params))
    return jax.tree.map(np.asarray, (float(loss), float(whole),
                                     float(whole_norm), grads, new_params))


def _jax_split_leaves(which: str):
    """{JAX path: split?} by JAX's ``tp_spec`` over 2 shards, for the
    narrow or full-width flagship or DCSE tree."""
    from sincformer_tpu.parallel.sharding import tp_spec
    from jax.sharding import PartitionSpec as P
    if which == "narrow_flagship":
        tree = narrow_model()[1]["params"]
    elif which == "narrow_dcse":
        tree = narrow_dcse()["params"]
    elif which == "flagship":
        from sincformer_tpu.train.agent_trainer import default_metacog
        model = default_metacog()
        wav, spec = jnp.zeros((1, 800)), jnp.zeros((1, 11, 129))
        tree = jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0), wav, spec, spec, train=False))["params"]
    else:
        from sincformer_tpu.models.dcse import default_speech_enhancer
        spec = jnp.zeros((1, 11, 129))
        tree = jax.eval_shape(lambda: default_speech_enhancer().init(
            jax.random.PRNGKey(0), spec, spec))["params"]
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = tuple(getattr(k, "key", str(k)) for k in path)
        out[keys] = tp_spec(leaf, 2) != P()
    return out


def _jax_remat_compiled() -> bool:
    """JAX's ``remat=True`` DCSE step compiled on the remat test's inputs
    (``_jax_fns`` keeps the jitted functions, so the test reuses them)."""
    from tests.test_torch_dcse_train import _batch, _jax_fns, _variables
    value_and_grad, _, init, update = _jax_fns("batch", (), True)
    v = _variables("batch")
    params = jax.tree.map(jnp.asarray, v["params"])
    noisy, clean = _batch(5)
    ((loss, _), grads), _ = value_and_grad(
        params, {"batch_stats": jax.tree.map(jnp.asarray, v["batch_stats"])},
        jnp.asarray(noisy), jnp.asarray(clean))
    jax.block_until_ready(update(params, grads, loss, init(params)))
    return True


@pytest.fixture(scope="module")
def ahead(tmp_path_factory):
    """The ranks' job, queued first; JAX's references and trees on two
    threads meanwhile."""
    import sincformer_tpu.parallel.sharding  # noqa: F401
    import sincformer_tpu.train.agent_trainer  # noqa: F401
    import sincformer_tpu.train.dcse_trainer  # noqa: F401
    import tests.test_torch_adversarial  # noqa: F401
    import tests.test_torch_data_parallel as dp
    import tests.test_torch_dcse_train as dt
    out_dir = str(tmp_path_factory.mktemp("tp"))
    _, v, _ = narrow_model()
    noisy, clean = _tp_batch()
    ticket = worker.pool().submit({
        "kind": "tp", "mesh": (("data", "model"), (1, 2)),
        "dcse": {"noisy": noisy, "clean": clean,
                 "variables": {"layer": dt._variables("layer", TP_SIZES)},
                 "num_heads": NARROW_DCSE["num_heads"]},
        "flagship": {"variables": v, "dvars": dp._jax_disc_vars(),
                     "noisy": dp._flagship_batch()[0],
                     "clean": dp._flagship_batch()[1],
                     "num_heads": NARROW["num_heads"],
                     "sinc_kernel_size": NARROW["sinc_kernel_size"]}},
        out_dir)
    a = Ahead()
    with a.start([(_jax_split_leaves, "flagship"), (_jax_remat_compiled,),
                  (_jax_tp_dcse,), (_jax_split_leaves, "dcse"),
                  (dp._jax_flagship,)]):
        a.ranks = ticket
        yield a


# ── the plan ─────────────────────────────────────────────────────────────

def test_tp_spec_is_jax_rule():
    """JAX's cases (tests/test_distributed.py) and a few more, both
    packages: a leaf of two or more dimensions splits its last when it is
    at least 64 and the shard count divides it."""
    from sincformer_tpu.parallel.sharding import tp_spec as jax_spec
    from sincformer_tpu_torch.parallel.sharding import tp_spec
    cases = {((256, 1024), 2): (None, "model"),
             ((31, 1, 256), 2): (None, None, "model"),
             ((256,), 2): (), ((16, 31), 2): (), ((64, 96), 5): (),
             ((3, 129), 2): (), ((1, 64), 2): (None, "model")}
    for (shape, n), want in cases.items():
        assert tp_spec(shape, n) == want, shape
        assert tuple(jax_spec(jnp.zeros(shape), n)) == want, shape


def _port_name(path: tuple) -> tuple:
    """(port parameter, the port's split) of a JAX leaf: a folded LSTM
    gate matrix splits its four row blocks, a kernel its dim 0, any other
    leaf its last dim."""
    from sincformer_tpu_torch.compat.from_jax import _param_leaf
    from sincformer_tpu_torch.parallel.sharding import Split
    if path[0] == "cpea" and path[1].startswith("LSTMCell_"):
        layer, direction = divmod(int(path[1][len("LSTMCell_"):]), 2)
        kind = ("bias_hh" if path[-1] == "bias" else
                "weight_ih" if path[2].startswith("i") else "kernel_hh")
        name = f"cpea.lstm.{kind}_l{layer}{'_reverse' if direction else ''}"
        return name, Split(0, 4)
    leaf, _ = _param_leaf(path, np.zeros((1,) * (3 if path[-1] == "kernel"
                                                 else 1)))
    return ".".join(path[:-1] + (leaf,)), (
        Split(0, 1) if path[-1] == "kernel" else None)


def _port_model(which: str):
    from sincformer_tpu_torch import (DCSEConfig, MetacogConfig,
                                      SincformerMetacog, SpeechEnhancer)
    sizes = {"narrow_flagship": ("flagship", dict(NARROW)),
             "narrow_dcse": ("dcse", dict(NARROW_DCSE)),
             "flagship": ("flagship", {}), "dcse": ("dcse", {})}[which]
    with torch.device("meta"):
        if sizes[0] == "flagship":
            return SincformerMetacog(MetacogConfig(**sizes[1]))
        kw = dict(sizes[1])
        if "d_ff" in kw:
            kw["ff_dim"] = kw.pop("d_ff")
        return SpeechEnhancer(DCSEConfig(**kw))


def _check_plan(which: str, jax_leaves: dict) -> None:
    """The port's plan splits a parameter exactly where JAX splits the
    leaves it holds, on the port's dimension of their output features;
    every port parameter is some JAX leaf."""
    from sincformer_tpu_torch.parallel.sharding import tp_param_shardings
    model = _port_model(which)
    plan = tp_param_shardings(model, 2)
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    seen = set()
    for path, split in jax_leaves.items():
        name, port_split = _port_name(path)
        assert name in plan, (path, name)
        seen.add(name)
        if not split:
            if not (path[0] == "cpea" and path[-1] == "bias"):
                assert plan[name] is None, (path, plan[name])
            continue
        if port_split is None:          # a leaf kept in JAX's layout
            port_split = (len(shapes[name]) - 1, 1)
        assert tuple(plan[name]) == tuple(port_split), (path, plan[name])
    assert seen == set(plan)


@pytest.mark.parametrize("which", ["narrow_flagship", "narrow_dcse"])
def test_plan_splits_the_leaves_jax_splits(which, ahead):
    """The narrow trees of the parity tests (``tests/_torch_parity.py``)."""
    _check_plan(which, _jax_split_leaves(which))


# ── remat ────────────────────────────────────────────────────────────────

def _remat_pair(dropout: float):
    """Two narrow DCSE trainers ("batch" norm, the same weights and seed),
    ``remat`` False and True."""
    from sincformer_tpu_torch.compat.from_jax import \
        load_dcse_train_state_from_jax
    from sincformer_tpu_torch.models.dcse import SpeechEnhancer
    from sincformer_tpu_torch.train.dcse_trainer import DCSETrainer
    from tests.test_torch_dcse_train import EPOCHS, STEPS, _variables
    v = _variables("batch")
    pipes = []
    for remat in (False, True):
        named, buffers, _, config = load_dcse_train_state_from_jax(
            v["params"], v["batch_stats"], None,
            num_heads=NARROW_DCSE["num_heads"], dropout=dropout, remat=remat)
        pipe = DCSETrainer(SpeechEnhancer(config), device="cpu",
                           model_dir=tempfile.mkdtemp(), seed=3)
        pipe.load_state(named, buffers)
        pipe.init_state(EPOCHS, STEPS, init_params=False)
        pipes.append(pipe)
    return pipes


def _grads_and_state(pipe, noisy, clean):
    loss, _, grads = pipe.loss_and_grads(torch.from_numpy(noisy),
                                         torch.from_numpy(clean))
    return loss, grads, {k: b.clone() for k, b in pipe.model.named_buffers()}


def test_remat_is_bit_equal_and_matches_jax(ahead):
    """With dropout 0.15 and a training BatchNorm, ``remat=True`` gives the
    ``remat=False`` loss, gradients and running statistics bit for bit
    (the recompute replays the dropout generator and steps the statistics
    once); without the replay the gradients differ. At dropout 0 the
    ``remat=True`` step meets ``tests/test_torch_dcse_train.py``'s bars
    against JAX's ``remat=True`` step."""
    import jax.numpy as jnp

    import sincformer_tpu_torch.models.dcse as dcse
    from tests.test_torch_dcse_train import (_batch, _check_step, _jax_fns,
                                             _port, _variables)
    noisy, clean = _batch(5, padded=True)
    plain, remat = _remat_pair(0.15)
    want = _grads_and_state(plain, noisy, clean)
    got = _grads_and_state(remat, noisy, clean)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    assert all(torch.equal(got[2][k], b) for k, b in want[2].items())
    assert torch.equal(plain.dropout_generator.get_state(),
                       remat.dropout_generator.get_state())

    def no_replay(block, x, mask, generator):
        return torch.utils.checkpoint.checkpoint(
            lambda x_: block(x_, mask, generator), x, use_reentrant=False)
    _, remat = _remat_pair(0.15)
    with mock.patch.object(dcse, "rematerialised", no_replay):
        planted = _grads_and_state(remat, noisy, clean)
    worst = max(float((a - b).abs().max()) for a, b in
                zip(planted[1], want[1]))
    print(f"remat without the generator replay: gradients {worst:.3g} off")
    assert worst > 0.0

    v = _variables("batch")
    params = jax.tree.map(jnp.asarray, v["params"])
    stats = jax.tree.map(jnp.asarray, v["batch_stats"])
    assert ahead(_jax_remat_compiled)
    init = _jax_fns("batch", (), True)[2]
    pipe = _port(v["params"], v["batch_stats"], remat=True)
    assert pipe.model.config.remat
    _check_step("batch", pipe, params, {"batch_stats": stats}, init(params),
                *_batch(5), remat=True)


@pytest.mark.parametrize("which,split,leaves", [("flagship", 94, 268),
                                                 ("dcse", 37, 130)])
def test_full_width_plan_splits_the_leaves_jax_splits(which, split, leaves,
                                                      ahead):
    """The full-width trees (``MetacogConfig()``, ``DCSEConfig()``; JAX's
    from ``jax.eval_shape``): 94 of 268 leaves split (the flagship), 37 of
    130 (DCSE)."""
    jax_leaves = ahead(_jax_split_leaves, which)
    assert (sum(jax_leaves.values()), len(jax_leaves)) == (split, leaves)
    _check_plan(which, jax_leaves)


# ── two ranks ────────────────────────────────────────────────────────────

def test_dcse_tp_step_matches_jax(ahead):
    """JAX's tensor-parallel DCSE case on a (1, 2) mesh: the whole loss
    within 1e-4 of JAX's unsharded step, the loss without the MR-STFT
    term, its gradients and the AdamW step at
    ``tests/test_torch_dcse_train.py``'s bars; each rank holds
    half of every split leaf (the plan's); the ranks' gathered parameters
    are bit-equal; a gather whose backward sums the ranks' gradients
    scales the split leaves' gradients by 2 and misses the bar; a forward of
    the split model outside ``model_parallel`` raises."""
    from sincformer_tpu_torch.compat.from_jax import _dcse_named
    from sincformer_tpu_torch.parallel.sharding import tp_param_shardings
    from tests.test_torch_data_parallel import (LOSS_TOL, _grad_ratio,
                                                _param_ratio, _ranks_equal)
    from tests.test_torch_dcse_train import _variables
    outs = ahead.ranks.result()
    loss, whole, _, grads, new_params = ahead(_jax_tp_dcse)
    got = outs[0]["dcse"]
    assert abs(got["whole"] - whole) < JAX_LOSS_TOL, (got["whole"], whole)
    want_grads = {k: np.asarray(g, np.float64)
                  for k, g in _dcse_named(grads).items()}
    ratios = {
        "loss": abs(got["loss"] - loss) / (LOSS_TOL * abs(loss)),
        "grads": _grad_ratio(got["grads"], want_grads),
        "params": _param_ratio(
            got["params"], {k: np.asarray(w, np.float64) for k, w in
                            _dcse_named(new_params).items()},
            _dcse_named(_variables("layer", TP_SIZES)["params"]),
            want_grads)}
    print(f"TP DCSE: {ratios}")
    assert max(ratios.values()) <= 1.0, ratios
    summing = _grad_ratio(outs[0]["summing_gather"]["grads"], want_grads)
    print(f"summing gather: gradient error {summing:.3g} x the bar")
    assert summing > 1.0
    _ranks_equal([o["dcse"] for o in outs], ("params",))
    from sincformer_tpu_torch.models.dcse import SpeechEnhancer
    from sincformer_tpu_torch import DCSEConfig
    with torch.device("meta"):
        plan = tp_param_shardings(SpeechEnhancer(DCSEConfig(
            d_model=64, num_blocks=1, num_heads=2, ff_dim=128,
            kernel_size=7)), 2)
    for o in outs:
        assert "model_parallel" in o["outside"], o["outside"]
        assert set(o["storage"]) == {k for k, s in plan.items() if s}
        assert all(2 * mine == whole_ for mine, whole_ in
                   o["storage"].values()), o["storage"]


def test_flagship_tp_step_matches_jax(ahead):
    """The narrow flagship's adversarial step on a (1, 2) mesh against
    JAX's unsharded step, at the data-parallel test's bars; the ranks'
    gathered parameters, buffers and discriminators bit-equal."""
    import tests.test_torch_data_parallel as dp
    outs = ahead.ranks.result()
    got = [o["flagship"] for o in outs]
    dp._ranks_equal(got, ("params", "buffers", "disc_params"))
    ratios = dp._flagship_ratios(got[0], ahead(dp._jax_flagship))
    print(f"TP flagship: {ratios}")
    assert max(ratios.values()) <= 1.0, ratios


def test_tp_checkpoint_round_trip(ahead):
    """The checkpoint two model ranks write: the first rank alone writes,
    in the unsharded format (every key and shape of a one-process
    trainer's checkpoint), with the gathered parameters and AdamW moments
    bit for bit; a resume re-shards it (each rank half of every split
    leaf) and gathers to the same values."""
    from tests.test_torch_dcse_train import _port, _variables
    outs = ahead.ranks.result()
    assert outs[1]["saved"] is None and outs[0]["saved"]
    written = outs[0]["written"]
    one = _port(_variables("layer", TP_SIZES)["params"])
    one.step = 1
    want = one._checkpoint_state(False)
    assert {k: tuple(v.shape) for k, v in written["params"].items()} == {
        k: tuple(v.shape) for k, v in want["params"].items()}
    assert set(written["opt_state"]["mu"]) == set(want["opt_state"]["mu"])
    assert set(written["model_state"]) == set(want["model_state"])
    for k, v in outs[0]["dcse"]["params"].items():
        assert torch.equal(written["params"][k], v), k
    for m in ("mu", "nu"):
        for k, v in outs[0]["opt"][m].items():
            assert torch.equal(written["opt_state"][m][k], v), (m, k)
    for o in outs:
        r = o["resumed"]
        assert r["step"] == 1
        assert all(2 * mine == whole_ for mine, whole_ in
                   r["storage"].values())
        assert set(r["storage"]) == set(o["storage"])
        for k, v in outs[0]["dcse"]["params"].items():
            assert torch.equal(r["params"][k], v), k
        for k, v in outs[0]["opt"]["mu"].items():
            assert torch.equal(r["mu"][k], v), k
