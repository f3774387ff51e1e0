"""Kernels K5 (conv + GroupNorm) and K6 (activation + envelope) under
autograd: on a CUDA tensor each wrapper's output carries a ``grad_fn`` whose
backward is the plain version's gradient, recomputed, as JAX's
``custom_vjp``s are. Here, on the CPU, the same ``autograd.Function`` runs
with the plain version standing in for the kernel's forward: its gradients
must be the plain version's bit for bit (``skip``'s only when it is given),
and JAX's ``custom_vjp`` backward on the same inputs and cotangent
(``conv1d_gn`` with and without ``skip``, ``env_act``'s) within each
kernel's bar of each gradient's scale (K5 1e-5, K6 3e-6: float32 on both
sides, the weight's and the scale's gradients summed over 1,600 rows in
another order). On the card the gradients are held against the plain
version's at the same bars."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sincformer_tpu.ops import conv_gn_pallas as jax_conv_gn
from sincformer_tpu.ops import envact_pallas as jax_envact
from sincformer_tpu_torch.ops import conv_gn, envact
from tests._torch_parity import Ahead

K5_TOL = 1e-5
K6_TOL = 3e-6
# (T, Cin, Cout, k, stride, groups, act, skip): a PA block's conv, its
# strided skip conv, a GELU-free conv with the residual
K5_CASES = [(200, 16, 32, 5, 1, 8, True, False),
            (200, 16, 32, 1, 2, 8, False, False),
            (150, 32, 32, 3, 1, 4, True, True)]
AHEAD = Ahead()


def _k5_arrays(t, cin, cout, k, stride, with_skip, seed=0):
    """The inputs, then the cotangent, as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    t_out = -(-t // stride)
    arrays = [rng.standard_normal((2, t, cin)),
              rng.standard_normal((k, cin, cout)) / np.sqrt(k * cin),
              0.1 * rng.standard_normal(cout),
              1.0 + 0.1 * rng.standard_normal(cout),
              0.1 * rng.standard_normal(cout)]
    if with_skip:
        arrays.append(rng.standard_normal((2, t_out, cout)))
    arrays.append(rng.standard_normal((2, t_out, cout)))
    return [a.astype(np.float32) for a in arrays]


def _k5_inputs(t, cin, cout, k, stride, with_skip, device):
    *args, cot = _k5_arrays(t, cin, cout, k, stride, with_skip)
    return ([torch.from_numpy(a).to(device).requires_grad_(True)
             for a in args], torch.from_numpy(cot).to(device))


def _k5_grads(fn, args, cot, stride, groups, act, with_skip):
    out = fn(*args[:5], args[5] if with_skip else None, stride=stride,
             groups=groups, act=act)
    return out, torch.autograd.grad(out, args, cot)


def _k6_arrays(seed=0):
    rng = np.random.default_rng(seed)
    return [(3 * rng.standard_normal((2, 800, 64))).astype(np.float32),
            rng.uniform(0.5, 2.0, 64).astype(np.float32),
            rng.standard_normal((2, 800, 64)).astype(np.float32),
            rng.standard_normal((2, 100, 64)).astype(np.float32)]


def _k6_inputs(device):
    x, scale, *cots = _k6_arrays()
    return ([torch.from_numpy(a).to(device).requires_grad_(True)
             for a in (x, scale)],
            tuple(torch.from_numpy(c).to(device) for c in cots))


def _k6_grads(fn, args, cots):
    y, env = fn(*args)
    return (y, env), torch.autograd.grad((y, env), args, cots)


def _k5_jax(case):
    """``jax.vjp`` of JAX's ``conv1d_gn`` (its ``custom_vjp`` backward:
    the reference formulation's gradient) on the case's inputs."""
    t, cin, cout, k, stride, groups, act, with_skip = case
    *args, cot = _k5_arrays(t, cin, cout, k, stride, with_skip)
    args = [jnp.asarray(a) for a in args]

    def f(*a):
        return jax_conv_gn.conv1d_gn(*a[:5], a[5] if with_skip else None,
                                     stride, groups, 1e-6, act)
    _, pull = jax.vjp(f, *args)
    return [np.asarray(g) for g in pull(jnp.asarray(cot))]


def _k6_jax():
    """JAX's ``custom_vjp`` backward of the K6 kernel (``_env_act_bwd``)
    on the same inputs and cotangents."""
    x, scale, *cots = (jnp.asarray(a) for a in _k6_arrays())
    return [np.asarray(g) for g in jax_envact._env_act_bwd(
        (x, scale), tuple(cots))]


@pytest.fixture(scope="module")
def ahead():
    with AHEAD.start([(_k5_jax, case) for case in K5_CASES]
                     + [(_k6_jax,)]):
        yield AHEAD


def _k5_function(monkeypatch):
    """``_ConvGN.apply`` with the plain forward in the kernel's place."""
    monkeypatch.setattr(conv_gn, "_forward", lambda *a: conv_gn.
                        conv_gn_reference(*a[:6], stride=a[6], groups=a[7],
                                          eps=a[8], act=a[9]).detach())
    return lambda *a, **kw: conv_gn._ConvGN.apply(  # noqa: E731
        *a, kw["stride"], kw["groups"], 1e-6, kw["act"])


def _k6_function(monkeypatch):
    monkeypatch.setattr(envact, "_forward", lambda x, s: tuple(
        o.detach() for o in envact.env_act_reference(x, s)))
    return envact._EnvAct.apply


def _scale_err(got, want):
    return max(float(np.max(np.abs(np.asarray(a, np.float64)
                                   - np.asarray(b, np.float64))))
               / float(np.max(np.abs(np.asarray(b, np.float64))))
               for a, b in zip(got, want))


@pytest.mark.parametrize("t,cin,cout,k,stride,groups,act,with_skip",
                         K5_CASES)
def test_k5_function_backward_is_the_plain_gradient(
        t, cin, cout, k, stride, groups, act, with_skip, monkeypatch):
    """The card's wiring on the CPU: ``_ConvGN`` with the plain forward in
    the kernel's place gives the plain version's gradients exactly."""
    fn = _k5_function(monkeypatch)
    args, cot = _k5_inputs(t, cin, cout, k, stride, with_skip, "cpu")
    out, got = _k5_grads(fn, args, cot, stride, groups, act, with_skip)
    assert out.grad_fn is not None
    _, want = _k5_grads(conv_gn.conv_gn_reference, args, cot, stride, groups,
                        act, with_skip)
    assert len(got) == len(want) == 5 + with_skip
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("case", K5_CASES)
def test_k5_function_backward_matches_jax_custom_vjp(case, monkeypatch,
                                                     ahead):
    """``_ConvGN``'s gradients (every input's, ``skip``'s when given)
    against ``jax.vjp`` of JAX's ``conv1d_gn`` on the same inputs and
    cotangent, within 1e-5 of each gradient's scale."""
    t, cin, cout, k, stride, groups, act, with_skip = case
    args, cot = _k5_inputs(t, cin, cout, k, stride, with_skip, "cpu")
    _, got = _k5_grads(_k5_function(monkeypatch), args, cot, stride, groups,
                       act, with_skip)
    want = ahead(_k5_jax, case)
    assert len(want) == len(got) == 5 + with_skip
    assert all(a.shape == b.shape for a, b in zip(got, want))
    assert _scale_err([g.numpy() for g in got], want) <= K5_TOL


def test_k6_function_backward_is_the_plain_gradient(monkeypatch):
    args, cots = _k6_inputs("cpu")
    outs, got = _k6_grads(_k6_function(monkeypatch), args, cots)
    assert all(o.grad_fn is not None for o in outs)
    _, want = _k6_grads(envact.env_act_reference, args, cots)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_k6_function_backward_matches_jax_custom_vjp(monkeypatch, ahead):
    """``_EnvAct``'s gradients of x and the scale against JAX's
    ``custom_vjp`` backward on the same inputs and cotangents, within 3e-6
    of each gradient's scale."""
    args, cots = _k6_inputs("cpu")
    _, got = _k6_grads(_k6_function(monkeypatch), args, cots)
    want = ahead(_k6_jax)
    assert [g.shape for g in got] == [w.shape for w in want]
    assert _scale_err([g.numpy() for g in got], want) <= K6_TOL


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _card_err(got, want):
    return max(float((a - b).abs().max()) / float(b.abs().max())
               for a, b in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("t,cin,cout,k,stride,groups,act,with_skip",
                         K5_CASES)
def test_k5_gradients_on_the_card(t, cin, cout, k, stride, groups, act,
                                  with_skip):
    """``conv1d_gn`` on the card launches K5, returns a ``grad_fn`` and
    gives the plain version's gradients within 1e-5 of their scale."""
    _need_card()
    args, cot = _k5_inputs(t, cin, cout, k, stride, with_skip, "cuda")
    before = conv_gn.conv1d_gn.launches
    out, got = _k5_grads(lambda *a, **kw: conv_gn.conv1d_gn(*a, **kw),
                         args, cot, stride, groups, act, with_skip)
    assert conv_gn.conv1d_gn.launches == before + 1
    assert out.grad_fn is not None
    _, want = _k5_grads(conv_gn.conv_gn_reference, args, cot, stride, groups,
                        act, with_skip)
    assert _card_err(got, want) <= K5_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("fn", ["env_act", "env_act_auto"])
def test_k6_gradients_on_the_card(fn):
    """``env_act`` and ``env_act_auto`` on the card launch K6, return
    outputs with a ``grad_fn`` and give the plain version's gradients
    within 3e-6 of their scale."""
    _need_card()
    args, cots = _k6_inputs("cuda")
    before = envact.env_act.launches
    outs, got = _k6_grads(getattr(envact, fn), args, cots)
    assert envact.env_act.launches == before + 1
    assert all(o.grad_fn is not None for o in outs)
    _, want = _k6_grads(envact.env_act_reference, args, cots)
    assert _card_err(got, want) <= K6_TOL
