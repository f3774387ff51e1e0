"""Kernel K6 (fine activation + pooled log envelope): the port's plain
version against the JAX Pallas kernel run in interpret mode and against the
JAX reference formulation, and the CUDA kernel against the plain version
where a card is present.

Tolerance 3e-6 absolute, as in tests/test_pallas_ops.py::TestEnvAct (float32
tanh and log1p on both sides, inputs of a few units)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sincformer_tpu.ops import envact_pallas as jax_envact
from sincformer_tpu_torch.ops.envact import (env_act, env_act_auto,
                                             env_act_reference)
from tests._torch_bf16 import agreement

TOL = 3e-6
# (shape, Pallas block): the JAX tests' shapes, a length for which the TPU
# kernel finds no tiling (no multiple of 64 divides 2400; interpret mode
# takes a block of 8), an odd channel count
SHAPES = [((2, 800, 64), 400), ((1, 6400, 64), None), ((2, 2400, 64), 8),
          ((1, 16, 3), 8)]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(shape) * 3).astype(np.float32),
            rng.uniform(0.5, 2.0, shape[-1]).astype(np.float32))


@pytest.mark.parametrize("shape,block", SHAPES)
def test_plain_matches_pallas_interpret(shape, block):
    x, scale = _inputs(shape)
    y_ref, env_ref = jax_envact.env_act(jnp.asarray(x), jnp.asarray(scale),
                                        block=block, interpret=True)
    y, env = env_act(torch.from_numpy(x), torch.from_numpy(scale))
    assert env.shape == (shape[0], shape[1] // 8, shape[2])
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=TOL)
    np.testing.assert_allclose(env.numpy(), np.asarray(env_ref), atol=TOL)


@pytest.mark.parametrize("shape,block", SHAPES)
def test_plain_matches_jax_reference(shape, block):
    x, scale = _inputs(shape, seed=1)
    y_ref, env_ref = jax_envact.env_act_reference(jnp.asarray(x),
                                                  jnp.asarray(scale))
    y, env = env_act_auto(torch.from_numpy(x), torch.from_numpy(scale))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=TOL)
    np.testing.assert_allclose(env.numpy(), np.asarray(env_ref), atol=TOL)


def test_gelu_is_the_tanh_form():
    """The exact-erf GELU differs from the tanh form by about 1e-3: the
    plain version must be the tanh one."""
    x = torch.linspace(-4, 4, 64).reshape(1, 8, 8).contiguous()
    y, _ = env_act_reference(x, torch.ones(8))
    erf_form = torch.nn.functional.gelu(x)
    assert float((y - erf_form).abs().max()) > 1e-4


def test_shapes_refused():
    x, scale = (torch.from_numpy(a) for a in _inputs((1, 16, 4)))
    with pytest.raises(ValueError, match="multiple of 8"):
        env_act(x[:, :12], scale)
    with pytest.raises(ValueError, match="scale"):
        env_act(x, scale[:3])
    with pytest.raises(ValueError, match=r"\(B, N, C\)"):
        env_act(x[0], scale)


def test_cpu_tensor_takes_plain_version_without_launch():
    x, scale = (torch.from_numpy(a) for a in _inputs((1, 64, 8)))
    before = env_act.launches
    y, env = env_act(x, scale)
    assert env_act.launches == before
    y_ref, env_ref = env_act_reference(x, scale)
    assert torch.equal(y, y_ref) and torch.equal(env, env_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 3200, 64), (1, 8, 3), (2, 2400, 64),
                                   (3, 808, 6), (4, 32000, 64), (2, 800, 12)])
def test_cuda_kernel_matches_plain(shape, dtype):
    """Needs a CUDA card and nvcc (builds csrc/envact.cu). float32: within
    3e-6; bfloat16 (chip_smoke.py's BF16_K6_CASES shapes among these): at
    least 99 % of the elements bit-equal to the plain bf16 version and none
    beyond one bf16 ulp at its term scale (tests/_torch_bf16.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    x, scale = (torch.from_numpy(a).cuda().to(dtype) for a in _inputs(shape))
    before = env_act.launches
    y, env = env_act(x, scale)
    torch.cuda.synchronize()
    assert env_act.launches == before + 1
    y_ref, env_ref = env_act_reference(x, scale)
    if dtype == torch.float32:
        assert float((y - y_ref).abs().max()) <= TOL
        assert float((env - env_ref).abs().max()) <= TOL
    else:
        for got, want, terms in ((y, y_ref, (x.float() * scale.float()).abs()),
                                 (env, env_ref, torch.zeros(()))):
            share, ulps = agreement(got.cpu(), want.cpu(), terms.cpu())
            assert got.dtype == dtype and share >= 0.99 and ulps <= 1.0
    with pytest.raises(ValueError, match="contiguous"):
        env_act(torch.cat([x, x], dim=-1)[..., :shape[-1]], scale)
