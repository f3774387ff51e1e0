"""Kernel K4 (Meddis hair cell): the port's plain per-sample loop against
the JAX scan and against the Pallas kernel run in interpret mode, the
``MeddisHairCell`` methods against their JAX counterparts, and the CUDA
kernel against the plain loop where a card is present.

Tolerance 1e-5 of the output's scale (float32 on both sides, the same Euler
updates in the same order; XLA may contract a product and a sum into a fused
multiply-add where torch's separate tensor operations cannot). On the card
the kernel is expected to equal the plain loop bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sincformer_tpu.dsp.haircell import MeddisHairCell as JaxHairCell
from sincformer_tpu.ops.meddis_pallas import meddis_pallas
from sincformer_tpu_torch.dsp.haircell import MeddisHairCell
from sincformer_tpu_torch.ops.meddis import (_meddis_plain, meddis,
                                            wave_columns)
from tests import _torch_threads  # noqa: F401

TOL = 1e-5
# the drives of tests/test_pallas_ops.py::TestMeddisPallas, plus one with
# both signs that exercises the clamp of the input, plus the edges of the
# CUDA kernel's tiling (128-sample tiles, 8 columns a block): one sample,
# under one tile, one sample past 64 and past 128, with a number of signals
# that is no multiple of 8 or 32
DRIVES = {"batch of channels": ((2, 8, 700), 20.0, True),
          "single signal": ((300,), 20.0, True),
          "weak drive": ((3, 200), 10.0, True),
          "both signs": ((5, 400), 30.0, False),
          "one sample": ((3, 1), 30.0, False),
          "under one tile": ((5, 63), 30.0, False),
          "past 64 samples": ((7, 65), 30.0, False),
          "past one tile": ((3, 3, 129), 30.0, False)}


def _drive(name):
    shape, gain, rectified = DRIVES[name]
    x = np.random.default_rng(len(name)).standard_normal(shape) * gain
    return (np.abs(x) if rectified else x).astype(np.float32)


def _close(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    if ref.shape[-1] == 1:
        # one step from the steady state clamps c to 0 whatever the input
        # (dt * (l + r) > 1): the outputs are zeros, and must be equal
        return np.array_equal(got, ref)
    assert float(ref.max()) > 0                      # non-degenerate drive
    return float(np.max(np.abs(got - ref))) <= TOL * float(np.abs(ref).max())


@pytest.mark.parametrize("name", list(DRIVES))
def test_plain_matches_jax_scan(name):
    x = _drive(name)
    got = _meddis_plain(torch.from_numpy(x)).numpy()
    assert _close(got, JaxHairCell().process(jnp.asarray(x)))


@pytest.mark.parametrize("name", list(DRIVES))
def test_plain_matches_pallas_interpret(name):
    x = _drive(name)
    got = meddis(torch.from_numpy(x)).numpy()
    assert _close(got, meddis_pallas(jnp.asarray(x), interpret=True))


@pytest.mark.parametrize("backend", ["scan", "pallas"])
def test_haircell_process_and_frames(backend):
    """``process``, ``process_filterbank`` and ``process_to_frames`` on a
    CPU tensor: the plain loop whatever ``backend`` says."""
    x = _drive("batch of channels")
    hc, ref = MeddisHairCell(), JaxHairCell()
    xt = torch.from_numpy(x)
    assert _close(hc.process(xt, backend=backend).numpy(),
                  ref.process(jnp.asarray(x)))
    assert _close(hc.process_filterbank(xt).numpy(),
                  ref.process_filterbank(jnp.asarray(x)))
    frames = hc.process_to_frames(xt, 160, 80)
    assert frames.shape == (2, 8, 7)
    assert _close(frames.numpy(),
                  ref.process_to_frames(jnp.asarray(x), 160, 80))


def test_constants_match_jax():
    hc, ref = MeddisHairCell(), JaxHairCell()
    for name in ("A", "B", "g", "y", "l", "r", "x", "h", "M", "q0", "c0",
                 "w0", "dt", "fs"):
        assert getattr(hc, name) == getattr(ref, name), name
    with pytest.raises(ValueError, match="backend"):
        hc.process(torch.zeros(4), backend="triton")


def test_cpu_tensor_takes_plain_version_without_launch():
    x = torch.from_numpy(_drive("weak drive"))
    before = meddis.launches
    out = meddis(x)
    assert meddis.launches == before
    torch.testing.assert_close(out, _meddis_plain(x), rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 1500), (64, 1500), (45, 999),
                                   (2, 3, 130), (3, 1), (5, 63), (7, 65),
                                   (3, 3, 129), (17, 8001), "past one wave"])
def test_cuda_kernel_equals_plain(shape):
    """Needs a CUDA card and nvcc (builds csrc/meddis.cu). "past one wave":
    more signals than the card holds blocks at once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    if shape == "past one wave":
        shape = (wave_columns() + 45, 300)
    x = (torch.randn(shape, generator=torch.Generator().manual_seed(0))
         * 30.0).cuda()
    before = meddis.launches
    out = meddis(x)
    torch.cuda.synchronize()
    assert meddis.launches == before + 1
    assert torch.equal(out, _meddis_plain(x))
    assert torch.equal(out.cpu(), _meddis_plain(x.cpu()))
    with pytest.raises(ValueError, match="contiguous"):
        # every other sample of twice the input: strided whatever the shape
        # (x[..., ::2] of an (M, 1) input would still be contiguous)
        meddis(torch.cat([x, x], dim=-1)[..., ::2])
