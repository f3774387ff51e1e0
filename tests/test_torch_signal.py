"""Port parity of the signal path: sincformer_tpu_torch.dsp.stft and
utils.signal against sincformer_tpu on the same numpy inputs (float32, CPU).

Tolerances: STFT bins are sums of 256 windowed samples of O(1) signals, so
1e-4 absolute is a few ulp of the largest bins (pocketfft on both sides, in
another order); the round-trip waveform is O(1) and holds to 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sincformer_tpu.dsp.stft import istft as jax_istft
from sincformer_tpu.dsp.stft import stft as jax_stft
from sincformer_tpu.utils import signal as jsignal
from sincformer_tpu_torch.dsp.stft import istft, stft
from sincformer_tpu_torch.utils.signal import (frame_signal, hann_window,
                                               num_frames, overlap_add,
                                               pcm_to_float)
from tests import _torch_threads  # noqa: F401


def _x(n, b=2, seed=0):
    return np.random.default_rng(seed + n).standard_normal(
        (b, n)).astype(np.float32)


@pytest.mark.parametrize("n", [4000, 8000, 12345])
def test_stft_matches_jax(n):
    x = _x(n)
    ref = np.asarray(jax_stft(jnp.asarray(x)))
    got = stft(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, n // 80 + 1, 129)
    assert np.max(np.abs(got - ref)) < 1e-4


@pytest.mark.parametrize("n", [4000, 8000, 12345])
def test_istft_matches_jax(n):
    """iSTFT of the same (random, not STFT-consistent) spectrum, so the
    window-square normalisation and the edges are compared, not only the
    round trip."""
    rng = np.random.default_rng(n)
    t = n // 80 + 1
    spec = (rng.standard_normal((2, t, 129))
            + 1j * rng.standard_normal((2, t, 129))).astype(np.complex64)
    ref = np.asarray(jax_istft(jnp.asarray(spec), length=n))
    got = istft(torch.from_numpy(spec), length=n).numpy()
    assert got.shape == ref.shape == (2, n)
    assert np.max(np.abs(got - ref)) < 1e-5


@pytest.mark.parametrize("n", [4000, 12345])
def test_stft_round_trip_and_torch_stft(n):
    """Round trip to the input, and torch.stft as a second check of the
    forward transform."""
    x = torch.from_numpy(_x(n, seed=1))
    spec = stft(x)
    assert torch.max(torch.abs(istft(spec, length=n) - x)) < 1e-5
    win = torch.from_numpy(hann_window(160))
    ref = torch.stft(x, 256, 80, 160, window=win, center=True,
                     pad_mode="reflect", return_complex=True).transpose(1, 2)
    assert torch.max(torch.abs(spec - ref)) < 1e-4


def test_framing_and_overlap_add_match_jax():
    x = _x(1000, b=3)
    for size, hop in ((256, 80), (160, 80), (100, 30)):
        ref = np.asarray(jsignal.frame_signal(jnp.asarray(x), size, hop))
        got = frame_signal(torch.from_numpy(x), size, hop).numpy()
        np.testing.assert_array_equal(got, ref)
        assert num_frames(1000, size, hop) == jsignal.num_frames(1000, size, hop)
        for out_len in (900, 1000, 1300):
            ref_ola = np.asarray(jsignal.overlap_add(jnp.asarray(ref), hop,
                                                     out_len))
            got_ola = overlap_add(torch.from_numpy(got.copy()), hop,
                                  out_len).numpy()
            assert np.max(np.abs(got_ola - ref_ola)) < 1e-5
    np.testing.assert_array_equal(hann_window(160),
                                  np.asarray(jsignal.hann_window(160)))


def test_pcm_to_float_int16():
    pcm = np.array([-32768, -1, 0, 1, 12345, 32767], np.int16)
    got = pcm_to_float(torch.from_numpy(pcm))
    ref = np.asarray(jsignal.pcm_to_float(jnp.asarray(pcm)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    f = torch.randn(5)
    assert pcm_to_float(f) is f


def test_float_to_pcm_bit_equal():
    """float_to_pcm against the JAX function: ties at .5 LSB round half to
    even, values past full scale clip to [-32768, 32767], and the host-side
    quantizer of serve.py is the same function."""
    from sincformer_tpu_torch.serve import StreamingEnhancer
    from sincformer_tpu_torch.utils.signal import float_to_pcm
    lsb = 1.0 / 32768.0
    ties = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 32766.5, -32767.5],
                    np.float32) * lsb
    edge = np.array([1.0, -1.0, 1.5, -1.5, 0.99999, -0.99999, 0.0, 32767 * lsb],
                    np.float32)
    x = np.concatenate([ties, edge, _x(500, b=1)[0] * 0.7])
    ref = np.asarray(jsignal.float_to_pcm(jnp.asarray(x)))
    got = float_to_pcm(torch.from_numpy(x))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got[:8].tolist() == [0, 2, 2, 0, -2, -2, 32766, -32768]
    assert got[8:12].tolist() == [32767, -32768, 32767, -32768]
    np.testing.assert_array_equal(StreamingEnhancer._quantize_host(x), ref)


def test_istft_ignores_imaginary_dc_and_nyquist():
    """A masked spectrum has imaginary parts in its DC and Nyquist bins. The
    JAX package's iSTFT (pocketfft) ignores them; the port drops them
    itself, because cuFFT's answer for such input changes with the batch
    size. Checked on the CPU against JAX, and on the card (where there is
    one) for one batch of 16 against four batches of 4."""
    rng = np.random.default_rng(9)
    re, im = (rng.standard_normal((16, 51, 129)).astype(np.float32)
              for _ in range(2))
    ref = np.asarray(jax_istft(jnp.asarray(re) + 1j * jnp.asarray(im),
                               length=4000))
    spec = torch.complex(torch.from_numpy(re), torch.from_numpy(im))
    got = istft(spec, length=4000)
    assert np.max(np.abs(got.numpy() - ref)) <= 1e-5
    clean = spec.clone()
    clean.imag[..., 0] = 0.0
    clean.imag[..., -1] = 0.0
    torch.testing.assert_close(istft(clean, length=4000), got, rtol=0, atol=0)
    if torch.cuda.is_available():
        on_card = spec.cuda()
        whole = istft(on_card, length=4000)
        parts = torch.cat([istft(on_card[i:i + 4], length=4000)
                           for i in range(0, 16, 4)])
        assert float((whole - parts).abs().max()) <= 1e-5
        assert float((whole.cpu() - got).abs().max()) <= 1e-5
