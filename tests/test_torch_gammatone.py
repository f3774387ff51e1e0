"""The gammatone filterbank of the port against the JAX package's: the same
float32 taps, ``filter`` / ``filter_to_frames`` / ``get_tf_magnitudes`` on
seeded speech-like signals, and the uncentred STFT pair of the DNN path.

Tolerances: the filtered signal within 1e-5 of its scale (a 400-tap float32
convolution summed in another order), per-unit power within 1e-5 of the
largest unit, the centre-bin phase compared as a unit phasor (so that a flip
between -pi and pi does not count) within 1e-3 where the bin holds energy,
the STFT pair within 1e-5 of its scale."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sincformer_tpu.dsp import gammatone as jax_gt
from sincformer_tpu.dsp.stft import istft_uncentered as jax_istft_uncentered
from sincformer_tpu.dsp.stft import stft_uncentered as jax_stft_uncentered
from sincformer_tpu_torch.dsp import gammatone as gt
from sincformer_tpu_torch.dsp.stft import istft_uncentered, stft_uncentered

from _torch_parity import max_abs, speechlike

TOL = 1e-5


def _signals(n=4000):
    return np.stack([speechlike(3, n), speechlike(4, n)])


def test_constants_and_taps_equal():
    ours, ref = gt.GammatoneFilterbank(), jax_gt.GammatoneFilterbank()
    assert np.array_equal(ours.fir, ref.fir)
    assert np.array_equal(ours.center_freqs, ref.center_freqs)
    assert np.array_equal(ours.cf_bins, ref.cf_bins)
    assert ours.fir.shape == (64, 400) and ours.fir.dtype == np.float32
    assert np.array_equal(gt.erb_space(50.0, 4000.0, 64),
                          jax_gt.erb_space(50.0, 4000.0, 64))
    assert np.array_equal(gt.erb_bandwidth([100.0, 1000.0]),
                          jax_gt.erb_bandwidth([100.0, 1000.0]))
    assert np.array_equal(gt.gammatone_impulse_response(440.0, 8000),
                          jax_gt.gammatone_impulse_response(440.0, 8000))


@pytest.mark.parametrize("lead", ["batch", "single", "nested"])
def test_filter_matches_jax(lead):
    x = {"batch": _signals(), "single": _signals()[0],
         "nested": _signals(1600).reshape(2, 2, 800)}[lead]
    ref = np.asarray(jax_gt.GammatoneFilterbank().filter(jnp.asarray(x)))
    got = gt.GammatoneFilterbank().filter(torch.from_numpy(x))
    assert got.shape == x.shape[:-1] + (64, x.shape[-1])
    assert max_abs(got, ref) <= TOL * np.abs(ref).max()


def test_filter_is_causal_convolution():
    """Channel c of ``filter`` is ``convolve(x, ir_c, 'full')[:N]``."""
    x = _signals(1000)[0]
    bank = gt.GammatoneFilterbank()
    got = bank.filter(torch.from_numpy(x)).numpy()
    for c in (0, 31, 63):
        ref = np.convolve(x.astype(np.float64), bank.fir[c])[:len(x)]
        assert np.max(np.abs(got[c] - ref)) <= TOL * np.abs(ref).max()


def test_filter_to_frames_and_tf_magnitudes_match_jax():
    x = _signals()
    ref_bank, bank = jax_gt.GammatoneFilterbank(), gt.GammatoneFilterbank()
    frames = bank.filter_to_frames(torch.from_numpy(x))
    ref_frames = np.asarray(ref_bank.filter_to_frames(jnp.asarray(x)))
    assert frames.shape == (2, 64, 49, 160)
    assert max_abs(frames, ref_frames) <= TOL * np.abs(ref_frames).max()

    mags, phases = bank.get_tf_magnitudes(torch.from_numpy(x))
    ref_mags, ref_phases = (np.asarray(a) for a in
                            ref_bank.get_tf_magnitudes(jnp.asarray(x)))
    assert mags.shape == phases.shape == (2, 64, 49)
    assert max_abs(mags, ref_mags) <= TOL * ref_mags.max()
    # the phase of a bin without energy is noise: compare where the unit's
    # power is above 1e-6 of the largest
    loud = ref_mags > 1e-6 * ref_mags.max()
    delta = np.abs(np.exp(1j * phases.numpy()) - np.exp(1j * ref_phases))
    assert loud.mean() > 0.5 and delta[loud].max() <= 1e-3


def test_uncentered_stft_pair_matches_jax():
    x = _signals()
    spec = stft_uncentered(torch.from_numpy(x))
    ref = np.asarray(jax_stft_uncentered(jnp.asarray(x)))
    assert spec.shape == (2, 49, 129)
    assert np.abs(spec.numpy() - ref).max() <= TOL * np.abs(ref).max()
    mask = np.random.default_rng(0).uniform(0, 1, ref.shape).astype(np.float32)
    back = istft_uncentered(torch.from_numpy(ref * mask), 4000)
    ref_back = np.asarray(jax_istft_uncentered(jnp.asarray(ref * mask), 4000))
    assert back.shape == (2, 4000)
    assert max_abs(back, ref_back) <= TOL * np.abs(ref_back).max()


def test_uncentered_istft_inverts_stft():
    """Away from the first and last half frame (where the summed window² is
    not yet complete) the pair is the identity."""
    x = torch.from_numpy(_signals(1600))
    back = istft_uncentered(stft_uncentered(x), 1600)
    assert float((back - x)[:, 80:1520].abs().max()) <= TOL
