"""The DNN's input features in the port against the JAX package's: AMS,
RASTA-PLP, MFCC, GFCC, the 54-dimensional frame features and their context
stacking, on seeded speech-like signals of 1 s in float32.

Tolerances, each relative to the scale (largest magnitude) of the feature
block compared: 1e-5 for everything but the per-frame GFCC block, which is
held to 1e-4: it takes differences of a float32 running sum over the whole
signal (XLA and torch add in another order, and the difference of two large
sums cancels) and then a cube root, which amplifies the error of small
energies. Measured at 1 s: 1.5e-5 for the GFCC block, at most 6e-7 for the
others."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sincformer_tpu.dsp import features as jax_f
from sincformer_tpu.utils import signal as jax_signal
from sincformer_tpu_torch.config import AudioConfig, FeatureConfig
from sincformer_tpu_torch.dsp import features as f
from sincformer_tpu_torch.pipeline import mask_interp_matrix
from sincformer_tpu_torch.utils import signal

from _torch_parity import speechlike

TOL = 1e-5
GFCC_TOL = 1e-4
BLOCKS = {"ams": slice(0, 15), "rasta": slice(15, 28), "mfcc": slice(28, 41),
          "gfcc": slice(41, 54)}


def _signals(n=8000):
    return np.stack([speechlike(5, n), speechlike(6, n)])


def _rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def test_windows_and_matrices_equal():
    assert np.array_equal(signal.hamming_window(160),
                          np.asarray(jax_signal.hamming_window(160)))
    assert np.array_equal(signal.hamming_window(128, periodic=True),
                          np.asarray(jax_signal.hamming_window(128, True)))
    assert np.array_equal(signal.dct_matrix(64, 13),
                          np.asarray(jax_signal.dct_matrix(64, 13)))
    assert np.array_equal(signal.dct_matrix(21), jax_signal.dct_matrix(21))
    assert np.array_equal(f.mel_filterbank(64, 512, 8000),
                          jax_f.mel_filterbank(64, 512, 8000))
    for ours, ref in zip(f._bark_filterbank(8000, 256, 21),
                         jax_f._bark_filterbank(8000, 256, 21)):
        assert np.array_equal(ours, ref)
    assert np.array_equal(f._ams_band_weights(8000),
                          jax_f._ams_band_weights(8000))
    fcfg, acfg = FeatureConfig(), AudioConfig()
    assert (fcfg.raw_dim, fcfg.dim) == (54, 594)
    assert (acfg.frame_size, acfg.hop_size, acfg.fft_size) == (160, 80, 256)


def test_ams_on_long_segments():
    """Segments long enough for AMS to be non-zero: 1 s gives 1000
    decimated samples, 14 segments of 128."""
    x = _signals()
    ref = jax_f.extract_ams(jnp.asarray(x))
    got = f.extract_ams(torch.from_numpy(x))
    assert got.shape == (2, 15) and float(np.abs(ref).max()) > 1.0
    assert _rel(got, ref) <= TOL
    short = f.extract_ams(torch.from_numpy(x[:, :640]))
    assert short.shape == (2, 15) and not short.any()
    assert not np.asarray(jax_f.extract_ams(jnp.asarray(x[:, :640]))).any()


@pytest.mark.parametrize("frames", [40, 399, 512, 1300])
def test_rasta_filter_matches_scan_and_loop(frames):
    """The triangular product against the JAX scan and against the
    recurrence written out; 1300 frames cross two block boundaries."""
    x = np.random.default_rng(frames).standard_normal(
        (3, 21, frames)).astype(np.float32)
    got = f.rasta_filter(torch.from_numpy(x))
    assert _rel(got, jax_f.rasta_filter(jnp.asarray(x))) <= TOL
    xp = np.pad(x.astype(np.float64), ((0, 0), (0, 0), (4, 0)))
    fir = sum(b * xp[..., 4 - k: frames + 4 - k]
              for k, b in enumerate((0.2, 0.1, 0.0, -0.1, -0.2)))
    y = np.zeros_like(fir)
    for n in range(frames):
        y[..., n] = fir[..., n] + 0.98 * (y[..., n - 1] if n else 0.0)
    assert _rel(got, y) <= TOL


@pytest.mark.parametrize("family", ["rasta_plp", "mfcc", "gfcc"])
def test_utterance_features_match_jax(family):
    x = _signals()
    ref = getattr(jax_f, f"extract_{family}")(jnp.asarray(x))
    got = getattr(f, f"extract_{family}")(torch.from_numpy(x))
    assert got.shape == (2, 13)
    assert _rel(got, ref) <= TOL
    one = getattr(f, f"extract_{family}")(torch.from_numpy(x[1]))
    assert _rel(one, np.asarray(ref)[1]) <= TOL


def test_mfcc_frames_and_pre_emphasis():
    x = _signals()
    assert _rel(f.pre_emphasis(torch.from_numpy(x)),
                jax_f.pre_emphasis(jnp.asarray(x))) == 0.0
    ref = jax_f._mfcc_frames(jnp.asarray(x), 8000, jax_f.cfg.DEFAULT.features,
                             jax_f.cfg.DEFAULT.audio, 13)
    got = f._mfcc_frames(torch.from_numpy(x), 8000, FeatureConfig(),
                         AudioConfig(), 13)
    assert got.shape == (2, 99, 13) and _rel(got, ref) <= TOL


@pytest.fixture(scope="module")
def frame_features():
    x = _signals()
    ref_fe = jax_f.FeatureExtractor()
    ref = np.stack([np.asarray(ref_fe.extract_frame_features(jnp.asarray(s)))
                    for s in x])
    got = f.FeatureExtractor().extract_frame_features(torch.from_numpy(x))
    return x, got, ref


@pytest.mark.parametrize("block", list(BLOCKS))
def test_frame_features_match_jax(frame_features, block):
    _, got, ref = frame_features
    assert got.shape == ref.shape == (2, 99, 54)
    if block == "ams":          # identically zero at the default constants
        assert not got[..., BLOCKS[block]].any()
        assert not ref[..., BLOCKS[block]].any()
        return
    tol = GFCC_TOL if block == "gfcc" else TOL
    assert _rel(got[..., BLOCKS[block]], ref[..., BLOCKS[block]]) <= tol


def test_frame_features_batched_equal_single(frame_features):
    x, got, _ = frame_features
    fe = f.FeatureExtractor()
    assert fe.raw_feature_dim == 54 and fe.feature_dim == 594
    for i in range(2):
        one = fe.extract_frame_features(torch.from_numpy(x[i]))
        assert one.shape == (99, 54)
        assert _rel(one, got[i]) <= TOL
    short = fe.extract_frame_features(torch.zeros(100) + 0.01)
    assert short.shape == (1, 54)        # padded to one frame


def test_add_context_matches_jax(frame_features):
    _, _, ref = frame_features
    ref_fe = jax_f.FeatureExtractor()
    want = np.stack([np.asarray(ref_fe.add_context(jnp.asarray(r)))
                     for r in ref])
    got = f.FeatureExtractor().add_context(torch.from_numpy(ref))
    assert got.shape == (2, 99, 594)
    assert np.array_equal(got.numpy(), want)
    one = f.FeatureExtractor().add_context(torch.from_numpy(ref[0, :3]))
    assert np.array_equal(one.numpy(),
                          np.asarray(ref_fe.add_context(jnp.asarray(ref[0, :3]))))


def test_mask_interp_matrix_is_np_interp():
    """The fixed (129, 64) matrix against ``np.interp`` row by row, the
    ends held (what ``jnp.interp(..., left=row[0], right=row[-1])`` does)."""
    from sincformer_tpu_torch.dsp.gammatone import erb_space
    centers = erb_space(50.0, 4000.0, 64)
    freqs = np.linspace(0, 4000.0, 129)
    w = mask_interp_matrix(centers, freqs)
    assert w.shape == (129, 64) and w.dtype == np.float32
    rows = np.random.default_rng(0).uniform(0, 1, (5, 64))
    for row in rows:
        want = np.interp(freqs, centers, row, left=row[0], right=row[-1])
        assert np.abs(w.astype(np.float64) @ row - want).max() <= 1e-6
    assert np.allclose(w.sum(axis=1), 1.0, atol=1e-6)
