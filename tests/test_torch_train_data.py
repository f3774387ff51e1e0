"""Training data, losses, the PCIRM oracle, the curriculum and the learning
rate schedule of the port against the JAX package, on the CPU.

Host data (generators, SNR mixing, held-out crops, splits, datasets and
batches in both modes over several epochs) must be bit-equal: both packages
run the same numpy. Losses and the oracle: within 1e-5 relative (f32 on
both sides, sums in another order)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import _torch_threads  # noqa: F401

TOL = 1e-5


def _rel(got, ref) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref)) / max(1e-30, np.max(np.abs(ref))))


def _rng(seed):
    return np.random.default_rng(seed)


# ── generators and mixing ──────────────────────────────────────────────────

GENERATORS = [
    ("synthetic_speech", (1.37,), {}),
    ("synthetic_speech", (0.5,), {"fs": 16000}),
    ("synthetic_speech_varied", (1.0,), {"seed": 3}),
    ("synthetic_speech_varied", (1.6,), {"seed": 1004}),
    ("synthetic_noise", (4321,), {"seed": 9}),
    ("synthetic_noise_bank", (8000,), {"seed": 7}),
]


@pytest.mark.parametrize("name,args,kwargs", GENERATORS,
                         ids=[f"{g[0]}-{i}" for i, g in enumerate(GENERATORS)])
def test_generators_bit_equal(name, args, kwargs):
    from sincformer_tpu.data import synthetic as jax_syn
    from sincformer_tpu_torch.data import synthetic as port_syn
    want = getattr(jax_syn, name)(*args, **kwargs)
    got = getattr(port_syn, name)(*args, **kwargs)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype
    else:
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


@pytest.mark.parametrize("kinds", [("white", "formant"), ("multi", "varied")])
def test_synthetic_corpus_bit_equal(kinds):
    from sincformer_tpu import cli as jax_cli
    from sincformer_tpu_torch import cli as port_cli
    want_c, want_n = jax_cli._synthetic_corpus(5, *kinds)
    got_c, got_n = port_cli._synthetic_corpus(5, *kinds)
    for g, w in zip(got_c, want_c, strict=True):
        np.testing.assert_array_equal(g, w)
    assert list(got_n) == list(want_n)
    for k in want_n:
        np.testing.assert_array_equal(got_n[k], want_n[k])


@pytest.mark.parametrize("snr", [-5.0, 0.0, 7.5, 10.0])
def test_add_noise_at_snr_bit_equal(snr):
    from sincformer_tpu.data.audio import add_noise_at_snr as jax_mix
    from sincformer_tpu_torch.data.audio import add_noise_at_snr as port_mix
    clean = _rng(1).standard_normal(3001).astype(np.float32) * 0.2
    for noise in (_rng(2).standard_normal(5000) * 0.3,     # cropped
                  _rng(3).standard_normal(700) * 0.3):     # tiled
        want = jax_mix(clean, noise, snr)
        got = port_mix(clean, noise, snr)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype == np.float32


def test_heldout_noises_split_and_discovery_bit_equal(tmp_path):
    from scipy.io import wavfile

    from sincformer_tpu.data import loader as jl
    from sincformer_tpu_torch.data import loader as pl
    noises = {"white": _rng(4).standard_normal(1001).astype(np.float32),
              "babble": _rng(5).standard_normal(800).astype(np.float32)}
    want, got = jl.heldout_noises(noises), pl.heldout_noises(noises)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    files = [f"f{i:02d}.wav" for i in range(23)]
    assert pl.train_test_split(files) == jl.train_test_split(files)
    assert pl.train_test_split(files, seed=3, max_train=9, max_test=2) == \
        jl.train_test_split(files, seed=3, max_train=9, max_test=2)
    for sub in ("DR1/A", "DR2/B"):
        os.makedirs(tmp_path / sub)
        for i in range(4):
            wavfile.write(str(tmp_path / sub / f"s{i}.WAV"), 8000,
                          np.zeros(10, np.int16))
    for cap in (None, 5):
        assert pl.find_speech_files(str(tmp_path), cap) == \
            jl.find_speech_files(str(tmp_path), cap)


@pytest.mark.parametrize("fallback", ["white", "multi", False])
def test_load_noise_signals_fallbacks_bit_equal(fallback, tmp_path):
    from sincformer_tpu.data import loader as jl
    from sincformer_tpu_torch.data import loader as pl
    want = jl.load_noise_signals(8000, str(tmp_path), fallback, seed=3)
    got = pl.load_noise_signals(8000, str(tmp_path), fallback, seed=3)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _datasets(tmp_path):
    from scipy.io import wavfile

    from sincformer_tpu.data import loader as jl
    from sincformer_tpu_torch.data import loader as pl
    lengths = (900, 4000, 5200, 2500, 7000, 3999, 100, 6100, 4001, 3000, 1200)
    clean = [(_rng(10 + i).standard_normal(n) * 0.2).astype(np.float32)
             for i, n in enumerate(lengths)]
    noises = {"white": _rng(30).standard_normal(9000).astype(np.float32),
              "hum": np.sin(np.arange(3000) * 0.05).astype(np.float32)}
    paths = []
    for i, c in enumerate(clean):
        p = str(tmp_path / f"u{i}.wav")
        wavfile.write(p, 8000, np.round(c * 32767).astype(np.int16))
        paths.append(p)
    out = []
    for mod in (jl, pl):
        out.append((mod.WaveformDataset.from_arrays(clean, noises,
                                                    max_len=6000),
                    mod.WaveformDataset.from_files(paths, noises,
                                                   [0, 5, 10],
                                                   max_len=5000)))
    return out


def test_datasets_bit_equal(tmp_path):
    (ja, jf), (pa, pf) = _datasets(tmp_path)
    for j, p in ((ja, pa), (jf, pf)):
        assert p.max_len == j.max_len and len(p) == len(j)
        for (pn, pc), (jn, jc) in zip(p.pairs, j.pairs):
            np.testing.assert_array_equal(pn, jn)
            np.testing.assert_array_equal(pc, jc)


@pytest.mark.parametrize("bucketed", [False, True])
def test_batch_iterator_bit_equal_over_epochs(bucketed, tmp_path):
    from sincformer_tpu.data.loader import batch_iterator as jit_
    from sincformer_tpu_torch.data.loader import batch_iterator as pit
    (jds, _), (pds, _) = _datasets(tmp_path)
    for epoch in range(3):
        for shuffle, drop_last, bs in ((True, True, 4), (False, False, 3),
                                       (True, False, 8)):
            kw = dict(batch_size=bs, shuffle=shuffle, seed=5,
                      drop_last=drop_last, bucketed=bucketed,
                      bucket_quantum=2000, epoch=epoch)
            want, got = list(jit_(jds, **kw)), list(pit(pds, **kw))
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                for k in ("noisy", "clean", "lengths"):
                    np.testing.assert_array_equal(g[k], w[k])
                    assert g[k].dtype == w[k].dtype


def test_remix_for_stage_and_curriculum_equal():
    from sincformer_tpu.train.agent_trainer import SincformerPipeline as JP
    from sincformer_tpu.train.curriculum import CurriculumScheduler as JC
    from sincformer_tpu_torch.train.agent_trainer import SincformerTrainer
    from sincformer_tpu_torch.train.curriculum import CurriculumScheduler
    clean = [(_rng(40 + i).standard_normal(n) * 0.3).astype(np.float32)
             for i, n in enumerate((3000, 5000, 4500))]
    noises = {"a": _rng(50).standard_normal(6000).astype(np.float32),
              "b": _rng(51).standard_normal(2000).astype(np.float32)}
    for epoch in (0, 1, 4):
        want = JP.remix_for_stage(clean, noises, [5, 10], 4000, epoch)
        got = SincformerTrainer.remix_for_stage(clean, noises, [5, 10],
                                                4000, epoch)
        assert got.max_len == want.max_len
        for (gn, gc), (wn, wc) in zip(got.pairs, want.pairs, strict=True):
            np.testing.assert_array_equal(gn, wn)
            np.testing.assert_array_equal(gc, wc)
    jc, pc = JC(), CurriculumScheduler()
    assert pc.total_epochs == jc.total_epochs == 50
    for epoch in range(52):
        assert pc.get_stage(epoch) == jc.get_stage(epoch), epoch


@pytest.mark.parametrize("total,spe", [(2, 4), (50, 3), (7, 1)])
def test_warmup_cosine_schedule_equal(total, spe):
    from sincformer_tpu.train.state import warmup_cosine_schedule as jsched
    from sincformer_tpu_torch.train.state import warmup_cosine_schedule
    want = jsched(5e-4, total, spe)
    got = warmup_cosine_schedule(5e-4, total, spe)
    for step in range(0, (total + 2) * spe):
        w = float(want(jnp.asarray(step, jnp.int32)))
        assert abs(got(step) - w) <= 1e-6 * w, (step, got(step), w)


# ── losses and the oracle ──────────────────────────────────────────────────

def _waves(seed, shape=(2, 4000)):
    r = _rng(seed)
    clean = (r.standard_normal(shape) * 0.3).astype(np.float32)
    est = (clean + r.standard_normal(shape) * 0.1).astype(np.float32)
    return est, clean


@pytest.mark.parametrize("masked", [False, True])
def test_si_snr_loss(masked):
    from sincformer_tpu.train.losses import si_snr_loss as jloss
    from sincformer_tpu_torch.train.losses import si_snr_loss
    est, clean = _waves(60)
    mask = None
    if masked:
        mask = (np.arange(4000)[None, :] < np.array([[4000], [2500]])
                ).astype(np.float32)
    want = jax.jit(jloss)(jnp.asarray(est), jnp.asarray(clean),
                          None if mask is None else jnp.asarray(mask))
    got = si_snr_loss(torch.from_numpy(est), torch.from_numpy(clean),
                      None if mask is None else torch.from_numpy(mask))
    assert _rel(got, want) <= TOL


def test_multi_resolution_stft_loss():
    from sincformer_tpu.train.losses import multi_resolution_stft_loss as jl
    from sincformer_tpu_torch.train.losses import multi_resolution_stft_loss
    est, clean = _waves(61)
    want = jax.jit(jl)(jnp.asarray(est), jnp.asarray(clean))
    got = multi_resolution_stft_loss(torch.from_numpy(est),
                                     torch.from_numpy(clean))
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("framed", [False, True])
def test_mse_mask_loss(framed):
    from sincformer_tpu.train.losses import mse_mask_loss as jl
    from sincformer_tpu_torch.train.losses import mse_mask_loss
    r = _rng(62)
    pred = r.uniform(0, 1, (2, 50, 129)).astype(np.float32)
    oracle = r.uniform(0, 1, (2, 50, 129)).astype(np.float32)
    fm = (r.uniform(0, 1, (2, 50)) > 0.3).astype(np.float32) if framed else None
    want = jax.jit(jl)(jnp.asarray(pred), jnp.asarray(oracle),
                       None if fm is None else jnp.asarray(fm))
    got = mse_mask_loss(torch.from_numpy(pred), torch.from_numpy(oracle),
                        None if fm is None else torch.from_numpy(fm))
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("t", [51, 401])
def test_perceptual_stoi_loss(t):
    from sincformer_tpu.train.losses import PerceptualSTOILoss as JL
    from sincformer_tpu.train.losses import _third_octave_weights as jw
    from sincformer_tpu_torch.train.losses import (PerceptualSTOILoss,
                                                   _third_octave_weights)
    np.testing.assert_array_equal(_third_octave_weights(8000, 256),
                                  np.asarray(jw(8000, 256)))
    r = _rng(63)
    clean = r.uniform(0, 2, (2, 129, t)).astype(np.float32)
    enh = (clean * r.uniform(0.5, 1.5, clean.shape)).astype(np.float32)
    want = jax.jit(JL(8000, 256).__call__)(jnp.asarray(enh),
                                           jnp.asarray(clean))
    got = PerceptualSTOILoss(8000, 256)(torch.from_numpy(enh),
                                        torch.from_numpy(clean))
    assert _rel(got, want) <= TOL


def _oracle(xp, mod, ns, cs, noisy, clean):
    """The oracle of the stage-1/2 mask loss as the training loss builds it
    from the STFTs of a mixture and of its clean part (plus the frame-mode
    correlations); ``xp`` is jnp or torch."""
    nr, ni, cr, ci = ns.real, ns.imag, cs.real, cs.imag
    zr, zi = nr - cr, ni - ci
    atan2 = jnp.arctan2 if xp is jnp else torch.atan2

    def mag(a, b):
        return xp.sqrt(a ** 2 + b ** 2 + 1e-8)
    phi1, phi2 = mod.compute_phase_differences(
        atan2(ni, nr), atan2(ci, cr), atan2(zi, zr))
    rho_s, rho_n = mod.compute_correlation_coefficients(
        mag(nr, ni), mag(cr, ci), mag(zr, zi), per_unit=True)
    frames = [x[:, :1020].reshape(2, 3, 17, 20) for x in
              (noisy, clean, noisy - clean)]
    rho_f = mod.compute_correlation_coefficients(*frames, per_unit=False)
    return (rho_s, rho_n, *rho_f,
            mod.compute_pcirm(mag(cr, ci), mag(zr, zi), rho_s, rho_n, phi1,
                              phi2))


def test_pcirm_oracle():
    """On fixed inputs: the same STFT arrays (a mixture and its clean part)
    and waveforms in both packages. (From each package's own STFT the mask
    differs by up to 1.5e-5 at units where cos φ is near 0: the STFTs
    differ by float32 rounding, and the formula amplifies it there.)"""
    from sincformer_tpu.dsp.stft import stft as jstft
    from sincformer_tpu.masks import pcirm as jp
    from sincformer_tpu_torch.masks import pcirm as pp
    noisy, clean = _waves(64)
    ns, cs = (np.array(jax.jit(jstft)(jnp.asarray(x))) for x in
              (noisy, clean))
    want = jax.jit(lambda *a: _oracle(jnp, jp, *a))(
        jnp.asarray(ns), jnp.asarray(cs), jnp.asarray(noisy),
        jnp.asarray(clean))
    got = _oracle(torch, pp, torch.from_numpy(ns), torch.from_numpy(cs),
                  torch.from_numpy(noisy), torch.from_numpy(clean))
    for g, w in zip(got, want, strict=True):
        assert _rel(g, w) <= TOL
    r = _rng(65)
    phases = [r.uniform(-np.pi, np.pi, (2, 51, 129)).astype(np.float32)
              for _ in range(3)]
    for g, w in zip(pp.compute_phase_differences(
            *(torch.from_numpy(x) for x in phases)),
            jp.compute_phase_differences(*(jnp.asarray(x) for x in phases))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_metrics_logger_and_step_timer(tmp_path):
    from sincformer_tpu_torch.utils.observability import (MetricsLogger,
                                                          StepTimer)
    log = MetricsLogger(str(tmp_path / "sub" / "m.jsonl"))
    log.log({"epoch": 0, "loss": np.float32(1.5), "n": torch.tensor(3)})
    log.log({"epoch": 1, "loss": 0.5})
    rows = log.read_all()
    assert [r["seq"] for r in rows] == [0, 1]
    assert rows[0]["loss"] == 1.5 and rows[0]["n"] == 3
    timer = StepTimer()
    for _ in range(3):
        with timer.measure():
            pass
    assert timer.count == 3 and timer.last >= 0 and timer.ema >= 0
