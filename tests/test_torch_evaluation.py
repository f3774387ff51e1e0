"""Evaluation in the port against the JAX package on the CPU: each of the
five metrics, the batched sweep, the numpy copies, the grid at narrow width
(the narrow flagship of tests/_torch_parity.py and the narrow mask DNN,
bridged) with checkpoint discovery, the flagship's gain calibration, and
the protocol of the committed JAX reference scores.

Inputs are speech-like signals made with numpy from a seed and mixed with
seeded white noise at the grid's four SNRs (-5, 0, 5, 10 dB), plus one
clean signal with a silent span and signals shorter than a frame for the
edge returns. Bars: the [0, 1] metrics (STOI, CSII, NCM) and the PESQ
proxy 1e-5 absolute, SSNR 1e-4 dB; the numpy copies (``stoi_full``,
``stoi_independent``, ``pesq_p862``) equal to the last bit; through a
model (the grid's enhanced rows) 1e-4 absolute for every metric; the
calibrated gain 1e-5 relative. The JAX package's grid runs on a background
thread from the start of the file (``tests/_torch_parity.Ahead``)."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests._torch_parity import (NARROW, Ahead, jax_dnn_pipeline,
                                 narrow_model, speechlike,
                                 torch_dnn_pipeline)

UNIT_TOL = 1e-5
SSNR_TOL = 1e-4
MODEL_TOL = 1e-4
GAIN_REL = 1e-5
SNRS = (-5, 0, 5, 10)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _noise(n, seed=40):
    return (np.random.default_rng(seed).standard_normal(n) * 0.3).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _pairs():
    """(clean, noisy) pairs of 1.5 s at the four SNRs, one with a silent
    span at 5 dB."""
    from sincformer_tpu_torch.data.audio import add_noise_at_snr
    clean = speechlike(41, 12000)
    quiet = clean.copy()
    quiet[3000:6000] = 0.0
    noise = _noise(30000)
    return ([(clean, add_noise_at_snr(clean, noise, s)) for s in SNRS]
            + [(quiet, add_noise_at_snr(quiet, noise, 5))])


def _metric(name):
    """(port function, JAX function, bar) of a host entry point."""
    from sincformer_tpu import evaluation as jev
    from sincformer_tpu_torch import evaluation as pev
    if name == "pesq_proxy":
        return (lambda c, e: pev.compute_pesq(c, e, impl="proxy",
                                              device="cpu"),
                lambda c, e: jev.compute_pesq(c, e, impl="proxy"), UNIT_TOL)
    port = getattr(pev, f"compute_{name}")
    return (lambda c, e: port(c, e, device="cpu"),
            getattr(jev, f"compute_{name}"),
            SSNR_TOL if name == "ssnr" else UNIT_TOL)


@pytest.mark.parametrize("name", ["stoi", "pesq_proxy", "ssnr", "csii",
                                  "ncm"])
def test_metric_matches_jax(name):
    """The host entry point on the four SNRs and the silent span; a signal
    of 150 samples, shorter than a frame of SSNR, STOI and the PESQ proxy,
    for their edge returns (CSII: 100 samples); for CSII also signals of
    one and two frames (150 and 200 samples), its small-region branch."""
    port, ref, tol = _metric(name)
    pairs = list(_pairs())
    short = _noise(150, 42), _noise(150, 43)
    pairs.append(short)
    if name == "csii":
        pairs.append((_noise(200, 44), _noise(200, 45)))
    for clean, noisy in pairs:
        got, want = port(clean, noisy), ref(clean, noisy)
        assert abs(got - want) <= tol, (len(clean), got, want)
    # shorter than a frame (CSII's frame is 128 samples): the constant
    # edge return
    if name == "csii":
        short = _noise(100, 46), _noise(100, 47)
    if name != "ncm":
        assert port(*short) == ref(*short)
    if name == "csii":
        import torch

        from sincformer_tpu_torch.evaluation.csii import csii_torch
        # the common branch is the batched Σ w·MSC
        c, e = pairs[0]
        assert abs(float(csii_torch(torch.from_numpy(c),
                                    torch.from_numpy(e)))
                   - port(c, e)) <= UNIT_TOL


def test_numpy_copies_are_bit_equal():
    """``stoi_full`` (STOI and ESTOI), the STOI conformance witness and the
    native P.862 are the JAX package's numpy code: equal bits."""
    from sincformer_tpu.evaluation import p862 as jp862
    from sincformer_tpu.evaluation import stoi as jstoi
    from sincformer_tpu.evaluation import stoi_indep as jindep
    from sincformer_tpu_torch.evaluation import p862, stoi, stoi_indep
    clean, noisy = (x[:8000] for x in _pairs()[1])
    for ext in (False, True):
        assert stoi.stoi_full(clean, noisy, extended=ext) == \
            jstoi.stoi_full(clean, noisy, extended=ext)
    assert stoi_indep.stoi_independent(clean, noisy) == \
        jindep.stoi_independent(clean, noisy)
    assert p862.pesq_p862(clean, noisy, 8000) == \
        jp862.pesq_p862(clean, noisy, 8000)


def test_stoi_full_on_the_device_matches_jax():
    """The fixed-shape full STOI (stable-argsort compaction, FFT-domain
    resampling) against JAX's, on a pair with a silent span."""
    import sincformer_tpu.evaluation.stoi as jstoi
    from sincformer_tpu_torch.evaluation.stoi import stoi_full_torch
    clean, noisy = _pairs()[4]
    got = float(stoi_full_torch(clean, noisy, device="cpu"))
    want = float(jax.jit(jstoi.stoi_full_jax)(jnp.asarray(clean),
                                              jnp.asarray(noisy)))
    assert abs(got - want) <= UNIT_TOL


WITNESS_FS = 10000           # STOI's own rate: no resampler in the path
WITNESS_HOST_TOL = 1e-9      # float64 host STOI against the witness
WITNESS_CASES = ("awgn_-5dB", "awgn_0dB", "awgn_10dB", "lowpass", "clipped")


@functools.lru_cache(maxsize=None)
def _witness_pairs():
    """Seeded formant speech at 10 kHz with a pause (so the silent-frame
    removal has work to do), under the degradations of the JAX package's
    cross-check: white noise at three SNRs, a moving-average lowpass and
    hard clipping."""
    rng = np.random.default_rng(42)
    t = np.arange(2 * WITNESS_FS) / WITNESS_FS
    clean = sum(rng.uniform(0.3, 1.0) * np.sin(2 * np.pi * f * t
                                               + rng.uniform(0, 2 * np.pi))
                for f in (210.0, 640.0, 1150.0, 2400.0, 3300.0))
    clean *= 0.4 + 0.6 * np.sin(2 * np.pi * 3.1 * t) ** 2
    clean[int(0.9 * WITNESS_FS):int(1.15 * WITNESS_FS)] *= 0.001
    clean /= np.max(np.abs(clean))
    noise = rng.standard_normal(len(clean))
    cases = {}
    for snr in (-5, 0, 10):
        a = np.sqrt(np.mean(clean ** 2)
                    / (10 ** (snr / 10) * np.mean(noise ** 2)))
        cases[f"awgn_{snr}dB"] = clean + a * noise
    cases["lowpass"] = np.convolve(clean, np.ones(25) / 25, mode="same")
    cases["clipped"] = np.clip(clean, -0.2, 0.2)
    return clean, cases


@pytest.mark.parametrize("case", WITNESS_CASES)
def test_stoi_independent_witnesses_the_port_full_stoi(case):
    """The port's two full STOIs against its independent transcription of
    Taal et al. (2011), ``stoi_independent`` (no code shared with
    ``stoi.py``): the host ``stoi_full`` (STOI and ESTOI) within
    WITNESS_HOST_TOL, the fixed-shape float32 ``stoi_full_torch`` within
    UNIT_TOL. At 10 kHz, so the check holds the algorithm alone; the 8 kHz
    resampling path is held against JAX above."""
    from sincformer_tpu_torch.evaluation.stoi import (stoi_full,
                                                      stoi_full_torch)
    from sincformer_tpu_torch.evaluation.stoi_indep import stoi_independent
    clean, cases = _witness_pairs()
    noisy = cases[case]
    want = stoi_independent(clean, noisy, WITNESS_FS)
    assert 0.0 < want < 1.0
    assert abs(stoi_full(clean, noisy, WITNESS_FS) - want) \
        <= WITNESS_HOST_TOL
    assert abs(stoi_full(clean, noisy, WITNESS_FS, extended=True)
               - stoi_independent(clean, noisy, WITNESS_FS, extended=True)) \
        <= WITNESS_HOST_TOL
    got = float(stoi_full_torch(clean, noisy, fs=WITNESS_FS, device="cpu"))
    assert abs(got - want) <= UNIT_TOL


def test_metrics_batch_matches_jax():
    """One sweep over (4, 16000) pairs: the device metrics within their
    bars, PESQ (the native P.862 on host threads) equal."""
    from sincformer_tpu.evaluation.batched import metrics_batch as jax_batch
    from sincformer_tpu_torch.data.audio import add_noise_at_snr
    from sincformer_tpu_torch.evaluation.batched import metrics_batch
    clean = np.stack([speechlike(50 + i, 16000) for i in range(4)])
    noisy = np.stack([add_noise_at_snr(c, _noise(16000, 60 + i), s)
                      for i, (c, s) in enumerate(zip(clean, SNRS))])
    got = metrics_batch(clean, noisy, device="cpu")
    want = jax_batch(clean, noisy)
    assert set(got) == set(want) == {"stoi", "pesq", "ssnr", "csii", "ncm"}
    for k in ("stoi", "csii", "ncm"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=UNIT_TOL)
    np.testing.assert_allclose(got["ssnr"], want["ssnr"], rtol=0,
                               atol=SSNR_TOL)
    np.testing.assert_array_equal(got["pesq"], want["pesq"])


# ── the grid at narrow width ───────────────────────────────────────────────

@functools.lru_cache(maxsize=None)
def _jax_flagship():
    """The JAX SincformerPipeline at the NARROW widths holding the weights
    of tests/_torch_parity.py."""
    import tempfile

    import optax

    from sincformer_tpu.agents.metacog import SincformerMetacog as JaxModel
    from sincformer_tpu.train.agent_trainer import SincformerPipeline
    from sincformer_tpu.train.state import TrainState
    _, v, _ = narrow_model()
    model = JaxModel(**NARROW, dropout=0.0, attn_impl="speech",
                     pa_fine_act="mulaw")
    pipe = SincformerPipeline(model=model, model_dir=tempfile.mkdtemp())
    pipe.state = TrainState.create(
        apply_fn=model.apply, params=jax.tree.map(jnp.asarray, v["params"]),
        tx=optax.identity(),
        model_state={k: jax.tree.map(jnp.asarray, v[k])
                     for k in ("maa_stats", "memory_bank", "memory_stats")},
        nan_count=jnp.zeros((), jnp.int32))
    return pipe


def _port_flagship(model_dir=None):
    import copy

    from sincformer_tpu_torch import SincformerPipeline
    return SincformerPipeline(copy.deepcopy(narrow_model()[2]), device="cpu",
                              model_dir=model_dir)


def _grid_inputs():
    from sincformer_tpu_torch.data.synthetic import synthetic_speech
    rng = np.random.default_rng(99)
    clean = [synthetic_speech(2.0) * (0.7 + 0.6 * rng.random())
             for _ in range(2)]
    return clean, {"white": _noise(8000 * 30, 7)}


GRID_SNRS = [0, 10]


def _jax_grid(model_dir: str):
    """The JAX package's grid of :func:`test_evaluate_grid_matches_jax`."""
    from sincformer_tpu.evaluation.grid import evaluate_grid as jax_grid
    clean, noises = _grid_inputs()
    return jax_grid(clean, noises, {
        "sincformer": _jax_flagship(),
        "pcirm": jax_dnn_pipeline(model_dir)}, GRID_SNRS, verbose=False)


@pytest.fixture(scope="module", autouse=True)
def ahead(tmp_path_factory):
    import sincformer_tpu.evaluation.grid  # noqa: F401
    import sincformer_tpu.train.agent_trainer  # noqa: F401
    narrow_model()
    grid_dir = str(tmp_path_factory.mktemp("jax_grid"))
    a = Ahead()
    with a.start([(_jax_grid, grid_dir)], threads=1):
        a.grid_dir = grid_dir
        yield a


def test_evaluate_grid_matches_jax(ahead):
    """2 utterances × 1 noise × 2 SNRs through the flagship and the mask
    DNN, batched: every cell's values within the metric bars (noisy row)
    or 1e-4 (enhanced rows), the P.862 of the noisy row equal."""
    from sincformer_tpu_torch.evaluation.grid import evaluate_grid
    clean, noises = _grid_inputs()
    snrs = GRID_SNRS
    got = evaluate_grid(clean, noises, {
        "sincformer": _port_flagship(), "pcirm": torch_dnn_pipeline()},
        snrs, verbose=False, device="cpu")
    want = ahead(_jax_grid, ahead.grid_dir)
    assert list(got["white"]) == ["noisy", "sincformer", "pcirm"]
    for method, by_snr in want["white"].items():
        for snr, cell in by_snr.items():
            for k, w in cell.items():
                g = got["white"][method][snr][k]
                assert len(g) == len(w) == 2, (method, snr, k)
                if method == "noisy":
                    tol = {"ssnr": SSNR_TOL, "pesq": 0.0}.get(k, UNIT_TOL)
                else:
                    tol = MODEL_TOL
                np.testing.assert_allclose(g, w, rtol=0, atol=tol,
                                           err_msg=f"{method} {snr} {k}")


def test_evaluate_grid_refuses_a_pipeline_without_enhance_batch():
    """The grid is batched only (every pipeline of the port has
    ``enhance_batch``): a pipeline without it is refused before any cell
    is scored, not counted as a failed enhancement."""
    from sincformer_tpu_torch.evaluation.grid import evaluate_grid

    class Serial:
        def enhance_signal(self, x):
            return x
    with pytest.raises(TypeError, match="serial"):
        evaluate_grid([speechlike(41, 8000)], {"white": _noise(8000)},
                      {"serial": Serial()}, verbose=False, device="cpu")


def test_discover_pipelines_on_port_checkpoints(tmp_path):
    """Checkpoints that the port saved (the narrow flagship and DNN) are
    found and loaded, and serve what the pipelines that saved them
    serve."""
    from sincformer_tpu_torch.evaluation.grid import discover_pipelines
    flagship = _port_flagship(str(tmp_path))
    flagship.output_gain = 1.25
    flagship.save_model()
    dnn = torch_dnn_pipeline(model_dir=str(tmp_path))
    dnn.save_model()
    found = discover_pipelines(str(tmp_path), device="cpu")
    assert list(found) == ["pcirm", "sincformer"]
    assert found["sincformer"].output_gain == 1.25
    x = speechlike(70, 4000)[None]
    for name, pipe in (("sincformer", flagship), ("pcirm", dnn)):
        np.testing.assert_array_equal(found[name].enhance_batch(x),
                                      pipe.enhance_batch(x))


def test_committed_reference_protocol_is_what_evaluate_runs():
    """``artifacts/r5/eval_grid_jax_cpu.json`` (scripts/torch_eval_reference.py)
    holds the grid that the port's ``evaluate`` verb runs by default: the
    same utterance draw, noise bank, SNRs and checkpoint family, and a
    full set of flagship cells."""
    from sincformer_tpu_torch.config import DataConfig
    from sincformer_tpu_torch.data.loader import load_noise_signals
    from sincformer_tpu_torch.evaluation.grid import eval_utterances
    with open(os.path.join(REPO, "artifacts", "r5",
                           "eval_grid_jax_cpu.json")) as f:
        ref = json.load(f)
    protocol = ref["protocol"]
    utterances = eval_utterances(protocol["max_eval"])
    assert protocol["max_eval"] == 50
    assert protocol["n_utterances"] == len(utterances) == 8
    assert protocol["noises"] == list(load_noise_signals(8000)) == ["white"]
    assert protocol["snr_levels"] == list(DataConfig().snr_levels)
    assert (protocol["synth_noises"], protocol["synth_speech"],
            protocol["ckpt_pref"]) == ("white", "formant", "final")
    assert protocol["methods"] == ["sincformer"]
    for method in ("noisy", "sincformer"):
        for snr in map(str, DataConfig().snr_levels):
            cell = ref["results"]["white"][method][snr]
            assert set(cell) == {"stoi", "pesq", "ssnr", "csii", "ncm"}
            assert all(len(v) == 8 and np.all(np.isfinite(v))
                       for v in cell.values())


def test_calibrate_gain_matches_jax(tmp_path):
    """The flagship's post-hoc calibration on 2 synthetic utterances with
    held-out noise: the gain equals JAX's to 1e-5 relative; it is written
    into the loaded checkpoint's sidecar and a fresh load reads it."""
    from sincformer_tpu_torch import SincformerPipeline
    clean, noises = _grid_inputs()
    jpipe = _jax_flagship()
    want = jpipe.calibrate_gain(clean, noises, persist=False)
    port = _port_flagship(str(tmp_path))
    path = port.save_model()
    port.load_model()
    got = port.calibrate_gain(clean, noises)
    assert abs(got - want) <= GAIN_REL * abs(want) and got != 1.0
    fresh = SincformerPipeline(device="cpu", model_dir=str(tmp_path))
    assert fresh.load_model() == path and fresh.output_gain == got


def test_evaluate_and_calibrate_verbs_on_the_cpu(tmp_path, monkeypatch,
                                                 capsys):
    """``test`` (the alias of ``evaluate``) with ``--max-eval 2`` over a
    narrow flagship the port saved, the utterances cut to 0.5 s: exit 0,
    every cell of the JSON record full; then ``calibrate --samples 2
    --synthetic`` persists a new gain that a fresh load reads."""
    from sincformer_tpu_torch import SincformerPipeline, cli
    from sincformer_tpu_torch.evaluation import grid
    _port_flagship(str(tmp_path)).save_model()
    monkeypatch.setenv("SINCFORMER_MODEL_DIR", str(tmp_path))
    draw = grid.eval_utterances
    monkeypatch.setattr(grid, "eval_utterances", lambda *a: [
        u[:4000] for u in draw(*a)])
    out = str(tmp_path / "grid.json")
    assert cli.main(["test", "--max-eval", "2", "--device", "cpu",
                     "--json-out", out]) == 0
    assert "FAILED" not in capsys.readouterr().out
    with open(out) as f:
        record = json.load(f)
    assert record["protocol"]["methods"] == ["sincformer"]
    cells = record["results"]["white"]
    assert all(len(v) == 2 and np.all(np.isfinite(v))
               for by_snr in cells.values() for cell in by_snr.values()
               for v in cell.values())
    assert cli.main(["calibrate", "--samples", "2", "--synthetic",
                     "--device", "cpu"]) == 0
    fresh = SincformerPipeline(device="cpu", model_dir=str(tmp_path))
    fresh.load_model()
    assert fresh.output_gain != 1.0
