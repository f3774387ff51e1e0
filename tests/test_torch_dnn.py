"""The original-paper DNN-mask path of the port against the JAX package's
``DNNPipeline``: the DNN alone, and the slice as a whole (features → z-score
→ DNN → mask onto 129 bins → masked uncentred iSTFT) on weights and feature
statistics saved by the JAX package in float32 and as an int8 export and
carried over by ``compat.from_jax``.

Narrow DNN (594 → 2 × 64 → 64), 1 s speech-like signals, float32 on the CPU
on both sides. Tolerance for waveforms: 1e-4 of the reference's peak (the
widest input delta is the GFCC block, 1.5e-5 of its scale at 1 s, see
tests/test_torch_features.py; it passes a z-score, three layers and a
sigmoid; measured 1.0e-5). The 16 samples at each end of the span that the
valid frames cover are held to 1e-3 of their own magnitude instead: there a
single frame is divided by a symmetric-Hann value under 0.1 (down to
3.9e-4), which amplifies the float32 noise of the inverse FFT by up to
2,560 in both packages, and those samples (up to 29 in a signal of peak
0.25) would otherwise set both the peak and the difference. The DNN alone:
1e-6 absolute on a sigmoid output."""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from sincformer_tpu.models.dnn import SpeechEnhancementDNN as JaxDNN
from sincformer_tpu.serve import StreamingEnhancer as JaxStreamingEnhancer
from sincformer_tpu.train.dnn_trainer import DNNPipeline as JaxDNNPipeline
from sincformer_tpu.train.state import latest_step_dir
from sincformer_tpu_torch import (DNNPipeline, SpeechEnhancementDNN,
                                  StreamingEnhancer, cli,
                                  convert_quantized_dnn_from_jax, create_dnn,
                                  dequantize_tree, load_dnn_from_jax)

from _torch_parity import (NARROW_DNN, dnn_variables, jax_dnn_pipeline,
                           speechlike, torch_dnn_pipeline)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAVE_TOL = 1e-4
N_ODD = 7300              # not a multiple of the 2000-sample padding quantum


WAVE_TOL_EDGE = 1e-3
EDGE = 16                 # samples whose window value is under 0.1


def _valid_end(n_true):
    """End of the span that the frames inside ``n_true`` samples cover."""
    return ((n_true - 160) // 80) * 80 + 160


def _rel(got, ref, valid_end=None):
    """Largest difference relative to the peak, both taken away from the
    edges of the valid span; the edges are checked here, sample by sample,
    and what lies past the span must be zero."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.all(np.isfinite(got))
    end = got.shape[-1] if valid_end is None else valid_end
    core = slice(EDGE, end - EDGE)
    diff = np.abs(got - ref)
    peak = np.abs(ref[..., core]).max()
    for edge in (slice(0, EDGE), slice(end - EDGE, end)):
        assert np.all(diff[..., edge] <= WAVE_TOL_EDGE * np.abs(ref[..., edge])
                      + WAVE_TOL * peak)
    assert not got[..., end:].any() and not ref[..., end:].any()
    return float(diff[..., core].max() / peak)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _rounding_moved(got, ref):
    """Relative L2 difference of two waveforms whose weights differ by one
    int8 rounding."""
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


# ── the DNN alone ───────────────────────────────────────────────────────────

def test_dnn_forward_matches_flax():
    variables, _, _ = dnn_variables()
    x = np.random.default_rng(0).standard_normal((7, 594)).astype(np.float32)
    ref = JaxDNN(input_dim=594, hidden_dim=64, output_dim=64,
                 num_hidden_layers=2).apply(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(x))
    state, sizes = load_dnn_from_jax(variables)
    assert sizes == {"input_dim": 594, "hidden_dim": 64, "output_dim": 64,
                     "num_hidden_layers": 2, "dropout": 0.2}
    model = SpeechEnhancementDNN(**sizes).eval()
    model.load_state_dict(state, strict=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert np.abs(got - np.asarray(ref)).max() <= 1e-6
    assert got.min() >= 0.0 and got.max() <= 1.0


def test_create_dnn_is_the_paper_configuration():
    model = create_dnn(594)
    assert [tuple(p.shape) for p in model.parameters()] == [
        (1024, 594), (1024,), (1024, 1024), (1024,), (1024, 1024), (1024,),
        (64, 1024), (64,)]
    assert model.dropout.p == 0.2
    model.init_params(torch.Generator().manual_seed(0))
    again = create_dnn(594).init_params(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))


@pytest.mark.parametrize("fault", ["missing layer", "stray leaf",
                                   "stray collection", "wrong shape"])
def test_bridge_refuses_a_tree_it_cannot_place(fault):
    variables, _, _ = dnn_variables()
    params = {k: dict(v) for k, v in variables["params"].items()}
    tree = {"params": params}
    if fault == "missing layer":
        del params["output"]
    elif fault == "stray leaf":
        params["hidden_0"]["scale"] = np.ones(64, np.float32)
    elif fault == "stray collection":
        tree["batch_stats"] = {}
    else:
        params["hidden_1"]["bias"] = np.zeros(63, np.float32)
    with pytest.raises(ValueError):
        load_dnn_from_jax(tree)


# ── the slice as a whole ────────────────────────────────────────────────────

def _read_jax_serving_tree(step_dir, state):
    spec = importlib.util.spec_from_file_location(
        "torch_convert_artifact",
        os.path.join(REPO, "scripts", "torch_convert_artifact.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script.read_jax_serving_tree(step_dir, state)[0]


@pytest.fixture(scope="module", params=["f32", "int8"])
def saved_by_jax(request, tmp_path_factory):
    """A checkpoint written by the JAX DNNPipeline (float32, or the int8
    export), restored by a second JAX pipeline, and the port's pipeline
    built from the restored tree and the sidecar's feature statistics."""
    model_dir = str(tmp_path_factory.mktemp(f"jax_dnn_{request.param}"))
    writer = jax_dnn_pipeline(model_dir)
    writer.save_model(quantize=request.param == "int8")
    step_dir = latest_step_dir(os.path.join(model_dir, "dnn_pcirm_final"))
    reference = JaxDNNPipeline(
        mask_type="pcirm", use_rbm_pretrain=False, model_dir=model_dir,
        dcfg=writer.dcfg)
    assert reference.load_model() == step_dir
    with open(step_dir + ".meta.json") as f:
        meta = json.load(f)
    restored = _numpy_tree(reference.state.params)
    port = torch_dnn_pipeline(restored)
    port.feat_mean = np.asarray(meta["feat_mean"], np.float32)
    port.feat_std = np.asarray(meta["feat_std"], np.float32)
    return request.param, reference, port, step_dir, writer, meta


def test_sidecar_and_int8_tree_carry_over(saved_by_jax):
    kind, reference, port, step_dir, writer, meta = saved_by_jax
    _, mean, std = dnn_variables()
    assert np.array_equal(port.feat_mean, mean)
    assert np.array_equal(port.feat_std, std)
    assert meta["mask_type"] == "pcirm"
    assert (meta["feature_dim"], meta["mask_dim"]) == (594, 64)
    if kind == "int8":
        params_q = _read_jax_serving_tree(step_dir, writer.state)
        converted, sizes = convert_quantized_dnn_from_jax(params_q)
        assert sizes["hidden_dim"] == NARROW_DNN["hidden_units"]
        assert all(converted[f"{layer}.weight"]["q"].dtype == torch.int8
                   for layer in ("hidden_0", "hidden_1", "output"))
        direct, _ = load_dnn_from_jax(_numpy_tree(reference.state.params))
        dequantized = dequantize_tree(converted)
        assert set(dequantized) == set(direct)
        for name, value in direct.items():
            assert torch.equal(dequantized[name], value), name


def test_enhance_signal_matches_jax(saved_by_jax):
    """A length that is no multiple of the padding quantum: both sides pad
    to 8000 and mask the frames past the true length."""
    _, reference, port, *_ = saved_by_jax
    noisy = speechlike(11, N_ODD)
    ref = reference.enhance_signal(noisy)
    got = port.enhance_signal(noisy)
    assert got.shape == (N_ODD,)
    assert _rel(got, ref, _valid_end(N_ODD)) <= WAVE_TOL
    pcm = np.round(noisy * 32767).astype(np.int16)
    assert _rel(port.enhance_signal(pcm), reference.enhance_signal(pcm),
                _valid_end(N_ODD)) <= WAVE_TOL


def test_enhance_batch_with_lengths_matches_jax(saved_by_jax):
    _, reference, port, *_ = saved_by_jax
    noisy = np.stack([speechlike(12, 8000), speechlike(13, 8000)])
    noisy[1, 5000:] = 0.0
    lengths = np.array([8000, 5000])
    ref = reference.enhance_batch(noisy, lengths)
    got = port.enhance_batch(noisy, lengths)
    # frames past a row's length are masked: nothing after its valid span
    for row, n_true in enumerate(lengths):
        assert _rel(got[row], ref[row], _valid_end(n_true)) <= WAVE_TOL
    full = port.enhance_batch(noisy)
    assert _rel(full, reference.enhance_batch(noisy)) <= WAVE_TOL
    pcm = np.round(noisy * 32767).astype(np.int16)
    got, ref = (p.enhance_batch(pcm, lengths) for p in (port, reference))
    for row, n_true in enumerate(lengths):
        assert _rel(got[row], ref[row], _valid_end(n_true)) <= WAVE_TOL


def test_streaming_host_path_matches_jax(saved_by_jax):
    """12,000 samples in windows of 8000 with a 400-sample cross-fade: two
    windows through ``enhance_batch`` and the host overlap-add."""
    _, reference, port, *_ = saved_by_jax
    noisy = speechlike(14, 12000)
    ref = JaxStreamingEnhancer(reference, window=8000, overlap=400).enhance(
        noisy)
    enhancer = StreamingEnhancer(port, window=8000, overlap=400)
    assert not enhancer._has_device_path()
    got = enhancer.enhance(noisy)
    assert got.shape == (12000,)
    assert _rel(got, ref) <= WAVE_TOL


def test_padding_quantum_is_part_of_the_numbers():
    """The whole-utterance RASTA-PLP mean runs over the padded signal, so
    another quantum gives another (close) answer; the port keeps the JAX
    package's 2000."""
    port = torch_dnn_pipeline()
    noisy = speechlike(15, N_ODD)
    a = port.enhance_signal(noisy)
    b = port.enhance_signal(noisy, pad_quantum=N_ODD)
    assert a.shape == b.shape and 0 < np.abs(a - b).max()


# ── the port's own checkpoints and CLI ──────────────────────────────────────

def test_pipeline_needs_a_model_and_a_known_mask():
    pipe = DNNPipeline(device="cpu")
    assert pipe.save_model() is None
    with pytest.raises(RuntimeError, match="load_model"):
        pipe.enhance_signal(np.zeros(800, np.float32))
    with pytest.raises(FileNotFoundError):
        DNNPipeline(device="cpu", model_dir="/nonexistent").load_model()
    with pytest.raises(ValueError, match="mask_type"):
        DNNPipeline(mask_type="ibm", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DNNPipeline()


@pytest.mark.parametrize("quantize", [False, True])
def test_save_load_round_trip(tmp_path, quantize):
    pipe = torch_dnn_pipeline(model_dir=str(tmp_path), mask_type="irm")
    pipe.step = 7
    path = pipe.save_model(quantize=quantize)
    assert path.endswith(os.path.join("dnn_irm_final", "step_7"))
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    assert meta["mask_type"] == "irm" and meta["feature_dim"] == 594
    assert meta["mask_dim"] == 64 and meta.get("quantized", False) == quantize
    loaded = DNNPipeline(mask_type="irm", device="cpu",
                         model_dir=str(tmp_path))
    assert loaded.load_model() == path and loaded.step == 7
    assert np.array_equal(loaded.feat_mean, pipe.feat_mean)
    assert np.array_equal(loaded.feat_std, pipe.feat_std)
    assert loaded.model.sizes == pipe.model.sizes
    for (name, a), b in zip(pipe.model.named_parameters(),
                            loaded.model.parameters()):
        if quantize and a.ndim == 2:
            step = a.detach().abs().amax(dim=1, keepdim=True) / 127.0
            assert float(((a.detach() - b.detach()).abs() / step).max()
                         ) <= 1.0 + 1e-6, name
        else:
            assert torch.equal(a, b), name
    noisy = speechlike(16, 4000)
    assert _rounding_moved(loaded.enhance_signal(noisy),
                           pipe.enhance_signal(noisy)) <= (
        5e-2 if quantize else 0.0)
    # the best-validation family is found when it is the only one
    best = torch_dnn_pipeline(model_dir=str(tmp_path / "b"), mask_type="irm")
    best.save_model("best_irm")
    assert DNNPipeline(mask_type="irm", device="cpu", model_dir=str(
        tmp_path / "b")).load_model().endswith(os.path.join("best_irm",
                                                            "step_0"))


def test_cli_enhance_and_export(tmp_path, monkeypatch, capsys):
    """``enhance --model pcirm --device cpu`` on a WAV file and ``export
    --model dnn``; the exported directory is a drop-in model directory."""
    model_dir = tmp_path / "models"
    pipe = torch_dnn_pipeline(model_dir=str(model_dir))
    pipe.save_model()
    monkeypatch.setenv("SINCFORMER_MODEL_DIR", str(model_dir))
    monkeypatch.delenv("SINCFORMER_CKPT_PREF", raising=False)
    noisy = speechlike(17, N_ODD)
    src, dst = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
    wavfile.write(src, 8000, noisy)
    assert cli.main(["enhance", src, dst, "--model", "pcirm", "--device",
                     "cpu"]) == 0
    assert "Using model: pcirm" in capsys.readouterr().out
    rate, out = wavfile.read(dst)
    assert rate == 8000 and out.shape == (N_ODD,)
    want = np.clip(pipe.enhance_signal(noisy), -1.0, 1.0)
    assert np.abs(out - want).max() <= 1e-6
    # no flagship or DCSE checkpoint here: the preference order falls
    # through to the first mask DNN
    assert cli.main(["enhance", src, dst, "--device", "cpu"]) == 0
    assert "Using model: pcirm" in capsys.readouterr().out
    assert cli.main(["enhance", src, dst, "--model", "irm", "--device",
                     "cpu"]) == 1

    exported = str(tmp_path / "serving")
    assert cli.main(["export", "--model", "dnn", "--mask-type", "pcirm",
                     "--ckpt", "final", "--out", exported, "--device",
                     "cpu"]) == 0
    served = DNNPipeline(device="cpu", model_dir=exported)
    path = served.load_model()
    with open(path + ".meta.json") as f:
        assert json.load(f)["quantized"] is True
    assert np.array_equal(served.feat_mean, pipe.feat_mean)
    assert _rounding_moved(served.enhance_signal(noisy),
                           pipe.enhance_signal(noisy)) <= 5e-2
    with open(os.path.join(exported, "dnn_pcirm_final",
                           "train_meta.json")) as f:
        assert json.load(f)["source_ckpt_pref"] == "final"
    assert cli.main(["info", "--device", "cpu"]) == 0
    assert "DNN Hidden Units:   1024" in capsys.readouterr().out


@pytest.mark.parametrize("verb", ["train", "evaluate", "test", "demo"])
def test_cli_names_what_is_still_missing(verb, capsys, tmp_path,
                                         monkeypatch):
    """Nothing of the JAX package's CLI is missing: ``_MISSING`` is empty
    and the parser has no epilog. ``evaluate --distributed`` and its alias
    ``test`` run on a single process (the whole grid, exit 0; an identity
    enhancer and the synthetic utterances stand in for trained models and
    TIMIT). ``demo`` and ``train --pipeline dnn`` (the default) are ported,
    and a bare ``train`` without a dataset says that the speech files are
    missing (exit 1), not that it is not ported."""
    assert cli._MISSING == "" and cli.build_parser().epilog is None
    if verb in ("evaluate", "test"):
        import sincformer_tpu_torch.evaluation.grid as grid
        from tests._torch_dp_worker import Identity
        monkeypatch.setenv("SINCFORMER_MODEL_DIR", str(tmp_path))
        monkeypatch.setattr(grid, "discover_pipelines",
                            lambda *a, **k: {"identity": Identity()})
        monkeypatch.setattr(grid, "find_speech_files", lambda *a, **k: [])
        assert cli.main([verb, "--distributed", "--max-eval", "1",
                         "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "process 0 of 1" in out and "GRAND SUMMARY" in out
        return
    if verb == "train":
        monkeypatch.setenv("SINCFORMER_TIMIT_DIR", str(tmp_path))
        assert cli.main(["train", "--device", "cpu"]) == 1
        err = capsys.readouterr().err
        assert "No speech files" in err and "not ported" not in err