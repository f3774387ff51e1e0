"""Flagship training in the port on the CPU at narrow width, without JAX:
a save and restore in the middle of training changes nothing, the
curriculum loop runs through ``SincformerTrainer.train`` and through the
``train`` verb of the CLI and leaves checkpoints that ``load_model``
serves, and what is not ported says so."""

import json
import os

import numpy as np
import pytest
import torch

from tests._torch_parity import NARROW, wave

HISTORY_KEYS = {"epoch", "stage", "train_loss", "val_loss", "val_sisnr",
                "nan_count", "epoch_seconds"}


def _pipe(model_dir, **config):
    from sincformer_tpu_torch import MetacogConfig, SincformerMetacog
    from sincformer_tpu_torch.train.agent_trainer import SincformerTrainer
    model = SincformerMetacog(MetacogConfig(**NARROW, **config))
    return SincformerTrainer(model, device="cpu", model_dir=str(model_dir))


def _step(pipe, seed):
    noisy = torch.from_numpy(wave(seed))
    clean = torch.from_numpy(wave(seed + 1) * 0.5)
    return pipe.train_step(noisy, clean, 1.0, 1.0, 1.5, 1.0)


def test_save_restore_step_equals_uninterrupted(tmp_path):
    """Parameters (CPEA K and b as they are), buffers, AdamW moments and
    count, step and NaN count survive a full checkpoint bit for bit: the
    step after a restore equals the step without one."""
    from sincformer_tpu_torch.train.agent_trainer import SincformerTrainer
    a = _pipe(tmp_path, dropout=0.0, routing="softmax")
    a.init_state(3, 2)
    _step(a, 1)
    a.nan_count += 1                       # carried like the rest
    path = a.save_model("sincformer_final")
    _step(a, 3)

    b = SincformerTrainer(device="cpu", model_dir=str(tmp_path))
    assert b.load_model() == path
    assert b.model.config == a.model.config and b.step == 1
    b.init_state(3, 2, reset_optimizer=False)
    _step(b, 3)
    assert b.step == a.step == 2 and int(b.nan_count) == int(a.nan_count) == 1
    for (name, x), (name_b, y) in zip(a.model.state_dict(keep_vars=True)
                                      .items(),
                                      b.model.state_dict(keep_vars=True)
                                      .items()):
        assert name == name_b and torch.equal(x, y), name
    for k, p in a.params().items():
        assert torch.equal(p, b.params()[k]), k
        for m in ("mu", "nu"):
            assert torch.equal(a.opt_state[m][k], b.opt_state[m][k]), k
    assert a.opt_state["count"] == b.opt_state["count"] == 2


def test_train_loop_checkpoints_and_serving(tmp_path):
    """Two epochs of the curriculum on 6 synthetic utterances of 0.5 s: the
    JAX package's history keys, finite losses, best and final checkpoints
    (the best one with its validation protocol), each served by
    load_model."""
    from sincformer_tpu_torch import SincformerPipeline
    from sincformer_tpu_torch.cli import _synthetic_corpus
    from sincformer_tpu_torch.train.state import read_train_meta
    clean, noises = _synthetic_corpus(6)
    pipe = _pipe(tmp_path)
    history = pipe.train(clean[:5], clean[5:], noises, epochs=2,
                         max_len=4000, verbose=False)
    pipe.save_model()
    assert [h["epoch"] for h in history] == [0, 1]
    for h in history:
        assert set(h) == HISTORY_KEYS and h["nan_count"] == 0
        assert np.isfinite(h["train_loss"]) and np.isfinite(h["val_loss"])
    meta = read_train_meta(str(tmp_path), "best_sincformer")
    assert meta["val_protocol"] == 2 and np.isfinite(meta["best_val"])
    assert np.isfinite(meta["output_gain"]) and meta["output_gain"] > 0
    assert pipe.step == 2
    for family, step in (("sincformer_final", 2),
                         ("best_sincformer", meta["step"])):
        served = SincformerPipeline(device="cpu", model_dir=str(tmp_path))
        step_dir = os.path.join(str(tmp_path), family, f"step_{step}")
        assert served.load_model(step_dir) == step_dir
        out = served.enhance_signal(wave(11, (3000,)))
        assert out.shape == (3000,) and np.all(np.isfinite(out))


def test_train_verb_in_process(tmp_path, monkeypatch, capsys):
    """``train --pipeline agents --synthetic 6 --epochs 2 --device cpu`` with
    the model factory at narrow width and 0.5 s utterances, then
    ``--resume`` for a third epoch; the log has one record per epoch."""
    from sincformer_tpu_torch import SincformerPipeline, cli
    from sincformer_tpu_torch.train import agent_trainer
    factory = agent_trainer.default_metacog
    monkeypatch.setattr(agent_trainer, "default_metacog",
                        lambda **kw: factory(**{**NARROW, **kw}))
    monkeypatch.setenv("SINCFORMER_MAX_WAVE_SECONDS", "0.5")
    monkeypatch.setenv("SINCFORMER_MODEL_DIR", str(tmp_path))
    monkeypatch.setenv("SINCFORMER_CKPT_PREF", "final")
    log = str(tmp_path / "log.jsonl")
    argv = ["train", "--pipeline", "agents", "--synthetic", "6", "--device",
            "cpu", "--log-jsonl", log]
    assert cli.main(argv + ["--epochs", "2"]) == 0
    assert cli.main(argv + ["--epochs", "3", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "Resuming from" in out and "Epoch   3/3" in out
    records = [json.loads(line) for line in open(log)]
    assert [r["epoch"] for r in records] == [0, 1, 2]
    assert all(HISTORY_KEYS <= set(r) and r["pipeline"] == "sincformer"
               and np.isfinite(r["train_loss"]) for r in records)
    served = SincformerPipeline(device="cpu")
    assert served.load_model().endswith(os.path.join("sincformer_final",
                                                     "step_3"))
    assert served.model.config.d_model == NARROW["d_model"]
    assert np.all(np.isfinite(served.enhance_signal(wave(12, (4000,)))))


@pytest.mark.parametrize("argv", [["train"],
                                  ["train", "--pipeline", "dcse"],
                                  ["train", "--pipeline", "conformer"]])
def test_train_verb_names_what_is_not_ported(argv, capsys, tmp_path,
                                             monkeypatch):
    """Every pipeline of ``train`` is ported: without a dataset (and
    without ``--synthetic``) each says that the speech files are missing
    (exit 1), none that it is not ported; nothing of the CLI is missing
    (``_MISSING`` is empty)."""
    from sincformer_tpu_torch import cli
    monkeypatch.setenv("SINCFORMER_TIMIT_DIR", str(tmp_path))
    assert cli.main(argv + ["--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "No speech files" in err and "not ported" not in err
    assert cli._MISSING == ""


def test_adversarial_pipeline_raises():
    """The adversarial trainer builds its discriminator; a step before
    ``init_state`` made the optimizers raises and says so."""
    from sincformer_tpu_torch.train.adversarial import \
        MultiScaleDiscriminator
    pipe = _pipe("unused")
    pipe = type(pipe)(pipe.model, device="cpu", use_adversarial=True)
    assert isinstance(pipe.disc, MultiScaleDiscriminator)
    with pytest.raises(RuntimeError, match="init_state"):
        _step(pipe, 1)


def test_card_entry_points_turn_tf32_off(monkeypatch):
    """A pipeline on the card computes in float32: picking CUDA turns TF32
    off in cuBLAS and cuDNN (PyTorch leaves it on in cuDNN); the CPU
    leaves the flags alone."""
    from sincformer_tpu_torch.pipeline import resolve_device
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert resolve_device("cpu").type == "cpu"
    assert torch.backends.cudnn.allow_tf32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device("cuda").type == "cuda"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_native_wav_reader_equals_scipy(tmp_path):
    """``load_audio`` decodes a written WAV through the native library,
    built from native/wavio.cpp into the package's build directory, to
    scipy's values: int16 mono at 8 kHz bit for bit, and int16 stereo at
    16 kHz mixed down and resampled within float32 rounding."""
    from scipy.io import wavfile

    from sincformer_tpu_torch.data import native
    from sincformer_tpu_torch.data.audio import load_audio
    from sincformer_tpu_torch.ops.build import BUILD_DIR
    mono = np.round(wave(90, (4000,)) * 32767).astype(np.int16)
    stereo = np.round(wave(91, (3200, 2)) * 32767).astype(np.int16)
    paths = [str(tmp_path / "mono.wav"), str(tmp_path / "stereo.wav")]
    wavfile.write(paths[0], 8000, mono)
    wavfile.write(paths[1], 16000, stereo)
    before = native.reads
    got = [load_audio(p) for p in paths]
    assert native.reads == before + 2
    assert os.path.dirname(native.library_path()) == BUILD_DIR
    assert os.path.exists(native.library_path())
    want = [load_audio(p, use_native=False) for p in paths]
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1].shape == want[1].shape == (1600,)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)


def test_trace_writes_a_chrome_trace(tmp_path):
    """``trace`` around one narrow flagship request writes a Chrome trace
    that names the request's operators."""
    from sincformer_tpu_torch import SincformerPipeline
    from sincformer_tpu_torch.utils.observability import trace
    pipe = SincformerPipeline(_pipe(tmp_path).model, device="cpu")
    with trace(str(tmp_path / "prof")) as log_dir:
        pipe.enhance_signal(wave(13, (4000,)))
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(log_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any("conv1d" in e.get("name", "") for e in events)


def test_train_verb_adversarial(tmp_path, monkeypatch):
    """``train --adversarial`` at narrow width: the discriminator takes its
    Adam step after every generator step (gated off before stage 3, so its
    count still advances), and the best and final checkpoints have their
    ``_disc`` siblings at the generator's step."""
    from sincformer_tpu_torch import cli
    from sincformer_tpu_torch.train import agent_trainer
    from sincformer_tpu_torch.train.state import restore_checkpoint
    factory = agent_trainer.default_metacog
    monkeypatch.setattr(agent_trainer, "default_metacog",
                        lambda **kw: factory(**{**NARROW, **kw}))
    monkeypatch.setenv("SINCFORMER_MAX_WAVE_SECONDS", "0.5")
    monkeypatch.setenv("SINCFORMER_MODEL_DIR", str(tmp_path))
    assert cli.main(["train", "--pipeline", "agents", "--synthetic", "6",
                     "--epochs", "2", "--adversarial", "--device",
                     "cpu"]) == 0
    disc = restore_checkpoint(str(tmp_path / "sincformer_final_disc"
                                  / "step_2"))
    assert disc["opt_state"]["count"] == 2
    assert "disc_0.conv_0.kernel_v" in disc["params"]
    assert (tmp_path / "best_sincformer_disc").is_dir()
