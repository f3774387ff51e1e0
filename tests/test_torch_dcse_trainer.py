"""DCSE training's loop in the port (``train/dcse_trainer.DCSETrainer.train``)
and the ``train --pipeline conformer`` verb, at narrow width on the CPU on
synthetic utterances of 0.5 s (``SINCFORMER_MAX_WAVE_SECONDS``): the
history's keys (the JAX package's), best and final checkpoints that the
serving ``DCSEPipeline`` loads, ``resume`` from the newest checkpoint with
the best validation loss from the sidecar, and the output gain as one
geometric mean over the validation utterances."""

import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

from tests import _torch_threads  # noqa: F401


# the keys of sincformer_tpu/train/dcse_trainer.py's history entries
HISTORY_KEYS = {"epoch", "train_loss", "val_loss", "val_sisnr", "nan_count",
                "epoch_seconds"}


def _narrow(**kw):
    from sincformer_tpu_torch.models.dcse import default_speech_enhancer
    return default_speech_enhancer(
        num_heads=2, d_model=32, num_blocks=2, ff_dim=64, kernel_size=7,
        **kw)


@pytest.fixture()
def short_waves(monkeypatch):
    monkeypatch.setenv("SINCFORMER_MAX_WAVE_SECONDS", "0.5")


def _datasets():
    from sincformer_tpu_torch.cli import _synthetic_corpus
    from sincformer_tpu_torch.data.loader import (WaveformDataset,
                                                  heldout_noises)
    clean, noises = _synthetic_corpus(7)
    return (WaveformDataset.from_arrays(clean[:4], noises),
            WaveformDataset.from_arrays(clean[4:], heldout_noises(noises)))


def test_train_resume_and_output_gain(tmp_path, short_waves):
    """Two epochs, then a resume to three: the history's keys, both
    checkpoint families, the resumed run starting at epoch 2 with the best
    validation loss of the sidecar, and the gain."""
    from sincformer_tpu_torch.data.loader import batch_iterator
    from sincformer_tpu_torch.pipeline import DCSEPipeline
    from sincformer_tpu_torch.train.dcse_trainer import DCSETrainer
    from sincformer_tpu_torch.train.state import (read_train_meta,
                                                  restore_checkpoint)
    train_ds, test_ds = _datasets()
    assert train_ds.max_len == 4000
    pipe = DCSETrainer(_narrow(conv_norm="batch"), device="cpu",
                       model_dir=str(tmp_path), seed=3)
    hist = pipe.train(train_ds, test_ds, epochs=2, batch_size=2,
                      verbose=False)
    assert [h["epoch"] for h in hist] == [0, 1]
    assert all(set(h) == HISTORY_KEYS for h in hist)
    assert all(np.isfinite(h["train_loss"]) and h["nan_count"] == 0
               for h in hist)
    assert pipe.step == 4 and pipe.opt_state["count"] == 4

    # the gain: one geometric mean of the validation utterances' α
    logs = []
    for b in batch_iterator(test_ds, 2, shuffle=False, drop_last=False):
        with torch.no_grad():
            _, (_, enh) = pipe._loss(torch.from_numpy(b["noisy"]),
                                     torch.from_numpy(b["clean"]), False)
        for i, n in enumerate(b["lengths"]):
            e, c = enh[i, :n].double().numpy(), b["clean"][i, :n]
            logs.append(np.log(np.dot(c, e) / (np.dot(e, e) + 1e-12)))
    assert len(logs) == 3
    assert abs(pipe.output_gain / np.exp(np.mean(logs)) - 1.0) <= 1e-5

    final = pipe.save_model()
    best = read_train_meta(str(tmp_path), "best_conformer")
    assert best["val_protocol"] == 2 and best["best_val"] == min(
        h["val_loss"] for h in hist)
    restored = restore_checkpoint(final)
    assert restored["opt_state"]["count"] == 4
    assert any(k.endswith("bn.mean") for k in restored["model_state"])
    served = DCSEPipeline(device="cpu", model_dir=str(tmp_path))
    served.load_model()
    assert served.model.config.conv_norm == "batch"
    assert served.output_gain == pytest.approx(pipe.output_gain)
    x = np.random.default_rng(0).standard_normal(3000).astype(np.float32)
    assert np.allclose(served.enhance_signal(x), pipe.enhance_signal(x),
                       atol=1e-6)

    again = DCSETrainer(_narrow(conv_norm="batch"), device="cpu",
                        model_dir=str(tmp_path), seed=3)
    with mock.patch.object(again, "_validate",
                           wraps=again._validate) as validate:
        hist3 = again.train(train_ds, test_ds, epochs=3, batch_size=2,
                            verbose=False, resume=True)
    assert [h["epoch"] for h in hist3] == [2]
    assert validate.call_count == 1          # best_val from the sidecar
    assert again.step == 6 and again.opt_state["count"] == 6


def test_train_verb_in_process(tmp_path, monkeypatch, short_waves):
    """``train --pipeline conformer --synthetic 6 --epochs 2 --device cpu``
    with the model patched narrow: exit 0, one record per epoch in the
    log, and a final checkpoint that ``enhance --model conformer``
    serves."""
    from sincformer_tpu_torch import cli
    from sincformer_tpu_torch.train import dcse_trainer
    monkeypatch.setenv("SINCFORMER_MODEL_DIR", str(tmp_path))
    log = tmp_path / "log.jsonl"
    with mock.patch.object(dcse_trainer, "default_speech_enhancer",
                           lambda: _narrow()):
        rc = cli.main(["train", "--pipeline", "conformer", "--synthetic",
                       "6", "--epochs", "2", "--device", "cpu",
                       "--log-jsonl", str(log)])
    assert rc == 0
    records = [json.loads(line) for line in open(log)]
    assert [r["pipeline"] for r in records] == ["dcse", "dcse"]
    assert os.path.isdir(tmp_path / "conformer_final" / "step_2")
    from scipy.io import wavfile
    x = (np.random.default_rng(1).standard_normal(5000) * 0.1).astype(
        np.float32)
    wavfile.write(tmp_path / "in.wav", 8000, x)
    assert cli.main(["enhance", str(tmp_path / "in.wav"),
                     str(tmp_path / "out.wav"), "--model", "conformer",
                     "--device", "cpu"]) == 0
    out = wavfile.read(tmp_path / "out.wav")[1]
    assert out.shape == x.shape and np.all(np.isfinite(out))
