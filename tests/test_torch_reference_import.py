"""Reference PyTorch checkpoints in the port (``compat/torch_import.py``,
``compat/torch_export.py``, ``DCSEPipeline.from_torch_checkpoint``) against
the JAX package's import and export.

No reference ``.pt`` is in the repo and none is fetched: the test builds a
reference-format DCSE state dict by hand, with the reference's names and
layouts (``blocks.i.ff1.linear1``, ``mhsa.attention.in_proj_weight``, k = 1
``conv.pointwise*`` convolutions, ``conv.batch_norm`` with running
statistics), from seeded numpy at narrow width (d_model 32, 2 blocks, ff
64, kernel 7, 129 bins), and saves it as ``conformer_final.pt`` with
``model_class``. Bars: enhanced waveforms within 1e-4 of the peak; the
export bit for bit; the grid's enhanced rows within 1e-4."""

import os

import numpy as np
import pytest
import torch

from tests import _torch_threads  # noqa: F401

D, FF, K, F, BLOCKS = 32, 64, 7, 129, 2
WAVE_TOL = 1e-4


class _NotAllowListed:
    """A pickled object that weights-only loading refuses."""


def _reference_state_dict(seed: int = 5):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return torch.from_numpy((rng.standard_normal(shape)
                                 / np.sqrt(shape[1] if len(shape) > 1
                                           else 1.0)).astype(np.float32))

    def b(n, around=0.0):
        return torch.from_numpy((around + 0.1 * rng.standard_normal(n)
                                 ).astype(np.float32))

    sd = {"input_norm.weight": b(2 * F, 1.0), "input_norm.bias": b(2 * F),
          "input_proj.weight": w(D, 2 * F), "input_proj.bias": b(D),
          "output_norm.weight": b(D, 1.0), "output_norm.bias": b(D),
          "mag_head.weight": w(F, D), "mag_head.bias": b(F),
          "phase_head.weight": w(F, D), "phase_head.bias": b(F)}
    for i in range(BLOCKS):
        p = f"blocks.{i}"
        for ff in ("ff1", "ff2"):
            sd.update({f"{p}.{ff}.layer_norm.weight": b(D, 1.0),
                       f"{p}.{ff}.layer_norm.bias": b(D),
                       f"{p}.{ff}.linear1.weight": w(FF, D),
                       f"{p}.{ff}.linear1.bias": b(FF),
                       f"{p}.{ff}.linear2.weight": w(D, FF),
                       f"{p}.{ff}.linear2.bias": b(D)})
        sd.update({
            f"{p}.mhsa.layer_norm.weight": b(D, 1.0),
            f"{p}.mhsa.layer_norm.bias": b(D),
            f"{p}.mhsa.attention.in_proj_weight": w(3 * D, D),
            f"{p}.mhsa.attention.in_proj_bias": b(3 * D),
            f"{p}.mhsa.attention.out_proj.weight": w(D, D),
            f"{p}.mhsa.attention.out_proj.bias": b(D),
            f"{p}.conv.layer_norm.weight": b(D, 1.0),
            f"{p}.conv.layer_norm.bias": b(D),
            f"{p}.conv.pointwise1.weight": w(2 * D, D, 1),
            f"{p}.conv.pointwise1.bias": b(2 * D),
            f"{p}.conv.depthwise.weight": w(D, 1, K) * np.sqrt(1.0 / K),
            f"{p}.conv.depthwise.bias": b(D),
            f"{p}.conv.batch_norm.weight": b(D, 1.0),
            f"{p}.conv.batch_norm.bias": b(D),
            f"{p}.conv.batch_norm.running_mean": b(D),
            f"{p}.conv.batch_norm.running_var": torch.from_numpy(
                rng.uniform(0.5, 1.5, D).astype(np.float32)),
            f"{p}.conv.batch_norm.num_batches_tracked": torch.tensor(7),
            f"{p}.conv.pointwise2.weight": w(D, D, 1),
            f"{p}.conv.pointwise2.bias": b(D),
            f"{p}.final_norm.weight": b(D, 1.0),
            f"{p}.final_norm.bias": b(D)})
    return sd


@pytest.fixture(scope="module")
def reference_pt(tmp_path_factory):
    d = tmp_path_factory.mktemp("reference")
    torch.save({"model_state": _reference_state_dict(),
                "model_class": "SpeechEnhancer"},
               d / "conformer_final.pt")
    return str(d)


def _wave(seed, n=6000):
    return (np.random.default_rng(seed).standard_normal(n) * 0.2).astype(
        np.float32)


def test_from_torch_checkpoint_matches_jax(reference_pt):
    """Both packages' ``from_torch_checkpoint`` of the same file (4 heads
    of 8, as the reference trains): the same architecture read off the
    shapes, enhanced waveforms within 1e-4 of the peak."""
    from sincformer_tpu.train.dcse_trainer import \
        DCSEPipeline as JaxDCSEPipeline

    from sincformer_tpu_torch.pipeline import DCSEPipeline
    pt = os.path.join(reference_pt, "conformer_final.pt")
    want_pipe = JaxDCSEPipeline.from_torch_checkpoint(pt,
                                                      model_dir=reference_pt)
    got_pipe = DCSEPipeline.from_torch_checkpoint(pt, device="cpu")
    c = got_pipe.model.config
    assert (c.d_model, c.num_blocks, c.ff_dim, c.kernel_size, c.n_freq,
            c.num_heads, c.conv_norm) == (D, BLOCKS, FF, K, F, 4, "batch")
    # the grid's batch shape: the test below reuses the compiled program
    x = _wave(1, 32000).reshape(2, 16000)
    want = want_pipe.enhance_batch(x)
    got = got_pipe.enhance_batch(x)
    assert np.max(np.abs(got - want)) <= WAVE_TOL * np.max(np.abs(want))


def test_export_matches_jax_bit_for_bit(reference_pt, tmp_path):
    """The port's export of the imported model equals the JAX package's
    export of its imported variables, key for key and bit for bit;
    importing the export again is the identity; a model without BatchNorm
    is refused."""
    from sincformer_tpu.compat import (export_dcse_state_dict as jax_export,
                                       load_reference_checkpoint as jax_load)

    from sincformer_tpu_torch.compat.torch_export import (
        export_dcse_state_dict, save_reference_checkpoint)
    from sincformer_tpu_torch.compat.torch_import import \
        load_reference_checkpoint
    from sincformer_tpu_torch.models.dcse import (SpeechEnhancer,
                                                  default_speech_enhancer)
    pt = os.path.join(reference_pt, "conformer_final.pt")
    loaded = load_reference_checkpoint(pt)
    model = default_speech_enhancer(**loaded["config"], conv_norm="batch")
    model.load_state_dict(loaded["state_dict"], strict=True)
    want = jax_export(jax_load(pt)["variables"])
    got = export_dcse_state_dict(model)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == np.asarray(w).dtype and g.shape == np.shape(w), k
        assert np.array_equal(g, w), k
    out = save_reference_checkpoint(model, str(tmp_path / "again.pt"))
    again = load_reference_checkpoint(out)
    assert again["config"] == loaded["config"]
    for k, v in model.state_dict().items():
        assert torch.equal(again["state_dict"][k], v), k
    with pytest.raises(ValueError, match="conv_norm='batch'"):
        export_dcse_state_dict(SpeechEnhancer(model.config.__class__(
            d_model=D, num_blocks=1, num_heads=4, ff_dim=FF,
            kernel_size=K)))


def test_both_grids_discover_and_score_the_file(reference_pt):
    """``discover_pipelines`` of both packages imports
    ``conformer_final.pt`` from a model directory that holds nothing else,
    and the two grids score it alike: 2 utterances × 2 SNRs, each
    enhanced cell's metrics within 1e-4."""
    from sincformer_tpu.evaluation.grid import (
        discover_pipelines as jax_discover, evaluate_grid as jax_grid)

    from sincformer_tpu_torch.data.synthetic import synthetic_speech
    from sincformer_tpu_torch.evaluation.grid import (discover_pipelines,
                                                      evaluate_grid)
    want_found = jax_discover(reference_pt)
    got_found = discover_pipelines(reference_pt, device="cpu")
    assert list(want_found) == list(got_found) == ["conformer"]
    rng = np.random.default_rng(99)
    clean = [synthetic_speech(2.0) * (0.7 + 0.6 * rng.random())
             for _ in range(2)]
    noises = {"white": _wave(7, 8000 * 30)}
    metrics = ("stoi", "ssnr", "csii", "ncm")
    want = jax_grid(clean, noises, want_found, [0, 10], metrics=metrics,
                    verbose=False)
    got = evaluate_grid(clean, noises, got_found, [0, 10], metrics=metrics,
                        verbose=False, device="cpu")
    for snr, cell in want["white"]["conformer"].items():
        for k, w in cell.items():
            np.testing.assert_allclose(got["white"]["conformer"][snr][k], w,
                                       rtol=0, atol=1e-4, err_msg=k)


def test_weights_only_refusal_and_the_dnn_import(tmp_path):
    """A file that weights-only loading refuses raises unless the caller
    opts in with ``allow_pickle``; a reference DNN checkpoint (the
    ``network`` Sequential, numpy feature statistics) converts as the JAX
    package converts it."""
    from sincformer_tpu.compat import load_reference_checkpoint as jax_load

    from sincformer_tpu_torch.compat.torch_import import \
        load_reference_checkpoint
    rng = np.random.default_rng(8)
    widths = [594, 16, 16, 16, 64]
    sd = {}
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        sd[f"network.{3 * i}.weight"] = torch.from_numpy(
            rng.standard_normal((b, a)).astype(np.float32))
        sd[f"network.{3 * i}.bias"] = torch.from_numpy(
            rng.standard_normal(b).astype(np.float32))
    mean = rng.standard_normal(594).astype(np.float32)
    path = str(tmp_path / "dnn_pcirm_final.pt")
    torch.save({"model_state": sd, "feat_mean": mean, "feat_std": mean + 2,
                "mask_type": "pcirm"}, path)
    got = load_reference_checkpoint(path)
    want = jax_load(path)
    assert got["kind"] == want["kind"] == "dnn" and got["mask_type"] == \
        "pcirm"
    assert got["sizes"]["num_hidden_layers"] == 3
    for name, layer in want["variables"]["params"].items():
        assert np.array_equal(got["state_dict"][f"{name}.weight"].numpy(),
                              np.asarray(layer["kernel"]).T)
        assert np.array_equal(got["state_dict"][f"{name}.bias"].numpy(),
                              layer["bias"])
    assert np.array_equal(got["feat_mean"], mean)

    bad = str(tmp_path / "conformer_final.pt")
    torch.save({"model_state": _reference_state_dict(),
                "model_class": "SpeechEnhancer",
                "extra": _NotAllowListed()}, bad)
    with pytest.raises(ValueError, match="allow_pickle=True"):
        load_reference_checkpoint(bad)
    assert load_reference_checkpoint(bad, allow_pickle=True)["kind"] == \
        "dcse"
