"""The port's serving layer (serve.py, train/state.py, data/audio.py, cli.py)
against sincformer_tpu on the CPU: the three long-form paths of
StreamingEnhancer against the JAX StreamingEnhancer on the JAX pipeline, the
online enhancers (alignment, causality, replay parity, pool equals solo, as
tests/test_online.py), serving checkpoints, and the CLI.

Narrow DCSE (2 blocks, d_model 32, d_ff 64), window 4000, overlap 400,
chunk_batch 2. Waveform tolerance 1e-5 of the peak (float32 on both sides);
int16 outputs within 1 LSB."""

import json
import os

import numpy as np
import pytest
import torch

from sincformer_tpu import serve as jserve
from sincformer_tpu_torch import serve as tserve
from tests._torch_parity import (jax_dcse_pipeline, max_abs,
                                 torch_dcse_pipeline, wave)

TOL = 1e-5
WINDOW, OVERLAP, GROUP = 4000, 400, 2
# hop 3600: 11050 mod 3600 = 250 <= overlap, so the tail's denominator
# correction of the segmented path is exercised; 4 windows = 2 segments
N_LONG = 3 * 3600 + 250
PATHS = {"host": dict(device_ola=False), "whole": dict(pipelined=False),
         "segmented": dict(pipelined=True)}


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    """(JAX DCSEPipeline, the port's, fused) on the same weights, gain 1.07."""
    jp = jax_dcse_pipeline(str(tmp_path_factory.mktemp("jax_dcse")), 1.07)
    return jp, torch_dcse_pipeline(fused=True, output_gain=1.07)


class _ScalePipe:
    """Halves the signal; has no enhance_tensor, so only the host path."""

    def __init__(self, batched=True):
        self.calls = []
        if batched:
            self.enhance_batch = self._batch

    def enhance_signal(self, x):
        self.calls.append(("signal", len(x)))
        return np.asarray(x, np.float32) * 0.5

    def _batch(self, x):
        self.calls.append(("batch",) + np.shape(x))
        return np.asarray(x, np.float32) * 0.5


def test_dcse_pipeline_matches_jax(pipes):
    """DCSEPipeline.enhance_batch (int16 PCM in, converted on the device)
    and enhance_signal (float, padded to the quantum) against the JAX
    pipeline, with an output gain."""
    jp, tp = pipes
    pcm = np.round(wave(11, (GROUP, WINDOW)) * 32767).astype(np.int16)
    ref = np.asarray(jp.enhance_batch(pcm))
    assert max_abs(tp.enhance_batch(pcm), ref) <= TOL * np.abs(ref).max()
    sig = wave(12, (3333,))
    ref = jp.enhance_signal(sig)
    got = tp.enhance_signal(sig)
    assert got.shape == (3333,) and got.dtype == np.float32
    assert max_abs(got, ref) <= TOL * np.abs(ref).max()


@pytest.mark.parametrize("path", list(PATHS))
def test_streaming_paths_match_jax(pipes, path):
    """Each of the three paths against the same path of the JAX
    StreamingEnhancer on the JAX pipeline, float32 in and out."""
    jp, tp = pipes
    x = wave(31, (N_LONG,))
    kw = dict(window=WINDOW, overlap=OVERLAP, chunk_batch=GROUP, **PATHS[path])
    ref = jserve.StreamingEnhancer(jp, **kw).enhance(x)
    got = tserve.StreamingEnhancer(tp, **kw).enhance(x)
    assert got.shape == (N_LONG,) and got.dtype == np.float32
    assert max_abs(got, ref) <= TOL * np.abs(ref).max()


def test_streaming_pcm16_paths_agree_with_jax(pipes):
    """int16 in, ``pcm16_out``: the port's three paths against the JAX
    segmented path (quantized on the device before the download), within
    1 LSB; a signal hot enough to reach full scale at the tail."""
    jp, tp = pipes
    pcm = np.round(np.clip(wave(32, (N_LONG,), scale=0.5), -1, 1) * 32767
                   ).astype(np.int16)
    kw = dict(window=WINDOW, overlap=OVERLAP, chunk_batch=GROUP)
    ref = jserve.StreamingEnhancer(jp, pipelined=True, **kw).enhance(
        pcm, pcm16_out=True)
    assert ref.dtype == np.int16
    for path, flags in PATHS.items():
        got = tserve.StreamingEnhancer(tp, **kw, **flags).enhance(
            pcm, pcm16_out=True)
        assert got.dtype == np.int16 and got.shape == ref.shape, path
        assert np.abs(got.astype(np.int32) - ref).max() <= 1, path


def test_segmented_path_is_bounded_and_auto_skips_short_input(pipes):
    """Auto mode takes the segmented path only from three segments on; more
    segments than the transfer depth still give the whole-file answer."""
    _, tp = pipes
    se = tserve.StreamingEnhancer(tp, window=WINDOW, overlap=OVERLAP,
                                  chunk_batch=1, transfer_depth=1)
    x = wave(33, (5 * 3600 + 100,))
    assert se._enhance_segmented(x[:7000], False) is None      # 2 segments
    whole = tserve.StreamingEnhancer(tp, window=WINDOW, overlap=OVERLAP,
                                     chunk_batch=1, pipelined=False).enhance(x)
    assert max_abs(se.enhance(x), whole) <= TOL * np.abs(whole).max()


def test_host_path_for_pipelines_without_enhance_tensor():
    """Short input passes through enhance_signal; long input is cut into
    windows of one size; a scale-only pipe makes the cross-fade invisible."""
    rng = np.random.default_rng(0)
    pipe = _ScalePipe(batched=False)
    x = rng.standard_normal(3000).astype(np.float32)
    out = tserve.StreamingEnhancer(pipe, window=WINDOW,
                                   overlap=OVERLAP).enhance(x)
    np.testing.assert_allclose(out, x * 0.5)
    assert pipe.calls == [("signal", 3000)]
    pipe = _ScalePipe()
    x = rng.standard_normal(20000).astype(np.float32)
    out = tserve.enhance_long(pipe, x, window=WINDOW, overlap=OVERLAP)
    np.testing.assert_allclose(out, x * 0.5, atol=1e-6)
    assert {c[0] for c in pipe.calls} == {"batch"}
    assert {c[2] for c in pipe.calls} == {WINDOW}
    with pytest.raises(ValueError, match="overlap"):
        tserve.StreamingEnhancer(pipe, window=1000, overlap=600)


def test_enhance_many_matches_jax(pipes):
    """Five utterances of mixed lengths (one longer than the window): the
    same buckets, the same order, the JAX package's numbers."""
    jp, tp = pipes
    signals = [wave(40 + i, (n,)) for i, n in
               enumerate((1500, 3900, 1700, 9000, 3999))]
    kw = dict(window=WINDOW, overlap=OVERLAP, chunk_batch=GROUP)
    ref = jserve.StreamingEnhancer(jp, **kw).enhance_many(signals,
                                                          pad_quantum=2000)
    got = tserve.StreamingEnhancer(tp, **kw).enhance_many(signals,
                                                          pad_quantum=2000)
    for s, g, r in zip(signals, got, ref):
        assert g.shape == s.shape
        assert max_abs(g, r) <= TOL * np.abs(r).max()


# ── online ──────────────────────────────────────────────────────────────

ONLINE = dict(context=2000, chunk=160, lookahead=240)


def test_online_alignment_and_latency():
    """Ragged pushes through a scale-only pipe come out sample-aligned; the
    default latency is 400 samples (50 ms), and only finalizable chunks are
    emitted."""
    rng = np.random.default_rng(0)
    pipe = _ScalePipe()
    oe = tserve.OnlineEnhancer(pipe, **ONLINE)
    x = rng.standard_normal(5000).astype(np.float32)
    outs, pos = [], 0
    for size in (1, 7, 159, 160, 161, 800, 2399):
        outs.append(oe.push(x[pos:pos + size]))
        pos += size
    outs += [oe.push(x[pos:]), oe.flush()]
    np.testing.assert_allclose(np.concatenate(outs), x * 0.5, atol=1e-6)
    assert {c[1:] for c in pipe.calls} == {(1, 2000)}
    assert len(oe.flush()) == 0
    oe = tserve.OnlineEnhancer(_ScalePipe())
    assert oe.latency_samples == 400 <= int(0.064 * 8000)
    assert len(oe.push(x[:1000])) == (1000 - 240) // 160 * 160
    short = tserve.OnlineEnhancer(_ScalePipe(), **ONLINE)
    out = np.concatenate([short.push(x[:90]), short.flush()])
    np.testing.assert_allclose(out, x[:90] * 0.5, atol=1e-6)
    with pytest.raises(ValueError, match="hops"):
        tserve.OnlineEnhancer(pipe, chunk=100)


def test_online_causality_with_divergent_suffix(pipes):
    """Two streams equal up to p give bit-equal output for every chunk
    finalized before p, and differ after it."""
    _, tp = pipes
    p = 2400
    a = wave(50, (4000,))
    b = a.copy()
    b[p:] = wave(51, (4000 - p,), scale=1.0)

    def run(x):
        oe = tserve.OnlineEnhancer(tp, **ONLINE)
        return np.concatenate([oe.push(x), oe.flush()])

    out_a, out_b = run(a), run(b)
    n_safe = (p - 240) // 160 * 160
    np.testing.assert_array_equal(out_a[:n_safe], out_b[:n_safe])
    assert not np.allclose(out_a[p:], out_b[p:])


def test_online_replay_parity_and_jax(pipes):
    """Every emitted chunk equals the pipeline's own enhance_batch on the
    documented sliding window, and the whole stream equals the JAX
    OnlineEnhancer on the JAX pipeline."""
    jp, tp = pipes
    ctx, chunk, la = ONLINE["context"], ONLINE["chunk"], ONLINE["lookahead"]
    x = wave(52, (2400,))
    oe = tserve.OnlineEnhancer(tp, **ONLINE)
    out = np.concatenate([oe.push(x[:1000]), oe.push(x[1000:]), oe.flush()])
    assert out.shape == x.shape
    for k in (0, 3, 10):
        end = (k + 1) * chunk + la
        w = np.zeros(ctx, np.float32)
        seg = x[max(0, end - ctx):end]
        w[ctx - len(seg):] = seg
        ref = tp.enhance_batch(w[None, :])[0]
        np.testing.assert_allclose(out[k * chunk:(k + 1) * chunk],
                                   ref[ctx - la - chunk:ctx - la], atol=1e-6)
    je = jserve.OnlineEnhancer(jp, **ONLINE)
    ref = np.concatenate([je.push(x), je.flush()])
    assert max_abs(out, ref) <= TOL * np.abs(ref).max()


def test_pool_equals_solo(pipes):
    """Pooled streams with staggered, ragged arrival equal solo enhancers
    (a real model: float tolerance, batch rows are independent), and step()
    advances only the ready streams."""
    _, tp = pipes
    xs = [wave(60, (2000,)), wave(61, (1300,)), wave(62, (2200,))]
    solo = []
    for x in xs:
        oe = tserve.OnlineEnhancer(tp, **ONLINE)
        solo.append(np.concatenate([oe.push(x), oe.flush()]))
    pool = tserve.OnlineEnhancerPool(tp, n_streams=3, **ONLINE)
    assert pool.step() == 0 and pool.latency_samples == 400
    pool.push(0, xs[0][:500]); pool.push(2, xs[2][:37])
    assert pool.run() == 1                       # only stream 0 had a chunk
    pool.push(0, xs[0][500:]); pool.push(1, xs[1][:800])
    pool.push(2, xs[2][37:1500])
    pool.run()
    pool.push(1, xs[1][800:]); pool.push(2, xs[2][1500:])
    outs = [np.concatenate([pool.take(i), pool.flush(i)]) for i in range(3)]
    for s, o in zip(solo, outs):
        assert o.shape == s.shape
        assert max_abs(o, s) <= TOL * np.abs(s).max()
    with pytest.raises(ValueError, match="n_streams"):
        tserve.OnlineEnhancerPool(tp, n_streams=0)


# ── checkpoints, audio files, CLI ───────────────────────────────────────

def test_serving_checkpoint_round_trip(pipes, tmp_path, monkeypatch):
    """save_model then load_model: float32 exact, int8 within one step per
    channel and flagged in the sidecar; the layout, the numeric choice of
    the newest step, the gain sidecar and its environment override."""
    from sincformer_tpu_torch import DCSEPipeline
    from sincformer_tpu_torch.train import state as tstate
    _, tp = pipes
    tp.model_dir, tp.step = str(tmp_path), 98
    tp.save_model("best_conformer")
    tp.step = 336
    path = tp.save_model("best_conformer")
    fam = tmp_path / "best_conformer"
    assert sorted(os.listdir(fam)) == ["step_336", "step_336.meta.json",
                                       "step_98", "step_98.meta.json",
                                       "train_meta.json"]
    assert tstate.latest_step_dir(str(fam)) == path
    assert tstate.latest_step_dir(str(tmp_path / "missing")) is None
    fresh = DCSEPipeline(device="cpu", model_dir=str(tmp_path))
    assert fresh.load_model() == path and fresh.step == 336
    assert fresh.model.config == tp.model.config       # narrow, from sidecar
    assert fresh.output_gain == pytest.approx(1.07)
    for k, v in tp.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k

    qpath = tp.save_model(quantize=True)                # conformer_final
    assert json.load(open(qpath + ".meta.json"))["quantized"] is True
    assert tstate.inference_ckpt_order("a", "b") == ("a", "b")
    fresh.load_model()                                  # final preferred
    for k, v in tp.model.state_dict().items():
        got = fresh.model.state_dict()[k]
        if v.ndim >= 2 and v.numel() >= 4096:
            step = v.abs().amax(dim=tuple(range(1, v.ndim)), keepdim=True) / 127
            assert not torch.equal(got, v), k
            assert torch.all((got - v).abs() <= step + 1e-7), k
        else:
            assert torch.equal(got, v), k
    size = lambda p: os.path.getsize(os.path.join(p, tstate.PAYLOAD))
    assert size(qpath) < size(path)
    monkeypatch.setenv("SINCFORMER_CKPT_PREF", "best")
    assert tstate.inference_ckpt_order("a", "b") == ("b", "a")
    monkeypatch.setenv("SINCFORMER_OUTPUT_GAIN", "off")
    assert tstate.resolve_output_gain(qpath) == 1.0
    monkeypatch.setenv("SINCFORMER_OUTPUT_GAIN", "0.5")
    assert tstate.resolve_output_gain(qpath) == 0.5
    monkeypatch.delenv("SINCFORMER_OUTPUT_GAIN")
    tstate.merge_train_meta(str(tmp_path), "conformer_final", {"note": "x"})
    assert tstate.read_train_meta(str(tmp_path), "conformer_final") == {
        "output_gain": 1.07, "note": "x"}
    with pytest.raises(FileNotFoundError):
        DCSEPipeline(device="cpu", model_dir=str(tmp_path / "none")).load_model()


def test_load_audio_matches_jax(tmp_path):
    """int16 stereo WAV at 16 kHz: scaled, mixed down and resampled to
    8 kHz exactly as the JAX package's loader does without its native
    decoder."""
    from scipy.io import wavfile

    from sincformer_tpu.data.audio import load_audio as jax_load
    from sincformer_tpu_torch.data.audio import load_audio
    pcm = np.round(wave(70, (3200, 2)) * 32767).astype(np.int16)
    path = str(tmp_path / "in.wav")
    wavfile.write(path, 16000, pcm)
    got = load_audio(path, 8000)
    assert got.dtype == np.float32 and got.shape == (1600,)
    np.testing.assert_array_equal(got, jax_load(path, 8000, use_native=False))


def test_cli_export_then_enhance(pipes, tmp_path, monkeypatch, capsys):
    """``export`` a float32 checkpoint to an int8 serving directory, then
    ``enhance`` WAV files from that directory on the CPU: one long file with
    --pcm16, two files into a directory, two files --online; the verbs that
    are not ported return non-zero."""
    from scipy.io import wavfile

    from sincformer_tpu_torch import DCSEPipeline, cli
    _, tp = pipes
    src, out = str(tmp_path / "models"), str(tmp_path / "serving")
    tp.model_dir, tp.step = src, 5
    tp.save_model("best_conformer")
    monkeypatch.setenv("SINCFORMER_MODEL_DIR", src)
    assert cli.main(["export", "--model", "conformer", "--out", out,
                     "--device", "cpu"]) == 0
    meta = json.load(open(os.path.join(out, "conformer_final",
                                       "train_meta.json")))
    assert meta["source_step"] == 5 and meta["output_gain"] == 1.07
    assert meta["exported_from"].endswith("best_conformer/step_5")

    monkeypatch.setenv("SINCFORMER_MODEL_DIR", out)
    served = DCSEPipeline(device="cpu", model_dir=out)
    served.load_model()
    wavs = []
    for i, n in enumerate((33000, 2400)):
        wavs.append(str(tmp_path / f"in{i}.wav"))
        wavfile.write(wavs[-1], 8000,
                      np.round(wave(80 + i, (n,)) * 32767).astype(np.int16))
    one = str(tmp_path / "out.wav")
    assert cli.main(["enhance", wavs[0], one, "--pcm16", "--device",
                     "cpu"]) == 0
    sr, got = wavfile.read(one)
    want = tserve.StreamingEnhancer(served).enhance(
        wavfile.read(wavs[0])[1].astype(np.float32) / 32768.0, pcm16_out=True)
    assert sr == 8000 and got.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    many = str(tmp_path / "many")
    assert cli.main(["enhance", *wavs, many, "--device", "cpu"]) == 0
    assert sorted(os.listdir(many)) == ["in0.wav", "in1.wav"]
    assert wavfile.read(os.path.join(many, "in1.wav"))[1].shape == (2400,)
    live = str(tmp_path / "live")
    short = str(tmp_path / "in2.wav")
    wavfile.write(short, 8000, np.round(wave(83, (900,)) * 32767
                                        ).astype(np.int16))
    assert cli.main(["enhance", wavs[1], short, live, "--online", "--device",
                     "cpu"]) == 0
    assert wavfile.read(os.path.join(live, "in2.wav"))[1].shape == (900,)
    assert "conformer" in capsys.readouterr().out
    assert cli.main(["enhance", wavs[1], one, "--model", "sincformer",
                     "--device", "cpu"]) == 1          # no such family
    assert cli.main(["train", "--pipeline", "agents"]) != 0
    assert cli.main(["info", "--device", "cpu"]) == 0
