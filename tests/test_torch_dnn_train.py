"""Training of the original paper's mask DNN in the port
(``train/dnn_trainer.py``) against the JAX package, on the CPU: the
per-utterance preprocessing and its cache, the frame dataset, one epoch of
Adam steps, the plateau schedule with the NaN re-initialisation, ``resume``,
the ``train --pipeline dnn`` verb, and the ``demo`` verb.

Bars: each feature block within 1e-5 of its scale (GFCC 1e-4: the
differences of a float32 running sum, ROADMAP.md Queue 3), the masks 1e-5,
the frame counts equal. As in JAX, the context of the last frames kept
reaches into the zero padding; the GFCC of a padding frame (the cube root of
a near-zero energy) is held to 1e-2 of the block's scale, the bar
``chip_smoke.py`` holds before a padding (measured here: 2.4e-4); the frame dataset bit for bit; after an epoch at
dropout 0 the first Adam moment within 1e-5 of its scale and the second,
a sum of squared gradients, within 2e-5 (twice the relative error of the
gradients it squares; measured 1.4e-5), and the parameters
too but for at most 1 % of the elements, which stay within the epoch's step:
Adam divides each moment by the root of the second, so an element whose
gradients nearly cancel over the epoch takes a step set by rounding, as in
``tests/test_torch_train_step.py`` (measured: 1 element of 46,400 at
2.2e-5 of its leaf's scale).
The narrow DNN is ``tests/_torch_parity.NARROW_DNN`` (594 → 2 × 64 →
64)."""

import dataclasses
import re
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import NARROW_DNN, dnn_variables, speechlike

FEATURE_TOL = 1e-5
GFCC_TOL = 1e-4
PADDING_GFCC_TOL = 1e-2
MASK_TOL = 1e-5
PARAM_TOL = 1e-5
BLOCKS = {"AMS": slice(0, 15), "RASTA-PLP": slice(15, 28),
          "MFCC": slice(28, 41), "GFCC": slice(41, 54)}


def _fe_gfb():
    from sincformer_tpu.dsp.features import FeatureExtractor as JFE
    from sincformer_tpu.dsp.gammatone import GammatoneFilterbank as JGFB

    from sincformer_tpu_torch.dsp.features import FeatureExtractor
    from sincformer_tpu_torch.dsp.gammatone import GammatoneFilterbank
    return ((JFE(fs=8000), JGFB(sample_rate=8000)),
            (FeatureExtractor(fs=8000), GammatoneFilterbank(sample_rate=8000)))


@pytest.mark.parametrize("mask_type", ["irm", "pcirm", "opt_pcirm"])
def test_process_single_utterance_matches_jax(mask_type, tmp_path):
    """A 3,500-sample utterance (padded to 4,000, as in JAX) at 5 dB: the
    frames kept, every feature block and the oracle mask. The ``.npz`` that
    the JAX package writes under the shared key is what the port reads."""
    from sincformer_tpu.train.dnn_trainer import \
        process_single_utterance as jax_process

    from sincformer_tpu_torch.train.dnn_trainer import (
        cache_key, process_single_utterance)
    (jfe, jgfb), (fe, gfb) = _fe_gfb()
    clean, noise = speechlike(1, 3500), speechlike(2, 8000)
    key = cache_key(clean, noise, 5, mask_type)
    jf, jm = jax_process(clean, noise, 5, mask_type, jfe, jgfb,
                         str(tmp_path), key)
    f, m = process_single_utterance(clean, noise, 5, mask_type, fe, gfb,
                                    device="cpu")
    assert f.shape == jf.shape == (42, 594) and m.shape == jm.shape == (42,
                                                                        64)
    raw, jraw = f.reshape(42, 11, 54), jf.reshape(42, 11, 54)
    # context column j of frame t holds frame t + j - 5; from 42 on, padding
    in_padding = (np.arange(42)[:, None] + np.arange(11)[None, :] - 5) >= 42
    for name, block in BLOCKS.items():
        scale = max(float(np.abs(jraw[..., block]).max()), 1e-30)
        err = np.max(np.abs(raw[..., block] - jraw[..., block]), axis=-1)
        tol = GFCC_TOL if name == "GFCC" else FEATURE_TOL
        assert np.max(err[~in_padding]) <= tol * scale, name
        assert np.max(err[in_padding]) <= (
            PADDING_GFCC_TOL if name == "GFCC" else tol) * scale, name
    if mask_type == "opt_pcirm":
        # a quantized unit may take the next step only at a near-tie
        assert np.mean(m != jm) <= 1e-3
    else:
        assert np.max(np.abs(m - jm)) <= MASK_TOL
    cached = process_single_utterance(clean, noise, 5, mask_type, fe, gfb,
                                      str(tmp_path), key, device="cpu")
    assert np.array_equal(cached[0], jf) and np.array_equal(cached[1], jm)


def test_frame_dataset_is_bit_equal():
    from sincformer_tpu.train.dnn_trainer import FrameDataset as JaxFD

    from sincformer_tpu_torch.train.dnn_trainer import FrameDataset
    rng = np.random.default_rng(3)
    feats = [rng.standard_normal((n, 594)).astype(np.float32) * 3
             for n in (40, 0, 25)]
    feats[0][3, 7] = np.nan
    feats[2][:, 5] = 1.0                       # a constant feature
    masks = [rng.uniform(-0.1, 1.1, (n, 64)).astype(np.float32)
             for n in (41, 0, 25)]
    want, got = JaxFD(feats, masks), FrameDataset(feats, masks)
    for k in ("features", "masks", "feat_mean", "feat_std"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    want_t = JaxFD(feats[:1], masks[:1], want.feat_mean, want.feat_std)
    got_t = FrameDataset(feats[:1], masks[:1], got.feat_mean, got.feat_std)
    assert np.array_equal(got_t.features, want_t.features) and len(got_t) == 40


def _jax_epoch(model):
    """The JAX pipeline's epoch (train/dnn_trainer.py ``train_epoch``): one
    scan step per minibatch."""
    from sincformer_tpu.train.state import guard_nan_update

    @jax.jit
    def train_epoch(state, feats, masks, rng):
        def step(carry, xs):
            st, k = carry
            f, m = xs
            k, sub = jax.random.split(k)

            def loss_fn(p):
                pred = model.apply(p, f, deterministic=False,
                                   rngs={"dropout": sub})
                return jnp.mean((pred - m) ** 2)
            loss, grads = jax.value_and_grad(loss_fn)(st.params)
            grads, is_bad = guard_nan_update(grads, loss)
            st = st.apply_gradients(grads=grads)
            return (st.replace(nan_count=st.nan_count
                               + is_bad.astype(jnp.int32)), k), loss
        (state, _), losses = jax.lax.scan(step, (state, rng), (feats, masks))
        return state, jnp.mean(losses)
    return train_epoch


def _narrow_trainer(tmp_path, **kw):
    from sincformer_tpu_torch.config import DNNConfig
    from sincformer_tpu_torch.train.dnn_trainer import DNNTrainer
    return DNNTrainer(device="cpu", model_dir=str(tmp_path),
                      dcfg=DNNConfig(dropout=0.0, **NARROW_DNN), **kw)


def test_one_epoch_matches_jax(tmp_path):
    """Four Adam steps of 16 frames at dropout 0 from the same weights and
    the same learning rate: the parameters, the Adam moments and the count,
    and the epoch's mean loss."""
    from sincformer_tpu import config as jcfg
    from sincformer_tpu.train.dnn_trainer import DNNPipeline as JaxDNN

    from sincformer_tpu_torch.compat.from_jax import load_dnn_from_jax
    jpipe = JaxDNN(use_rbm_pretrain=False, model_dir=str(tmp_path / "j"),
                   dcfg=dataclasses.replace(jcfg.DEFAULT.dnn, dropout=0.0,
                                            **NARROW_DNN))
    state = jpipe._init_model_state(1e-3, jax.random.PRNGKey(0))
    variables = dnn_variables()[0]
    state = state.replace(params=jax.tree.map(jnp.asarray, variables))
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((4, 16, 594)).astype(np.float32)
    masks = rng.uniform(0, 1, (4, 16, 64)).astype(np.float32)
    state, loss = _jax_epoch(jpipe.model)(state, feats, masks,
                                          jax.random.PRNGKey(1))

    pipe = _narrow_trainer(tmp_path)
    pipe._init_model_state(1e-3, 0)
    pipe.model.load_state_dict(load_dnn_from_jax(variables)[0])
    got = pipe.train_epoch(torch.from_numpy(feats), torch.from_numpy(masks),
                           torch.Generator().manual_seed(1))
    assert abs(float(got) - float(loss)) <= 1e-5 * float(loss)
    adam = state.opt_state[1].inner_state[0]
    assert pipe.opt_state["count"] == int(adam.count) == 4
    for tree, got_tree, tol in ((adam.mu, pipe.opt_state["mu"], PARAM_TOL),
                                (adam.nu, pipe.opt_state["nu"],
                                 2 * PARAM_TOL)):
        want = load_dnn_from_jax(jax.tree.map(np.asarray, tree))[0]
        for k, w in want.items():
            w = w.numpy()
            assert np.max(np.abs(got_tree[k].numpy() - w)) <= \
                tol * float(np.abs(w).max()), k
    want = load_dnn_from_jax(jax.tree.map(np.asarray, state.params))[0]
    before = load_dnn_from_jax(variables)[0]
    loose = total = 0
    for k, p in pipe.model.named_parameters():
        w = want[k].numpy()
        diff = np.abs(p.detach().numpy() - w)
        step = float(np.abs(w - before[k].numpy()).max())
        off = diff > PARAM_TOL * float(np.abs(w).max())
        assert np.all(diff[off] <= step), k
        loose += int(off.sum())
        total += w.size
    assert loose <= 0.01 * total, (loose, total)


# (train loss, validation loss) of each epoch: a best, three NaN epochs
# (re-init at 0.1x), a plateau of five (x 0.5), a best, a plateau of one
SCRIPT = ([(0.5, 0.3)] + [(float("nan"), None)] * 3 + [(0.4, 0.3)] * 6
          + [(0.35, 0.2), (0.3, 0.2)])


def test_plateau_schedule_and_nan_reinit_match_jax(tmp_path):
    """The same scripted losses through both trainers' loops: the same
    learning rate in every history entry (ReduceLROnPlateau, patience 5,
    x 0.5, threshold 1e-6; 0.1x after 3 NaN epochs), the same epochs."""
    from sincformer_tpu import config as jcfg
    from sincformer_tpu.train import dnn_trainer as jdt
    from sincformer_tpu.train.dnn_trainer import FrameDataset as JaxFD

    from sincformer_tpu_torch.train.dnn_trainer import DNNTrainer, FrameDataset
    rng = np.random.default_rng(5)
    f = [rng.standard_normal((20, 594)).astype(np.float32)]
    m = [rng.uniform(0, 1, (20, 64)).astype(np.float32)]
    script_t, script_v = ([t for t, _ in SCRIPT],
                          [v for _, v in SCRIPT if v is not None])

    real_jit = jax.jit
    queue_t, queue_v = list(script_t), list(script_v)

    def scripted_jit(fn, *a, **kw):
        if fn.__name__ == "train_epoch":
            return lambda state, *_: (state, queue_t.pop(0))
        if fn.__name__ == "validate":
            return lambda *_: queue_v.pop(0)
        return real_jit(fn, *a, **kw)
    jpipe = jdt.DNNPipeline(use_rbm_pretrain=False,
                            model_dir=str(tmp_path / "j"),
                            dcfg=dataclasses.replace(jcfg.DEFAULT.dnn,
                                                     **NARROW_DNN))
    with mock.patch.object(jdt.jax, "jit", scripted_jit), \
            mock.patch.object(jdt.DNNPipeline, "save_model"):
        want = jpipe.train(JaxFD(f, m), JaxFD(f, m), epochs=len(SCRIPT),
                           batch_size=10, verbose=False)

    pipe = _narrow_trainer(tmp_path / "p", use_rbm_pretrain=False)
    with mock.patch.object(DNNTrainer, "train_epoch",
                           side_effect=[torch.tensor(t) for t in script_t]), \
            mock.patch.object(DNNTrainer, "validate", side_effect=script_v):
        got = pipe.train(FrameDataset(f, m), FrameDataset(f, m),
                         epochs=len(SCRIPT), batch_size=10, verbose=False)
    assert [h["epoch"] for h in got] == [h["epoch"] for h in want] == [
        0, 4, 5, 6, 7, 8, 9, 10, 11]
    assert [h["lr"] for h in got] == [h["lr"] for h in want]
    assert got[-1]["lr"] == pytest.approx(1e-3 * 0.1 * 0.5)
    assert pipe.opt_state["lr"] == got[-1]["lr"]


def test_resume_skips_the_rbm(tmp_path):
    """Two epochs with RBM pretraining; a resume to three restores the
    weights, the Adam state with its rate, the plateau counter and the
    best validation loss, starts at epoch 2 and does not pretrain."""
    from sincformer_tpu_torch.config import RBMConfig
    from sincformer_tpu_torch.train.dnn_trainer import (DNNTrainer,
                                                        FrameDataset)
    rng = np.random.default_rng(6)
    ds = FrameDataset([rng.standard_normal((64, 594)).astype(np.float32)],
                      [rng.uniform(0, 1, (64, 64)).astype(np.float32)])
    small = RBMConfig(epochs=1, batch_size=32)
    pipe = _narrow_trainer(tmp_path, rcfg=small)
    with mock.patch.object(DNNTrainer, "_rbm_pretrain",
                           wraps=pipe._rbm_pretrain) as rbm:
        first = pipe.train(ds, ds, epochs=2, batch_size=16, verbose=False)
    assert rbm.call_count == 1 and len(first) == 2
    pipe.save_model()
    again = _narrow_trainer(tmp_path, rcfg=small)
    with mock.patch.object(DNNTrainer, "_rbm_pretrain") as rbm:
        more = again.train(ds, ds, epochs=3, batch_size=16, verbose=False,
                           resume=True)
    assert rbm.call_count == 0
    assert [h["epoch"] for h in more] == [2]
    assert again.opt_state["count"] == 12 and again.step == 12
    assert again.opt_state["lr"] == 1e-3


def test_train_verb_serves_enhance(tmp_path, monkeypatch):
    """``train --pipeline dnn --synthetic 6 --epochs 2 --device cpu`` at
    full width with RBM pretraining (the default pipeline): exit 0, and its
    final checkpoint serves ``enhance --model pcirm``."""
    from scipy.io import wavfile

    from sincformer_tpu_torch import cli
    monkeypatch.setenv("SINCFORMER_MODEL_DIR", str(tmp_path / "models"))
    monkeypatch.setenv("SINCFORMER_CACHE_DIR", str(tmp_path / "cache"))
    assert cli.main(["train", "--synthetic", "6", "--epochs", "2",
                     "--device", "cpu"]) == 0
    x = speechlike(9, 9000)
    wavfile.write(tmp_path / "in.wav", 8000, x)
    assert cli.main(["enhance", str(tmp_path / "in.wav"),
                     str(tmp_path / "out.wav"), "--model", "pcirm",
                     "--device", "cpu"]) == 0
    out = wavfile.read(tmp_path / "out.wav")[1]
    assert out.shape == x.shape and np.all(np.isfinite(out))


def test_demo_prints_the_tables_and_jax_mask_stats(capsys):
    """``demo --device cpu`` with the noise fixed: three metric tables,
    and mask statistics equal to the JAX package's on the same signal."""
    import sincformer_tpu_torch.data.synthetic as synth
    from sincformer_tpu import masks as J
    from sincformer_tpu.data import add_noise_at_snr, synthetic_speech
    from sincformer_tpu.dsp import GammatoneFilterbank

    from sincformer_tpu_torch import cli
    noise = (np.random.default_rng(10).standard_normal(16000) * 0.3).astype(
        np.float32)
    with mock.patch.object(synth, "synthetic_noise", lambda n, seed=None:
                           noise[:n]):
        assert cli.main(["demo", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("Metric") == 3 and "Demo complete" in out
    stats = re.findall(r"(IRM|PCIRM)\s+— mean=([\d.]+), std=([\d.]+)", out)
    means = re.findall(r"OPT-PCIRM— unique values=.*, mean=([\d.]+)", out)
    clean = synthetic_speech(2.0, 8000)
    gfb = GammatoneFilterbank(sample_rate=8000)
    want = []
    for snr in (0, 5, 10):
        noisy = add_noise_at_snr(clean, noise, snr)
        (cm, cp), (ym, yp), (nm, np_) = (gfb.get_tf_magnitudes(
            jnp.asarray(x)) for x in (clean, noisy, noise[:len(clean)]))
        irm = J.compute_irm(cm, nm)
        p = J.compute_pcirm_from_signals(ym, cm, nm, yp, cp, np_, cm, nm)[0]
        opt = J.quantize_pcirm(p, J.compute_snr_boundaries()[0])
        want += [("IRM", f"{float(jnp.mean(irm)):.3f}",
                  f"{float(jnp.std(irm)):.3f}"),
                 ("PCIRM", f"{float(jnp.mean(p)):.3f}",
                  f"{float(jnp.std(p)):.3f}")]
        assert means.pop(0) == f"{float(jnp.mean(opt)):.3f}"
    assert stats == want
