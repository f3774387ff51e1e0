"""Port parity of the whole flagship enhancement path: SincformerMetacog and
the pipeline of sincformer_tpu_torch against sincformer_tpu, on the CPU in
float32, at narrow width and at full width with the committed int8 serving
artifact of the round-5 flagship. The JAX pipeline loads the artifact and
enhances the full-width tests' two mixtures on a background thread from
the start of the file (``tests/_torch_parity.Ahead``); both tests compare
with those references."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import Ahead, max_abs, narrow_model, wave

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(REPO, "artifacts", "r5", "sincformer_v4s0_best_serving",
                        "sincformer_final", "step_210")
CONVERTED = os.path.join(REPO, "artifacts", "r5",
                         "sincformer_v4s0_best_serving_torch")


def _jax_artifact(model_dir: str):
    """The JAX flagship pipeline with the committed int8 artifact loaded
    (the load takes about half a minute cold), and its outputs for the
    two mixtures of the full-width tests: each enhanced by
    ``enhance_signal``, and the MAA decisions of one batched forward."""
    from sincformer_tpu.dsp.stft import stft as jax_stft
    from sincformer_tpu.train.agent_trainer import \
        SincformerPipeline as JaxPipeline
    jp = JaxPipeline(model_dir=model_dir)
    jp.load_model(ARTIFACT)
    mixes = _mixtures()
    spec = jax_stft(jnp.asarray(mixes))
    out = jax.jit(lambda p, s, w, r, i: jp.model.apply(
        {"params": p, **s}, w, r, i, train=False))(
        jp.state.params, jp.state.model_state, mixes, spec.real, spec.imag)
    return jp, {"enhanced": [jp.enhance_signal(m) for m in mixes],
                "decisions": np.asarray(out["decisions"])}


@pytest.fixture(scope="module", autouse=True)
def ahead(tmp_path_factory):
    import sincformer_tpu.train.agent_trainer  # noqa: F401
    model_dir = str(tmp_path_factory.mktemp("jax_flagship"))
    a = Ahead()
    with a.start([(_jax_artifact, model_dir)], threads=1):
        a.model_dir = model_dir
        yield a


@pytest.fixture(scope="module")
def jax_artifact(ahead):
    return ahead(_jax_artifact, ahead.model_dir)[0]


@pytest.fixture(scope="module")
def jax_refs(ahead):
    return ahead(_jax_artifact, ahead.model_dir)[1]


def test_metacog_narrow_matches_jax():
    """The whole model at train=False, 0.5 s of audio: every routed and
    enhanced output within 1e-5 of the output's scale (same float32
    rounding argument as tests/test_torch_modules.py), identical MAA
    decisions."""
    from sincformer_tpu.dsp.stft import stft as jax_stft
    from sincformer_tpu_torch.dsp.stft import stft
    model, v, tm = narrow_model()
    x = wave(20)
    spec = jax_stft(jnp.asarray(x))
    ref = jax.jit(lambda var, w, r, i: model.apply(var, w, r, i, train=False))(
        v, x, spec.real, spec.imag)
    tx = torch.from_numpy(x)
    ts = stft(tx)
    with torch.no_grad():
        got = tm(tx, ts.real, ts.imag)
    np.testing.assert_array_equal(got["decisions"].numpy(),
                                  np.asarray(ref["decisions"]))
    for key in ("enhanced_real", "enhanced_imag", "mask_mag", "mask_phase",
                "sigma", "memory_gate", "confidence"):
        r = np.asarray(ref[key])
        assert max_abs(got[key], r) <= 1e-5 * max(1.0, np.abs(r).max()), key


def _mixtures() -> np.ndarray:
    return np.stack([_mixture(1), _mixture(2)])


def _mixture(seed: int, n: int = 8000) -> np.ndarray:
    from sincformer_tpu.data.synthetic import synthetic_speech_varied
    clean = synthetic_speech_varied(n / 8000, seed=seed)[:n]
    noise = np.random.default_rng(seed).standard_normal(n)
    noise *= np.sqrt(np.mean(clean ** 2) / np.mean(noise ** 2)) * 10 ** (-5 / 20)
    return (0.5 * (clean + noise)).astype(np.float32)


def test_artifact_enhance_signal_matches_jax(jax_artifact, jax_refs):
    """Full width, trained weights: the int8 serving artifact loaded by the
    JAX pipeline, carried over by load_from_jax, two seeded 1 s mixtures at
    5 dB SNR through enhance_signal. Same MAA decisions on every frame, and
    the enhanced waveforms within 1e-4 of their peak (float32 through a
    15.5M-parameter graph of ~30 layers and a 100-step BiLSTM)."""
    from sincformer_tpu_torch import (SincformerMetacog, SincformerPipeline,
                                      load_from_jax, resolve_output_gain)

    jp = jax_artifact
    variables = jax.tree.map(np.asarray, {"params": jp.state.params,
                                          **jp.state.model_state})
    state, buffers, config = load_from_jax(variables)
    assert (config.pa_fine_act, config.msa_blocks, config.d_model) == (
        "mulaw", 4, 256)
    tp = SincformerPipeline(SincformerMetacog(config), device="cpu",
                            output_gain=resolve_output_gain(ARTIFACT))
    tp.load_state(state, buffers)
    assert tp.output_gain == pytest.approx(jp.output_gain, abs=0)

    mixes = _mixtures()
    for mix, ref in zip(mixes, jax_refs["enhanced"]):
        got = tp.enhance_signal(mix)
        assert np.all(np.isfinite(got))
        assert np.max(np.abs(got - ref)) <= 1e-4 * np.max(np.abs(ref))

    # MAA decisions on the same frames, from one batched forward each
    from sincformer_tpu_torch.dsp.stft import stft
    tx = torch.from_numpy(mixes)
    ts = stft(tx)
    with torch.no_grad():
        tout = tp.model(tx, ts.real, ts.imag)
    flips = tout["decisions"].numpy() != jax_refs["decisions"]
    top2 = np.sort(tout["route_logits"].numpy(), axis=-1)[..., -2:]
    assert not flips.any(), (f"MAA decisions flip at logit margins "
                             f"{(top2[..., 1] - top2[..., 0])[flips]}")


def test_converted_artifact_matches_jax(jax_artifact, jax_refs):
    """The committed converted artifact, loaded by the port alone (torch and
    numpy), against the JAX pipeline on the JAX artifact: the output gain,
    the enhanced waveforms of two seeded 1 s mixtures within 1e-4 of their
    peak (one of them through the streaming enhancer's short-input route),
    and the MAA decisions of every frame."""
    from sincformer_tpu_torch import SincformerPipeline, StreamingEnhancer
    from sincformer_tpu_torch.dsp.stft import stft

    jp = jax_artifact
    tp = SincformerPipeline(device="cpu", model_dir=CONVERTED)
    assert tp.load_model().endswith("sincformer_final/step_210")
    assert tp.step == 210
    assert tp.output_gain == pytest.approx(jp.output_gain, abs=0)
    mixes = _mixtures()
    for mix, ref, enhance in zip(mixes, jax_refs["enhanced"],
                                 (tp.enhance_signal,
                                  StreamingEnhancer(tp).enhance)):
        got = enhance(mix)
        assert np.max(np.abs(got - ref)) <= 1e-4 * np.max(np.abs(ref))

    tx = torch.from_numpy(mixes)
    ts = stft(tx)
    with torch.no_grad():
        tout = tp.model(tx, ts.real, ts.imag)
    np.testing.assert_array_equal(tout["decisions"].numpy(),
                                  jax_refs["decisions"])


def test_converted_artifact_equals_fresh_conversion(jax_artifact):
    """scripts/torch_convert_artifact.py run again on the JAX artifact gives
    the committed payload tensor for tensor, int8 kept as int8 (only the
    CPEA recurrent matrices, which carry the folded bias, are float32), and
    the sidecar keeps the source's keys."""
    import json

    from sincformer_tpu_torch.compat.from_jax import \
        convert_quantized_from_jax
    from sincformer_tpu_torch.ops.quantize import is_quantized
    spec = importlib.util.spec_from_file_location(
        "torch_convert_artifact",
        os.path.join(REPO, "scripts", "torch_convert_artifact.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    params_q, model_state, step = script.read_jax_serving_tree(
        ARTIFACT, jax_artifact.state)
    fresh, buffers, _ = convert_quantized_from_jax(params_q, model_state)
    step_dir = os.path.join(CONVERTED, "sincformer_final", "step_210")
    saved = torch.load(os.path.join(step_dir, "state.pt"), weights_only=True)
    assert saved["step"] == step == 210
    assert set(saved["params_q"]) == set(fresh)
    int8_bytes = total_bytes = 0
    for name, node in fresh.items():
        got = saved["params_q"][name]
        assert is_quantized(got) == is_quantized(node), name
        for a, b in zip(*(([n["q"], n["s"]] if is_quantized(n) else [n])
                          for n in (got, node))):
            assert a.dtype == b.dtype and torch.equal(a, b), name
            total_bytes += a.numel() * a.element_size()
            int8_bytes += a.numel() if a.dtype == torch.int8 else 0
        if "weight_hh" in name:
            assert not is_quantized(got), name
    assert int8_bytes > 0.9 * total_bytes
    for name, b in buffers.items():
        assert torch.equal(saved["model_state"][name], b), name
    family = os.path.join(CONVERTED, "sincformer_final")
    meta = json.load(open(os.path.join(family, "train_meta.json")))
    src = json.load(open(os.path.join(os.path.dirname(ARTIFACT),
                                      "train_meta.json")))
    assert {k: meta[k] for k in src} == src
    assert meta["converted_from"].endswith("sincformer_final/step_210")
