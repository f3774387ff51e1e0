"""Port parity, module by module: each sincformer_tpu_torch module against its
flax counterpart at narrow widths, the same weights carried across by
compat.from_jax (tests/_torch_parity.py) and the same numpy inputs.

Tolerance 1e-5 of the output's scale, max(1, peak |reference|): float32 on
both sides, with sums taken in another order by XLA and by PyTorch's CPU
kernels. That is a few ulp on O(1) outputs; the perception agent's
GroupNorm'd latent peaks near 5 after five conv and norm layers and lands
10-20 ulp apart. The BiLSTM runs 50 steps each way and stays within it."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import NARROW, max_abs, narrow_model, wave

TOL = 1e-5
D = NARROW["encoder_channels"]


def close(got, ref) -> bool:
    return max_abs(got, ref) <= TOL * max(1.0, float(np.max(np.abs(ref))))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _apply(module, variables, *args, **static):
    """Jitted flax apply: one compile instead of one per eager op."""
    return jax.jit(functools.partial(module.apply, **static))(variables, *args)


def _latent(seed, b=2, t=50):
    return np.random.default_rng(seed).standard_normal(
        (b, D, t)).astype(np.float32)


def test_sincconv():
    from sincformer_tpu.agents.sincnet import SincConv1d
    _, v, tm = narrow_model()
    x = wave(3)
    ref = _apply(SincConv1d(out_channels=D // 4,
                            kernel_size=NARROW["sinc_kernel_size"],
                            channels_last=True),
                 {"params": v["params"]["pa"]["sinc"]}, x)
    with torch.no_grad():
        got = tm.pa.sinc(_t(x))
    assert close(got, ref)


@pytest.mark.parametrize("fine_act", ["mulaw", "gelu"])
def test_perception_agent(fine_act):
    """Both fine-stream activations; the GELU tree is the μ-law one without
    act_mu, as in a GELU checkpoint."""
    from sincformer_tpu.agents.perception import PerceptionAgentMXU
    from sincformer_tpu_torch.agents.perception import \
        PerceptionAgentMXU as TorchPA
    _, v, tm = narrow_model()
    jparams = {k: p for k, p in v["params"]["pa"].items()
               if fine_act == "mulaw" or k != "act_mu"}
    pa = TorchPA(D, 8000, NARROW["sinc_kernel_size"], 80,
                 fine_act=fine_act).eval()
    pa.load_state_dict({k: p for k, p in tm.pa.state_dict().items()
                        if fine_act == "mulaw" or k != "act_mu"}, strict=True)
    x = wave(4)
    ref = _apply(PerceptionAgentMXU(D, 8000, NARROW["sinc_kernel_size"], 80,
                                    fine_act=fine_act),
                 {"params": jparams}, x)
    with torch.no_grad():
        got = pa(_t(x))
    for g, r in zip(got, ref):
        assert close(g, r)


def test_cpea_bilstm():
    from sincformer_tpu.agents.cpea import CorrelationPhaseEstimationAgent
    _, v, tm = narrow_model()
    z = _latent(5)
    ref = _apply(CorrelationPhaseEstimationAgent(
        D, NARROW["cpea_hidden"], 2, NARROW["cpea_channels"]),
        {"params": v["params"]["cpea"]}, z, channels_first=True)
    with torch.no_grad():
        got = tm.cpea(_t(z))
    for key in ("rho_s", "rho_n", "phi1", "phi2"):
        assert close(got[key], ref[key]), key


def test_cpea_recurrent_bias_fold():
    """Pins a fault of the JAX CPEA that the port reproduces: its recurrent
    matrix is Dense(eye(H)) = kernel + bias in every row, so with non-zero
    h-side biases it is not flax's LSTMCell. The port equals the JAX CPEA;
    a torch LSTM given the plain kernels differs by far more than TOL."""
    from sincformer_tpu.agents.cpea import CorrelationPhaseEstimationAgent
    _, v, tm = narrow_model()
    z = _latent(14)
    ref = _apply(CorrelationPhaseEstimationAgent(
        D, NARROW["cpea_hidden"], 2, NARROW["cpea_channels"]),
        {"params": v["params"]["cpea"]}, z, channels_first=True)
    textbook = {k: t.clone() for k, t in tm.cpea.state_dict().items()}
    for layer in range(2):
        for sfx, cell in (("", 2 * layer), ("_reverse", 2 * layer + 1)):
            c = v["params"]["cpea"][f"LSTMCell_{cell}"]
            textbook[f"lstm.weight_hh_l{layer}{sfx}"] = _t(np.concatenate(
                [c[f"h{g}"]["kernel"] for g in "ifgo"], 1).T.copy())
    from sincformer_tpu_torch.agents.cpea import \
        CorrelationPhaseEstimationAgent as TorchCPEA
    plain = TorchCPEA(D, NARROW["cpea_hidden"], 2, NARROW["cpea_channels"])
    plain.load_state_dict(textbook)
    with torch.no_grad():
        assert close(tm.cpea(_t(z))["phi1"], ref["phi1"])
        assert max_abs(plain(_t(z))["phi1"], ref["phi1"]) > 1e-2


@pytest.mark.parametrize("masked", [False, True])
def test_conformer_block(masked):
    from sincformer_tpu.models.conformer import ConformerBlock
    _, v, tm = narrow_model()
    d = NARROW["d_model"]
    x = np.random.default_rng(6).standard_normal((2, 50, d)).astype(np.float32)
    mask = np.arange(50)[None, :] < np.array([[50], [37]])
    block = ConformerBlock(d, NARROW["num_heads"], NARROW["d_ff"],
                           NARROW["kernel_size"], 0.0, attn_impl="speech")
    ref = jax.jit(lambda p, x, m: block.apply(p, x, True, m))(
        {"params": v["params"]["msa"]["block_0"]}, x,
        mask if masked else None)
    with torch.no_grad():
        got = tm.msa.block_0(_t(x), _t(mask) if masked else None)
    assert close(got, ref)


def test_mask_synthesis_agent():
    from sincformer_tpu.agents.msa import MaskSynthesisAgent
    _, v, tm = narrow_model()
    rng = np.random.default_rng(7)
    zr, zi = _latent(8), _latent(9)
    c = NARROW["cpea_channels"]
    cpea = {k: rng.uniform(0, 1, (2, 50, c)).astype(np.float32)
            for k in ("rho_s", "rho_n", "phi1", "phi2")}
    sr, si = (rng.standard_normal((2, 50, 129)).astype(np.float32)
              for _ in range(2))
    ref = _apply(MaskSynthesisAgent(D, c, NARROW["d_model"], 129,
                                    NARROW["msa_blocks"], NARROW["num_heads"],
                                    NARROW["d_ff"], NARROW["kernel_size"],
                                    0.0, attn_impl="speech"),
                 {"params": v["params"]["msa"]}, zr, zi, cpea, sr, si,
                 deterministic=True)
    with torch.no_grad():
        got = tm.msa(_t(zr), _t(zi), {k: _t(a) for k, a in cpea.items()},
                     _t(sr), _t(si))
    for g, r in zip(got, ref):
        assert close(g, r)


def test_episodic_memory_read():
    from sincformer_tpu.agents.memory import EpisodicMemory
    _, v, tm = narrow_model()
    e = np.random.default_rng(10).standard_normal((3, D)).astype(np.float32)
    ref = _apply(EpisodicMemory(D, 129, NARROW["memory_slots"],
                                episodic_slots=NARROW["episodic_slots"]),
                 {"params": v["params"]["memory"],
                  "memory_bank": v["memory_bank"]["memory"],
                  "memory_stats": v["memory_stats"]["memory"]},
                 e, train=False)
    with torch.no_grad():
        got = tm.memory(_t(e))
    for key in ("bias", "gate", "similarity"):
        assert close(got[key], ref[key]), key
    np.testing.assert_array_equal(got["top_indices"].numpy(),
                                  np.asarray(ref["top_indices"]))


def test_vector_quantizer():
    from sincformer_tpu.models.vq import VectorQuantizer
    _, v, tm = narrow_model()
    x = np.random.default_rng(11).uniform(0, 1, (2, 50, 129)).astype(np.float32)
    q, idx, loss = _apply(VectorQuantizer(3, 0.25),
                          {"params": v["params"]["vq"]}, x)
    with torch.no_grad():
        gq, gidx, gloss = tm.vq(_t(x))
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(idx))
    assert max_abs(gq, q) == 0.0
    assert abs(float(gloss) - float(loss)) < 1e-6


def test_maa_routing():
    from sincformer_tpu.agents.maa import MetacognitiveArbitrationAgent
    _, v, tm = narrow_model()
    sigma = np.exp(np.random.default_rng(12).standard_normal(
        (2, 1, 50))).astype(np.float32)
    ref = _apply(MetacognitiveArbitrationAgent(),
                 {"params": v["params"]["maa"],
                  "maa_stats": v["maa_stats"]["maa"]}, sigma, train=False)
    with torch.no_grad():
        got = tm.maa(_t(sigma))
    np.testing.assert_array_equal(got["decisions"].numpy(),
                                  np.asarray(ref["decisions"]))
    np.testing.assert_array_equal(got["route"].numpy(),
                                  np.asarray(ref["route"]))
    for key in ("logits", "probs", "confidence"):
        assert close(got[key], ref[key]), key


@pytest.mark.parametrize("impl", ["speech", "xla"])
def test_attention_dispatch(impl):
    """ops/attention impl speech and xla against the JAX dispatch, with a
    valid-frame mask."""
    from sincformer_tpu.ops.attention import dot_product_attention as jax_dpa
    from sincformer_tpu_torch.ops.attention import dot_product_attention
    rng = np.random.default_rng(13)
    q, k, v = (rng.standard_normal((2, 60, 2, 16)).astype(np.float32)
               for _ in range(3))
    mask = np.arange(60)[None, :] < np.array([[60], [45]])
    ref = jax_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  mask=jnp.asarray(mask), impl=impl)
    got = dot_product_attention(_t(q), _t(k), _t(v), mask=_t(mask), impl=impl)
    assert close(got, ref)


@pytest.mark.parametrize("impl", ["ring", "flash"])
def test_attention_later_impls_raise(impl):
    """The impls ported after the first slice, without a ring context:
    ``"ring"`` raises in a training forward (JAX's message) and warns and
    falls back to ``"speech"`` in inference, as the JAX dispatch does;
    ``"flash"`` equals JAX's ``impl="flash"`` on the CPU (full attention
    off a TPU), with a valid-frame mask."""
    from sincformer_tpu.ops.attention import dot_product_attention as jax_dpa
    from sincformer_tpu_torch.ops.attention import dot_product_attention
    rng = np.random.default_rng(17)
    q, k, v = (rng.standard_normal((2, 50, 2, 16)).astype(np.float32)
               for _ in range(3))
    mask = np.arange(50)[None, :] < np.array([[50], [37]])
    if impl == "ring":
        with pytest.raises(RuntimeError, match="ring_mesh"):
            dot_product_attention(_t(q), _t(k), _t(v), impl="ring",
                                  train=True)
        with pytest.warns(RuntimeWarning, match="ring"):
            got = dot_product_attention(_t(q), _t(k), _t(v), impl="ring")
        want = dot_product_attention(_t(q), _t(k), _t(v), impl="speech")
        assert torch.equal(got, want)
        return
    ref = jax_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  mask=jnp.asarray(mask), impl="flash")
    got = dot_product_attention(_t(q), _t(k), _t(v), mask=_t(mask),
                                impl="flash")
    assert close(got, ref)
