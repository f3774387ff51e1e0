"""The port's public surface against the JAX package's, name for name.

The JAX package's sources are read with ``ast`` (nothing of JAX is imported
for it): every public function, class and module constant that a JAX module
defines, every name a JAX ``__init__`` exports, every public method and
property of every JAX class and every field of every JAX dataclass must
exist in the port's module at the same path, under the same name or its
rename (:data:`MODULE_RENAMES`, :func:`port_name`). :data:`EXCLUDED` is the
one exclusion table; each entry gives its reason. The configuration
dataclasses' defaults must equal the JAX package's
(``sincformer_tpu/config.py`` imports no JAX). A planted pair of packages
shows that the checker reports a missing name and a differing default.
The flagship's and DCSE's default builders take JAX's configuration
sections and build from replaced ones what JAX's build.

Then the names this surface added, each against the JAX package on the same
inputs on the CPU: ``VQMaskQuantizer`` around the narrow mask DNN (soft
mask 1e-5 of its scale, quantized values equal but at a near-tie of JAX's
two nearest centroids (1e-6), vq_loss 1e-6 relative, the estimator's
gradients 1e-4 of each leaf's scale), ``perceptual_stoi_loss`` (1e-6
absolute, its input gradient 1e-5 of its scale), ``sorted_centroids``,
``get_utilization``, ``usage_stats`` and ``get_strategy_name`` (equal),
``contrastive_divergence`` on JAX's uniforms (parameters 1e-6 of their
scale, error 1e-6 relative), ``print_schedule`` (the same text),
``stft_frame_count`` (equal, and equal to the port's ``stft``),
``dct_ortho`` (1e-6 of its scale) and the native ``mix_snr`` and
``batch_pad`` (JAX's own test cases, against JAX's functions)."""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
import importlib
import pathlib

import numpy as np
import pytest
import torch

from tests import _torch_threads  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_ROOT = REPO / "sincformer_tpu"

# JAX module path → the port's module that holds its counterpart
MODULE_RENAMES = {"ops/conv_gn_pallas.py": "ops/conv_gn.py",
                  "ops/envact_pallas.py": "ops/envact.py",
                  "ops/meddis_pallas.py": "ops/meddis.py"}

# "<JAX module path>:<qualified name>" patterns left out, with the reason
EXCLUDED = {
    "utils/backend.py:*":
        "on_tpu asks where JAX runs; the port dispatches on the device of "
        "each tensor it is given",
    "parallel/*.py:data_sharding":
        "a jax.sharding.NamedSharding; the port's ranks take their block of "
        "the batch themselves (parallel/mesh.py)",
    "parallel/*.py:replicated":
        "a jax.sharding.NamedSharding; a torch tensor on a rank is its "
        "replica (parallel/mesh.py)",
    "train/state.py:TrainState*":
        "flax's train_state.TrainState and its subclass; the port's train "
        "state is a dict (train/state.py)",
    "*:_*": "private names",
    "*:*._*": "private names",
}


def port_name(name: str) -> str:
    """The port's name for a JAX name: ``*_jax`` → ``*_torch``,
    ``meddis_pallas`` → ``meddis``."""
    if name == "meddis_pallas":
        return "meddis"
    if name.endswith("_jax"):
        return name[:-len("_jax")] + "_torch"
    return name


def _targets(node):
    for t in getattr(node, "targets", [getattr(node, "target", None)]):
        if isinstance(t, ast.Name):
            yield t.id
        elif isinstance(t, ast.Tuple):
            yield from (e.id for e in t.elts if isinstance(e, ast.Name))


def _is_dataclass(node: ast.ClassDef) -> bool:
    for d in node.decorator_list:
        d = d.func if isinstance(d, ast.Call) else d
        name = d.attr if isinstance(d, ast.Attribute) else getattr(d, "id", "")
        if name == "dataclass":
            return True
    return False


def surface(root: pathlib.Path):
    """[(module path, qualified name, kind)] of the package under ``root``:
    kinds "export", "function", "class", "constant", "member", "field"."""
    out = []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        tree = ast.parse(path.read_text(encoding="utf-8"), str(path))
        for node in tree.body:
            if path.name == "__init__.py" and isinstance(node, ast.ImportFrom):
                out += [(rel, a.asname or a.name, "export")
                        for a in node.names]
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append((rel, node.name, "function"))
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                out += [(rel, n, "constant") for n in _targets(node)]
            elif isinstance(node, ast.ClassDef):
                out.append((rel, node.name, "class"))
                for b in node.body:
                    if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        out.append((rel, f"{node.name}.{b.name}", "member"))
                    elif (isinstance(b, ast.AnnAssign) and _is_dataclass(node)
                          and isinstance(b.target, ast.Name)):
                        out.append((rel, f"{node.name}.{b.target.id}",
                                    "field"))
    return out


def excluded(rel: str, qual: str, table=EXCLUDED) -> bool:
    return any(fnmatch.fnmatchcase(f"{rel}:{qual}", pat) for pat in table)


def _port_module(rel: str, package: str):
    parts = MODULE_RENAMES.get(rel, rel)[:-len(".py")].split("/")
    if parts[-1] == "__init__":
        parts.pop()
    return importlib.import_module(".".join([package] + parts))


def missing(items, package: str, table=EXCLUDED):
    """The entries of ``surface`` with no counterpart in ``package``."""
    out = []
    for rel, qual, kind in items:
        if excluded(rel, qual, table):
            continue
        try:
            mod = _port_module(rel, package)
        except ImportError as e:
            out.append(f"{rel}: no module ({e})")
            continue
        owner, _, member = qual.rpartition(".")
        if not owner:
            found = hasattr(mod, port_name(qual))
        else:
            cls = getattr(mod, port_name(owner), None)
            if kind == "field":
                found = dataclasses.is_dataclass(cls) and member in {
                    f.name for f in dataclasses.fields(cls)}
            else:
                found = cls is not None and hasattr(cls, port_name(member))
        if not found:
            out.append(f"{rel}:{qual} ({kind})")
    return out


def _differences(a, b, where: str):
    if dataclasses.is_dataclass(a):
        return [d for f in dataclasses.fields(a)
                for d in _differences(getattr(a, f.name),
                                      getattr(b, f.name, "<missing>"),
                                      f"{where}.{f.name}")]
    return [] if a == b else [f"{where}: {a!r} != {b!r}"]


def differing_defaults(jax_mod, port_mod):
    """``Class.field`` of every dataclass ``jax_mod`` defines whose default
    differs in ``port_mod`` (nested dataclasses field by field)."""
    out = []
    for name, cls in vars(jax_mod).items():
        if (isinstance(cls, type) and dataclasses.is_dataclass(cls)
                and cls.__module__ == jax_mod.__name__):
            out += _differences(cls(), getattr(port_mod, name)(), name)
    return out


JAX_SURFACE = surface(JAX_ROOT)
JAX_MODULES = sorted({rel for rel, _, _ in JAX_SURFACE})


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_port_has_every_public_name_of_the_jax_module(rel):
    gaps = missing([s for s in JAX_SURFACE if s[0] == rel],
                   "sincformer_tpu_torch")
    assert not gaps, gaps


def test_every_exclusion_matches_a_jax_name():
    """No entry of the table outlives the JAX name it excludes."""
    for pat in EXCLUDED:
        assert any(fnmatch.fnmatchcase(f"{rel}:{qual}", pat)
                   for rel, qual, _ in JAX_SURFACE), pat


def test_config_defaults_equal_jax():
    """Every configuration dataclass's defaults, field for field, the root
    ``DEFAULT`` included, and the loss weight that the flagship trainer
    does not read (10.0) beside the one it does (1.0)."""
    from sincformer_tpu import config as jcfg

    from sincformer_tpu_torch import config as pcfg
    assert not differing_defaults(jcfg, pcfg)
    assert not _differences(jcfg.DEFAULT, pcfg.DEFAULT, "DEFAULT")
    assert [f.name for f in dataclasses.fields(pcfg.Config)] == [
        f.name for f in dataclasses.fields(jcfg.Config)]
    assert pcfg.DEFAULT.loss.perceptual_weight == 10.0
    assert pcfg.replace(pcfg.DEFAULT.vq, num_centroids=4).num_centroids == 4
    assert (pcfg.DEFAULT.audio.frame_size, pcfg.DEFAULT.audio.hop_size) == (
        jcfg.DEFAULT.audio.frame_size, jcfg.DEFAULT.audio.hop_size) == (
        160, 80)


def test_checker_reports_a_planted_missing_name_and_default(tmp_path,
                                                             monkeypatch):
    """A JAX-side package with a name the port-side one lacks and a
    dataclass default that differs: both are reported, and nothing else."""
    jax_side, port_side = tmp_path / "planted_jax", tmp_path / "planted_port"
    for pkg, body in ((jax_side, "def g():\n    pass\n\n\n"),
                      (port_side, "")):
        pkg.mkdir()
        (pkg / "__init__.py").write_text(
            f"from {pkg.name}.mod import C, f  # noqa: F401\n")
        (pkg / "mod.py").write_text(
            "import dataclasses\n\n\ndef f():\n    pass\n\n\n" + body
            + "@dataclasses.dataclass(frozen=True)\nclass C:\n"
            + "    x: int = 1\n"
            + f"    y: float = {2.0 if pkg is jax_side else 3.0}\n\n"
            + "    def m(self):\n        pass\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    gaps = missing(surface(jax_side), "planted_port")
    assert gaps == ["mod.py:g (function)"]
    diffs = differing_defaults(importlib.import_module("planted_jax.mod"),
                               importlib.import_module("planted_port.mod"))
    assert diffs == ["C.y: 2.0 != 3.0"]
    # and an entry of the table silences a name
    assert not missing(surface(jax_side), "planted_port",
                       {**EXCLUDED, "mod.py:g": "planted"})


def test_flagship_trainer_keeps_its_own_stoi_weight(tmp_path):
    """LossConfig.perceptual_weight is JAX's 10.0, and the flagship
    trainer's STOI weight stays 1.0 unless given, as JAX's."""
    from sincformer_tpu.train.agent_trainer import \
        SincformerPipeline as JaxTrainer
    from tests._torch_parity import NARROW

    from sincformer_tpu_torch.config import LossConfig, MetacogConfig
    from sincformer_tpu_torch.agents.metacog import SincformerMetacog
    from sincformer_tpu_torch.train.agent_trainer import SincformerTrainer
    assert LossConfig().perceptual_weight == 10.0
    assert JaxTrainer(model_dir=str(tmp_path)).perceptual_weight == 1.0
    model = SincformerMetacog(MetacogConfig(**NARROW))
    assert SincformerTrainer(model, device="cpu").perceptual_weight == 1.0
    assert SincformerTrainer(model, device="cpu",
                             perceptual_weight=2.5).perceptual_weight == 2.5


def test_default_builders_read_replaced_sections_as_jax():
    """``default_metacog`` and ``default_speech_enhancer`` take JAX's
    configuration sections: built from replaced sections (and a size given
    by name), every field the port's model shares with JAX's module
    (``d_ff`` is DCSEConfig's ``ff_dim``) holds JAX's value."""
    from sincformer_tpu import config as jcfg
    from sincformer_tpu.models.dcse import default_speech_enhancer as jdse
    from sincformer_tpu.train.agent_trainer import default_metacog as jdm

    from sincformer_tpu_torch import config as pcfg
    from sincformer_tpu_torch.models.dcse import default_speech_enhancer
    from sincformer_tpu_torch.train.agent_trainer import default_metacog

    def sections(c):
        return dict(
            acfg=c.replace(c.DEFAULT.audio, fft_size=128, frame_size_ms=32),
            agcfg=c.replace(c.DEFAULT.agents, memory_slots=8,
                            cpea_hidden_size=16, cpea_num_layers=1,
                            pa_encoder_channels=32, sinc_kernel_size=65,
                            pa_impl="reference"),
            vqcfg=c.replace(c.DEFAULT.vq, num_centroids=4,
                            commitment_weight=0.5))
    narrow = dict(d_model=32, msa_blocks=1, num_heads=2, d_ff=64,
                  kernel_size=7, cpea_channels=8)
    jm = jdm(**sections(jcfg), **narrow)
    pm = default_metacog(**sections(pcfg), **narrow).config
    shared = [f.name for f in dataclasses.fields(pm) if hasattr(jm, f.name)]
    assert len(shared) >= 20
    assert {n: getattr(pm, n) for n in shared} == {
        n: getattr(jm, n) for n in shared}
    assert (pm.n_freq, pm.hop, pm.memory_slots, pm.vq_centroids) == (
        65, 128, 8, 4)

    def dcse(c):
        return dict(dcfg=c.replace(c.DEFAULT.dcse, d_model=32, num_blocks=1,
                                   num_heads=2, ff_dim=64, kernel_size=7),
                    acfg=c.replace(c.DEFAULT.audio, fft_size=128))
    jd = jdse(**dcse(jcfg), dropout=0.0)
    pd = default_speech_enhancer(**dcse(pcfg), dropout=0.0).config
    fields = {f.name: getattr(pd, {"d_ff": "ff_dim"}.get(f.name, f.name))
              for f in dataclasses.fields(jd)
              if f.name not in ("parent", "name")}
    assert fields == {n: getattr(jd, n) for n in fields}
    assert (pd.n_freq, pd.d_model, pd.dropout) == (65, 32, 0.0)


def _scale_err(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def test_vq_mask_quantizer_matches_jax():
    """The narrow mask DNN inside VQMaskQuantizer, initialised by JAX from a
    seed and carried across by load_vq_mask_quantizer_from_jax."""
    import dataclasses as dc

    import jax
    import jax.numpy as jnp
    from sincformer_tpu import config as jcfg
    from sincformer_tpu.models.dnn import create_dnn as jax_create
    from sincformer_tpu.models.vq import VQMaskQuantizer as JaxVQM
    from tests._torch_parity import NARROW_DNN

    from sincformer_tpu_torch.compat.from_jax import (
        load_dnn_from_jax, load_vq_mask_quantizer_from_jax)
    from sincformer_tpu_torch.models import SpeechEnhancementDNN
    from sincformer_tpu_torch.models import VQMaskQuantizer
    rng = np.random.default_rng(5)
    x = rng.standard_normal((256, 594)).astype(np.float32)
    c = rng.standard_normal((256, 64)).astype(np.float32)
    jm = JaxVQM(jax_create(594, dcfg=dc.replace(jcfg.DEFAULT.dnn,
                                                **NARROW_DNN)))
    variables = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))
    assert set(variables["params"]) == {"mask_estimator", "vq"}

    def jloss(params):
        q, soft, vq_loss = jm.apply({"params": params}, jnp.asarray(x),
                                    return_soft=True)
        return jnp.sum(q * c) + vq_loss, (q, soft, vq_loss)
    (_, (jq, jsoft, jvq)), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        variables["params"])
    np_vars = jax.tree.map(np.asarray, variables)

    state, sizes = load_vq_mask_quantizer_from_jax(np_vars)
    model = VQMaskQuantizer(SpeechEnhancementDNN(**sizes))
    model.load_state_dict(state, strict=True)
    q, soft, vq_loss = model(torch.from_numpy(x), return_soft=True)
    (q * torch.from_numpy(c)).sum().add(vq_loss).backward()

    jsoft, jq = np.asarray(jsoft), np.asarray(jq)
    assert _scale_err(soft.detach(), jsoft) <= 1e-5
    cents = np.sort(np.asarray(variables["params"]["vq"]["centroids"]))
    d = np.sort((jsoft[..., None] - cents) ** 2, axis=-1)
    near_tie = (d[..., 1] - d[..., 0]) <= 1e-6
    differ = q.detach().numpy() != jq
    assert not np.any(differ & ~near_tie)
    assert abs(vq_loss.item() - float(jvq)) <= 1e-6 * abs(float(jvq))
    want, _ = load_dnn_from_jax(
        {"params": jax.tree.map(np.asarray, jgrad["mask_estimator"])})
    for name, p in model.mask_estimator.named_parameters():
        assert _scale_err(p.grad, want[name]) <= 1e-4, name
    assert _scale_err(model.vq.centroids.grad,
                      np.asarray(jgrad["vq"]["centroids"])) <= 1e-4


def test_vq_helpers_memory_stats_and_strategy_names_equal_jax():
    """sorted_centroids, get_utilization, usage_stats and
    get_strategy_name give JAX's values."""
    import jax.numpy as jnp
    from sincformer_tpu.agents import maa as jmaa
    from sincformer_tpu.agents.memory import EpisodicMemory as JaxMemory
    from sincformer_tpu.models import vq as jvq

    from sincformer_tpu_torch.agents import EpisodicMemory
    from sincformer_tpu_torch.agents import maa
    from sincformer_tpu_torch.models import VectorQuantizer
    from sincformer_tpu_torch.models.vq import sorted_centroids
    rng = np.random.default_rng(8)
    cents = rng.uniform(0, 1, 5).astype(np.float32)
    want = np.asarray(jvq.sorted_centroids(
        {"params": {"vq": {"centroids": jnp.asarray(cents)}}}))
    q = VectorQuantizer(5)
    with torch.no_grad():
        q.centroids.copy_(torch.from_numpy(cents))
    assert np.array_equal(sorted_centroids(q).numpy(), want)
    assert np.array_equal(sorted_centroids(
        {"vq.centroids": torch.from_numpy(cents)}).numpy(), want)
    idx = rng.integers(0, 5, (7, 11))
    assert np.array_equal(
        VectorQuantizer.get_utilization(torch.from_numpy(idx), 5).numpy(),
        np.asarray(jvq.VectorQuantizer.get_utilization(jnp.asarray(idx), 5)))

    usage = rng.integers(0, 9, 20).astype(np.float32)
    for n in (0, 37):
        jstats = {"usage_count": jnp.asarray(usage),
                  "num_queries": jnp.asarray(n, jnp.int32)}
        want = np.asarray(JaxMemory.usage_stats(jstats))
        mem = EpisodicMemory(8, 4, num_slots=16, episodic_slots=4)
        mem.usage_count.copy_(torch.from_numpy(usage))
        mem.num_queries.fill_(n)
        assert np.array_equal(EpisodicMemory.usage_stats(mem).numpy(), want)
        assert np.array_equal(EpisodicMemory.usage_stats(
            dict(mem.named_buffers())).numpy(), want)
    assert maa.STRATEGY_NAMES == jmaa.STRATEGY_NAMES
    for i in (0, 1, 2, 3, 4, -1, np.int64(2)):
        assert maa.get_strategy_name(i) == jmaa.get_strategy_name(i)


def test_perceptual_stoi_loss_matches_jax():
    """JAX's test shape (2, 129, 90): the loss 1e-6 absolute, its gradient
    with respect to the enhanced magnitudes 1e-5 of its scale."""
    import jax
    import jax.numpy as jnp
    from sincformer_tpu.train.losses import perceptual_stoi_loss as jloss

    from sincformer_tpu_torch.train import perceptual_stoi_loss
    rng = np.random.default_rng(11)
    spec_c = np.abs(rng.standard_normal((2, 129, 90))).astype(np.float32)
    spec_e = spec_c + 0.1 * np.abs(
        rng.standard_normal((2, 129, 90))).astype(np.float32)
    want, jgrad = jax.value_and_grad(jloss)(jnp.asarray(spec_e),
                                            jnp.asarray(spec_c))
    e = torch.from_numpy(spec_e).requires_grad_(True)
    got = perceptual_stoi_loss(e, torch.from_numpy(spec_c))
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-6
    assert _scale_err(e.grad, np.asarray(jgrad)) <= 1e-5


def test_contrastive_divergence_matches_jax_on_its_uniforms(monkeypatch):
    """One CD-1 step through the RBM's own parameters, on the uniforms JAX
    draws from the same key (``jax.random.split(key, 2k + 1)``)."""
    import jax
    from sincformer_tpu.models.rbm import RBM as JaxRBM

    from sincformer_tpu_torch.models import RBM
    from sincformer_tpu_torch.models.rbm import cd_uniform_shapes
    b, vis, hid = 32, 40, 24
    rng = np.random.default_rng(4)
    v = rng.uniform(0, 1, (b, vis)).astype(np.float32)
    params = (rng.standard_normal((vis, hid)).astype(np.float32) * 0.3,
              (0.1 * rng.standard_normal(vis)).astype(np.float32),
              (0.1 * rng.standard_normal(hid)).astype(np.float32))
    jrbm = JaxRBM(vis, hid, learning_rate=0.05)
    jrbm.W, jrbm.v_bias, jrbm.h_bias = params
    key = jax.random.PRNGKey(23)
    jerr = jrbm.contrastive_divergence(v, key)
    u = [np.array(jax.random.uniform(kk, s)) for kk, s in zip(
        jax.random.split(key, 3), cd_uniform_shapes(b, vis, hid, 1))]

    rbm = RBM(vis, hid, learning_rate=0.05, device="cpu")
    rbm.W, rbm.v_bias, rbm.h_bias = (torch.from_numpy(p.copy())
                                     for p in params)
    draws = []
    monkeypatch.setattr(rbm, "draw_uniforms", lambda batch, generator: (
        draws.append((batch, generator)) or [torch.from_numpy(x) for x in u]))
    g = torch.Generator().manual_seed(0)
    err = rbm.contrastive_divergence(v, generator=g)
    assert draws == [(b, g)]
    assert isinstance(err, float)
    for got, want in zip(rbm.params, (jrbm.W, jrbm.v_bias, jrbm.h_bias)):
        assert _scale_err(got, want) <= 1e-6
    assert abs(err - jerr) <= 1e-6 * abs(jerr)


def test_print_schedule_prints_jax_text(capsys):
    from sincformer_tpu import config as jcfg
    from sincformer_tpu.train.curriculum import \
        CurriculumScheduler as JaxScheduler

    from sincformer_tpu_torch.config import CurriculumConfig
    from sincformer_tpu_torch.train import CurriculumScheduler
    for sizes in ({}, dict(stage1_epochs=2, stage2_epochs=3,
                           stage3_epochs=1)):
        JaxScheduler(jcfg.CurriculumConfig(**sizes)).print_schedule()
        want = capsys.readouterr().out
        CurriculumScheduler(CurriculumConfig(**sizes)).print_schedule()
        assert capsys.readouterr().out == want
        assert "Stage 3" in want


def test_stft_frame_count_equals_jax_and_stft():
    from sincformer_tpu.dsp.stft import stft_frame_count as jcount

    from sincformer_tpu_torch.dsp import stft, stft_uncentered
    from sincformer_tpu_torch.dsp.stft import stft_frame_count
    for n in (0, 1, 79, 80, 159, 160, 161, 4000, 4003):
        for hop in (40, 64, 80, 128):
            for center in (True, False):
                got = stft_frame_count(n, hop, center)
                assert got == jcount(n, hop, center)
                if n < 160:
                    continue
                x = torch.zeros(n)
                frames = (stft(x, hop=hop) if center
                          else stft_uncentered(x, hop=hop)).shape[-2]
                assert frames == got, (n, hop, center)


def test_dct_ortho_matches_jax():
    import jax.numpy as jnp
    from sincformer_tpu.utils.signal import dct_ortho as jdct

    from sincformer_tpu_torch.utils import dct_ortho
    x = np.random.default_rng(6).standard_normal((3, 5, 64)).astype(
        np.float32)
    for n_out in (None, 13):
        want = np.asarray(jdct(jnp.asarray(x), n_out))
        got = dct_ortho(torch.from_numpy(x), n_out)
        assert got.shape == want.shape
        assert _scale_err(got, want) <= 1e-6


@pytest.fixture
def jax_native(monkeypatch):
    """The JAX package's bindings on the library the port builds from the
    same native/wavio.cpp (it would otherwise run make in native/)."""
    from sincformer_tpu.data import native as jnative

    from sincformer_tpu_torch.data import native
    if not native.available():
        pytest.skip("no host C++ compiler")
    monkeypatch.setattr(jnative, "_LIB_PATH", native.library_path())
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", False)
    assert jnative.available()
    return jnative


def test_native_mix_snr_and_batch_pad_match_jax(jax_native):
    """JAX's tests/test_native.py cases: each function against JAX's on the
    same input (bit for bit: the same library code), mix_snr also 1e-5 of
    add_noise_at_snr as JAX's test holds it."""
    from sincformer_tpu_torch.data import add_noise_at_snr, native
    rng = np.random.default_rng(0)
    clean = rng.standard_normal(4000).astype(np.float32)
    noise = rng.standard_normal(1500).astype(np.float32)
    ours = native.mix_snr(clean, noise, 5.0)
    assert np.array_equal(ours, jax_native.mix_snr(clean, noise, 5.0))
    np.testing.assert_allclose(ours, add_noise_at_snr(clean, noise, 5.0),
                               atol=1e-5)
    sigs = [rng.standard_normal(n).astype(np.float32)
            for n in (100, 250, 40)]
    out = native.batch_pad(sigs, 250)
    assert np.array_equal(out, jax_native.batch_pad(sigs, 250))
    assert out.shape == (3, 250)
    np.testing.assert_array_equal(out[0, :100], sigs[0])
    assert np.all(out[0, 100:] == 0)
    np.testing.assert_array_equal(out[2, :40], sigs[2])
