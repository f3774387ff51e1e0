"""The port's package boundary: it imports nothing of JAX or of the JAX
package, and its entry points run on the CPU only when asked to."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from tests import _torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "sincformer_tpu")


def _port_sources():
    pkg = os.path.join(REPO, "sincformer_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_no_jax():
    bad = [(os.path.relpath(p, REPO), m) for p in _port_sources()
           for m in _imported(p) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def _port_modules():
    """Every module of the package, by walking its directory."""
    pkg = os.path.join(REPO, "sincformer_tpu_torch")
    for path in _port_sources():
        if not path.startswith(pkg):
            continue
        name = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        yield name[:-len(".__init__")] if name.endswith(".__init__") else name


def test_import_loads_no_jax_module():
    """Importing every module of the port (the new front-end, feature, DNN
    and kernel-wrapper modules included, and every subpackage with the
    names it re-exports as the JAX package's do) and chip_smoke.py loads
    nothing of JAX, builds no kernel (nor the native audio library) and
    needs no CUDA, nvcc or triton."""
    modules = sorted(_port_modules())
    for new in ("dsp.gammatone", "dsp.haircell", "dsp.features", "models.dnn",
                "ops.meddis", "ops.envact", "ops.conv_gn"):
        assert f"sincformer_tpu_torch.{new}" in modules
    subpackages = sorted(os.path.basename(os.path.dirname(p)) for p in
                         _port_sources() if p.endswith("__init__.py")
                         and os.path.dirname(os.path.dirname(p)).endswith(
                             "sincformer_tpu_torch"))
    jax_pkg = os.path.join(REPO, "sincformer_tpu")
    assert subpackages == sorted(
        d for d in os.listdir(jax_pkg)
        if os.path.exists(os.path.join(jax_pkg, d, "__init__.py")))
    code = (f"import sys, chip_smoke, {', '.join(modules)}; "
            f"from sincformer_tpu_torch.ops import build; "
            f"from sincformer_tpu_torch.data import native; "
            f"print([m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN + ('triton',)!r}], build.load.cache_info().currsize,"
            f" native._tried)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "[] 0 False"
    from sincformer_tpu_torch import models
    assert models.VQMaskQuantizer.__module__ == (
        "sincformer_tpu_torch.models.vq")


def test_pipeline_default_device_needs_cuda():
    """Without CUDA the default device raises rather than running on the
    CPU; device='cpu' is the explicit opt-in."""
    from sincformer_tpu_torch import (MetacogConfig, SincformerMetacog,
                                      SincformerPipeline)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    small = SincformerMetacog(MetacogConfig(
        encoder_channels=32, cpea_hidden=8, cpea_channels=4, d_model=32,
        msa_blocks=1, num_heads=2, d_ff=32, kernel_size=3, memory_slots=2,
        episodic_slots=2, sinc_kernel_size=33))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SincformerPipeline(small)
    pipe = SincformerPipeline(small, device="cpu")
    out = pipe.enhance_signal(torch.zeros(1000).numpy())
    assert out.shape == (1000,)


def test_dcse_pipeline_default_device_needs_cuda():
    """The DCSE pipeline and the CLI follow the same rule: the card unless
    the caller asks for the CPU."""
    from sincformer_tpu_torch import DCSEPipeline, cli
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DCSEPipeline()
    assert cli.build_parser().parse_args(["info"]).device == "cuda"


@pytest.mark.parametrize("wrapper", ["meddis", "env_act", "conv1d_gn"])
def test_new_wrappers_refuse_other_devices(wrapper):
    """A wrapper takes the plain version only for a CPU tensor: a tensor on
    any other device that is not CUDA raises instead of falling back."""
    from sincformer_tpu_torch import conv1d_gn, env_act, meddis
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        if wrapper == "meddis":
            meddis(torch.zeros(2, 16, device=meta))
        elif wrapper == "env_act":
            env_act(torch.zeros(1, 8, 4, device=meta),
                    torch.ones(4, device=meta))
        else:
            conv1d_gn(torch.zeros(1, 8, 4, device=meta),
                      torch.zeros(3, 4, 4, device=meta),
                      *(torch.zeros(4, device=meta) for _ in range(3)), None,
                      1, 2)


def test_chip_smoke_refuses_without_cuda():
    """chip_smoke.py exits non-zero and prints no result line when there is
    no CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_library_name_follows_included_headers(tmp_path, monkeypatch):
    """A kernel's library name hashes its source and the csrc/ headers it
    includes, also through another header; an edit to any of them names a
    new library (so a stale one is never loaded), an edit elsewhere does
    not. Needs no nvcc."""
    from sincformer_tpu_torch.ops import build
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n'
                                   '#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text('#pragma once\nint b;\n')
    (tmp_path / "other.cuh").write_text('int other;\n')
    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    assert sorted(build._sources("k")) == ["a.cuh", "b.cuh", "k.cu"]
    first = build._library_path("k")
    assert os.path.basename(first).startswith("libk-")
    (tmp_path / "other.cuh").write_text('int other2;\n')
    assert build._library_path("k") == first
    (tmp_path / "b.cuh").write_text('#pragma once\nint b2;\n')
    second = build._library_path("k")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint k2;\n')
    assert build._library_path("k") not in (first, second)
    monkeypatch.undo()
    for name in ("speech_attention", "fused_ffn"):
        assert "tf32x3.cuh" in build._sources(name)


def test_chip_smoke_tells_the_ports_kernels_in_a_profile():
    """chip_smoke.py's profiles count as the port's exactly the kernels of
    sincformer_tpu_torch/csrc/, by their names as torch.profiler gives
    them, and no library kernel of another namespace."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    names = chip_smoke.port_kernel_names()
    assert {"speech_attention_kernel", "attention_bf16_wgmma",
            "quantize_tree_kernel", "fused_ffn_kernel",
            "fused_ffn_bf16_kernel", "meddis_kernel", "conv_kernel",
            "conv_bf16_kernel", "stats_kernel", "norm_kernel",
            "envact_kernel_vec4", "envact_kernel_bf16_vec8"} <= set(names)
    port = ["void (anonymous namespace)::bf16form::conv_bf16_kernel<32, 4>("
            "__nv_bfloat16 const*, (anonymous namespace)::bf16form::Geo)",
            "(anonymous namespace)::envact_kernel_vec4(float4 const*, "
            "float4 const*, float4*, float4*, long long, int)",
            "void (anonymous namespace)::stats_kernel<64>(float const*)"]
    other = ["void at::native::vectorized_elementwise_kernel<4, "
             "at::native::(anonymous namespace)::norm_kernel>(int)",
             "void at::native::(anonymous namespace)::conv_kernel(float*)",
             "void (anonymous namespace)::softmax_warp_forward<float>(float*)",
             "Memcpy HtoD (Pageable -> Device)"]
    assert all(chip_smoke.is_port_kernel(k, names) for k in port)
    assert not any(chip_smoke.is_port_kernel(k, names) for k in other)
