"""The port's ``parallel/`` package and the split metric sweep, on the CPU:
the grid's partition and merge against the JAX package's at 1, 2 and 3
processes, ``shard_batch``'s rows and its raise, the mesh's refusal to
shrink, a gloo group of one rank bit-equal to no mesh, and
``evaluate_grid`` with its metric sweep split over devices. The
multi-process tests are in tests/test_torch_data_parallel.py."""

import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tests import _torch_dp_worker as worker
from tests._torch_parity import NARROW, NARROW_DCSE, wave

NOISES = ["white", "babble", "factory", "pink"]
SNRS = [-5.0, 0.0, 5.0, 10.0]
SWEEP_TOL = 1e-7


@pytest.mark.parametrize("nproc", [1, 2, 3])
def test_partition_and_merge_match_jax(nproc):
    """The 4-noise × 4-SNR grid dealt to 1, 2 and 3 processes (3: the
    uneven 6/5/5 deal) gives JAX's cells in JAX's order, and the parts
    merge as JAX merges them."""
    from sincformer_tpu.parallel import distributed as jd
    from sincformer_tpu_torch.parallel import distributed as pd
    parts_p = []
    for pid in range(nproc):
        got = pd.partition_grid_cells(NOISES, SNRS, pid, nproc)
        assert got == jd.partition_grid_cells(NOISES, SNRS, pid, nproc)
        part = {}
        for n, s in got:
            part.setdefault(n, {}).setdefault("noisy", {})[s] = {
                "stoi": [float(pid), s], "pesq": [len(n) * s]}
        parts_p.append(part)
    assert sorted(len(pd.partition_grid_cells(NOISES, SNRS, p, nproc))
                  for p in range(nproc)) == sorted(
        len(range(p, 16, nproc)) for p in range(nproc))
    merged = pd.merge_grid_results(parts_p)
    want = jd.merge_grid_results(parts_p)
    assert merged == want
    assert sum(len(c) for m in merged.values() for c in m["noisy"].values()) \
        == 32


def test_shard_batch_rows_and_raise():
    """Each rank takes its contiguous block in rank order; a batch that
    does not divide raises; without a mesh the batch is returned whole."""
    from sincformer_tpu_torch.parallel import mesh as pm

    class Mesh:
        mesh_dim_names = ("data",)

        def __init__(self, rank, n):
            self.rank, self.n = rank, n

        def size(self, dim):
            return self.n

        def get_local_rank(self, axis):
            return self.rank

    batch = {"noisy": np.arange(24).reshape(6, 4),
             "lengths": torch.arange(6)}
    assert pm.shard_batch(None, batch) is batch
    for n in (1, 2, 3, 6):
        blocks = [pm.shard_batch(Mesh(r, n), batch) for r in range(n)]
        assert np.array_equal(np.concatenate([b["noisy"] for b in blocks]),
                              batch["noisy"])
        assert torch.equal(torch.cat([b["lengths"] for b in blocks]),
                           batch["lengths"])
        assert all(len(b["noisy"]) == 6 // n for b in blocks)
    with pytest.raises(ValueError, match="divide"):
        pm.shard_batch(Mesh(0, 4), batch)


def test_mesh_never_shrinks_and_collectives_are_local():
    """Without a process group the mesh raises (for two devices: that it
    has one); outside a data-parallel block the reductions are the local
    operations bit for bit."""
    from sincformer_tpu_torch.parallel import collectives, make_mesh
    from sincformer_tpu_torch.parallel.distributed import (
        global_batch_from_local, init_distributed, is_primary,
        make_global_mesh)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        make_mesh(2)
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh()
    assert make_global_mesh() is None and is_primary()
    assert init_distributed(world_size=1) is False
    x = torch.from_numpy(wave(3, (3, 5, 4)))
    with collectives.data_parallel(None):
        assert torch.equal(collectives.mean(x, dim=(0, 1)),
                           x.mean(dim=(0, 1)))
        assert torch.equal(collectives.var(x), x.var(unbiased=False))
        assert torch.equal(collectives.norm(x), torch.linalg.vector_norm(x))
        assert collectives.sum(x) is x
    got = global_batch_from_local({"x": x.numpy()})
    assert torch.equal(got["x"], x)


@pytest.fixture
def group_of_one():
    """A gloo group of one rank in this process, and its mesh; two CPU
    threads meanwhile, as each rank of the multi-process tests takes (on a
    shared host the default thread count made one narrow step take 0.4 to
    22 s)."""
    from sincformer_tpu_torch.parallel import make_mesh
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{worker.free_port()}",
        world_size=1, rank=0)
    try:
        yield make_mesh()
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(threads)


def test_one_rank_is_bit_equal_to_no_mesh(group_of_one, tmp_path):
    """A trainer on a one-rank mesh takes the step of a trainer without a
    mesh bit for bit: the narrow flagship's adversarial step and DCSE's
    "batch" step from seeded weights (loss, gradients, parameters,
    buffers, the discriminator)."""
    from sincformer_tpu_torch.parallel import make_mesh
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        make_mesh(2)
    job = {"config": NARROW, "noisy": wave(5, (2, 4000)),
           "clean": (wave(6, (2, 4000)) * 0.5).astype(np.float32),
           "model_dir": str(tmp_path)}
    a = worker._flagship_step(job, group_of_one)
    b = worker._flagship_step(job, None)
    job["config"] = {"d_model": NARROW_DCSE["d_model"],
                     "num_blocks": NARROW_DCSE["num_blocks"],
                     "num_heads": NARROW_DCSE["num_heads"],
                     "ff_dim": NARROW_DCSE["d_ff"],
                     "kernel_size": NARROW_DCSE["kernel_size"]}
    c = worker._dcse_step(job, "batch", group_of_one)
    d = worker._dcse_step(job, "batch", None)
    for got, want in ((a, b), (c, d)):
        assert set(got) == set(want)
        for key, value in want.items():
            if isinstance(value, dict):
                bad = [k for k in value
                       if not torch.equal(got[key][k], value[k])]
                assert not bad, (key, bad)
            else:
                assert got[key] == value, key


def _grid_inputs(n):
    from sincformer_tpu_torch.data.loader import load_noise_signals
    from sincformer_tpu_torch.evaluation.grid import eval_utterances
    return eval_utterances(n), load_noise_signals(8000,
                                                  synth_fallback="white")


@functools.lru_cache(maxsize=None)
def _sweep_grid(devices: int):
    """The 3-utterance grid at 0 dB with the device metrics (P.862 runs on
    host threads row by row whatever the split), the sweep over
    ``devices`` CPU devices (0: unsharded)."""
    from sincformer_tpu_torch.evaluation.grid import evaluate_grid
    cleans, noises = _grid_inputs(3)
    return evaluate_grid(cleans, noises, {"identity": worker.Identity()},
                         [0.0], ("stoi", "ssnr", "csii", "ncm"),
                         device="cpu", verbose=False,
                         mesh=[torch.device("cpu")] * devices or None)


def test_split_sweep_runs_the_host_metrics_once_over_the_real_rows():
    """Split over two devices, a 3-row sweep scores P.862 once per real
    row (no padded row, no call per block) and gives the unsharded
    sweep's values."""
    from unittest import mock

    from sincformer_tpu_torch.evaluation import batched
    cleans, _ = _grid_inputs(3)
    n = min(len(c) for c in cleans)
    clean = np.stack([c[:n] for c in cleans])
    noisy = (clean + 0.05 * np.random.default_rng(3).standard_normal(
        clean.shape)).astype(np.float32)
    calls = []
    pesq = batched.compute_pesq

    def counted(c, e, *args):
        calls.append(len(c))
        return pesq(c, e, *args)
    with mock.patch.object(batched, "compute_pesq", counted):
        got = batched.metrics_batch(clean, noisy, ("pesq", "ssnr"),
                                    device=[torch.device("cpu")] * 2)
    assert calls == [n] * 3
    want = batched.metrics_batch(clean, noisy, ("pesq", "ssnr"),
                                 device="cpu")
    assert got["pesq"].shape == got["ssnr"].shape == (3,)
    np.testing.assert_array_equal(got["pesq"], want["pesq"])
    assert np.max(np.abs(got["ssnr"] - want["ssnr"])) <= SWEEP_TOL


@pytest.mark.parametrize("devices", [2, 8])
def test_sweep_split_over_devices_equals_unsharded(devices):
    """A 3-utterance bucket over 2 and over 8 devices (cyclic padding past
    the bucket's size) gives the unsharded grid, and no padded row reaches
    the results. Values within SWEEP_TOL: a sweep of one row rounds NCM's
    float32 once otherwise (1.5e-8 measured at 8 devices; 2 devices give
    every value bit for bit)."""
    want, got = _sweep_grid(0), _sweep_grid(devices)
    for method, cells in want["white"].items():
        for k, vals in cells[0.0].items():
            assert len(got["white"][method][0.0][k]) == len(vals) == 3
            assert np.max(np.abs(np.subtract(got["white"][method][0.0][k],
                                             vals))) <= SWEEP_TOL, (method, k)
