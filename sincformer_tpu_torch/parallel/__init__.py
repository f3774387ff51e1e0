"""Multi-device training and evaluation (``sincformer_tpu/parallel/``):
process groups, meshes, the batch split and the batch-wide reductions of a
data-parallel step (``collectives.py``), the tensor-parallel parameter
split (``sharding.py``) and the multi-device dry run (``dryrun.py``).

The JAX package shards a jitted step over a ``jax.sharding.Mesh`` and lets
XLA place the collectives; here every rank runs the step on its block of
the batch and its slices of the split parameters, and the collectives are
written out (``collectives.py``). A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the JAX axis names
(``"data"``, ``"model"``), or None for one process. Context parallelism
(ring attention and the halo-exchange conv) is in ``ops/`` and runs under
``ops.ring_mesh``.
"""

from sincformer_tpu_torch.parallel.distributed import (  # noqa: F401
    global_batch_from_local, init_distributed, is_primary, make_global_mesh,
    merge_grid_results, partition_grid_cells)
from sincformer_tpu_torch.parallel.mesh import (  # noqa: F401
    data_rank, data_size, make_mesh, model_rank, shard_batch)
from sincformer_tpu_torch.parallel.sharding import (  # noqa: F401
    has_model_axis, shard_params, shard_state_params, tp_param_shardings,
    tp_spec)
