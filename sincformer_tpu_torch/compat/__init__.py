"""Checkpoints of the PyTorch reference in and out (``torch_import``,
``torch_export``), and the JAX package's trees into the port
(``from_jax``)."""

from sincformer_tpu_torch.compat.torch_import import (  # noqa: F401
    import_dnn_state_dict, import_dcse_state_dict,
    load_reference_checkpoint)
from sincformer_tpu_torch.compat.torch_export import (  # noqa: F401
    export_dcse_state_dict, save_reference_checkpoint)
