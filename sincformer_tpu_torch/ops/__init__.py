"""Hand-written kernels for Hopper (``csrc/``, each beside its plain
version) and the attention dispatch with its context-parallel ops."""

from sincformer_tpu_torch.ops.attention import (  # noqa: F401
    dot_product_attention, ring_mesh)
from sincformer_tpu_torch.ops.ring_attention import (  # noqa: F401
    ring_attention, ring_attention_in_mesh)
from sincformer_tpu_torch.ops.speech_attention import \
    speech_attention  # noqa: F401
