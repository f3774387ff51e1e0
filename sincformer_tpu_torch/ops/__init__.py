"""Hand-written kernels for Hopper (``csrc/``, each beside its plain
version), the attention dispatch with its context-parallel ops, and
flax's elementwise functions and norms with the JAX package's bf16
rounding (``flax_math``). The JAX package's ``meddis_pallas`` is
:func:`meddis` here."""

from sincformer_tpu_torch.ops.attention import (  # noqa: F401
    dot_product_attention, ring_mesh)
from sincformer_tpu_torch.ops.conv_gn import conv1d_gn  # noqa: F401
from sincformer_tpu_torch.ops.fused_ffn import fused_ffn  # noqa: F401
from sincformer_tpu_torch.ops.meddis import meddis  # noqa: F401
from sincformer_tpu_torch.ops.quantize import (  # noqa: F401
    dequantize_int8, dequantize_tree, quantize_int8, quantize_tree)
from sincformer_tpu_torch.ops.ring_attention import (  # noqa: F401
    ring_attention, ring_attention_in_mesh)
from sincformer_tpu_torch.ops.speech_attention import \
    speech_attention  # noqa: F401
