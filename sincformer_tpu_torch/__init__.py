"""PyTorch and CUDA port of sincformer_tpu: flagship Sincformer-metacog
enhancement on an NVIDIA H100, with the speech-attention kernel written by
hand in CUDA C++ (csrc/speech_attention.cu).

Imports torch, numpy and the standard library only; nothing of JAX.
"""

from sincformer_tpu_torch.agents.metacog import SincformerMetacog
from sincformer_tpu_torch.compat.from_jax import load_from_jax
from sincformer_tpu_torch.config import AudioConfig, MetacogConfig
from sincformer_tpu_torch.ops.speech_attention import speech_attention
from sincformer_tpu_torch.pipeline import (SincformerPipeline,
                                           read_output_gain)

__all__ = ["AudioConfig", "MetacogConfig", "SincformerMetacog",
           "SincformerPipeline", "load_from_jax", "read_output_gain",
           "speech_attention"]
