"""PyTorch and CUDA port of sincformer_tpu on an NVIDIA H100: flagship
Sincformer-metacog and DCSE enhancement, long-form, online and int8-export
serving, with the TPU kernels rewritten by hand in CUDA C++ (csrc/: speech
attention, int8 stochastic rounding, fused feed-forward).

Imports torch, numpy and the standard library only; nothing of JAX.
"""

from sincformer_tpu_torch.agents.metacog import SincformerMetacog
from sincformer_tpu_torch.compat.from_jax import (convert_quantized_from_jax,
                                                  load_dcse_from_jax,
                                                  load_from_jax)
from sincformer_tpu_torch.config import AudioConfig, DCSEConfig, MetacogConfig
from sincformer_tpu_torch.models.dcse import SpeechEnhancer
from sincformer_tpu_torch.ops.fused_ffn import fused_ffn
from sincformer_tpu_torch.ops.quantize import (dequantize_int8,
                                               dequantize_tree, quantize_int8,
                                               quantize_tree)
from sincformer_tpu_torch.ops.speech_attention import speech_attention
from sincformer_tpu_torch.pipeline import DCSEPipeline, SincformerPipeline
from sincformer_tpu_torch.serve import (OnlineEnhancer, OnlineEnhancerPool,
                                        StreamingEnhancer, enhance_long)
from sincformer_tpu_torch.train.state import resolve_output_gain

__all__ = ["AudioConfig", "DCSEConfig", "DCSEPipeline", "MetacogConfig",
           "OnlineEnhancer", "OnlineEnhancerPool", "SincformerMetacog",
           "SincformerPipeline", "SpeechEnhancer", "StreamingEnhancer",
           "convert_quantized_from_jax", "dequantize_int8", "dequantize_tree",
           "enhance_long", "fused_ffn", "load_dcse_from_jax", "load_from_jax",
           "quantize_int8", "quantize_tree", "resolve_output_gain",
           "speech_attention"]
