"""PyTorch and CUDA port of sincformer_tpu on an NVIDIA H100: flagship
Sincformer-metacog, DCSE and original-paper DNN-mask enhancement, flagship
curriculum training (with its adversarial branch), DCSE training, the mask
DNN's training (oracle masks, particle swarm, RBM pretraining), reference
PyTorch checkpoints in and out (``compat``), output-gain calibration,
five-metric evaluation (``evaluation``), the gammatone /
Meddis auditory front-end, long-form, online and int8-export serving, with
the TPU kernels rewritten by hand in CUDA C++ (csrc/: speech attention,
int8 stochastic rounding, fused feed-forward, Meddis hair cell, conv +
GroupNorm, envelope / activation).

Imports torch, numpy and the standard library only; nothing of JAX.
"""

from sincformer_tpu_torch import config
from sincformer_tpu_torch.agents.metacog import SincformerMetacog
from sincformer_tpu_torch.compat.from_jax import (
    convert_quantized_dnn_from_jax, convert_quantized_from_jax,
    load_dcse_from_jax, load_dcse_train_state_from_jax, load_dnn_from_jax,
    load_from_jax, load_train_state_from_jax)
from sincformer_tpu_torch.config import (AudioConfig, DCSEConfig, DNNConfig,
                                         FeatureConfig, GammatoneConfig,
                                         MetacogConfig)
from sincformer_tpu_torch.dsp.features import FeatureExtractor
from sincformer_tpu_torch.dsp.gammatone import GammatoneFilterbank
from sincformer_tpu_torch.dsp.haircell import MeddisHairCell
from sincformer_tpu_torch.models.dcse import SpeechEnhancer
from sincformer_tpu_torch.models.dnn import SpeechEnhancementDNN, create_dnn
from sincformer_tpu_torch.ops.conv_gn import conv1d_gn
from sincformer_tpu_torch.ops.envact import env_act, env_act_auto
from sincformer_tpu_torch.ops.fused_ffn import fused_ffn
from sincformer_tpu_torch.ops.meddis import meddis
from sincformer_tpu_torch.ops.quantize import (dequantize_int8,
                                               dequantize_tree, quantize_int8,
                                               quantize_tree)
from sincformer_tpu_torch.ops.speech_attention import speech_attention
from sincformer_tpu_torch.pipeline import (DCSEPipeline, DNNPipeline,
                                           SincformerPipeline)
from sincformer_tpu_torch.serve import (OnlineEnhancer, OnlineEnhancerPool,
                                        StreamingEnhancer, enhance_long)
from sincformer_tpu_torch.train.state import resolve_output_gain

__all__ = ["AudioConfig", "config", "DCSEConfig", "DCSEPipeline", "DNNConfig",
           "DNNPipeline", "FeatureConfig", "FeatureExtractor",
           "GammatoneConfig", "GammatoneFilterbank", "MeddisHairCell",
           "MetacogConfig", "OnlineEnhancer", "OnlineEnhancerPool",
           "SincformerMetacog", "SincformerPipeline", "SpeechEnhancementDNN",
           "SpeechEnhancer", "StreamingEnhancer", "conv1d_gn",
           "convert_quantized_dnn_from_jax", "convert_quantized_from_jax",
           "create_dnn", "dequantize_int8", "dequantize_tree", "enhance_long",
           "env_act", "env_act_auto", "fused_ffn", "load_dcse_from_jax",
           "load_dcse_train_state_from_jax",
           "load_dnn_from_jax", "load_from_jax", "load_train_state_from_jax",
           "meddis", "quantize_int8",
           "quantize_tree", "resolve_output_gain", "speech_attention"]
