"""Full-softmax attention for speech-length sequences (kernel K1).

Counterpart of ``sincformer_tpu/ops/speech_attention.py``. On a CUDA tensor
:func:`speech_attention` launches a hand-written kernel of
``csrc/speech_attention.cu``: for float32 q, k, v its f32 form (one f32
online softmax per batch, head and query row; both products on the tensor
cores in split TF32, which keeps f32-level results), for bfloat16 its bf16
form. On a CPU tensor it runs :func:`_speech_attention_plain`, the plain
PyTorch version that the CPU tests compare with JAX and that
``chip_smoke.py`` compares with the kernel on the card. There is no
fallback from one to the other: a CUDA tensor the kernel does not take
raises.

bfloat16 rounds where the JAX package's ``_reference`` rounds: the scores
S = Q.K^T (bf16 products, exact in f32) and the softmax stay f32, the
normalised P is rounded to V's dtype, P.V accumulates in f32 and the
output is rounded once to q's dtype. The bias stays a float32 (B, T).

Under autograd the call is one :class:`_SpeechAttention` function, as the
JAX package's custom VJP is: the forward is the kernel (the plain version on
a CPU tensor), and the backward recomputes the plain formulation on the
saved q, k, v and bias, in their dtype, and takes its gradient. There is no
backward kernel, in JAX or here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from sincformer_tpu_torch.ops import build

_HEAD_DIMS = (16, 32, 64, 128)
# the kernel's entry point for each dtype it takes
_ENTRY = {torch.float32: "speech_attention_fwd",
          torch.bfloat16: "speech_attention_fwd_bf16"}


def _speech_attention_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor,
                            bias: Optional[torch.Tensor] = None,
                            sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain softmax attention, (B, T, H, dh) in and out: float32 (float64
    for float64 inputs, a reference for rounding studies). bfloat16 inputs
    keep S and the softmax in float32, round P to V's dtype and take P.V
    in float32, rounded once to q's dtype (the JAX ``_reference``'s
    rounding points); ``.to`` is the identity in float32 and float64."""
    scale = sm_scale if sm_scale is not None else 1.0 / float(q.shape[-1]) ** 0.5
    dt = torch.float64 if q.dtype == torch.float64 else torch.float32
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(dt), k.to(dt)) * scale
    if bias is not None:
        s = s + bias[:, None, None, :].to(dt)
    p = torch.softmax(s, dim=-1).to(v.dtype).to(dt)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.to(dt)).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _kernel(dtype: torch.dtype = torch.float32):
    fn = getattr(build.load("speech_attention"), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_args(q, k, v, bias):
    b, t, h, dh = q.shape
    if q.dtype not in _ENTRY:
        raise TypeError(f"speech_attention kernel takes float32 or bfloat16, "
                        f"q is {q.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != q.dtype:
            raise TypeError(f"speech_attention kernel takes q, k and v of one "
                            f"dtype; {name} is {x.dtype}, q {q.dtype}")
        if x.shape != q.shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, q has "
                             f"{tuple(q.shape)}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"speech_attention kernel needs contiguous "
                             f"(B, T, H, dh) tensors; {name} is not")
        if x.data_ptr() % 16:
            raise ValueError(f"speech_attention kernel needs {name} aligned "
                             f"to 16 bytes")
    if dh not in _HEAD_DIMS:
        raise ValueError(f"speech_attention kernel supports dh in "
                         f"{_HEAD_DIMS}, got {dh}")
    if bias is not None:
        if (bias.dtype != torch.float32 or bias.shape != (b, t)
                or bias.device != q.device or not bias.is_contiguous()):
            raise ValueError(f"bias must be a contiguous float32 (B, T) = "
                             f"({b}, {t}) tensor on {q.device}; got "
                             f"{bias.dtype} {tuple(bias.shape)} on "
                             f"{bias.device}")


def _launch(q, k, v, bias, scale):
    """One launch of the kernel on CUDA tensors the caller has checked."""
    b, t, h, dh = q.shape
    out = torch.empty_like(q)
    fn = _kernel(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                 b, t, h, dh, scale, stream)
    if err != 0:
        raise RuntimeError(f"speech_attention kernel launch failed: CUDA "
                           f"error {err}")
    speech_attention.launches += 1
    if q.dtype == torch.bfloat16:
        speech_attention.launches_bf16 += 1
    return out


def _forward(q, k, v, bias, scale):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return _speech_attention_plain(q, k, v, bias, scale)
    if q.device.type != "cuda":
        raise ValueError(f"speech_attention runs on cpu or cuda, not "
                         f"{q.device}")
    _check_cuda_args(q, k, v, bias)
    return _launch(q, k, v, bias, scale)


class _SpeechAttention(torch.autograd.Function):
    """Forward through :func:`_forward`; backward = the gradient of the
    plain formulation, recomputed on the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale = scale
        return _forward(q, k, v, bias, scale)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, bias = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
            out = _speech_attention_plain(*leaves, bias, ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, leaves, grad_out)
        return dq, dk, dv, None, None


def speech_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     sm_scale: Optional[float] = None) -> torch.Tensor:
    """Full-softmax attention tuned for speech-length T.

    Args:
        q, k, v: (B, T, H, dh).
        bias: optional (B, T) f32 key-side additive bias (0 valid, -1e9
            masked), the valid-frame mask in additive form; it takes no
            gradient.
        sm_scale: score scale; default 1/sqrt(dh).

    Returns:
        (B, T, H, dh) attention output.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (counted in ``speech_attention.launches``, forward launches only, and
    those of the bf16 form also in ``speech_attention.launches_bf16``) or
    raises. When q, k or v needs a gradient the call is differentiable:
    the backward is the plain formulation's, in the inputs' dtype.
    """
    scale = sm_scale if sm_scale is not None else 1.0 / float(
        q.shape[-1]) ** 0.5
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        if bias is not None:
            bias = bias.detach()
        return _SpeechAttention.apply(q, k, v, bias, scale)
    return _forward(q, k, v, bias, scale)


speech_attention.launches = 0
speech_attention.launches_bf16 = 0
