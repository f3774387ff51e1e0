"""Fine activation and pooled log envelope of the sinc filterbank output in
one pass (kernel K6). Counterpart of ``sincformer_tpu/ops/envact_pallas.py``.

    y   = gelu_tanh(x * scale)                         (B, N, C)
    env = log1p(mean over 8 consecutive rows of |x|)   (B, N/8, C)

On a CUDA tensor :func:`env_act` launches the hand-written kernel
``csrc/envact.cu``, which reads x once and writes both outputs; on a CPU
tensor it runs :func:`env_act_reference`, the plain PyTorch version. There
is no fallback from one to the other. N must be a multiple of 8 (the plain
version's reshape has the same limit); the TPU kernel's block tiling and its
"no tiling" branch have no counterpart here. Like the JAX package, no model
calls this: it is reached through :func:`env_act` and :func:`env_act_auto`.
Differentiable on either device, as JAX's: on the card the forward is the
kernel and the backward the gradient of :func:`env_act_reference`,
recomputed.

bfloat16 (x and scale both bf16): the kernel's bf16 form
(``envact_fwd_bf16``) and the plain version round where the JAX package's
``env_act_reference`` rounds in bf16: x · scale and every operation of the
GELU's expansion (``ops.flax_math.gelu``) to bf16 (the kernel on pairs of
channels, packed bf16x2 products and sums, each rounded once as the plain
version's f32 operation and rounding are); the envelope's mean and log1p in
float32 from the widened input, rounded once. A bf16 launch
counts in ``env_act.launches`` and in ``env_act.launches_bf16``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from sincformer_tpu_torch.ops import build
from sincformer_tpu_torch.ops.flax_math import gelu

POOL = 8
# the kernel's entry point for each dtype it takes
_ENTRY = {torch.float32: "envact_fwd", torch.bfloat16: "envact_fwd_bf16"}


def _check_shapes(x: torch.Tensor, scale: torch.Tensor) -> None:
    if x.ndim != 3:
        raise ValueError(f"env_act takes x of shape (B, N, C), got "
                         f"{tuple(x.shape)}")
    if x.shape[1] % POOL:
        raise ValueError(f"env_act needs N to be a multiple of {POOL}, got "
                         f"N={x.shape[1]}")
    if tuple(scale.shape) != (x.shape[2],):
        raise ValueError(f"scale must have shape ({x.shape[2]},), got "
                         f"{tuple(scale.shape)}")


def env_act_reference(x: torch.Tensor, scale: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (B, N, C), (C,) → (y (B, N, C),
    env (B, N/8, C)), in x's dtype (bf16 rounding as the module says)."""
    _check_shapes(x, scale)
    b, n, c = x.shape
    y = gelu(x * scale)
    env = x.abs().reshape(b, n // POOL, POOL, c).to(torch.float32).mean(dim=2)
    return y, torch.log1p(env).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _kernel(dtype: torch.dtype = torch.float32):
    fn = getattr(build.load("envact"), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _forward(x: torch.Tensor, scale: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on CUDA tensors, counted in ``env_act.launches``."""
    _check_shapes(x, scale)
    if x.dtype not in _ENTRY:
        raise TypeError(f"env_act kernel takes float32 or bfloat16, x is "
                        f"{x.dtype}")
    for name, t in (("x", x), ("scale", scale)):
        if t.dtype != x.dtype:
            raise TypeError(f"env_act kernel takes x and scale of one dtype; "
                            f"{name} is {t.dtype}, x {x.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"env_act kernel needs contiguous tensors; "
                             f"{name} is not")
    b, n, c = x.shape
    if x.numel() == 0:
        raise ValueError("env_act kernel needs a non-empty input")
    y = torch.empty_like(x)
    env = torch.empty((b, n // POOL, c), dtype=x.dtype, device=x.device)
    fn = _kernel(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), scale.data_ptr(), y.data_ptr(),
                 env.data_ptr(), b * n, c, stream)
    if err != 0:
        raise RuntimeError(f"env_act kernel launch failed: CUDA error {err}")
    env_act.launches += 1
    if x.dtype == torch.bfloat16:
        env_act.launches_bf16 += 1
    return y, env


class _EnvAct(torch.autograd.Function):
    """Forward through :func:`_forward`; backward = the gradient of
    :func:`env_act_reference`, recomputed on the saved inputs."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.save_for_backward(x, scale)
        return _forward(x, scale)

    @staticmethod
    def backward(ctx, grad_y, grad_env):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True)
                      for t in ctx.saved_tensors]
            outs = env_act_reference(*leaves)
            return torch.autograd.grad(outs, leaves, (grad_y, grad_env))


def env_act(x: torch.Tensor, scale: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N, C) sinc output, (C,) scale → (gelu(x*scale),
    log1p(pool8(|x|))).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (counted in ``env_act.launches``, forward launches only, and those of
    the bf16 form also in ``env_act.launches_bf16``) or raises.
    When an input needs a gradient the call is differentiable: the backward
    is the plain version's.
    """
    if x.device.type == "cpu":
        return env_act_reference(x, scale)
    if x.device.type != "cuda":
        raise ValueError(f"env_act runs on cpu or cuda, not {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _EnvAct.apply(x, scale)
    return _forward(x, scale)


env_act.launches = 0
env_act.launches_bf16 = 0


def env_act_auto(x: torch.Tensor, scale: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor
    (the JAX package's TPU / elsewhere dispatch)."""
    return env_act(x, scale)
