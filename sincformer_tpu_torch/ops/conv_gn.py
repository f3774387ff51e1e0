"""Strided SAME Conv1d → GroupNorm [→ + skip] [→ tanh-GELU] (kernel K5).
Counterpart of ``sincformer_tpu/ops/conv_gn_pallas.py``.

The entry point keeps the JAX contract: x (B, T, Cin) channel last, w
(K, Cin, Cout), flax SAME padding (``Tout = ceil(T / stride)``, the smaller
half of the padding on the left), GroupNorm over all rows of a batch row
with eps inside the square root, the skip added after the affine and before
the GELU. On a CUDA tensor :func:`conv1d_gn` launches the hand-written
kernels of ``csrc/conv_gn.cu`` (the convolution is computed there, on the
tensor cores in split TF32, not by a library); on a CPU tensor it runs
:func:`conv_gn_reference`, the plain PyTorch version. There is no fallback
from one to the other. Any kernel size and stride are taken; the TPU
kernel's geometry guards belonged to its DMA window. Like the JAX package,
no model calls this. Differentiable on either device: on the card the
forward is the kernel and the backward the gradient of
:func:`conv_gn_reference`, recomputed (JAX's ``custom_vjp`` backward is
the plain formulation's too); the optional ``skip`` gets a gradient when
it is given.

bfloat16 (every input bf16): the kernel's bf16 form (``conv_gn_fwd_bf16``:
one TF32 product per product, exact for bf16 operands, f32 sums) and the
plain version compute in float32 and round once at the end, as the JAX
package's ``conv_gn_reference`` does. A bf16 launch counts in
``conv1d_gn.launches`` and in ``conv1d_gn.launches_bf16``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from sincformer_tpu_torch.ops import build

_TILE_ROWS = 128         # csrc/conv_gn.cu: kTM
# the kernel's entry point for each dtype it takes
_ENTRY = {torch.float32: "conv_gn_fwd", torch.bfloat16: "conv_gn_fwd_bf16"}


def _same_pads(t: int, k: int, s: int) -> Tuple[int, int, int]:
    """lax/flax SAME padding: (t_out, pad_left, pad_right)."""
    t_out = -(-t // s)
    total = max((t_out - 1) * s + k - t, 0)
    return t_out, total // 2, total - total // 2


def _check_shapes(x, w, b, gamma, beta, skip, stride: int, groups: int):
    if x.ndim != 3 or w.ndim != 3 or w.shape[1] != x.shape[2]:
        raise ValueError(f"conv1d_gn takes x (B, T, Cin) and w (K, Cin, "
                         f"Cout), got {tuple(x.shape)} and {tuple(w.shape)}")
    if stride < 1:
        raise ValueError(f"stride must be at least 1, got {stride}")
    cout = w.shape[2]
    if groups < 1 or cout % groups:
        raise ValueError(f"groups={groups} does not divide Cout={cout}")
    for name, t in (("b", b), ("gamma", gamma), ("beta", beta)):
        if tuple(t.shape) != (cout,):
            raise ValueError(f"{name} must have shape ({cout},), got "
                             f"{tuple(t.shape)}")
    t_out = _same_pads(x.shape[1], w.shape[0], stride)[0]
    if skip is not None and tuple(skip.shape) != (x.shape[0], t_out, cout):
        raise ValueError(f"skip must have shape "
                         f"{(x.shape[0], t_out, cout)}, got "
                         f"{tuple(skip.shape)}")


def conv_gn_reference(x, w, b, gamma, beta, skip=None, *, stride: int,
                      groups: int, eps: float = 1e-6, act: bool = True):
    """Plain PyTorch version: Conv(SAME) → GroupNorm [→ + skip] [→ GELU] in
    float32, the variance as the mean of squares about the mean, rounded
    once to x's dtype."""
    _check_shapes(x, w, b, gamma, beta, skip, stride, groups)
    k = w.shape[0]
    _, pad_l, pad_r = _same_pads(x.shape[1], k, stride)
    xp = F.pad(x.to(torch.float32).transpose(1, 2), (pad_l, pad_r))
    y = F.conv1d(xp, w.to(torch.float32).permute(2, 1, 0), b.float(),
                 stride=stride).transpose(1, 2)             # (B, Tout, Cout)
    bsz, t_out, cout = y.shape
    yg = y.reshape(bsz, t_out, groups, cout // groups)
    mu = yg.mean(dim=(1, 3), keepdim=True)
    var = ((yg - mu) ** 2).mean(dim=(1, 3), keepdim=True)
    yn = ((yg - mu) * torch.rsqrt(var + eps)).reshape(bsz, t_out, cout)
    yn = yn * gamma.float() + beta.float()
    if skip is not None:
        yn = yn + skip.float()
    if act:
        yn = F.gelu(yn, approximate="tanh")
    return yn.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _kernel(dtype: torch.dtype = torch.float32):
    fn = getattr(build.load("conv_gn"), _ENTRY[dtype])
    # the bf16 form takes one more pointer: its f32 convolution scratch
    n_ptr = 9 if dtype == torch.float32 else 10
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _forward(x, w, b, gamma, beta, skip, stride: int, groups: int,
             eps: float, act: bool) -> torch.Tensor:
    """The kernels on CUDA tensors, counted in ``conv1d_gn.launches``."""
    _check_shapes(x, w, b, gamma, beta, skip, stride, groups)
    tensors = [("x", x), ("w", w), ("b", b), ("gamma", gamma), ("beta", beta)]
    if skip is not None:
        tensors.append(("skip", skip))
    if x.dtype not in _ENTRY:
        raise TypeError(f"conv1d_gn kernel takes float32 or bfloat16, x is "
                        f"{x.dtype}")
    for name, t in tensors:
        if t.dtype != x.dtype:
            raise TypeError(f"conv1d_gn kernel takes inputs of one dtype; "
                            f"{name} is {t.dtype}, x {x.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"conv1d_gn kernel needs contiguous tensors; "
                             f"{name} is not")
    bsz, t, cin = x.shape
    k, _, cout = w.shape
    if x.numel() == 0 or bsz > 65535:
        raise ValueError(f"conv1d_gn kernel takes 1 to 65535 batch rows of "
                         f"at least one sample, got x {tuple(x.shape)}")
    t_out, pad_l, _ = _same_pads(t, k, stride)
    if max(t * stride + k, cin, cout) >= 1 << 31:
        raise ValueError("conv1d_gn kernel takes sizes below 2^31")
    n_tiles = -(-t_out // _TILE_ROWS)
    out = torch.empty((bsz, t_out, cout), dtype=x.dtype, device=x.device)
    partial = torch.empty((bsz, n_tiles, cout, 2), dtype=torch.float32,
                          device=x.device)
    stats = torch.empty((bsz, groups, 2), dtype=torch.float32,
                        device=x.device)
    scratch = []          # bf16: the f32 convolution before the norm
    if x.dtype == torch.bfloat16:
        scratch = [torch.empty((bsz, t_out, cout), dtype=torch.float32,
                               device=x.device)]
    fn = _kernel(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), gamma.data_ptr(),
                 beta.data_ptr(), skip.data_ptr() if skip is not None else None,
                 out.data_ptr(), *(c.data_ptr() for c in scratch),
                 partial.data_ptr(),
                 stats.data_ptr(), bsz, t, cin, cout, k, stride, pad_l, t_out,
                 groups, float(eps), int(bool(act)), stream)
    if err != 0:
        raise RuntimeError(f"conv1d_gn kernel launch failed: CUDA error "
                           f"{err}")
    conv1d_gn.launches += 1
    if x.dtype == torch.bfloat16:
        conv1d_gn.launches_bf16 += 1
    return out


class _ConvGN(torch.autograd.Function):
    """Forward through :func:`_forward`; backward = the gradient of
    :func:`conv_gn_reference`, recomputed on the saved inputs (``skip``'s
    only when it was given)."""

    @staticmethod
    def forward(ctx, x, w, b, gamma, beta, skip, stride, groups, eps, act):
        ctx.conf = dict(stride=stride, groups=groups, eps=eps, act=act)
        ctx.has_skip = skip is not None
        ctx.save_for_backward(x, w, b, gamma, beta,
                              *((skip,) if ctx.has_skip else ()))
        return _forward(x, w, b, gamma, beta, skip, stride, groups, eps, act)

    @staticmethod
    def backward(ctx, grad_out):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True)
                      for t in ctx.saved_tensors]
            skip = leaves[5] if ctx.has_skip else None
            out = conv_gn_reference(*leaves[:5], skip, **ctx.conf)
            grads = torch.autograd.grad(out, leaves, grad_out)
        return (*grads[:5], grads[5] if ctx.has_skip else None,
                None, None, None, None)


def conv1d_gn(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              gamma: torch.Tensor, beta: torch.Tensor,
              skip: Optional[torch.Tensor], stride: int, groups: int,
              eps: float = 1e-6, act: bool = True) -> torch.Tensor:
    """Fused Conv1d(SAME, stride) → GroupNorm(groups) [→ + skip] [→ GELU].

    Args:
        x: (B, T, Cin). w: (K, Cin, Cout). b, gamma, beta: (Cout,).
        skip: optional (B, Tout, Cout), added after the GroupNorm's affine
            and before the activation.
        act: apply the tanh-GELU at the end.

    Returns (B, Tout, Cout), Tout = ceil(T / stride). A CPU tensor takes the
    plain version; a CUDA tensor launches the kernels (counted once per call
    in ``conv1d_gn.launches``, forward launches only, and those of the bf16
    form also in ``conv1d_gn.launches_bf16``) or raises. When an
    input needs a gradient the call is differentiable: the backward is the
    plain version's.
    """
    if x.device.type == "cpu":
        return conv_gn_reference(x, w, b, gamma, beta, skip, stride=stride,
                                 groups=groups, eps=eps, act=act)
    if x.device.type != "cuda":
        raise ValueError(f"conv1d_gn runs on cpu or cuda, not {x.device}")
    args = (x, w, b, gamma, beta, skip)
    if torch.is_grad_enabled() and any(
            a is not None and a.requires_grad for a in args):
        return _ConvGN.apply(*args, stride, groups, eps, act)
    return _forward(*args, stride, groups, eps, act)


conv1d_gn.launches = 0
conv1d_gn.launches_bf16 = 0
