"""Fused LayerNorm -> Dense(d_ff) -> Swish -> Dense(d) -> half residual
(kernel K3). Counterpart of ``sincformer_tpu/ops/fused_ffn.py``.

    y = x + 0.5 * (swish(LN(x) . W1 + b1) . W2 + b2)

LayerNorm has eps 1e-6 and f32 statistics, the variance being the mean of
squares of ``x - mean``. On a CUDA tensor :func:`fused_ffn` launches a
hand-written kernel of ``csrc/fused_ffn.cu``, which reads each row once,
writes it once, keeps the normalised rows and the d_ff-wide intermediate on
chip and streams the weights through shared memory with asynchronous copies:
for float32 inputs its f32 form (both products on the tensor cores in split
TF32, f32-level results), for bfloat16 its bf16 form (weights copied by
TMA, wgmma products, the intermediate in registers). On a CPU tensor it
runs :func:`_fused_ffn_plain`. There is no fallback from one to the other:
a CUDA tensor the kernel does not take raises.

bfloat16 rounds where the JAX package's ``_ffn_reference`` rounds: the
LayerNorm is f32, xn is rounded to W1's dtype, xn.W1 accumulates in f32
(bf16 products are exact in f32) and adds b1, the swish is f32, h is
rounded to W2's dtype, h.W2 accumulates in f32 and adds b2, and
x + 0.5 y is taken in f32 and rounded once to x's dtype.

Under autograd the call is one :class:`_FusedFFN` function, as in the JAX
package: the forward is the kernel (the plain version on a CPU tensor), the
backward recomputes the plain formula on the saved inputs, in their dtype,
and takes its gradient (there is no backward kernel).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sincformer_tpu_torch.ops import build

LN_EPS = 1e-6
_WIDTHS = (32, 64, 128, 256)
# the kernel's entry point for each dtype it takes
_ENTRY = {torch.float32: "fused_ffn_fwd", torch.bfloat16: "fused_ffn_fwd_bf16"}


def _widened(t: torch.Tensor) -> torch.Tensor:
    """A bfloat16 tensor in float32 (exact); any other as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t


def _fused_ffn_plain(x, ln_g, ln_b, w1, b1, w2, b2):
    """Plain PyTorch version of the same formula, any leading shape. With
    bfloat16 weights xn and h are rounded to them before each product,
    which is taken in float32; in float32 the casts are the identity."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    xn = (xf - mu) * torch.rsqrt(var + LN_EPS) * ln_g + ln_b
    h = _widened(xn.to(w1.dtype)) @ _widened(w1) + b1
    h = h * torch.sigmoid(h)
    y = _widened(h.to(w2.dtype)) @ _widened(w2) + b2
    return (xf + 0.5 * y).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _kernel(dtype: torch.dtype = torch.float32):
    fn = getattr(build.load("fused_ffn"), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_args(x, ln_g, ln_b, w1, b1, w2, b2):
    d = x.shape[-1]
    if w1.ndim != 2 or w1.shape[0] != d:
        raise ValueError(f"w1 must be (d, d_ff) = ({d}, d_ff), got "
                         f"{tuple(w1.shape)}")
    d_ff = w1.shape[1]
    shapes = {"ln_g": (d,), "ln_b": (d,), "w1": (d, d_ff), "b1": (d_ff,),
              "w2": (d_ff, d), "b2": (d,)}
    tensors = {"ln_g": ln_g, "ln_b": ln_b, "w1": w1, "b1": b1, "w2": w2,
               "b2": b2}
    if x.dtype not in _ENTRY:
        raise TypeError(f"fused_ffn kernel takes float32 or bfloat16, x is "
                        f"{x.dtype}")
    for name, t in (("x", x), *tensors.items()):
        if t.dtype != x.dtype:
            raise TypeError(f"fused_ffn kernel takes tensors of one dtype; "
                            f"{name} is {t.dtype}, x {x.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_ffn kernel needs contiguous tensors; "
                             f"{name} is not")
        if name != "x" and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shapes[name]}")
    if d not in _WIDTHS:
        raise ValueError(f"fused_ffn kernel supports d in {_WIDTHS}, got {d}")
    if d_ff % 32:
        raise ValueError(f"fused_ffn kernel needs d_ff to be a multiple of "
                         f"32, got {d_ff}")
    # byte alignment: the f32 form copies w1, w2 and b1 in 16-byte pieces
    # and reads x and b2 as float2 pairs; the bf16 form reads x in 16-byte
    # pieces, b1 and b2 as bf16 pairs, and w1 and w2 by TMA, which needs
    # 16-byte aligned bases and row strides (the rows, d_ff and d bf16, are
    # multiples of 16 bytes for every d and d_ff taken above)
    if x.dtype == torch.float32:
        aligns = (("w1", w1, 16), ("w2", w2, 16), ("b1", b1, 16),
                  ("x", x, 8), ("b2", b2, 8))
    else:
        aligns = (("w1", w1, 16), ("w2", w2, 16), ("x", x, 16),
                  ("b1", b1, 4), ("b2", b2, 4))
    for name, t, align in aligns:
        if t.data_ptr() % align:
            raise ValueError(f"fused_ffn kernel needs {name} aligned to "
                             f"{align} bytes")


def _forward(x, ln_g, ln_b, w1, b1, w2, b2):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return _fused_ffn_plain(x, ln_g, ln_b, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ffn runs on cpu or cuda, not {x.device}")
    _check_cuda_args(x, ln_g, ln_b, w1, b1, w2, b2)
    d, d_ff = w1.shape
    rows = x.numel() // d
    if rows == 0:
        raise ValueError("fused_ffn kernel needs at least one row")
    out = torch.empty_like(x)
    fn = _kernel(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), ln_g.data_ptr(), ln_b.data_ptr(),
                 w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                 out.data_ptr(), rows, d, d_ff, stream)
    if err != 0:
        raise RuntimeError(f"fused_ffn kernel launch failed: CUDA error {err}")
    fused_ffn.launches += 1
    if x.dtype == torch.bfloat16:
        fused_ffn.launches_bf16 += 1
    return out


class _FusedFFN(torch.autograd.Function):
    """Forward through :func:`_forward`; backward = the gradient of the
    plain formula, recomputed on the saved inputs."""

    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return _forward(*args)

    @staticmethod
    def backward(ctx, grad_out):
        args = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [a.detach().requires_grad_(True) for a in args]
            out = _fused_ffn_plain(*leaves)
            return torch.autograd.grad(out, leaves, grad_out)


def fused_ffn(x: torch.Tensor, ln_g: torch.Tensor, ln_b: torch.Tensor,
              w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor) -> torch.Tensor:
    """y = x + 0.5 * (swish(LN(x) . W1 + b1) . W2 + b2).

    Args:
        x: (..., d) activations.
        ln_g, ln_b: LayerNorm scale and bias (d,).
        w1: (d, d_ff); b1: (d_ff,); w2: (d_ff, d); b2: (d,), the JAX
            package's (in, out) layout.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (counted in ``fused_ffn.launches``, forward launches only, and those of
    the bf16 form also in ``fused_ffn.launches_bf16``) or raises. When an
    input needs a gradient the call is differentiable: the backward is the
    plain formula's, in the inputs' dtype.
    """
    args = (x, ln_g, ln_b, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return _FusedFFN.apply(*args)
    return _forward(*args)


fused_ffn.launches = 0
fused_ffn.launches_bf16 = 0
