"""Strided SAME Conv1d → GroupNorm [→ + skip] [→ tanh-GELU] (kernel K5).
Counterpart of ``sincformer_tpu/ops/conv_gn_pallas.py``.

The entry point keeps the JAX contract: x (B, T, Cin) channel last, w
(K, Cin, Cout), flax SAME padding (``Tout = ceil(T / stride)``, the smaller
half of the padding on the left), GroupNorm over all rows of a batch row
with eps inside the square root, the skip added after the affine and before
the GELU. On a CUDA tensor :func:`conv1d_gn` launches the hand-written
kernels of ``csrc/conv_gn.cu`` (the convolution is computed there, on the
tensor cores, not by a library); on a CPU tensor it runs
:func:`conv_gn_reference`, the plain PyTorch version. There is no fallback
from one to the other. Any kernel size and stride are taken; the TPU
kernel's geometry guards belonged to its DMA window. Like the JAX package,
no model calls this. Differentiable on either device: on the card the
forward is the kernel and the backward the gradient of
:func:`conv_gn_reference`, recomputed (JAX's ``custom_vjp`` backward is
the plain formulation's too); the optional ``skip`` gets a gradient when
it is given.

float32: split TF32 on the tensor cores (``conv_gn_fwd``). bfloat16 (every
input bf16): the kernel's bf16 form (``conv_gn_fwd_bf16``: ``wgmma`` bf16
products with f32 sums) and the plain version compute in float32 and round
once at the end, as the JAX package's ``conv_gn_reference`` does. Its path
is planned here, by :func:`bf16_plan`: one launch where a block's registers
hold whole groups of a batch row, else a statistics pass and a pass that
computes the convolution again and normalises; neither writes an f32
tensor. A bf16 launch counts in ``conv1d_gn.launches`` and in
``conv1d_gn.launches_bf16``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from sincformer_tpu_torch.ops import build

_TILE_ROWS = 128         # csrc/conv_gn.cu: kTM, and the bf16 form's kRows
_PP_ROWS = 64            # the bf16 form's tiles in two passes (kRowsPP)
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


# The bf16 form's tiling (csrc/conv_gn.cu, bf16form): wgmma widths, the
# dynamic shared memory a block may take, and the ring's choices in order of
# preference, (input channels a stage, stages): fused, one ring; in two
# passes, a ring of half the stages for each warpgroup. Fused, 16 and 32
# (32 measured faster at the flagship block, PERF.md section 6), 128 for
# groups wider than 32 channels; two passes, the narrowest that covers Cout
_BF16_WIDTHS = (16, 32, 128)
_BF16_SMEM = 218 * 1024
_BF16_RINGS = {True: ((64, 4), (64, 3), (32, 4), (32, 3), (16, 4), (16, 3),
                      (64, 2), (32, 2), (16, 2)),
               False: ((64, 6), (64, 4), (32, 6), (32, 4), (16, 6),
                       (16, 4))}


class Bf16Plan(NamedTuple):
    """How ``conv_gn_fwd_bf16`` takes one call: ``fused`` (one launch, a
    whole batch row's groups in a block's registers) or not (a statistics
    pass, the merge, a normalising pass); the wgmma width ``nt``, the 64-row
    sub-tiles ``mt`` each consumer warpgroup keeps (a fused tile is 128 mt
    rows; in two passes a tile is 64 rows of one warpgroup) and the
    channels ``nb`` a block owns; ``ck`` input channels and
    ``taps`` taps a ring stage, ``stages`` of them; w staged once a block
    (``resident``); the grid; the dynamic shared memory in bytes."""
    fused: bool
    nt: int
    mt: int
    nb: int
    ck: int
    taps: int
    stages: int
    resident: bool
    blocks: int
    smem: int

    def args(self) -> Tuple[int, ...]:
        """The plan's arguments of ``conv_gn_fwd_bf16``, in its order."""
        return (int(self.fused), self.nt, self.mt, self.nb, self.ck,
                self.taps, self.stages, int(self.resident), self.blocks)


def _bf16_smem(cin: int, k: int, s: int, nt: int, mt: int, ck: int,
               taps: int, stages: int, resident: bool, fused: bool) -> int:
    """Dynamic shared memory of a bf16 block (csrc/conv_gn.cu,
    ``bf16form::geometry``): w where resident, the ring (the window of a
    tap group for a tile, 128 mt rows fused, else 64, by stride phase, and
    its w where not resident), the bf16 copies of normalised tiles (in the
    ring when fused and it fits there; one a warpgroup otherwise) and two
    mbarriers a stage."""
    cin16 = -(-cin // 16) * 16
    rows = (_TILE_ROWS * mt if fused else _PP_ROWS) - 1 + -(-taps // s)
    slot = 16 * min(taps, s) * (ck // 8) * rows
    if not resident:
        slot += 16 * taps * (nt // 8) * ck
    w_res = 16 * k * (nt // 8) * cin16 if resident else 0
    ring = stages * slot
    out_tile = _TILE_ROWS * mt * (2 * nt + 16)
    out_extra = max(out_tile - ring, 0) if fused else out_tile
    return w_res + ring + out_extra + 16 * stages


def _bf16_ring(cin, k, s, nt, mt, fused):
    """The first ring that fits, w resident before w streamed, all taps a
    stage before fewer: (ck, taps, stages, resident, smem) or None."""
    cin16 = -(-cin // 16) * 16
    for resident in (True, False):
        for taps in ((k,) if resident else range(k, 0, -1)):
            for ck, stages in _BF16_RINGS[fused]:
                if ck > cin16:
                    continue
                smem = _bf16_smem(cin, k, s, nt, mt, ck, taps, stages,
                                  resident, fused)
                if smem <= _BF16_SMEM:
                    return ck, taps, stages, resident, smem
    return None


def bf16_instances() -> Tuple[Tuple[int, int], ...]:
    """The (NT, MT) instantiations of ``conv_bf16_kernel`` that
    ``conv_gn_fwd_bf16`` dispatches: every width with every power-of-two MT
    whose accumulators fit (MT x NT <= 128, 64 a thread)."""
    return tuple((nt, mt) for nt in _BF16_WIDTHS for mt in (1, 2, 4, 8)
                 if mt * nt <= 128)


def fused_plan(bsz: int, t: int, cin: int, cout: int, k: int, stride: int,
               groups: int, nt: int) -> Optional[Bf16Plan]:
    """The fused path at wgmma width ``nt``, or None where a block's
    registers or shared memory cannot hold a batch row's groups at it."""
    t_out = _same_pads(t, k, stride)[0]
    cg = cout // groups
    mt = 1 << max(0, (-(-t_out // _TILE_ROWS) - 1).bit_length())
    if nt < cg or mt * nt > 128:
        return None
    nb = min(nt, cout) // cg * cg
    ring = _bf16_ring(cin, k, stride, nt, mt, True)
    if ring is None:
        return None
    return Bf16Plan(True, nt, mt, nb, ring[0], ring[1], ring[2], ring[3],
                    bsz * -(-cout // nb), ring[4])


def bf16_plan(bsz: int, t: int, cin: int, cout: int, k: int, stride: int,
              groups: int, sms: int = 132) -> Bf16Plan:
    """The bf16 form's path for a call, on a card with ``sms`` SMs.

    Fused where a block's registers hold whole groups (nb a multiple of
    Cout / groups) of all Tout rows (:func:`fused_plan`); among the widths
    that do, the one with the fewest waves of blocks (one block an SM)
    times columns computed. Otherwise two passes of 64-row tiles, a
    warpgroup each, at the narrowest width that covers Cout (128 past it),
    on persistent blocks that each keep one slab of channels."""
    plans = [p for p in (fused_plan(bsz, t, cin, cout, k, stride, groups, nt)
                         for nt in _BF16_WIDTHS) if p is not None]
    if plans:
        return min(plans, key=lambda p: -(-p.blocks // sms) * (p.nt + 16))
    t_out = _same_pads(t, k, stride)[0]
    nt = next((w for w in _BF16_WIDTHS if w >= cout), _BF16_WIDTHS[-1])
    ring = _bf16_ring(cin, k, stride, nt, 1, False)
    if ring is None:
        raise ValueError(f"conv1d_gn bf16 kernel: no tiling fits K={k}, "
                         f"stride={stride}")
    slabs = -(-cout // nt)
    items = bsz * -(-t_out // _PP_ROWS)
    blocks = slabs * max(1, min(items, sms // slabs))
    return Bf16Plan(False, nt, 1, nt, ring[0], ring[1], ring[2], ring[3],
                    blocks, ring[4])


def stat_buffers(plan: Optional[Bf16Plan], bsz: int, t_out: int, cout: int,
                 groups: int, device) -> tuple:
    """The f32 buffers a call writes besides its output: the tiles'
    centred partials (B, n_tiles, Cout, 2), tiles of 128 rows (f32) or 64
    (bf16), and the merged statistics (B, groups, 2), or none for a fused
    bf16 plan. No plan allocates a (B, Tout, Cout) f32 tensor."""
    if plan is not None and plan.fused:
        return None, None
    n_tiles = -(-t_out // (_TILE_ROWS if plan is None else _PP_ROWS))
    return (torch.empty((bsz, n_tiles, cout, 2), dtype=torch.float32,
                        device=device),
            torch.empty((bsz, groups, 2), dtype=torch.float32, device=device))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _kernel(dtype: torch.dtype = torch.float32):
    fn = getattr(build.load("conv_gn"), _ENTRY[dtype])
    # the bf16 form takes its plan after `act`
    n_plan = 0 if dtype == torch.float32 else 9
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [
        ctypes.c_float] + [ctypes.c_int] * (1 + n_plan) + [ctypes.c_void_p]
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
    plan = None
    if x.dtype == torch.bfloat16:
        plan = bf16_plan(bsz, t, cin, cout, k, stride, groups,
                         _sm_count(x.device.index or 0))
    out = torch.empty((bsz, t_out, cout), dtype=x.dtype, device=x.device)
    partial, stats = stat_buffers(plan, bsz, t_out, cout, groups, x.device)
    fn = _kernel(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), gamma.data_ptr(),
                 beta.data_ptr(), skip.data_ptr() if skip is not None else None,
                 out.data_ptr(),
                 partial.data_ptr() if partial is not None else None,
                 stats.data_ptr() if stats is not None else None, bsz, t, cin,
                 cout, k, stride, pad_l, t_out, groups, float(eps),
                 int(bool(act)), *(plan.args() if plan else ()), stream)
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
