"""What holds the kernels K1, K3, K4, K5 and K6 back, measured by removing
parts of them in turn, on one CUDA card.

    python3 scripts/torch_kernel_ablation.py [--out ablation.json]
        [--kernels k1,k3,k5,k1bf16,k3bf16] [--k5-baseline path/to/conv_gn.cu]
        [--k4-baseline path/to/meddis.cu] [--sass k4.sass]
        [--bf16-baseline path/to/csrc]

Builds edited copies of ``sincformer_tpu_torch/csrc/fused_ffn.cu`` (K3),
``speech_attention.cu`` (K1), ``conv_gn.cu`` (K5) and ``meddis.cu`` (K4)
with ``nvcc`` (one process each, all started together) into
``sincformer_tpu_torch/_build/ablation/`` and times each beside the kernel
as committed and the library call, from CUDA-graph replays (device time;
K4, whose calls take milliseconds, from CUDA events around eager calls),
at the main path's shapes:

  * K3: ``no_product_a`` (the three mma of h = xn . W1 removed),
    ``no_product_b`` (those of y += h . W2), ``no_weight_copies`` (W1 and W2
    never copied to shared memory), ``product_a_1xtf32`` (h = xn . W1 by
    the single product hi.hi), ``cvt_rounding`` (TF32 rounding by
    ``cvt.rna.tf32.f32`` instead of two integer operations);
  * K1: ``cvt_rounding``;
  * K5, at the JAX docstring's call site (16, 32,000, 64 -> 128, k=7, s=2)
    and the flagship block's shape (16, 400, 256 -> 256, k=7, s=1):
    ``no_mma`` (the tensor-core products removed), ``conv_only`` (the
    statistics merge and the normalise kernel not launched), ``1xtf32``
    (each product as the single TF32 product hi.hi), ``no_split`` (the
    staged window and w not split into hi and lo), ``no_staging`` (nothing
    copied into shared memory), and, with ``--k5-baseline``, another
    ``conv_gn.cu`` with the same C interface built as it is (the CUDA-core
    kernel of an earlier commit, unpacked with ``git archive``).

  * K4 (``--kernels k4``, not in the default set), at the front-end
    request's (1024, 32,000) and one request's (64, 32,000), beside the
    chain alone in registers (``probe``) and the SM clock under load:
    ``walk_only`` (the movers load, divide and store nothing; the walker
    walks tiles filled once), ``move_only`` (the walker takes no step),
    ``no_wait`` (no mbarrier wait waits; timing only), ``idle_movers`` (a
    mover pauses 500 ns between tests of its barrier), ``k_inline`` (the
    walker does the division), ``probe_shared`` (the walker's batch loop
    alone over one shared tile, no barriers), ``cols16``, ``cols32`` (with
    64-sample tiles: 32 do not fit), ``tile64``, ``batch32``.
    ``--k4-baseline`` takes the earlier ``meddis.cu`` (32 columns a block,
    one ``__syncthreads`` per 64-sample tile) and builds it as it is and
    with the edits ``walk_only``, ``move_only``, ``no_barrier``,
    ``k_inline``, ``probe_shared`` (its ``walk`` alone) and ``cols8`` (8
    columns a block). ``--sass`` writes ``cuobjdump -sass`` of every K4
    library.

  * K1's bf16 form (``--kernels k1bf16``) at (B, T) = (4, 400), (16, 401),
    (8, 401) and (128, 401), H 4, dh 64: ``div`` (P by an IEEE division
    for every score instead of one reciprocal a row), ``exp2``
    (ex2.approx of x log2(e) in place of expf), ``no_softmax`` (exp and the normalisation removed),
    ``no_staging`` (K and V never copied), ``no_wgmma`` (the products
    removed), ``tile_a_block`` (one block a row tile: K and V copied for
    every tile), ``warp_form`` (the mma.sync form of the other head widths
    at dh 64);
  * K3's bf16 form (``--kernels k3bf16``) at 25,664, 6,416, 3,208 and 51,328
    rows (d 256, d_ff 1024): ``no_tma`` (the ring's copies never made),
    ``no_product_a``, ``no_product_b``, ``no_swish``, ``ieee_rcp`` (the
    swish's reciprocal as an IEEE division), ``split_all`` (every M as one
    64-row unit a block, d_ff split between the warpgroups), ``rows_all``
    (every M in 128-row tiles).

  * K5's bf16 form (``--kernels k5bf16``, not in the default set) at the
    call site and the flagship block's shape: ``no_mma`` (the wgmma
    products removed), ``no_staging`` (nothing copied into the ring or the
    resident w), ``conv_only`` (the two passes' merge and normalising pass
    not launched; fused, no statistics and no epilogue), ``no_epilogue``
    (no tile's epilogue at all), ``gelu_tanh`` (the GELU by the accurate
    tanhf of the f32 form in place of ex2.approx and a fast division); the
    committed kernel and ``gelu_tanh`` also with their shares bit-equal to
    the plain bf16 version, and the committed kernel also on the fused
    path at each width its plan did not take (``fused nt16 mt4``, ...);
  * K6's bf16 form (``--kernels k6bf16``) at (16, 32,000, 64):
    ``copy_only`` (loads, the envelope's sums and stores alone), ``no_tanh``,
    ``f32_math`` (the f32 form's GELU on the widened pair, rounded once),
    and the count of packed bf16 products, sums and fused multiply-adds in
    the SASS of its eight-channel kernel (``cuobjdump -sass``);
  * ``--kernels k5bf16old,k6bf16old --bf16-baseline path/to/csrc``: the
    bf16 forms of an earlier ``conv_gn.cu`` and ``envact.cu`` (those with
    an f32 scratch and scalar roundings, unpacked with ``git archive``),
    as they are and with ``no_mma``, ``no_staging``, ``conv_only``,
    ``no_scratch`` (the f32 store and its read removed), ``copy_only``,
    ``no_round`` (each rounding an identity), ``no_tanh``, ``f32_math``.

K3 is also timed on the inputs that the fused DCSE model (seeded weights)
gives its eight calls in a 60 s request, beside random values of the same
shape.

A variant that drops work gives wrong numbers; only its time is read. Every
edit is checked to apply, so a change to a kernel's source that moves the
edited lines fails here instead of timing the unedited kernel. Needs a CUDA
device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CVT = ('  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));\n'
       '  return r;')
INT_ROUND = "  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;"
PRODUCT_A = ("          mma(small[j], al, bh);\n"
             "          mma(small[j], ah, bl);\n"
             "          mma(big[j], ah, bh);\n")
PRODUCT_B = "for (int i = 0; i < 2; ++i) mma3(y[i][j], ah[i], al[i], bh, bl);"
W1_COPIES = "i < D * (kFC / 4); i += kThreads"
W2_COPIES = "i < kFC * (D / 4); i += kThreads"
K5_MMA = "mma3(acc[mt][nt], ah[mt], al[mt], bh, bl);"
K5_MMA1 = "tf32x3::mma(acc[mt][nt], ah[mt], bh);"
K5_STATS = ("  err = cudaGetLastError();\n  if (err != cudaSuccess) return (int)err;"
            "\n  stats_kernel<kTM><<<")
K5_STOP = "  return (int)cudaGetLastError();\n  stats_kernel<kTM><<<"
K5_SPLIT_X = "i < n_rows * kKC; i += kThreads"
K5_SPLIT_W = "i < kt * kKC * kTN; i += kThreads"
K5_STAGE_X = "phase < nph; ++phase"
K5_STAGE_W = "i < kt * kKC * (kTN / 4); i += kThreads"

# name -> (kernel source, [(old, new) edits of the source], header edit)
VARIANTS = {
    "k4": ("meddis", [], None),
    "k3": ("fused_ffn", [], None),
    "k3_no_product_a": ("fused_ffn", [(PRODUCT_A, "")], None),
    "k3_no_product_b": ("fused_ffn", [(PRODUCT_B, "")], None),
    "k3_no_weight_copies": ("fused_ffn", [
        (W1_COPIES, "i < 0; i += kThreads"),
        (W2_COPIES, "i < 0; i += kThreads")], None),
    "k3_product_a_1xtf32": ("fused_ffn", [(PRODUCT_A,
                                           "          mma(big[j], ah, bh);\n")],
                            None),
    "k3_cvt_rounding": ("fused_ffn", [], (INT_ROUND, CVT)),
    "k1": ("speech_attention", [], None),
    "k1_cvt_rounding": ("speech_attention", [], (INT_ROUND, CVT)),
    "k5": ("conv_gn", [], None),
    "k5_no_mma": ("conv_gn", [(K5_MMA, ";")], None),
    "k5_conv_only": ("conv_gn", [(K5_STATS, K5_STOP)], None),
    "k5_1xtf32": ("conv_gn", [(K5_MMA, K5_MMA1)], None),
    "k5_no_split": ("conv_gn", [(K5_SPLIT_X, "i < 0; i += kThreads"),
                                (K5_SPLIT_W, "i < 0; i += kThreads")], None),
    "k5_no_staging": ("conv_gn", [(K5_STAGE_X, "phase < 0; ++phase"),
                                  (K5_STAGE_W, "i < 0; i += kThreads")],
                      None),
}


# The bf16 forms (K1's and K3's ``_bf16`` entry points), timed at the bf16
# shapes of chip_smoke.py's [bf16] beside the bf16 library calls
K1B_EXP = "float softmax_exp(float x) { return expf(x); }"
K1B_P = "  return pack_bf16(e0 * il, e1 * il);"
K1B_P_DIV = "  return pack_bf16(e0 / (1.f / il), e1 / (1.f / il));"
K1B_P_NONE = "  return pack_bf16(e0, e1);"
K1B_STAGE_KV = """      tf32x3::cp_async16(dst + j * P + 8 * c,
                         src + (ok ? head + (long long)j * D + 8 * c : 0), ok);"""
K1B_STAGE_WG = """      tf32x3::cp_async16(
          dst + r * 128 + ((c ^ (r & 7)) << 4),
          src + (ok ? head + (long long)(row0 + r) * D + 8 * c : 0), ok);"""
K1B_WG_S = """      wgmma::ss<NK, 0>(s, wgmma::desc(q_at + 32 * kk, 0, 1024),
                       wgmma::desc(k_at + 32 * kk, 0, 1024), kk > 0);"""
K1B_WG_PV = """      wgmma::rs<DH>(o, pa[kk], wgmma::desc(v_at + 2048 * kk, 0, 1024),
                    kk > 0);"""
K1B_PER_HEAD = """  const int per_head = heads >= sms ? 1
      : (int)(sms / heads < n_tiles ? sms / heads : n_tiles);"""
K3B_LOADS = """          bar_expect(full1 + 8 * s, Plan::kW1);
          tma_load(smem_u32(w1s + s * Plan::kW1), &w1_map, c * kChunk, 0,
                   full1 + 8 * s);
          if (use > 0) bar_wait(empty2 + 8 * s, (use - 1) & 1);
          bar_expect(full2 + 8 * s, Plan::kW2);
#pragma unroll
          for (int p = 0; p < kN / 64; ++p) {
            tma_load(smem_u32(w2s + s * Plan::kW2 + p * 8192), &w2_map,
                     64 * p, c * kChunk, full2 + 8 * s);
          }"""
K3B_NO_LOADS = """          bar_arrive(full1 + 8 * s);
          if (use > 0) bar_wait(empty2 + 8 * s, (use - 1) & 1);
          bar_arrive(full2 + 8 * s);"""
K3B_PRODUCT_A = """        wgmma::ss<64, 1>(acc,
                         wgmma::desc(xn_a + (kk / 4) * 8192 + (kk % 4) * 32,
                                     0, 1024),
                         wgmma::desc(w1a + kk * 2048, 0, 1024), kk > 0);"""
K3B_PRODUCT_B = """          wgmma::rs<kN>(y, ha[kk],
                        wgmma::desc(w2a + kk * 2048, 8192, 1024), 1);"""
K3B_RCP = """  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  r = fmaf(r, fmaf(-d, r, 1.f), r);"""
K3B_SWISH = "  return __fmul_rn(v, r);"
BF16_VARIANTS = {
    "k1bf16": ("speech_attention", [], None),
    "k1bf16_div": ("speech_attention", [(K1B_P, K1B_P_DIV)], None),
    "k1bf16_exp2": ("speech_attention", [(
        K1B_EXP,
        "float softmax_exp(float x) { return exp2f(x * 1.44269504f); }")],
        None),
    "k1bf16_no_softmax": ("speech_attention", [
        (K1B_EXP, "float softmax_exp(float x) { return x; }"),
        (K1B_P, K1B_P_NONE)], None),
    "k1bf16_no_staging": ("speech_attention", [
        (K1B_STAGE_KV, "      (void)ok;"),
        (K1B_STAGE_WG, "      (void)ok;")], None),
    "k1bf16_tile_a_block": ("speech_attention", [
        (K1B_PER_HEAD + "\n  const dim3 grid",
         "  const int per_head = n_tiles + 0 * (int)heads;\n  const dim3 grid"),
        (K1B_PER_HEAD + "\n  attention_bf16_wgmma",
         "  const int per_head = n_tiles + 0 * (int)heads;\n"
         "  attention_bf16_wgmma")], None),
    "k1bf16_no_wgmma": ("speech_attention", [(K1B_WG_S, "      (void)q_at;"),
                                             (K1B_WG_PV, "      (void)v_at;")],
                        None),
    "k1bf16_warp_form": ("speech_attention", [
        ("  if (DH == 64 && T <= 4 * kWgKeys) {", "  if (false) {")], None),
    "k3bf16": ("fused_ffn", [], None),
    "k3bf16_no_tma": ("fused_ffn", [(K3B_LOADS, K3B_NO_LOADS)], None),
    "k3bf16_no_product_a": ("fused_ffn", [(K3B_PRODUCT_A, "        (void)w1a;")],
                            None),
    "k3bf16_no_product_b": ("fused_ffn", [(K3B_PRODUCT_B, "          (void)w2a;")],
                            None),
    "k3bf16_no_swish": ("fused_ffn", [(K3B_SWISH, "  return v;")], None),
    "k3bf16_ieee_rcp": ("fused_ffn", [(K3B_RCP, "  r = 1.f / d;")], None),
    "k3bf16_split_all": ("fused_ffn", [("  if (units <= sms) {", "  if (true) {")],
                         None),
    "k3bf16_rows_all": ("fused_ffn", [("  if (units <= sms) {", "  if (false) {")],
                        None),
}

# K5's and K6's bf16 forms as an earlier commit wrote them (PR 15: K5 bf16
# the f32 tiling with one TF32 product per product, an f32 scratch between
# its conv and norm kernels; K6 bf16 one scalar rounding per operation),
# built from the csrc/ directory that --bf16-baseline names
K5B_OLD_MMA = "for (int mt = 0; mt < 2; ++mt) mma(acc[mt][nt], ah[mt], bh);"
K5B_OLD_STATS = ("  err = cudaGetLastError();\n  if (err != cudaSuccess) "
                 "return (int)err;\n  stats_kernel<<<")
K5B_OLD_STOP = "  return (int)cudaGetLastError();\n  stats_kernel<<<"
K5B_OLD_STORE = """          if (n0 + col + 1 < Cout && (Cout & 1) == 0) {
            *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
          } else {
            if (n0 + col < Cout) o[0] = v[0];
            if (n0 + col + 1 < Cout) o[1] = v[1];
          }"""
K5B_OLD_READ = "      load4(in + i, r);"
K6B_OLD_GELU = """        out[q] = to_bf16(gelu_bf16(rb(v0 * s[2 * q]))) |
                 (to_bf16(gelu_bf16(rb(v1 * s[2 * q + 1]))) << 16);"""
K6B_OLD_ENV = """      e4[q] = to_bf16(log1pf(sum[2 * q] * (1.0f / kPool))) |
              (to_bf16(log1pf(sum[2 * q + 1] * (1.0f / kPool))) << 16);"""
BF16_OLD_VARIANTS = {
    "k5bf16old": ("conv_gn", []),
    "k5bf16old_no_mma": ("conv_gn", [(K5B_OLD_MMA, ";")]),
    "k5bf16old_no_staging": ("conv_gn", [(K5_STAGE_X, "phase < 0; ++phase"),
                                         (K5_STAGE_W, "i < 0; i += kThreads")]),
    "k5bf16old_conv_only": ("conv_gn", [(K5B_OLD_STATS, K5B_OLD_STOP)]),
    "k5bf16old_no_scratch": ("conv_gn", [
        (K5B_OLD_STORE, "          (void)o;"),
        (K5B_OLD_READ, "      r[0] = r[1] = r[2] = r[3] = 0.f;")]),
    "k6bf16old": ("envact", []),
    "k6bf16old_copy_only": ("envact", [
        (K6B_OLD_GELU, "        out[q] = xw[q];"),
        (K6B_OLD_ENV, "      e4[q] = to_bf16(sum[2 * q]) | "
                      "(to_bf16(sum[2 * q + 1]) << 16);")]),
    "k6bf16old_no_round": ("envact", [(
        "  return __bfloat162float(__float2bfloat16_rn(v));", "  return v;")]),
    "k6bf16old_no_tanh": ("envact", [("rb(tanhf(inner))", "inner")]),
    "k6bf16old_f32_math": ("envact", [(
        K6B_OLD_GELU,
        "        out[q] = to_bf16(gelu_tanh(v0 * s[2 * q])) |\n"
        "                 (to_bf16(gelu_tanh(v1 * s[2 * q + 1])) << 16);")]),
}

# K5's and K6's bf16 forms as they are now (wgmma ring and fused epilogue;
# packed bf16x2 GELU)
K5B_WGMMA = """              wgmma::ss<NT, 1>(
                  acc[m],
                  wgmma::desc_plain(a + 2048 * m + 32 * kk * g.rp,
                                    16 * g.rp, 128),
                  bd, 1);"""
K5B_MERGE = """  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_kernel<kRowsPP><<<dim3(g.groups, g.B), 128, 0, st>>>("""
K5B_FUSED = "      // kFused: the batch row is in registers; each group's mean, then its"
K5B_EPILOGUE = "    // ── the tile's epilogue ──"
K6B_GELU = "        o[q] = gelu2(mul2(v[q], s[q]));"
K6B_ENV = """      eo[q] = __floats2bfloat162_rn(log1pf(sum[q].x * (1.0f / kPool)),
                                    log1pf(sum[q].y * (1.0f / kPool)));"""
K6B_TANH = ("  const bf162 th = __floats2bfloat162_rn(tanhf(inner.x), "
            "tanhf(inner.y));")
BF16_VARIANTS.update({
    "k5bf16": ("conv_gn", [], None),
    "k5bf16_no_mma": ("conv_gn", [(K5B_WGMMA, "              (void)bd;")],
                      None),
    "k5bf16_no_staging": ("conv_gn", [
        ("    for (int i = threadIdx.x; i < n; i += kThreads) {",
         "    for (int i = threadIdx.x; i < 0 * n; i += kThreads) {"),
        ("for (int i = p; i < nx; i += kProducers, r += dr) {",
         "for (int i = p; i < 0 * nx; i += kProducers, r += dr) {"),
        ("for (int i = p; i < nw; i += kProducers, ci += dci) {",
         "for (int i = p; i < 0 * nw; i += kProducers, ci += dci) {")],
        None),
    "k5bf16_conv_only": ("conv_gn", [
        (K5B_MERGE, "  return (int)cudaGetLastError();\n" + K5B_MERGE),
        (K5B_FUSED, "      continue;\n" + K5B_FUSED)], None),
    "k5bf16_no_epilogue": ("conv_gn", [
        (K5B_EPILOGUE, "    if (g.mode >= 0) continue;\n" + K5B_EPILOGUE)],
        None),
    "k5bf16_gelu_tanh": ("conv_gn", [(
        "v = gelu_bf16_out(v);", "v = gelu_tanh(v);")], None),
    "k6bf16": ("envact", [], None),
    "k6bf16_copy_only": ("envact", [
        (K6B_GELU, "        o[q] = v[q];"),
        (K6B_ENV, "      eo[q] = __floats2bfloat162_rn(sum[q].x, sum[q].y);")],
        None),
    "k6bf16_no_tanh": ("envact", [(
        K6B_TANH,
        "  const bf162 th = __floats2bfloat162_rn(inner.x, inner.y);")],
        None),
    "k6bf16_f32_math": ("envact", [(
        K6B_GELU,
        "        { const float2 xf = __bfloat1622float2(v[q]);\n"
        "          const float2 sf = __bfloat1622float2(s[q]);\n"
        "          o[q] = __floats2bfloat162_rn(gelu_tanh(xf.x * sf.x),\n"
        "                                       gelu_tanh(xf.y * sf.y)); }")],
        None),
})


def packed_sass(lib: str, kernel: str) -> dict:
    """The packed bf16 instructions of ``kernel`` in ``lib``'s SASS
    (``cuobjdump -sass``), by kind: products (HMUL2, or HFMA2 with a -0
    addend), sums (HADD2, or HFMA2 with the multiplier 1) and fused
    multiply-adds (any other HFMA2 on bf16 pairs), which would round a
    product and a sum once."""
    import re

    from sincformer_tpu_torch.ops import build
    text = subprocess.run(
        [os.path.join(os.path.dirname(build._nvcc()), "cuobjdump"), "-sass",
         lib], capture_output=True, text=True, check=True).stdout
    counts = {"products": 0, "sums": 0, "fused": 0}
    body = text.split(kernel, 1)[1].split("Function :", 1)[0]
    for op in re.findall(r"(H(?:FMA|MUL|ADD)2[.A-Z0-9_]*BF16_V2[^;]*);", body):
        args = [a.strip() for a in op.split(None, 1)[1].split(",")]
        if op.startswith("HMUL2") or (op.startswith("HFMA2")
                                      and args[-1] == "-RZ"):
            counts["products"] += 1
        elif op.startswith("HADD2") or args[2:4] == ["1", "1"]:
            counts["sums"] += 1
        else:
            counts["fused"] += 1
    return counts

# K4: the earlier meddis.cu (one walking warp, three moving warps, one
# __syncthreads per 64-sample tile), as --k4-baseline builds it
OLD_MOVE = """      if (i < n_tiles)
        load_tile(tiles[i % kStages], x, col0, cols, N, i * kTile, warp - 1,
                  lane);
      if (i >= 2)
        store_tile(tiles[(i - 2) % kStages], out, col0, cols, N,
                   (i - 2) * kTile, warp - 1, lane);
"""
OLD_STATE = "  float q = q0, c = c0, w = w0;\n"
OLD_FILL = ("  for (int e = threadIdx.x; e < kStages * kCols * kPitch; "
            "e += kThreads)\n    (&tiles[0][0])[e] = 0.5f;\n  __syncthreads();\n")
OLD_WALK = "        walk(tiles[j % kStages] + lane * kPitch, steps, dt, q, c, w);"
OLD_K = ("        tile[r * kPitch + lane + 32 * j] = "
         "__fdiv_rn(s, __fadd_rn(s, kB));")
STEP_HEAD = """float dt, float& q,
                                            float& c, float& w) {
"""
K_INLINE = ("  { const float s = fmaxf(__fadd_rn(k, kA), 0.0f);\n"
            "    k = __fdiv_rn(s, __fadd_rn(s, kB)); }\n")
OLD_PROBE = """  float q = q0, c = c0, w = w0, last = 0.0f;
  for (int t = 0; t < N; ++t) last = euler_step(k, dt, q, c, w);
  out[blockIdx.x * kCols + threadIdx.x] = last;"""
OLD_PROBE_SHARED = """  __shared__ float tile[kCols * kPitch];
  for (int e = threadIdx.x; e < kCols * kPitch; e += kCols) tile[e] = k;
  __syncwarp();
  float q = q0, c = c0, w = w0;
  for (int t0 = 0; t0 < N; t0 += kTile)
    walk(tile + threadIdx.x * kPitch, N - t0 < kTile ? N - t0 : kTile, dt, q,
         c, w);
  out[blockIdx.x * kCols + threadIdx.x] = tile[threadIdx.x * kPitch];"""
# variant -> edits of the earlier meddis.cu
K4_BASELINE_EDITS = {
    "walk_only": [(OLD_MOVE, ""), (OLD_STATE, OLD_FILL + OLD_STATE)],
    "move_only": [(OLD_WALK, "        (void)steps;")],
    "no_barrier": [("    __syncthreads();\n  }\n}", "  }\n}")],
    "k_inline": [(OLD_K, "        tile[r * kPitch + lane + 32 * j] = v[a][j];"),
                 (STEP_HEAD, STEP_HEAD + K_INLINE)],
    "probe_shared": [(OLD_PROBE, OLD_PROBE_SHARED)],
    "cols8": [("constexpr int kCols = 32; ", "constexpr int kCols = 8; ")],
}

# K4 as committed: a walking warp and three moving warps around a ring of
# tiles with mbarriers
MOVE_LOAD = """          v[r][j] = (r < cols && t < N) ? x[(col0 + r) * (long long)N + t]
                                        : 0.0f;"""
MOVE_STORE = """          if (r < cols && t < N)
            out[(col0 + r) * (long long)N + t] = slot[r * kPitch + 32 * j +
                                                      lane];"""
MOVE_K = "          slot[r * kPitch + 32 * j + lane] = __fdiv_rn(s, __fadd_rn(s, kB));"
RING_INIT = "  __syncthreads();\n  if (warp == 0)"
RING_FILL = ("  for (int e = threadIdx.x; e < kSlots * kSlotFloats; e += kThreads)\n"
             "    ring[e] = 0.5f;\n")
PROBE = """  float q = q0, c = c0, w = w0, last = 0.0f;
  for (int t = 0; t < N; ++t) last = euler_step(k, dt, q, c, w);
  out[blockIdx.x * 32 + threadIdx.x] = last;"""
PROBE_SHARED = """  __shared__ __align__(16) float tile[kSlotFloats];
  for (int e = threadIdx.x; e < kSlotFloats; e += 32) tile[e] = k;
  __syncwarp();
  float q = q0, c = c0, w = w0;
  const uint32_t row0 = smem(tile) + 4u * (threadIdx.x % kCols) * kPitch;
  const bool writes = threadIdx.x < kCols;
  const auto at = [&](int b) { return row0 + 4u * ((b % kBpt) * kBatch); };
  float4 ka[kBatch / 4], kb[kBatch / 4];
  load_batch(ka, at(0));
  for (int b = 0; b + 2 <= N / kBatch; b += 2) {
    load_batch(kb, at(b + 1));
    steps_full(ka, dt, q, c, w);
    if (writes) store_batch(ka, at(b));
    load_batch(ka, at(b + 2));
    steps_full(kb, dt, q, c, w);
    if (writes) store_batch(kb, at(b + 1));
  }
  out[blockIdx.x * 32 + threadIdx.x] = q;"""
MOVER_WAIT = "      bar_wait(walked0 + 8u * (i % kSlots), ((i - kSlots) / kSlots) & 1);"
MOVER_WAIT_IDLE = """      while (!bar_test(walked0 + 8u * (i % kSlots),
                       ((i - kSlots) / kSlots) & 1))
        __nanosleep(500);"""
COLS = "constexpr int kCols = 8; "
TILE = "constexpr int kTile = 128; "
K4_VARIANTS = {
    "k4_walk_only": ("meddis", [(MOVE_LOAD, "          v[r][j] = 0.0f;"),
                                (MOVE_STORE, "          (void)t;"),
                                (MOVE_K, "          (void)s;"),
                                (RING_INIT, RING_FILL + RING_INIT)], None),
    "k4_move_only": ("meddis", [
        ("    steps_full(ka, dt, q, c, w);\n", ""),
        ("    steps_full(kb, dt, q, c, w);\n", ""),
        ("    steps_part(ka, N - b * kBatch, dt, q, c, w);\n", "")], None),
    "k4_no_wait": ("meddis", [("!bar_test(bar, parity);", "false;")], None),
    "k4_idle_movers": ("meddis", [(MOVER_WAIT, MOVER_WAIT_IDLE)], None),
    "k4_batch32": ("meddis", [("constexpr int kBatch = 16; ",
                                "constexpr int kBatch = 32; ")], None),
    "k4_k_inline": ("meddis", [(MOVE_K, "          slot[r * kPitch + 32 * j + "
                                        "lane] = v[r][j];"),
                               (STEP_HEAD, STEP_HEAD + K_INLINE)], None),
    "k4_probe_shared": ("meddis", [(PROBE, PROBE_SHARED)], None),
    "k4_cols16": ("meddis", [(COLS, "constexpr int kCols = 16;")], None),
    "k4_cols32": ("meddis", [(COLS, "constexpr int kCols = 32;"),
                             (TILE, "constexpr int kTile = 64;")], None),
    "k4_tile64": ("meddis", [(TILE, "constexpr int kTile = 64;")], None),
}


def edited(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"edit does not apply once: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def sources_in(csrc: str, name: str) -> dict:
    """``<csrc>/<name>.cu`` and the headers it includes with quotes, read
    from another csrc/ directory (an earlier commit's)."""
    import re
    found, todo = {}, [f"{name}.cu"]
    while todo:
        fname = todo.pop()
        if fname not in found:
            with open(os.path.join(csrc, fname), "rb") as f:
                found[fname] = f.read()
            todo += [i.decode() for i in re.findall(
                rb'^\s*#\s*include\s+"([^"]+)"', found[fname], re.M)]
    return found


def build_variants(out_dir: str, kernels, k5_baseline=None,
                   k4_baseline=None, bf16_baseline=None) -> dict:
    from sincformer_tpu_torch.ops import build
    os.makedirs(out_dir, exist_ok=True)
    variants = {name: v for name, v in {**VARIANTS, **K4_VARIANTS,
                                        **BF16_VARIANTS}.items()
                if name.split("_")[0] in kernels}
    old = {name: v for name, v in BF16_OLD_VARIANTS.items()
           if name.split("_")[0] in kernels}
    if old and not bf16_baseline:
        raise SystemExit("k5bf16old and k6bf16old need --bf16-baseline")
    variants.update({name: (src, edits, None, bf16_baseline)
                     for name, (src, edits) in old.items()})
    procs = {}
    for name, (src, edits, header, *csrc) in variants.items():
        vdir = os.path.join(out_dir, name)
        os.makedirs(vdir, exist_ok=True)
        for fname, text in (sources_in(csrc[0], src) if csrc
                            else build._sources(src)).items():
            text = text.decode()
            if fname == f"{src}.cu":
                text = edited(text, edits)
            elif header is not None:
                text = edited(text, [header])
            with open(os.path.join(vdir, fname), "w") as f:
                f.write(text)
        procs[name] = os.path.join(vdir, f"{src}.cu")
    if k5_baseline:
        procs["k5_baseline"] = os.path.abspath(k5_baseline)
    if k4_baseline:
        procs["k4_baseline"] = os.path.abspath(k4_baseline)
        with open(k4_baseline) as f:
            text = f.read()
        for vname, edits in K4_BASELINE_EDITS.items():
            vdir = os.path.join(out_dir, f"k4_baseline_{vname}")
            os.makedirs(vdir, exist_ok=True)
            with open(os.path.join(vdir, "meddis.cu"), "w") as f:
                f.write(edited(text, edits))
            procs[f"k4_baseline_{vname}"] = os.path.join(vdir, "meddis.cu")
    running = {}
    for name, source in procs.items():
        lib = os.path.join(out_dir, f"lib{name}.so")
        running[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", lib, source],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in running.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(lib)
        if name.startswith("k4"):
            fwd, probe = fn.meddis_fwd, fn.meddis_chain_probe
            fwd.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_longlong, ctypes.c_int] + [
                ctypes.c_float] * 4 + [ctypes.c_void_p]
            probe.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [
                ctypes.c_float] * 5 + [ctypes.c_void_p]
            fwd.restype = probe.restype = ctypes.c_int
            fns[name] = (fwd, probe, lib)
            continue
        if name.startswith("k5bf16"):
            fn = fn.conv_gn_fwd_bf16
            # the earlier form takes an f32 scratch and no plan
            fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
                if name.startswith("k5bf16old") else
                [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [
                    ctypes.c_float] + [ctypes.c_int] * 10 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            fns[name] = fn
            continue
        if name.startswith("k6bf16"):
            fn = fn.envact_fwd_bf16
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                                   ctypes.c_int,
                                                   ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fns[name] = fn
            continue
        if name.startswith("k1"):
            fn = (fn.speech_attention_fwd_bf16 if name.startswith("k1bf16")
                  else fn.speech_attention_fwd)
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
                ctypes.c_float, ctypes.c_void_p]
        elif name.startswith("k5"):
            fn = fn.conv_gn_fwd
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        else:
            fn = (fn.fused_ffn_fwd_bf16 if name.startswith("k3bf16")
                  else fn.fused_ffn_fwd)
            fn.argtypes = [ctypes.c_void_p] * 8 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def sm_clock() -> str:
    """The SM clock and its maximum, as nvidia-smi reads them now."""
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def time_k4(fns: dict, card: str, sass: str = None) -> dict:
    """K4's variants at the front-end request's shape (1024, 32,000) and one
    request's (64, 32,000), CUDA events around 10 calls each (a call is
    about 2 ms: the eager time is the device time), the committed kernel
    first and last; the chain probes with one 32-thread block per 32
    columns. The SM clock is read while 200 calls of the committed kernel
    run."""
    from chip_smoke import cuda_ms
    from sincformer_tpu_torch.ops import build
    from sincformer_tpu_torch.ops.meddis import _dt, steady_state
    dt, state = _dt(8000), steady_state()
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device="cuda").manual_seed(0)
    result = {}
    for cols in (1024, 64):
        n = 32000
        x = torch.randn(cols, n, device="cuda", generator=g) * 30.0
        out = torch.empty_like(x)

        def fwd(fn):
            def call():
                err = fn(x.data_ptr(), out.data_ptr(), cols, n, dt, *state,
                         stream)
                if err != 0:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
            return call

        def probe(fn):
            def call():
                err = fn(out.data_ptr(), cols // 32, n, dt, 0.3, *state,
                         stream)
                if err != 0:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
            return call
        row = {}
        for name, (f, p, _) in fns.items():
            if name.startswith("k4"):
                row[name] = cuda_ms(probe(p) if name.endswith("probe_shared")
                                    else fwd(f), iters=10, warmup=2)
        row["probe"] = cuda_ms(probe(fns["k4"][1]), iters=10, warmup=2)
        row["k4_2"] = cuda_ms(fwd(fns["k4"][0]), iters=10, warmup=2)
        busy = fwd(fns["k4"][0])
        for _ in range(200):
            busy()
        row["clocks_sm_max_mhz"] = sm_clock()
        torch.cuda.synchronize()
        result[f"({cols}, {n})"] = row
        print(f"[k4] ({cols}, {n}): " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in row.items() if k[0] in "kp")
              + f"; SM clock, max: {row['clocks_sm_max_mhz']} on {card}",
              flush=True)
    if sass:
        os.makedirs(os.path.dirname(os.path.abspath(sass)), exist_ok=True)
        with open(sass, "w") as f:
            for name, (_, _, lib) in fns.items():
                f.write(f"==== {name}: {lib}\n")
                f.write(subprocess.run(
                    [os.path.join(os.path.dirname(build._nvcc()), "cuobjdump"),
                     "-sass", lib], capture_output=True, text=True,
                    check=True).stdout)
        print(f"[k4] SASS of the K4 libraries in {sass}", flush=True)
    return result


def time_k5(fns: dict, g, card: str) -> dict:
    """K5's variants at the call site and the flagship block's shape, in
    turns with the library chain (conv1d f32 without TF32, group_norm,
    gelu)."""
    import torch.nn.functional as F

    from chip_smoke import graph_ms
    from sincformer_tpu_torch.ops.conv_gn import _same_pads
    result = {}
    for name, (bsz, t, cin, cout, k, s) in (
            ("call site", (16, 32000, 64, 128, 7, 2)),
            ("flagship block", (16, 400, 256, 256, 7, 1))):
        def r(*shape, scale=1.0):
            return torch.randn(*shape, device="cuda", generator=g) * scale
        x, w = r(bsz, t, cin), r(k, cin, cout, scale=0.1)
        b, beta = r(cout, scale=0.1), r(cout, scale=0.1)
        gamma = 1.0 + r(cout, scale=0.1)
        t_out, pad_l, pad_r = _same_pads(t, k, s)
        n_tiles = -(-t_out // 64)
        out = torch.empty(bsz, t_out, cout, device="cuda")
        partial = torch.empty(bsz, n_tiles, cout, 2, device="cuda")
        stats = torch.empty(bsz, 16, 2, device="cuda")
        w_oik = w.permute(2, 1, 0).contiguous()

        def library():
            y = F.conv1d(F.pad(x.transpose(1, 2), (pad_l, pad_r)), w_oik, b,
                         stride=s)
            return F.gelu(F.group_norm(y, 16, gamma, beta, 1e-6),
                          approximate="tanh").transpose(1, 2)
        row = {"library": graph_ms(library, 10)}
        for vname, fn in fns.items():
            if not vname.startswith("k5"):
                continue

            def call(fn=fn):
                err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                         gamma.data_ptr(), beta.data_ptr(), None,
                         out.data_ptr(), partial.data_ptr(), stats.data_ptr(),
                         bsz, t, cin, cout, k, s, pad_l, t_out, 16, 1e-6, 1,
                         torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
            row[vname] = graph_ms(call, 10)
        row["library_2"] = graph_ms(library, 10)
        result[name] = row
        print(f"[k5] {name} ({bsz}, {t}, {cin}->{cout}, k={k}, s={s}): "
              + ", ".join(f"{k_} {v:.4f} ms" for k_, v in row.items())
              + f" on {card}", flush=True)
    return result


def time_k56bf16(fns: dict, g, card: str) -> dict:
    """K5's and K6's bf16 forms at chip_smoke.py's timed bf16 shapes, in
    turns with the bf16 library chains (conv1d, group_norm and gelu;
    mul, gelu, abs, avg_pool1d and log1p), from CUDA-graph replays."""
    import torch.nn.functional as F

    from chip_smoke import (BF16_K5_TIMED, BF16_K6_TIMED, bf16_agreement,
                            conv_gn_scale, graph_ms)
    from sincformer_tpu_torch.ops.conv_gn import _same_pads, conv_gn_reference

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def check(err):
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    result = {}
    for name, (bsz, t, cin, cout, k, s) in (
            BF16_K5_TIMED if any(n.startswith("k5bf16") for n in fns)
            else ()):
        def r(*shape, scale=1.0, shift=0.0):
            return (shift + scale * torch.randn(*shape, device="cuda",
                                                generator=g)).bfloat16()
        x, w = r(bsz, t, cin), r(k, cin, cout, scale=(k * cin) ** -0.5)
        b, beta = r(cout, scale=0.1), r(cout, scale=0.1)
        gamma = r(cout, scale=0.1, shift=1.0)
        t_out, pad_l, pad_r = _same_pads(t, k, s)
        out = torch.empty(bsz, t_out, cout, device="cuda",
                          dtype=torch.bfloat16)
        conv = torch.empty(bsz, t_out, cout, device="cuda")
        partial = torch.empty(bsz, -(-t_out // 128), cout, 2, device="cuda")
        stats = torch.empty(bsz, 16, 2, device="cuda")
        if any(n.startswith("k5bf16") and not n.startswith("k5bf16old")
               for n in fns):
            from sincformer_tpu_torch.ops.conv_gn import (_BF16_WIDTHS,
                                                          bf16_plan,
                                                          fused_plan)
            plan = bf16_plan(bsz, t, cin, cout, k, s, 16)
            # the fused path at the widths the plan did not take
            others = {f"nt{nt}": p for nt in _BF16_WIDTHS
                      for p in [fused_plan(bsz, t, cin, cout, k, s, 16, nt)]
                      if p is not None and p != plan}
        w_oik = w.permute(2, 1, 0).contiguous()
        ptrs = [v.data_ptr() for v in (x, w, b, gamma, beta)] + [None]
        want = conv_gn_reference(x, w, b, gamma, beta, stride=s, groups=16)
        scale = conv_gn_scale(x, w, b, gamma, beta, None, s, 16)

        def library():
            y = F.conv1d(F.pad(x.transpose(1, 2), (pad_l, pad_r)), w_oik, b,
                         stride=s)
            return F.gelu(F.group_norm(y, 16, gamma, beta, 1e-6),
                          approximate="tanh").transpose(1, 2)
        row = {"library": graph_ms(library, 10)}
        for vname, fn in fns.items():
            if not vname.startswith("k5bf16"):
                continue
            if vname.startswith("k5bf16old"):
                def call(fn=fn):
                    check(fn(*ptrs, out.data_ptr(), conv.data_ptr(),
                             partial.data_ptr(), stats.data_ptr(), bsz, t,
                             cin, cout, k, s, pad_l, t_out, 16, 1e-6, 1,
                             stream()))
            else:
                def call(fn=fn, plan=plan):
                    check(fn(*ptrs, out.data_ptr(), partial.data_ptr(),
                             stats.data_ptr(), bsz, t, cin, cout, k, s,
                             pad_l, t_out, 16, 1e-6, 1, *plan.args(),
                             stream()))
            row[vname] = graph_ms(call, 10)
            if vname in ("k5bf16", "k5bf16_gelu_tanh"):
                call()
                torch.cuda.synchronize()
                share, ulps = bf16_agreement(out, want, scale)
                row[f"{vname} share"], row[f"{vname} ulps"] = share, ulps
            if vname == "k5bf16":
                for alt, p in others.items():
                    row[f"k5bf16 fused {alt} mt{p.mt} {p.blocks} blocks"] = (
                        graph_ms(lambda p=p: call(plan=p), 10))
        row["library_2"] = graph_ms(library, 10)
        result[f"k5bf16 {name}"] = row
        print(f"[k5bf16] {name} ({bsz}, {t}, {cin}->{cout}, k={k}, s={s}): "
              + ", ".join(f"{k_} {v:.5f}" if k_.endswith(("share", "ulps"))
                          else f"{k_} {v:.4f} ms" for k_, v in row.items())
              + f" on {card}", flush=True)
    if any(n.startswith("k6bf16") for n in fns):
        b, n, c = BF16_K6_TIMED
        x = (torch.randn(b, n, c, device="cuda", generator=g) * 3.0).bfloat16()
        scale = (torch.rand(c, device="cuda", generator=g) * 1.5
                 + 0.5).bfloat16()
        y, env = torch.empty_like(x), torch.empty(b, n // 8, c, device="cuda",
                                                  dtype=torch.bfloat16)

        def library():
            yy = F.gelu(x * scale, approximate="tanh")
            e = F.avg_pool1d(x.abs().transpose(1, 2), 8).transpose(1, 2)
            return yy, torch.log1p(e)
        row = {"library": graph_ms(library, 20)}
        for vname, fn in fns.items():
            if vname.startswith("k6bf16"):
                def call(fn=fn):
                    check(fn(x.data_ptr(), scale.data_ptr(), y.data_ptr(),
                             env.data_ptr(), b * n, c, stream()))
                row[vname] = graph_ms(call, 20)
        row["library_2"] = graph_ms(library, 20)
        result[f"k6bf16 ({b}, {n}, {c})"] = row
        print(f"[k6bf16] ({b}, {n}, {c}): " + ", ".join(
            f"{k_} {v:.4f} ms" for k_, v in row.items()) + f" on {card}",
              flush=True)
    return result


def time_bf16(fns: dict, g, card: str) -> dict:
    """The bf16 forms' variants at chip_smoke.py's timed bf16 shapes, in
    turns with the bf16 library calls (scaled_dot_product_attention;
    layer_norm, two linear and silu)."""
    import torch.nn.functional as F

    from chip_smoke import BF16_ATTN_TIMED, BF16_FFN_TIMED, graph_ms

    def stream():   # the capturing stream inside a CUDA graph's capture
        return torch.cuda.current_stream().cuda_stream
    result = {}
    for b, t in BF16_ATTN_TIMED if any(n.startswith("k1bf16")
                                       for n in fns) else ():
        h, dh = 4, 64
        q, k, v = (torch.randn(b, t, h, dh, device="cuda", generator=g)
                   .bfloat16() for _ in range(3))
        qt, kt, vt = (y.transpose(1, 2).contiguous() for y in (q, k, v))
        out = torch.empty_like(q)
        sdpa = F.scaled_dot_product_attention
        row = {"library": graph_ms(lambda: sdpa(qt, kt, vt), 50)}
        for name, fn in fns.items():
            if name.startswith("k1bf16"):
                def call(fn=fn):
                    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                             out.data_ptr(), b, t, h, dh, dh ** -0.5,
                             stream())
                    if err != 0:
                        raise RuntimeError(f"launch failed: CUDA error {err}")
                row[name] = graph_ms(call, 50)
        row["library_2"] = graph_ms(lambda: sdpa(qt, kt, vt), 50)
        result[f"k1bf16 B={b},T={t}"] = row
        print(f"[k1bf16] B={b} T={t} H={h} dh={dh}: " + ", ".join(
            f"{k_} {v_:.4f} ms" for k_, v_ in row.items()) + f" on {card}",
              flush=True)
    for m in BF16_FFN_TIMED if any(n.startswith("k3bf16")
                                   for n in fns) else ():
        d, f = 256, 1024

        def r(*shape, scale=1.0, shift=0.0):
            return (shift + scale * torch.randn(*shape, device="cuda",
                                                generator=g)).bfloat16()
        x, ln_g, ln_b, w1, b1, w2, b2 = a = (
            r(m, d), r(d, scale=0.1, shift=1.0), r(d, scale=0.1),
            r(d, f, scale=d ** -0.5), r(f, scale=0.1),
            r(f, d, scale=f ** -0.5), r(d, scale=0.1))
        out = torch.empty_like(x)
        w1_oi, w2_oi = w1.t().contiguous(), w2.t().contiguous()

        def library():
            xn = F.layer_norm(x, (d,), ln_g, ln_b, 1e-6)
            return x + 0.5 * F.linear(F.silu(F.linear(xn, w1_oi, b1)), w2_oi,
                                      b2)
        row = {"library": graph_ms(library, 20)}
        for name, fn in fns.items():
            if name.startswith("k3bf16"):
                def call(fn=fn):
                    err = fn(*(t_.data_ptr() for t_ in a), out.data_ptr(), m,
                             d, f, stream())
                    if err != 0:
                        raise RuntimeError(f"launch failed: CUDA error {err}")
                row[name] = graph_ms(call, 20)
        row["library_2"] = graph_ms(library, 20)
        result[f"k3bf16 rows={m}"] = row
        print(f"[k3bf16] rows={m} d={d} d_ff={f}: " + ", ".join(
            f"{k_} {v_:.4f} ms" for k_, v_ in row.items()) + f" on {card}",
              flush=True)
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--kernels", default="k1,k3,k5,k1bf16,k3bf16",
                    help="which kernels' variants to build and time")
    ap.add_argument("--k5-baseline", default=None,
                    help="another conv_gn.cu to time beside K5's variants")
    ap.add_argument("--k4-baseline", default=None,
                    help="the earlier meddis.cu, built as it is and with parts "
                         "removed, beside K4's variants")
    ap.add_argument("--bf16-baseline", default=None,
                    help="an earlier csrc/ directory whose conv_gn.cu and "
                         "envact.cu the k5bf16old and k6bf16old variants "
                         "build")
    ap.add_argument("--sass", default=None,
                    help="write the SASS of the K4 libraries to this file")
    args = ap.parse_args()
    kernels = set(args.kernels.split(","))
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import torch.nn.functional as F

    from chip_smoke import graph_ms
    from sincformer_tpu_torch.ops import build
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = build_variants(os.path.join(build.BUILD_DIR, "ablation"), kernels,
                         args.k5_baseline, args.k4_baseline,
                         args.bf16_baseline)
    g = torch.Generator(device="cuda").manual_seed(0)
    result = {"card": card, "k3": {}, "k1": {}}
    if "k4" in kernels:
        result["k4"] = time_k4(fns, card, args.sass)
    if "k5" in kernels:
        torch.backends.cudnn.allow_tf32 = False
        result["k5"] = time_k5(fns, g, card)
    if kernels & {"k1bf16", "k3bf16"}:
        result["bf16"] = time_bf16(fns, g, card)
    if kernels & {"k5bf16", "k6bf16", "k5bf16old", "k6bf16old"}:
        result["k56bf16"] = time_k56bf16(fns, g, card)
    if "k6bf16" in kernels:
        counts = packed_sass(os.path.join(build.BUILD_DIR, "ablation",
                                          "libk6bf16.so"),
                             "envact_kernel_bf16_vec8")
        result["k6bf16_sass"] = counts
        print(f"[k6bf16] SASS of envact_kernel_bf16_vec8, packed bf16 "
              f"instructions: {counts['products']} products, "
              f"{counts['sums']} sums, {counts['fused']} fused "
              f"multiply-adds", flush=True)

    if "k3" in kernels:
        for m in (25664, 6416, 1):
            d, f = 256, 1024

            def r(*shape, scale=1.0):
                return torch.randn(*shape, device="cuda", generator=g) * scale
            x, ln_g, ln_b, w1, b1, w2, b2 = a = (
                r(m, d), 1.0 + r(d, scale=0.1), r(d, scale=0.1),
                r(d, f, scale=d ** -0.5), r(f, scale=0.1),
                r(f, d, scale=f ** -0.5), r(d, scale=0.1))
            out = torch.empty_like(x)
            w1_oi, w2_oi = w1.t().contiguous(), w2.t().contiguous()

            def library():
                xn = F.layer_norm(x, (d,), ln_g, ln_b, 1e-6)
                return x + 0.5 * F.linear(F.silu(F.linear(xn, w1_oi, b1)), w2_oi,
                                          b2)
            row = {"library": graph_ms(library, 20)}
            for name, fn in fns.items():
                if not name.startswith("k3"):
                    continue

                def call(fn=fn):
                    err = fn(*(t.data_ptr() for t in a), out.data_ptr(), m, d, f,
                             torch.cuda.current_stream().cuda_stream)
                    if err != 0:
                        raise RuntimeError(f"launch failed: CUDA error {err}")
                row[name] = graph_ms(call, 20)
            result["k3"][f"rows={m}"] = row
            print(f"[k3] rows={m} d={d} d_ff={f}: " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in row.items()) + f" on {card}",
                  flush=True)

        # K3 on the inputs that the fused DCSE model gives it in a 60 s request
        # (16 windows of 401 frames; seeded weights, as in chip_smoke.py),
        # against the same shapes filled with random values
        import numpy as np

        import sincformer_tpu_torch as port
        from sincformer_tpu_torch.models import conformer
        from sincformer_tpu_torch.ops.fused_ffn import fused_ffn
        from sincformer_tpu_torch.serve import StreamingEnhancer
        model = port.SpeechEnhancer(port.DCSEConfig(fused_ffn=True)).init_params(
            torch.Generator().manual_seed(0))
        pipe = port.DCSEPipeline(model, device="cuda")
        calls = []

        def recording(*call_args):
            calls.append(tuple(t.clone() for t in call_args))
            return fused_ffn(*call_args)
        pcm60 = np.round(np.random.default_rng(1).standard_normal(480000)
                         * 3000).clip(-32768, 32767).astype(np.int16)
        conformer.fused_ffn = recording
        try:
            StreamingEnhancer(pipe, pipelined=False).enhance(pcm60)
        finally:
            conformer.fused_ffn = fused_ffn
        model_ms = [graph_ms(lambda c=c: fused_ffn(*c), 20) for c in calls]
        x0 = calls[0][0]
        random_x = (torch.randn(x0.shape, device="cuda", generator=g),
                    *calls[0][1:])
        result["k3_model_inputs"] = {
            "rows": x0.numel() // x0.shape[-1], "calls": model_ms,
            "first_call_random_x": graph_ms(lambda: fused_ffn(*random_x), 20)}
        print(f"[k3] the fused DCSE model's {len(calls)} feed-forward calls of a "
              f"60 s request ({tuple(x0.shape)}): "
              + ", ".join(f"{t:.4f}" for t in model_ms) + " ms; the first with "
              f"random x {result['k3_model_inputs']['first_call_random_x']:.4f} "
              f"ms on {card}", flush=True)

    if "k1" in kernels:
        sdpa = torch.nn.functional.scaled_dot_product_attention
        for b, t in ((4, 400), (16, 401)):
            h, dh = 4, 64
            q, k, v = (torch.randn(b, t, h, dh, device="cuda", generator=g)
                       for _ in range(3))
            qt, kt, vt = (y.transpose(1, 2).contiguous() for y in (q, k, v))
            row = {"library": graph_ms(lambda: sdpa(qt, kt, vt), 50)}
            for name, fn in fns.items():
                if not name.startswith("k1"):
                    continue

                def call(fn=fn):
                    out = torch.empty_like(q)
                    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                             out.data_ptr(), b, t, h, dh, dh ** -0.5,
                             torch.cuda.current_stream().cuda_stream)
                    if err != 0:
                        raise RuntimeError(f"launch failed: CUDA error {err}")
                row[name] = graph_ms(call, 50)
            result["k1"][f"B={b},T={t}"] = row
            print(f"[k1] B={b} T={t} H={h} dh={dh}: " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in row.items()) + f" on {card}",
                  flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
