// Speech attention forward for Hopper (sm_90a): an f32 form on split-TF32
// tensor cores and a bf16 form (below, after the f32 form's launchers).
//
// Replaces the TPU kernel sincformer_tpu/ops/speech_attention.py::_attn_kernel
// (launched by _speech_attention_fwd). Same function, not a block-by-block
// copy: for every (batch, head, query row)
//     s_j = (q . k_j) * scale + bias[b, j]        (bias optional, 0 / -1e9)
//     o   = sum_j softmax(s)_j * v_j
// over all T keys, one f32 softmax per row. q, k, v, out are (B, T, H*dh)
// with the heads packed in the last dimension, as in the TPU kernel.
//
// Bound at the main-path shape (B=4, T=400, H=4, dh=64, D=256): 4*B*T^2*D
// = 0.66 GFLOP against 4*B*T*D*4 = 6.6 MB of traffic, so it is bound by
// operations: 9.8 us at 67 TFLOP/s on CUDA cores, 4.0 us for the three
// TF32 products per product at 495 TFLOP/s that f32-level results take on
// the tensor cores (tf32x3.cuh).
//
// Design: a block owns RW x 16 query rows of one (batch, head) and has
// RW x KW warps: warp (r, kw) takes the 16 rows r and, of every tile of 64
// keys, the 64 / KW keys kw. Each warp runs its own online softmax over its
// share of the keys; at the end the KW partial results of a row group are
// merged through shared memory (max, rescaled sums). Splitting the keys
// gives KW times the warps: one warp walking a row group alone spends most
// of its time waiting on its own chains of dependent tensor-core products.
// Blocks of 64 rows (RW = 4) are launched when B*H*ceil(T/64) fills the
// SMs, else blocks of 32 rows (RW = 2), so that small requests spread over
// twice the SMs. The block's Q rows stay in shared memory for the whole
// walk; tiles of 64 keys of K and V are copied there with cp.async, two
// buffers deep (tile i+1 in flight while tile i is used). Every tile is
// kept at a pitch of dh + 4 floats, so that the fragment loads of both
// products hit 32 distinct banks. Per tile a warp computes its S (16 x
// 64/KW) = Q.K^T, runs the online softmax in registers (row max and sum
// over the 4 lanes of a quad by __shfl_xor_sync; the running sum stays per
// lane until the end), takes the tile's P.V (16 x dh) in fresh
// accumulators and adds it to the rescaled O in f32. The tensor cores add
// into their accumulator by truncation, so a sum carried through every tile
// of a long walk (33 tiles at T = 2100) drifts: the fresh accumulators bound
// that to one tile and leave the sum across tiles to round-to-nearest f32
// additions.
//
// P goes from the accumulator layout into the A operand of P.V without a
// shuffle: a lane holds S columns 2t and 2t+1 of each 8-key block, and the
// A fragment wants columns t and t+4. The sum over keys does not depend on
// their order, so P.V reads the 8 keys of a block in the order
// (0, 2, 4, 6, 1, 3, 5, 7): A column t is key 2t, column t+4 is key 2t+1,
// and the lane loads V rows 2t and 2t+1 as its B fragment to match.
//
// Keys past T are zero-filled in shared memory and carry a score of -inf
// (probability 0), as in the unpadded reference. A warp whose share of a
// tile lies wholly past T keeps its running max (or -inf, if it has seen no
// key yet: its sums stay 0 and weigh nothing in the merge, since key 0 is
// in warp kw = 0's share). Any T runs in fixed shared memory: this covers
// the T > 2048 range that the JAX dispatch sends to its flash kernel. Every
// product is a 3xTF32 tensor-core product; softmax, scale and bias stay f32
// on the CUDA cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "tf32x3.cuh"
#include "wgmma.cuh"

namespace {

using tf32x3::cp_async16;
using tf32x3::mma3;
using tf32x3::split;

constexpr int kKeys = 64;     // keys per tile
constexpr int KW = 2;         // warps that share a row group's keys

// shared memory of a block: Q rows, K and V tiles (two buffers each), bias
template <int DH, int RW>
constexpr int smem_bytes() {
  return ((RW * 16 + 4 * kKeys) * (DH + 4) + 2 * kKeys) * (int)sizeof(float);
}

template <int DH, int RW>
__global__ void __launch_bounds__(RW * KW * 32)
speech_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ bias,
                        float* __restrict__ out,
                        int T, int H, float scale) {
  constexpr int kThreads = RW * KW * 32;
  constexpr int P = DH + 4;         // row pitch of the Q, K and V tiles
  constexpr int KS = DH / 8;        // k-steps of Q.K^T, n-tiles of P.V
  constexpr int NT = kKeys / 8 / KW;  // n-tiles of a warp's S, k-steps of P.V
  constexpr int kRed = 4 * KS + 5;  // floats a lane leaves for the merge
  static_assert(RW * (KW - 1) * 32 * kRed <= 4 * kKeys * P,
                "the merge must fit in the K and V buffers");
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // [RW * 16][P]
  float* ks = qs + RW * 16 * P;           // [2][kKeys][P]
  float* vs = ks + 2 * kKeys * P;         // [2][kKeys][P]
  float* bs = vs + 2 * kKeys * P;         // [2][kKeys]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rw = warp % RW;               // row group
  const int kw = warp / RW;               // share of each tile's keys
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long D = (long long)H * DH;
  const long long head = (long long)b * T * D + (long long)h * DH;
  const int q0 = blockIdx.x * (RW * 16);
  const int r_lo = q0 + rw * 16 + g;
  const int r_hi = r_lo + 8;

  // copies of the tile of keys k0..k0+63 into buffer `buf`
  auto stage = [&](int buf, int k0) {
    constexpr int kVec = DH / 4;
    float* kd = ks + buf * kKeys * P;
    float* vd = vs + buf * kKeys * P;
    for (int i = tid; i < kKeys * kVec; i += kThreads) {
      const int j = i / kVec;
      const int c = i - j * kVec;
      const int key = k0 + j;
      const bool ok = key < T;
      const long long off = ok ? head + (long long)key * D + 4 * c : 0;
      cp_async16(kd + j * P + 4 * c, k + off, ok);
      cp_async16(vd + j * P + 4 * c, v + off, ok);
    }
    for (int j = tid; j < kKeys; j += kThreads) {
      const int key = k0 + j;
      bs[buf * kKeys + j] =
          key < T ? (bias != nullptr ? bias[(long long)b * T + key] : 0.f)
                  : -INFINITY;
    }
    tf32x3::cp_async_commit();
  };

  // the block's query rows (zeros past T) join the first tile's copies
  for (int i = tid; i < RW * 16 * (DH / 4); i += kThreads) {
    const int r = i / (DH / 4);
    const int c = i - r * (DH / 4);
    const bool ok = q0 + r < T;
    cp_async16(qs + r * P + 4 * c,
               q + (ok ? head + (long long)(q0 + r) * D + 4 * c : 0), ok);
  }
  const int n_tiles = (T + kKeys - 1) / kKeys;
  stage(0, 0);
  // A fragments of Q read from here: rows g and g + 8 of the warp's 16
  const float* qr = qs + (rw * 16 + g) * P + t;
  const int key0 = kw * (kKeys / KW);     // the warp's keys in a tile

  float o[KS][4];
#pragma unroll
  for (int nd = 0; nd < KS; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nd][i] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;   // running max of rows g, g+8
  float l_lo = 0.f, l_hi = 0.f;               // this lane's part of the sums

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      stage((it + 1) & 1, (it + 1) * kKeys);
      tf32x3::cp_async_wait<1>();
    } else {
      tf32x3::cp_async_wait<0>();
    }
    __syncthreads();   // tile it is in shared memory for every thread
    const float* kt = ks + (it & 1) * kKeys * P + key0 * P;
    const float* vt = vs + (it & 1) * kKeys * P + key0 * P;
    const float* bt = bs + (it & 1) * kKeys + key0;

    // S = Q . K^T: B fragment b0 = K[8nt + g][8kk + t], b1 = ...[+ 4]
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ah[4], al[4];
      split(qr[8 * kk], ah[0], al[0]);
      split(qr[8 * P + 8 * kk], ah[1], al[1]);
      split(qr[8 * kk + 4], ah[2], al[2]);
      split(qr[8 * P + 8 * kk + 4], ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* kr = kt + (8 * nt + g) * P + 8 * kk + t;
        uint32_t bh[2], bl[2];
        split(kr[0], bh[0], bl[0]);
        split(kr[4], bh[1], bl[1]);
        mma3(s[nt], ah, al, bh, bl);
      }
    }

    // online softmax over this tile, rows g (s0, s1) and g + 8 (s2, s3)
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float b0 = bt[8 * nt + 2 * t];
      const float b1 = bt[8 * nt + 2 * t + 1];
      s[nt][0] = s[nt][0] * scale + b0;
      s[nt][1] = s[nt][1] * scale + b1;
      s[nt][2] = s[nt][2] * scale + b0;
      s[nt][3] = s[nt][3] * scale + b1;
      mx_lo = fmaxf(mx_lo, fmaxf(s[nt][0], s[nt][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o_));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o_));
    }
    // no key yet for this warp: exponents against 0 give p = 0, corr = 0
    const float mn_lo = fmaxf(m_lo, mx_lo);
    const float mn_hi = fmaxf(m_hi, mx_hi);
    const float base_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
    const float base_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
    const float corr_lo = expf(m_lo - base_lo);
    const float corr_hi = expf(m_hi - base_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    l_lo *= corr_lo;
    l_hi *= corr_hi;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = expf(s[nt][0] - base_lo);
      s[nt][1] = expf(s[nt][1] - base_lo);
      s[nt][2] = expf(s[nt][2] - base_hi);
      s[nt][3] = expf(s[nt][3] - base_hi);
      l_lo += s[nt][0] + s[nt][1];
      l_hi += s[nt][2] + s[nt][3];
    }

    // this tile's P . V over the 8-key blocks, keys in the order
    // 0,2,4,6,1,3,5,7: A (g, t) = P(g, 2t), A (g, t+4) = P(g, 2t+1); B rows
    // to match
    float pv[KS][4];
#pragma unroll
    for (int nd = 0; nd < KS; ++nd)
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[nd][i] = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t ah[4], al[4];
      split(s[nt][0], ah[0], al[0]);
      split(s[nt][2], ah[1], al[1]);
      split(s[nt][1], ah[2], al[2]);
      split(s[nt][3], ah[3], al[3]);
      const float* vr = vt + (8 * nt + 2 * t) * P + g;
#pragma unroll
      for (int nd = 0; nd < KS; ++nd) {
        uint32_t bh[2], bl[2];
        split(vr[8 * nd], bh[0], bl[0]);
        split(vr[P + 8 * nd], bh[1], bl[1]);
        mma3(pv[nd], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int nd = 0; nd < KS; ++nd) {
      o[nd][0] = fmaf(o[nd][0], corr_lo, pv[nd][0]);
      o[nd][1] = fmaf(o[nd][1], corr_lo, pv[nd][1]);
      o[nd][2] = fmaf(o[nd][2], corr_hi, pv[nd][2]);
      o[nd][3] = fmaf(o[nd][3], corr_hi, pv[nd][3]);
    }
    __syncthreads();   // buffer it & 1 is free for tile it + 2
  }

#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, o_);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, o_);
  }
  // merge the key shares of each row group: the K and V buffers are free
  // (the loop ended on a barrier); a lane's values sit at a stride of
  // kRed (odd) floats, so the lanes of a warp hit distinct banks
  float* red = ks;
  if (kw > 0) {
    float* mine = red + ((rw * (KW - 1) + kw - 1) * 32 + lane) * kRed;
#pragma unroll
    for (int nd = 0; nd < KS; ++nd)
#pragma unroll
      for (int i = 0; i < 4; ++i) mine[4 * nd + i] = o[nd][i];
    mine[4 * KS] = m_lo;
    mine[4 * KS + 1] = m_hi;
    mine[4 * KS + 2] = l_lo;
    mine[4 * KS + 3] = l_hi;
  }
  __syncthreads();
  if (kw > 0) return;
  // key 0 is in this warp's share, so m_lo and m_hi are finite
  float mm_lo = m_lo, mm_hi = m_hi;
#pragma unroll
  for (int j = 1; j < KW; ++j) {
    const float* other = red + ((rw * (KW - 1) + j - 1) * 32 + lane) * kRed;
    mm_lo = fmaxf(mm_lo, other[4 * KS]);
    mm_hi = fmaxf(mm_hi, other[4 * KS + 1]);
  }
  float c_lo = expf(m_lo - mm_lo), c_hi = expf(m_hi - mm_hi);
  l_lo *= c_lo;
  l_hi *= c_hi;
#pragma unroll
  for (int nd = 0; nd < KS; ++nd) {
    o[nd][0] *= c_lo;
    o[nd][1] *= c_lo;
    o[nd][2] *= c_hi;
    o[nd][3] *= c_hi;
  }
#pragma unroll
  for (int j = 1; j < KW; ++j) {
    const float* other = red + ((rw * (KW - 1) + j - 1) * 32 + lane) * kRed;
    c_lo = expf(other[4 * KS] - mm_lo);
    c_hi = expf(other[4 * KS + 1] - mm_hi);
    l_lo = fmaf(other[4 * KS + 2], c_lo, l_lo);
    l_hi = fmaf(other[4 * KS + 3], c_hi, l_hi);
#pragma unroll
    for (int nd = 0; nd < KS; ++nd) {
      o[nd][0] = fmaf(other[4 * nd], c_lo, o[nd][0]);
      o[nd][1] = fmaf(other[4 * nd + 1], c_lo, o[nd][1]);
      o[nd][2] = fmaf(other[4 * nd + 2], c_hi, o[nd][2]);
      o[nd][3] = fmaf(other[4 * nd + 3], c_hi, o[nd][3]);
    }
  }

  const float inv_lo = 1.f / l_lo;
  const float inv_hi = 1.f / l_hi;
#pragma unroll
  for (int nd = 0; nd < KS; ++nd) {
    const int c = 8 * nd + 2 * t;
    if (r_lo < T) {
      *reinterpret_cast<float2*>(out + head + (long long)r_lo * D + c) =
          make_float2(o[nd][0] * inv_lo, o[nd][1] * inv_lo);
    }
    if (r_hi < T) {
      *reinterpret_cast<float2*>(out + head + (long long)r_hi * D + c) =
          make_float2(o[nd][2] * inv_hi, o[nd][3] * inv_hi);
    }
  }
}

template <int DH, int RW>
int launch(const float* q, const float* k, const float* v, const float* bias,
           float* out, int B, int T, int H, float scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DH, RW>();
  static int ready[64];
  const cudaError_t err = tf32x3::allow_smem(
      speech_attention_kernel<DH, RW>, smem, ready);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + RW * 16 - 1) / (RW * 16), H, B);
  speech_attention_kernel<DH, RW><<<grid, RW * KW * 32, smem, stream>>>(
      q, k, v, bias, out, T, H, scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_dh(const float* q, const float* k, const float* v,
              const float* bias, float* out, int B, int T, int H, float scale,
              cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return (int)err;
  const long long blocks64 = (long long)B * H * ((T + 63) / 64);
  return blocks64 >= sms
      ? launch<DH, 4>(q, k, v, bias, out, B, T, H, scale, stream)
      : launch<DH, 2>(q, k, v, bias, out, B, T, H, scale, stream);
}


// ── The bf16 form ──────────────────────────────────────────────────────────
//
// For bfloat16 q, k, v the function is the JAX package's _reference in bf16
// (sincformer_tpu/ops/speech_attention.py): S = Q.K^T * scale + bias and the
// softmax in f32, the normalised P rounded to bf16, O = P.V accumulated in
// f32 and rounded once to bf16. P is normalised before it is rounded, so
// every row's max m and sum l must be known before any P.V: the online
// softmax of the f32 form does not give this function.
//
// Bound at the main path's shapes (dh 64, H 4): (4, 400) 0.655 GFLOP is
// 0.66 us at 989 TFLOP/s, 3.28 MB 0.98 us at 3.35 TB/s; (16, 401) 2.63
// GFLOP and 13.1 MB, 2.66 and 3.92 us: bound by bytes. The work is small
// and comes in 64-row tiles, so what limits it is how much of a tile's work
// overlaps: staging K and V, the products, the exp of every score (one
// MUFU operation each) and the two merges of each row's max and sum.
//
// Design. Each row's S is computed once and kept in registers from its
// product to P, the keys split between warps (or warpgroups) so that it
// fits; the row maxima, sums and partial O are merged through shared
// memory, in warp order. A block owns one (batch, head): K and V are copied
// to shared memory once (cp.async, zeros past T, V in a second group that
// arrives under the first scores) and the block walks its row tiles on that
// copy; the launcher gives each (batch, head) as many blocks as the SMs
// allow, at most one a tile.
//  * dh 64 (attention_bf16_wgmma): four warpgroups share each 64-row tile,
//    warpgroup kw taking 112 keys; S = Q.K^T and O = P.V are wgmma products
//    on Q, K and V in 128-byte-swizzled rows (wgmma.cuh); P goes from S's
//    accumulator to the A registers of P.V.
//  * dh 16, 32, 128 (attention_bf16_resident): RG x KW warps, warp (rg, kw)
//    taking the 16 rows of group rg against the 16-key blocks kw, kw + KW,
//    ... (interleaved, so the warps' shares stay within one block of each
//    other): mma.sync.m16n8k16 products, K's B operands by ldmatrix.x4, V's
//    by ldmatrix.x4.trans, rows at a pitch of dh + 8 bf16 (conflict-free
//    ldmatrix phases). S's accumulator layout is the A layout of P.V.
//  * T past the registers (448; dh 128: 256, where shared memory ends):
//    attention_bf16_tiled, the same warps over tiles of KW x 32 keys, two
//    buffers deep: pass 1 takes each warp's running max and rescaled sum,
//    merged at the end; pass 2 recomputes the same S bits and adds each
//    tile's P.V, in fresh accumulators, to O in f32 (the tensor cores add
//    into an accumulator by truncation: a sum carried through many tiles
//    would drift).
// S = Q.K^T * scale + bias is a rounded product, then a rounded sum, exp is
// expf, and P = exp(s - m) * (1 / l), one reciprocal a row: an IEEE
// division for every score compiles to a branch each, which keeps the
// scores' chains from overlapping (measured: 0.0414 against 0.0229 ms at
// (16, 401)). Keys past T carry a score of -inf; queries past T are
// computed on zeros and not stored.
//
// On an H100 80GB HBM3, 700.00 W (scripts/torch_kernel_ablation.py
// --kernels k1bf16, CUDA-graph replays): 0.0080 ms at (4, 400) against
// SDPA bf16's 0.0110, 0.0229 at (16, 401) against 0.0171, 0.0130 at (8, 401)
// against 0.0113, 0.1534 at (128, 401) against 0.1021. At (16, 401), by
// ablation, the products take 0.0048 ms, the softmax 0.0058 and the staging
// of K and V 0.0029 (at (128, 401): 0.032, 0.041, 0.025): a tile's phases
// run one after another on its SM, where SDPA's online softmax overlaps
// them. dh 64 is the head width of every model configuration (d_model 256,
// 4 heads); there the warp form takes 0.0285 ms at (16, 401) and 0.1868 at
// (128, 401), so dh 64 keeps its warpgroup form.

using bf16 = __nv_bfloat16;

// d += a . b, one bf16 tensor-core product (16 x 8 x 16, f32 accumulators)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats rounded to bf16 and packed, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four 8 x 8 bf16 matrices from shared memory: lanes 8i .. 8i + 7 give the
// addresses of matrix i's eight rows; lane l receives in r[i] row l / 4,
// columns 2 (l % 4) and 2 (l % 4) + 1 of matrix i (with .trans: column
// l / 4, rows 2 (l % 4) and 2 (l % 4) + 1)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

constexpr int kKB = 16;   // keys per key block (one k-step of P.V)

// A fragments of 16 query rows (row 0 at q16, pitch P), one per 16-wide
// k-step: matrices rows 0-7 / 8-15 of columns 0-7, then of columns 8-15
template <int DH, int P>
__device__ __forceinline__ void load_q(uint32_t (&qa)[DH / 16][4],
                                       const bf16* q16, int lane) {
  const bf16* p = q16 + ((lane >> 3 & 1) * 8 + (lane & 7)) * P +
                  (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) ldsm_x4(qa[kk], p + 16 * kk);
}

// S = Q.K^T * scale + bias (f32) of 16 query rows (A fragments qa) against
// the key blocks j = 0 .. nj - 1 of a warp, block j's keys at kb + j *
// kb_step (pitch P) and its bias at b16 + j * b_step; blocks j >= nj get
// -inf. The k-steps are the outer loop, so the products of one step are
// independent of each other.
template <int DH, int P, int NJ>
__device__ __forceinline__ void warp_scores(float (&s)[NJ][2][4],
                                            const uint32_t (&qa)[DH / 16][4],
                                            const bf16* kb, int kb_step,
                                            const float* b16, int b_step,
                                            int nj, float scale, int lane) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][n][e] = 0.f;
  // matrices: keys 0-7 of columns 0-7, 8-15; keys 8-15 of the same
  const bf16* p = kb + ((lane >> 4) * 8 + (lane & 7)) * P +
                  (lane >> 3 & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < nj) {
        uint32_t r[4];
        ldsm_x4(r, p + j * kb_step + 16 * kk);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_bf16(s[j][0], qa[kk], b0);
        mma_bf16(s[j][1], qa[kk], b1);
      }
    }
  }
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      if (j < nj) {
        const float* bj = b16 + j * b_step + 8 * n + 2 * t;
        s[j][n][0] = __fadd_rn(__fmul_rn(s[j][n][0], scale), bj[0]);
        s[j][n][1] = __fadd_rn(__fmul_rn(s[j][n][1], scale), bj[1]);
        s[j][n][2] = __fadd_rn(__fmul_rn(s[j][n][2], scale), bj[0]);
        s[j][n][3] = __fadd_rn(__fmul_rn(s[j][n][3], scale), bj[1]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][n][e] = -INFINITY;
      }
    }
  }
}

// o += P . V over one key block (key 0 at vb, pitch P); pa the block's P
template <int DH, int P>
__device__ __forceinline__ void block_pv(float (&o)[DH / 8][4],
                                         const uint32_t (&pa)[4],
                                         const bf16* vb, int lane) {
  // matrices: keys 0-7 / 8-15 of columns 0-7, then of columns 8-15
  const bf16* p = vb + ((lane >> 3 & 1) * 8 + (lane & 7)) * P +
                  (lane >> 4) * 8;
#pragma unroll
  for (int nd = 0; nd < DH / 8; nd += 2) {
    uint32_t r[4];
    ldsm_x4_t(r, p + 8 * nd);
    const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
    mma_bf16(o[nd], pa, b0);
    mma_bf16(o[nd + 1], pa, b1);
  }
}

// exp of a shifted score, as the plain version's softmax takes it (ex2.approx
// of x log2(e) saves a third of the softmax's instructions but rounds some P
// apart from the plain version's: 1 bf16 ulp at the term scale measured)
__device__ __forceinline__ float softmax_exp(float x) { return expf(x); }

// two neighbouring P of a row: exp(s - m) times the row's 1 / l, rounded to
// bf16 and packed
__device__ __forceinline__ uint32_t p_pair(float e0, float e1, float il) {
  return pack_bf16(e0 * il, e1 * il);
}

// P of one key block from its exp(s - m) (rows g: lo, g + 8: hi), in the A
// layout of P.V
__device__ __forceinline__ void block_p(uint32_t (&pa)[4],
                                        const float (&e)[2][4], float il_lo,
                                        float il_hi) {
  pa[0] = p_pair(e[0][0], e[0][1], il_lo);
  pa[1] = p_pair(e[0][2], e[0][3], il_hi);
  pa[2] = p_pair(e[1][0], e[1][1], il_lo);
  pa[3] = p_pair(e[1][2], e[1][3], il_hi);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// the KW warps of row group rg wait for each other (named barrier 1 + rg)
template <int KW>
__device__ __forceinline__ void sync_rows(int rg) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + rg), "n"(KW * 32) : "memory");
}

// The KW partial O of row group rg, added in warp order through `red` (KW
// - 1 slots of 32 lanes, free on entry) and stored, rounded once to bf16,
// by warp kw = 0.
template <int DH, int KW>
__device__ __forceinline__ void merge_and_store(float (&o)[DH / 8][4],
                                                float* red, int rg, int kw,
                                                int lane, bf16* out,
                                                long long head, long long D,
                                                int r_lo, int T) {
  constexpr int ND = DH / 8;
  constexpr int kRed = 4 * ND + 1;   // odd: a warp's lanes hit distinct banks
  if (kw > 0) {
    float* mine = red + ((kw - 1) * 32 + lane) * kRed;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[4 * nd + e] = o[nd][e];
  }
  sync_rows<KW>(rg);
  if (kw > 0) return;
#pragma unroll
  for (int w = 1; w < KW; ++w) {
    const float* other = red + ((w - 1) * 32 + lane) * kRed;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] += other[4 * nd + e];
  }
  const int r_hi = r_lo + 8;
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int c = 8 * nd + c0;
    if (r_lo < T) {
      *reinterpret_cast<__nv_bfloat162*>(out + head + (long long)r_lo * D +
                                         c) =
          __floats2bfloat162_rn(o[nd][0], o[nd][1]);
    }
    if (r_hi < T) {
      *reinterpret_cast<__nv_bfloat162*>(out + head + (long long)r_hi * D +
                                         c) =
          __floats2bfloat162_rn(o[nd][2], o[nd][3]);
    }
  }
}

// floats of the partial-O slots of one row group
template <int DH, int KW>
__host__ __device__ constexpr int red_floats() {
  return (KW - 1) * 32 * (DH / 2 + 1);
}

// shared memory of the resident form for `keys` staged keys (a multiple of
// 16): K and V, two buffers of each row group's Q rows, the partial-O
// slots, the bias, the merge slots of the row maxima and sums
template <int DH, int RG, int KW>
constexpr int resident_smem(int keys) {
  return (2 * keys + RG * 2 * 16) * (DH + 8) * (int)sizeof(bf16) +
         (RG * red_floats<DH, KW>() + keys + 2 * RG * KW * 16) *
             (int)sizeof(float);
}

template <int DH, int RG, int KW, int NJ>
__global__ void __launch_bounds__(RG * KW * 32, 1)
attention_bf16_resident(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const float* __restrict__ bias,
                        bf16* __restrict__ out, int T, int H, float scale) {
  constexpr int kThreads = RG * KW * 32;
  constexpr int P = DH + 8;        // row pitch of Q, K and V (bf16)
  constexpr int kVec = DH / 8;     // 16-byte pieces of a row
  constexpr int ND = DH / 8;       // n-tiles of P.V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nkb = (T + kKB - 1) / kKB;
  const int keys = nkb * kKB;
  const int n_tiles = (T + RG * 16 - 1) / (RG * 16);
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);    // [keys][P]
  bf16* vs = ks + keys * P;                         // [keys][P]
  bf16* qs = vs + keys * P;                         // [RG][2][16][P]
  float* red = reinterpret_cast<float*>(qs + RG * 2 * 16 * P);
  float* bs = red + RG * red_floats<DH, KW>();      // [keys]
  float* mred = bs + keys;                          // [RG][KW][16]
  float* lred = mred + RG * KW * 16;                // [RG][KW][16]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rg = warp % RG;
  const int kw = warp / RG;
  const int rt = kw * 32 + lane;   // thread of the row group
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long D = (long long)H * DH;
  const long long head = (long long)b * T * D + (long long)h * DH;

  // the row group's 16 rows of a tile (zeros past T) into Q buffer `buf`
  auto stage_q = [&](int tile, int buf) {
    bf16* dst = qs + (rg * 2 + buf) * 16 * P;
    const int r0 = tile * (RG * 16) + rg * 16;
    for (int i = rt; i < 16 * kVec; i += KW * 32) {
      const int r = i / kVec;
      const int c = i - r * kVec;
      const bool ok = r0 + r < T;
      tf32x3::cp_async16(dst + r * P + 8 * c,
                         q + (ok ? head + (long long)(r0 + r) * D + 8 * c : 0),
                         ok);
    }
  };
  // K and V of the (batch, head), zeros past T
  auto stage_kv = [&](bf16* dst, const bf16* src) {
    for (int i = tid; i < keys * kVec; i += kThreads) {
      const int j = i / kVec;
      const int c = i - j * kVec;
      const bool ok = j < T;
      tf32x3::cp_async16(dst + j * P + 8 * c,
                         src + (ok ? head + (long long)j * D + 8 * c : 0), ok);
    }
  };

  // group 1: K, the bias (-inf past T), the first tile's Q; group 2: V
  stage_kv(ks, k);
  for (int j = tid; j < keys; j += kThreads) {
    bs[j] = j < T ? (bias != nullptr ? bias[(long long)b * T + j] : 0.f)
                  : -INFINITY;
  }
  stage_q(blockIdx.x, 0);
  tf32x3::cp_async_commit();
  stage_kv(vs, v);
  tf32x3::cp_async_commit();
  tf32x3::cp_async_wait<1>();
  __syncthreads();   // K, the bias and the first Q are in for every thread

  const int nj = (nkb - kw + KW - 1) / KW;   // this warp's key blocks
  float* mrow = mred + rg * KW * 16;
  float* lrow = lred + rg * KW * 16;
  bool first = true;
  int buf = 0;
  for (int tile = blockIdx.x; tile < n_tiles;
       tile += gridDim.x, buf ^= 1) {
    if (tile + (int)gridDim.x < n_tiles) stage_q(tile + gridDim.x, buf ^ 1);
    tf32x3::cp_async_commit();

    // S of the warp's key blocks, kept in registers; the row maxima
    float s[NJ][2][4];
    {
      uint32_t qa[DH / 16][4];
      load_q<DH, P>(qa, qs + (rg * 2 + buf) * 16 * P, lane);
      warp_scores<DH, P, NJ>(s, qa, ks + kw * kKB * P, KW * kKB * P,
                             bs + kw * kKB, KW * kKB, nj, scale, lane);
    }
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[j][n][0], s[j][n][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[j][n][2], s[j][n][3]));
      }
    mx_lo = quad_max(mx_lo);
    mx_hi = quad_max(mx_hi);
    if (t == 0) {
      mrow[kw * 16 + g] = mx_lo;
      mrow[kw * 16 + g + 8] = mx_hi;
    }
    sync_rows<KW>(rg);
    // the row max over every key (finite: key 0 is in warp 0's share)
    float m_lo = mrow[g], m_hi = mrow[g + 8];
#pragma unroll
    for (int w = 1; w < KW; ++w) {
      m_lo = fmaxf(m_lo, mrow[w * 16 + g]);
      m_hi = fmaxf(m_hi, mrow[w * 16 + g + 8]);
    }
    // exp(s - m) in place; this warp's part of the row sums
    float l_lo = 0.f, l_hi = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < nj) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          s[j][n][0] = softmax_exp(s[j][n][0] - m_lo);
          s[j][n][1] = softmax_exp(s[j][n][1] - m_lo);
          s[j][n][2] = softmax_exp(s[j][n][2] - m_hi);
          s[j][n][3] = softmax_exp(s[j][n][3] - m_hi);
          l_lo += s[j][n][0] + s[j][n][1];
          l_hi += s[j][n][2] + s[j][n][3];
        }
      }
    }
    l_lo = quad_sum(l_lo);
    l_hi = quad_sum(l_hi);
    if (t == 0) {
      lrow[kw * 16 + g] = l_lo;
      lrow[kw * 16 + g + 8] = l_hi;
    }
    if (first) {   // V (group 2; the next Q may still be in flight)
      tf32x3::cp_async_wait<1>();
      __syncthreads();
      first = false;
    } else {
      sync_rows<KW>(rg);
    }
    l_lo = lrow[g];
    l_hi = lrow[g + 8];
#pragma unroll
    for (int w = 1; w < KW; ++w) {
      l_lo += lrow[w * 16 + g];
      l_hi += lrow[w * 16 + g + 8];
    }
    const float il_lo = 1.f / l_lo, il_hi = 1.f / l_hi;

    // O = P . V over the warp's key blocks
    float o[ND][4];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < nj) {
        uint32_t pa[4];
        block_p(pa, s[j], il_lo, il_hi);
        block_pv<DH, P>(o, pa, vs + (kw + KW * j) * kKB * P, lane);
      }
    }
    merge_and_store<DH, KW>(o, red + rg * red_floats<DH, KW>(), rg, kw, lane,
                            out, head, D, tile * (RG * 16) + rg * 16 + g, T);
    // the next tile's Q is in; the merge slots and partial O are free
    tf32x3::cp_async_wait<0>();
    sync_rows<KW>(rg);
  }
}

// shared memory of the tiled form: Q, two buffers of K and V tiles, the
// partial-O slots, the tiles' bias, the merge slots
template <int DH, int RG, int KW>
constexpr int tiled_smem() {
  return (RG * 16 + 4 * KW * 2 * kKB) * (DH + 8) * (int)sizeof(bf16) +
         (RG * red_floats<DH, KW>() + 2 * KW * 2 * kKB + 2 * RG * KW * 16) *
             (int)sizeof(float);
}

template <int DH, int RG, int KW>
__global__ void __launch_bounds__(RG * KW * 32, 1)
attention_bf16_tiled(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const float* __restrict__ bias, bf16* __restrict__ out,
                     int T, int H, float scale) {
  constexpr int kThreads = RG * KW * 32;
  constexpr int P = DH + 8;
  constexpr int kVec = DH / 8;
  constexpr int ND = DH / 8;
  constexpr int kTile = KW * 2 * kKB;   // keys per tile: two blocks a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [RG * 16][P]
  bf16* ks = qs + RG * 16 * P;                     // [2][kTile][P]
  bf16* vs = ks + 2 * kTile * P;                   // [2][kTile][P]
  float* red = reinterpret_cast<float*>(vs + 2 * kTile * P);
  float* bs = red + RG * red_floats<DH, KW>();     // [2][kTile]
  float* mred = bs + 2 * kTile;                    // [RG][KW][16]
  float* lred = mred + RG * KW * 16;               // [RG][KW][16]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rg = warp % RG;
  const int kw = warp / RG;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long D = (long long)H * DH;
  const long long head = (long long)b * T * D + (long long)h * DH;
  const int q0 = blockIdx.x * (RG * 16);
  const int n_tiles = (T + kTile - 1) / kTile;

  // copies of the tile of keys k0.. into buffer `buf` (V only in pass 2)
  auto stage = [&](int buf, int k0, bool with_v) {
    bf16* kd = ks + buf * kTile * P;
    bf16* vd = vs + buf * kTile * P;
    for (int i = tid; i < kTile * kVec; i += kThreads) {
      const int j = i / kVec;
      const int c = i - j * kVec;
      const int key = k0 + j;
      const bool ok = key < T;
      const long long off = ok ? head + (long long)key * D + 8 * c : 0;
      tf32x3::cp_async16(kd + j * P + 8 * c, k + off, ok);
      if (with_v) tf32x3::cp_async16(vd + j * P + 8 * c, v + off, ok);
    }
    for (int j = tid; j < kTile; j += kThreads) {
      const int key = k0 + j;
      bs[buf * kTile + j] =
          key < T ? (bias != nullptr ? bias[(long long)b * T + key] : 0.f)
                  : -INFINITY;
    }
    tf32x3::cp_async_commit();
  };
  // S of the warp's two key blocks of the tile in buffer `buf`
  auto scores = [&](int buf, const uint32_t (&qa)[DH / 16][4],
                    float (&s)[2][2][4]) {
    warp_scores<DH, P, 2>(s, qa, ks + (buf * kTile + kw * kKB) * P,
                          KW * kKB * P, bs + buf * kTile + kw * kKB, KW * kKB,
                          2, scale, lane);
  };

  // the block's query rows (zeros past T) join the first tile's copies
  for (int i = tid; i < RG * 16 * kVec; i += kThreads) {
    const int r = i / kVec;
    const int c = i - r * kVec;
    const bool ok = q0 + r < T;
    tf32x3::cp_async16(qs + r * P + 8 * c,
                       q + (ok ? head + (long long)(q0 + r) * D + 8 * c : 0),
                       ok);
  }
  uint32_t qa[DH / 16][4];

  // ── pass 1: this warp's running max and rescaled sum of each row ──
  float m_lo = -INFINITY, m_hi = -INFINITY;
  float l_lo = 0.f, l_hi = 0.f;     // this lane's part of the sums
  stage(0, 0, false);
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      stage((it + 1) & 1, (it + 1) * kTile, false);
      tf32x3::cp_async_wait<1>();
    } else {
      tf32x3::cp_async_wait<0>();
    }
    __syncthreads();   // tile it (and, the first time, Q) is in
    if (it == 0) load_q<DH, P>(qa, qs + rg * 16 * P, lane);
    float s[2][2][4];
    scores(it & 1, qa, s);
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[j][n][0], s[j][n][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[j][n][2], s[j][n][3]));
      }
    const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
    const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
    // no key yet for this warp: exponents against 0 give 0
    const float base_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
    const float base_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
    l_lo *= softmax_exp(m_lo - base_lo);
    l_hi *= softmax_exp(m_hi - base_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        l_lo += softmax_exp(s[j][n][0] - base_lo) +
                softmax_exp(s[j][n][1] - base_lo);
        l_hi += softmax_exp(s[j][n][2] - base_hi) +
                softmax_exp(s[j][n][3] - base_hi);
      }
    __syncthreads();   // buffer it & 1 is free for tile it + 2
  }
  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);
  float* mrow = mred + rg * KW * 16;
  float* lrow = lred + rg * KW * 16;
  if (t == 0) {
    mrow[kw * 16 + g] = m_lo;
    mrow[kw * 16 + g + 8] = m_hi;
    lrow[kw * 16 + g] = l_lo;
    lrow[kw * 16 + g + 8] = l_hi;
  }
  __syncthreads();
  // the row max over every key (finite: key 0 is in warp 0's share), and
  // the warps' sums rescaled to it, added in warp order
  m_lo = mrow[g];
  m_hi = mrow[g + 8];
#pragma unroll
  for (int w = 1; w < KW; ++w) {
    m_lo = fmaxf(m_lo, mrow[w * 16 + g]);
    m_hi = fmaxf(m_hi, mrow[w * 16 + g + 8]);
  }
  l_lo = 0.f;
  l_hi = 0.f;
#pragma unroll
  for (int w = 0; w < KW; ++w) {
    l_lo += lrow[w * 16 + g] * softmax_exp(mrow[w * 16 + g] - m_lo);
    l_hi += lrow[w * 16 + g + 8] * softmax_exp(mrow[w * 16 + g + 8] - m_hi);
  }
  const float il_lo = 1.f / l_lo, il_hi = 1.f / l_hi;

  // ── pass 2: P = exp(s - m) / l rounded to bf16, O += P . V ──
  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
  stage(0, 0, true);
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      stage((it + 1) & 1, (it + 1) * kTile, true);
      tf32x3::cp_async_wait<1>();
    } else {
      tf32x3::cp_async_wait<0>();
    }
    __syncthreads();
    float s[2][2][4];
    scores(it & 1, qa, s);
    float pv[ND][4];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[nd][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        s[j][n][0] = softmax_exp(s[j][n][0] - m_lo);
        s[j][n][1] = softmax_exp(s[j][n][1] - m_lo);
        s[j][n][2] = softmax_exp(s[j][n][2] - m_hi);
        s[j][n][3] = softmax_exp(s[j][n][3] - m_hi);
      }
      uint32_t pa[4];
      block_p(pa, s[j], il_lo, il_hi);
      block_pv<DH, P>(pv, pa,
                      vs + ((it & 1) * kTile + (kw + KW * j) * kKB) * P, lane);
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] += pv[nd][e];
    __syncthreads();   // buffer it & 1 is free for tile it + 2
  }
  merge_and_store<DH, KW>(o, red + rg * red_floats<DH, KW>(), rg, kw, lane,
                          out, head, D, q0 + rg * 16 + g, T);
}

// ── dh = 64: the resident form on warpgroup products ──
//
// Four warpgroups share one 64-row tile of queries; warpgroup kw takes the
// NK = 112 keys kw NK .. (kw + 1) NK - 1 (T up to 448). Q, K and V sit in
// shared memory as 128-byte-swizzled rows (dh = 64 bf16 is one 128-byte
// row), written there by cp.async: Q and K are the
// K-major operands of S = Q.K^T (wgmma m64nNKk16, both from shared memory),
// V the N-major B of O = P.V (wgmma m64n64k16 with P from registers). S
// (NK / 2 f32 a thread) stays in registers from its product to P; the row
// maxima and sums of the four warpgroups are merged through shared memory
// as in the warp form above, and so are the partial O.
constexpr int kWgKeys = 112;

// shared memory of the warpgroup form: 1024 to align, K and V, two Q
// tiles, the partial-O slots of three warpgroups, the bias, the merges
template <int NK>
constexpr int wg_smem() {
  return 1024 + (2 * 4 * NK + 2 * 64) * 128 +
         (3 * 128 * 33 + 4 * NK + 2 * 4 * 64) * (int)sizeof(float);
}

template <int NK>
__global__ void __launch_bounds__(512, 1)
attention_bf16_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const float* __restrict__ bias, bf16* __restrict__ out,
                     int T, int H, float scale) {
  constexpr int DH = 64;
  constexpr int kKeys = 4 * NK;   // keys staged (zeros and -inf past T)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (wgmma::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ks = base;                        // [kKeys][128 B]
  unsigned char* vs = ks + kKeys * 128;            // [kKeys][128 B]
  unsigned char* qs = vs + kKeys * 128;            // [2][64][128 B]
  float* red = reinterpret_cast<float*>(qs + 2 * 64 * 128);   // [3][128][33]
  float* bs = red + 3 * 128 * 33;                  // [kKeys]
  float* mred = bs + kKeys;                        // [4][64]
  float* lred = mred + 4 * 64;                     // [4][64]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;              // the warpgroup: keys wg NK ..
  const int wt = tid & 127;             // thread of the warpgroup
  const int r0 = 16 * (wt >> 5) + (lane >> 2);   // rows r0, r0 + 8 of the tile
  const int t = lane & 3;
  const long long D = (long long)H * DH;
  const long long head = (long long)b * T * D + (long long)h * DH;
  const int n_tiles = (T + 63) / 64;

  // rows of a (T, 64) slice into 128-byte-swizzled rows, zeros past T
  auto stage_rows = [&](unsigned char* dst, const bf16* src, int row0,
                        int rows) {
    for (int i = tid; i < rows * 8; i += 512) {
      const int r = i >> 3;
      const int c = i & 7;
      const bool ok = row0 + r < T;
      tf32x3::cp_async16(
          dst + r * 128 + ((c ^ (r & 7)) << 4),
          src + (ok ? head + (long long)(row0 + r) * D + 8 * c : 0), ok);
    }
  };
  // cp.async writes become visible to the products (the async proxy)
  auto arrived = [] {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  };

  // group 1: K, the bias (-inf past T), the first tile's Q; group 2: V
  stage_rows(ks, k, 0, kKeys);
  for (int j = tid; j < kKeys; j += 512) {
    bs[j] = j < T ? (bias != nullptr ? bias[(long long)b * T + j] : 0.f)
                  : -INFINITY;
  }
  stage_rows(qs, q, blockIdx.x * 64, 64);
  tf32x3::cp_async_commit();
  stage_rows(vs, v, 0, kKeys);
  tf32x3::cp_async_commit();
  tf32x3::cp_async_wait<1>();
  arrived();

  const uint32_t k_at = wgmma::smem_u32(ks + wg * NK * 128);
  const uint32_t v_at = wgmma::smem_u32(vs + wg * NK * 128);
  const float* bw = bs + wg * NK;
  bool first = true;
  int buf = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    if (tile + (int)gridDim.x < n_tiles) {
      stage_rows(qs + (buf ^ 1) * 64 * 128, q, (tile + gridDim.x) * 64, 64);
    }
    tf32x3::cp_async_commit();

    // S = Q . K^T of this warpgroup's keys
    float s[NK / 2];
    const uint32_t q_at = wgmma::smem_u32(qs + buf * 64 * 128);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      wgmma::ss<NK, 0>(s, wgmma::desc(q_at + 32 * kk, 0, 1024),
                       wgmma::desc(k_at + 32 * kk, 0, 1024), kk > 0);
    }
    wgmma::commit();
    wgmma::wait0();
    wgmma::fence_regs(s);
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int i = 0; i < NK / 8; ++i) {
      const float c0 = bw[8 * i + 2 * t], c1 = bw[8 * i + 2 * t + 1];
      s[4 * i] = __fadd_rn(__fmul_rn(s[4 * i], scale), c0);
      s[4 * i + 1] = __fadd_rn(__fmul_rn(s[4 * i + 1], scale), c1);
      s[4 * i + 2] = __fadd_rn(__fmul_rn(s[4 * i + 2], scale), c0);
      s[4 * i + 3] = __fadd_rn(__fmul_rn(s[4 * i + 3], scale), c1);
      mx_lo = fmaxf(mx_lo, fmaxf(s[4 * i], s[4 * i + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
    mx_lo = quad_max(mx_lo);
    mx_hi = quad_max(mx_hi);
    if (t == 0) {
      mred[wg * 64 + r0] = mx_lo;
      mred[wg * 64 + r0 + 8] = mx_hi;
    }
    __syncthreads();
    // the row max over every key (finite: key 0 is warpgroup 0's)
    float m_lo = mred[r0], m_hi = mred[r0 + 8];
#pragma unroll
    for (int w = 1; w < 4; ++w) {
      m_lo = fmaxf(m_lo, mred[w * 64 + r0]);
      m_hi = fmaxf(m_hi, mred[w * 64 + r0 + 8]);
    }
    // exp(s - m) in place; this warpgroup's part of the row sums
    float l_lo = 0.f, l_hi = 0.f;
#pragma unroll
    for (int i = 0; i < NK / 8; ++i) {
      s[4 * i] = softmax_exp(s[4 * i] - m_lo);
      s[4 * i + 1] = softmax_exp(s[4 * i + 1] - m_lo);
      s[4 * i + 2] = softmax_exp(s[4 * i + 2] - m_hi);
      s[4 * i + 3] = softmax_exp(s[4 * i + 3] - m_hi);
      l_lo += s[4 * i] + s[4 * i + 1];
      l_hi += s[4 * i + 2] + s[4 * i + 3];
    }
    l_lo = quad_sum(l_lo);
    l_hi = quad_sum(l_hi);
    if (t == 0) {
      lred[wg * 64 + r0] = l_lo;
      lred[wg * 64 + r0 + 8] = l_hi;
    }
    if (first) {   // V (group 2; the next Q may still be in flight)
      tf32x3::cp_async_wait<1>();
      arrived();
      first = false;
    } else {
      __syncthreads();
    }
    l_lo = lred[r0];
    l_hi = lred[r0 + 8];
#pragma unroll
    for (int w = 1; w < 4; ++w) {
      l_lo += lred[w * 64 + r0];
      l_hi += lred[w * 64 + r0 + 8];
    }
    const float il_lo = 1.f / l_lo, il_hi = 1.f / l_hi;

    // O = P . V: P rounded to bf16 in the A layout of each 16-key step
    uint32_t pa[NK / 16][4];
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk) {
      pa[kk][0] = p_pair(s[8 * kk], s[8 * kk + 1], il_lo);
      pa[kk][1] = p_pair(s[8 * kk + 2], s[8 * kk + 3], il_hi);
      pa[kk][2] = p_pair(s[8 * kk + 4], s[8 * kk + 5], il_lo);
      pa[kk][3] = p_pair(s[8 * kk + 6], s[8 * kk + 7], il_hi);
    }
    float o[DH / 2];
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk) {
      wgmma::rs<DH>(o, pa[kk], wgmma::desc(v_at + 2048 * kk, 0, 1024),
                    kk > 0);
    }
    wgmma::commit();
    wgmma::wait0();
    wgmma::fence_regs(o);

    // the partial O of warpgroups 1-3, added in order by warpgroup 0
    if (wg > 0) {
      float* mine = red + ((wg - 1) * 128 + wt) * 33;
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) mine[i] = o[i];
    }
    __syncthreads();
    if (wg == 0) {
#pragma unroll
      for (int w = 1; w < 4; ++w) {
        const float* other = red + ((w - 1) * 128 + wt) * 33;
#pragma unroll
        for (int i = 0; i < DH / 2; ++i) o[i] += other[i];
      }
      const int row = tile * 64 + r0;
#pragma unroll
      for (int i = 0; i < DH / 8; ++i) {
        const int c = 8 * i + 2 * t;
        if (row < T) {
          *reinterpret_cast<__nv_bfloat162*>(out + head + (long long)row * D +
                                             c) =
              __floats2bfloat162_rn(o[4 * i], o[4 * i + 1]);
        }
        if (row + 8 < T) {
          *reinterpret_cast<__nv_bfloat162*>(
              out + head + (long long)(row + 8) * D + c) =
              __floats2bfloat162_rn(o[4 * i + 2], o[4 * i + 3]);
        }
      }
    }
    // the next tile's Q is in; the merge slots and partial O are free
    tf32x3::cp_async_wait<0>();
    arrived();
  }
}

template <int NK>
int launch_wgmma(const bf16* q, const bf16* k, const bf16* v,
                 const float* bias, bf16* out, int B, int T, int H,
                 float scale, cudaStream_t stream) {
  static int ready[64];
  cudaError_t err =
      tf32x3::allow_smem(attention_bf16_wgmma<NK>, wg_smem<NK>(), ready);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (T + 63) / 64;
  const long long heads = (long long)B * H;
  const int per_head = heads >= sms ? 1
      : (int)(sms / heads < n_tiles ? sms / heads : n_tiles);
  attention_bf16_wgmma<NK><<<dim3(per_head, H, B), 512, wg_smem<NK>(),
                             stream>>>(q, k, v, bias, out, T, H, scale);
  return (int)cudaGetLastError();
}

// The warp form's row groups (RG), key warps (KW) and key blocks a warp
// at most (NJ): T up to KW * 16 * NJ keys, 448 (dh 128: 256, where shared
// memory runs out)
template <int DH>
struct Bf16Plan {
  static constexpr int RG = 4, KW = 4, NJ = 7;
};
template <>
struct Bf16Plan<128> {   // O takes 64 registers a lane: fewer, larger warps
  static constexpr int RG = 2, KW = 4, NJ = 4;
};

template <int DH, int RG, int KW, int NJ>
int launch_resident(const bf16* q, const bf16* k, const bf16* v,
                    const float* bias, bf16* out, int B, int T, int H,
                    float scale, cudaStream_t stream) {
  static int ready[64];
  cudaError_t err = tf32x3::allow_smem(
      attention_bf16_resident<DH, RG, KW, NJ>,
      resident_smem<DH, RG, KW>(KW * kKB * NJ), ready);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return (int)err;
  // blocks per (batch, head): one per row tile while the SMs last, else
  // fewer, each walking several tiles on one copy of K and V
  const int n_tiles = (T + RG * 16 - 1) / (RG * 16);
  const long long heads = (long long)B * H;
  const int per_head = heads >= sms ? 1
      : (int)(sms / heads < n_tiles ? sms / heads : n_tiles);
  const dim3 grid(per_head, H, B);
  const int smem = resident_smem<DH, RG, KW>((T + kKB - 1) / kKB * kKB);
  attention_bf16_resident<DH, RG, KW, NJ><<<grid, RG * KW * 32, smem, stream>>>(
      q, k, v, bias, out, T, H, scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v,
                const float* bias, bf16* out, int B, int T, int H,
                float scale, cudaStream_t stream) {
  using Plan = Bf16Plan<DH>;
  if (DH == 64 && T <= 4 * kWgKeys) {
    return launch_wgmma<kWgKeys>(q, k, v, bias, out, B, T, H, scale, stream);
  }
  if (T <= Plan::KW * kKB * Plan::NJ) {
    return launch_resident<DH, Plan::RG, Plan::KW, Plan::NJ>(
        q, k, v, bias, out, B, T, H, scale, stream);
  }
  constexpr int RG = 2, KW = 4;
  constexpr int smem = tiled_smem<DH, RG, KW>();
  static int ready[64];
  const cudaError_t err =
      tf32x3::allow_smem(attention_bf16_tiled<DH, RG, KW>, smem, ready);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + RG * 16 - 1) / (RG * 16), H, B);
  attention_bf16_tiled<DH, RG, KW><<<grid, RG * KW * 32, smem, stream>>>(
      q, k, v, bias, out, T, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out: (B, T, H*dh) contiguous f32 on the device, 16-byte aligned;
// bias: (B, T) f32 or null. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int speech_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* bias,
                                    void* out, int B, int T, int H, int dh,
                                    float scale, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || B > 65535 || H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* bf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return launch_dh<16>(qf, kf, vf, bf, of, B, T, H, scale, s);
    case 32: return launch_dh<32>(qf, kf, vf, bf, of, B, T, H, scale, s);
    case 64: return launch_dh<64>(qf, kf, vf, bf, of, B, T, H, scale, s);
    case 128: return launch_dh<128>(qf, kf, vf, bf, of, B, T, H, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The bf16 form: q, k, v, out (B, T, H*dh) contiguous bf16 on the device,
// 16-byte aligned; bias (B, T) f32 or null. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int speech_attention_fwd_bf16(const void* q, const void* k,
                                         const void* v, const void* bias,
                                         void* out, int B, int T, int H,
                                         int dh, float scale, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || B > 65535 || H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const float* bf = static_cast<const float*>(bias);
  bf16* ob = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return launch_bf16<16>(qb, kb, vb, bf, ob, B, T, H, scale, s);
    case 32: return launch_bf16<32>(qb, kb, vb, bf, ob, B, T, H, scale, s);
    case 64: return launch_bf16<64>(qb, kb, vb, bf, ob, B, T, H, scale, s);
    case 128: return launch_bf16<128>(qb, kb, vb, bf, ob, B, T, H, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
