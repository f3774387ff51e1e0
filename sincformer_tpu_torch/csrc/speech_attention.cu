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
// f32 and rounded once to bf16. The online softmax of the f32 form would
// round exp(s - m_running) instead of the normalised P, so this form walks
// the keys twice: pass 1 takes each row's max m and sum l (an online
// rescaled sum, f32); pass 2 recomputes S tile by tile (the same products
// in the same order, so the same bits), forms P = exp(s - m) / l, rounds it
// to bf16 and adds P.V into f32 accumulators.
//
// Both products run on the tensor cores as mma.sync.m16n8k16 bf16 with f32
// accumulators: a bf16 product is exact in f32, so there is no split. The
// accumulator layout of S (lane (g, t) holds columns 2t, 2t+1 of each
// 8-key block, rows g and g + 8) is the A-operand layout of P.V for the
// 16 keys of two neighbouring blocks, so P goes from registers to the next
// product without a shuffle. V's B operand wants keys 2t, 2t+1 of one
// column: two 16-bit loads from shared memory packed into one register.
//
// A block owns RW x 16 query rows of one (batch, head), one warp per 16
// rows, each warp walking every key (no split of the keys between warps:
// the first form, right before fast). K (pass 1) and K, V (pass 2) tiles
// of 64 keys are copied to shared memory with cp.async, two buffers deep;
// rows are kept at a pitch of dh + 8 bf16 (16 bytes of padding), which
// keeps every 16-byte copy aligned and the fragment loads free of bank
// conflicts. Keys past T are zero-filled and carry a score of -inf. P.V of
// each tile goes to fresh accumulators, added to O in f32 (as the f32 form
// does, so the tensor cores' truncating adds span one tile). Bound at the
// main-path shape (B=4, T=400, H=4, dh=64): 0.655 GFLOP is 0.66 us at
// 989 TFLOP/s, 3.28 MB is 0.98 us at 3.35 TB/s: bound by bytes.

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

// two bf16 at p and q packed, *p in the low half
__device__ __forceinline__ uint32_t pack2(const bf16* p, const bf16* q) {
  const uint32_t lo = *reinterpret_cast<const unsigned short*>(p);
  const uint32_t hi = *reinterpret_cast<const unsigned short*>(q);
  return lo | (hi << 16);
}

__device__ __forceinline__ uint32_t word(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int DH, int RW>
constexpr int smem_bytes_bf16() {
  return (RW * 16 + 4 * kKeys) * (DH + 8) * (int)sizeof(bf16) +
         2 * kKeys * (int)sizeof(float);
}

template <int DH, int RW>
__global__ void __launch_bounds__(RW * 32)
speech_attention_bf16_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const float* __restrict__ bias,
                             bf16* __restrict__ out, int T, int H,
                             float scale) {
  constexpr int kThreads = RW * 32;
  constexpr int P = DH + 8;         // row pitch of the Q, K and V tiles
  constexpr int KS = DH / 16;       // k-steps of Q.K^T
  constexpr int NT = kKeys / 8;     // n-tiles of a warp's S
  constexpr int ND = DH / 8;        // n-tiles of P.V
  constexpr int kVec = DH / 8;      // 16-byte pieces of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [RW * 16][P]
  bf16* ks = qs + RW * 16 * P;                     // [2][kKeys][P]
  bf16* vs = ks + 2 * kKeys * P;                   // [2][kKeys][P]
  float* bs = reinterpret_cast<float*>(vs + 2 * kKeys * P);   // [2][kKeys]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long D = (long long)H * DH;
  const long long head = (long long)b * T * D + (long long)h * DH;
  const int q0 = blockIdx.x * (RW * 16);
  const int r_lo = q0 + warp * 16 + g;
  const int r_hi = r_lo + 8;
  const int n_tiles = (T + kKeys - 1) / kKeys;

  // copies of the tile of keys k0.. into buffer `buf` (V only in pass 2)
  auto stage = [&](int buf, int k0, bool with_v) {
    bf16* kd = ks + buf * kKeys * P;
    bf16* vd = vs + buf * kKeys * P;
    for (int i = tid; i < kKeys * kVec; i += kThreads) {
      const int j = i / kVec;
      const int c = i - j * kVec;
      const int key = k0 + j;
      const bool ok = key < T;
      const long long off = ok ? head + (long long)key * D + 8 * c : 0;
      tf32x3::cp_async16(kd + j * P + 8 * c, k + off, ok);
      if (with_v) tf32x3::cp_async16(vd + j * P + 8 * c, v + off, ok);
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
  for (int i = tid; i < RW * 16 * kVec; i += kThreads) {
    const int r = i / kVec;
    const int c = i - r * kVec;
    const bool ok = q0 + r < T;
    tf32x3::cp_async16(qs + r * P + 8 * c,
                       q + (ok ? head + (long long)(q0 + r) * D + 8 * c : 0),
                       ok);
  }
  // A fragments of Q: rows g and g + 8 of the warp's 16, columns 2t, 2t+1
  // (+ 8) of each 16-wide k-step, kept in registers for both passes
  uint32_t qa[KS][4];
  const bf16* qr = qs + (warp * 16 + g) * P + 2 * t;

  // S of one tile into s: Q . K^T * scale + bias, f32
  auto scores = [&](const bf16* kt, const float* bt, float (&s)[NT][4]) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* kr = kt + (8 * nt + g) * P + 16 * kk + 2 * t;
        const uint32_t bb[2] = {word(kr), word(kr + 8)};
        mma_bf16(s[nt], qa[kk], bb);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float b0 = bt[8 * nt + 2 * t];
      const float b1 = bt[8 * nt + 2 * t + 1];
      s[nt][0] = s[nt][0] * scale + b0;
      s[nt][1] = s[nt][1] * scale + b1;
      s[nt][2] = s[nt][2] * scale + b0;
      s[nt][3] = s[nt][3] * scale + b1;
    }
  };

  // ── pass 1: each row's max and sum ────────────────────────────────────
  float m_lo = -INFINITY, m_hi = -INFINITY;   // running max of rows g, g+8
  float l_lo = 0.f, l_hi = 0.f;               // this lane's part of the sums
  stage(0, 0, false);
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      stage((it + 1) & 1, (it + 1) * kKeys, false);
      tf32x3::cp_async_wait<1>();
    } else {
      tf32x3::cp_async_wait<0>();
    }
    __syncthreads();   // tile it (and, the first time, Q) is in
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        qa[kk][0] = word(qr + 16 * kk);
        qa[kk][1] = word(qr + 8 * P + 16 * kk);
        qa[kk][2] = word(qr + 16 * kk + 8);
        qa[kk][3] = word(qr + 8 * P + 16 * kk + 8);
      }
    }
    float s[NT][4];
    scores(ks + (it & 1) * kKeys * P, bs + (it & 1) * kKeys, s);
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[nt][0], s[nt][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o_));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o_));
    }
    // key 0 is in tile 0, so the max is finite from the first tile on
    const float mn_lo = fmaxf(m_lo, mx_lo);
    const float mn_hi = fmaxf(m_hi, mx_hi);
    l_lo *= expf(m_lo - mn_lo);
    l_hi *= expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      l_lo += expf(s[nt][0] - m_lo) + expf(s[nt][1] - m_lo);
      l_hi += expf(s[nt][2] - m_hi) + expf(s[nt][3] - m_hi);
    }
    __syncthreads();   // buffer it & 1 is free for tile it + 2
  }
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, o_);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, o_);
  }
  const float inv_lo = 1.f / l_lo;
  const float inv_hi = 1.f / l_hi;

  // ── pass 2: P = exp(s - m) / l rounded to bf16, O += P . V ────────────
  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nd][i] = 0.f;
  stage(0, 0, true);
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      stage((it + 1) & 1, (it + 1) * kKeys, true);
      tf32x3::cp_async_wait<1>();
    } else {
      tf32x3::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* vt = vs + (it & 1) * kKeys * P;
    float s[NT][4];
    scores(ks + (it & 1) * kKeys * P, bs + (it & 1) * kKeys, s);
    float pv[ND][4];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[nd][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {   // 16 keys: blocks 2kk, 2kk + 1
      uint32_t pa[4];
      pa[0] = pack_bf16(expf(s[2 * kk][0] - m_lo) * inv_lo,
                        expf(s[2 * kk][1] - m_lo) * inv_lo);
      pa[1] = pack_bf16(expf(s[2 * kk][2] - m_hi) * inv_hi,
                        expf(s[2 * kk][3] - m_hi) * inv_hi);
      pa[2] = pack_bf16(expf(s[2 * kk + 1][0] - m_lo) * inv_lo,
                        expf(s[2 * kk + 1][1] - m_lo) * inv_lo);
      pa[3] = pack_bf16(expf(s[2 * kk + 1][2] - m_hi) * inv_hi,
                        expf(s[2 * kk + 1][3] - m_hi) * inv_hi);
      const bf16* vr = vt + (16 * kk + 2 * t) * P + g;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        const uint32_t bb[2] = {pack2(vr + 8 * nd, vr + P + 8 * nd),
                                pack2(vr + 8 * P + 8 * nd,
                                      vr + 9 * P + 8 * nd)};
        mma_bf16(pv[nd], pa, bb);
      }
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[nd][i] += pv[nd][i];
    __syncthreads();
  }

#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int c = 8 * nd + 2 * t;
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

template <int DH, int RW>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v,
                const float* bias, bf16* out, int B, int T, int H,
                float scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes_bf16<DH, RW>();
  static int ready[64];
  const cudaError_t err = tf32x3::allow_smem(
      speech_attention_bf16_kernel<DH, RW>, smem, ready);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + RW * 16 - 1) / (RW * 16), H, B);
  speech_attention_bf16_kernel<DH, RW><<<grid, RW * 32, smem, stream>>>(
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
    case 16: return launch_bf16<16, 4>(qb, kb, vb, bf, ob, B, T, H, scale, s);
    case 32: return launch_bf16<32, 4>(qb, kb, vb, bf, ob, B, T, H, scale, s);
    case 64: return launch_bf16<64, 4>(qb, kb, vb, bf, ob, B, T, H, scale, s);
    case 128:
      return launch_bf16<128, 4>(qb, kb, vb, bf, ob, B, T, H, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
