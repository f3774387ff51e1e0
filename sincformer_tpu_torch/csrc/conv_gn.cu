// Strided SAME Conv1d -> GroupNorm [-> + skip] [-> tanh-GELU] for Hopper
// (sm_90a), f32, the convolution on the tensor cores in split TF32.
//
// Replaces the TPU kernel sincformer_tpu/ops/conv_gn_pallas.py::_kernel
// (launched by _conv1d_gn_pallas, entry point conv1d_gn). For x (B, T, Cin),
// w (K, Cin, Cout) in the JAX layout and stride s:
//     conv[b, t, o] = bias[o] + sum_{k, i} x[b, t*s + k - pad_left, i] * w[k, i, o]
// over Tout = ceil(T / s) rows (flax SAME padding, zeros outside), then
// GroupNorm over (all Tout rows) x (Cout / groups channels) of one batch
// row with the biased variance and eps inside the square root, the affine
// (gamma, beta), the optional skip and the optional tanh-GELU.
//
// Bound: operations, 2 * B * Tout * K * Cin * Cout (29.4 GFLOP at B=16,
// T=32,000, 64 -> 128, k=7, s=2): 0.178 ms for the three TF32 products per
// product at 495 TFLOP/s that f32-level results take on the tensor cores
// (tf32x3.cuh), 0.44 ms at the 67 TFLOP/s of f32 outside them; the bytes of
// the same call, 262 MB, are 0.08 ms.
//
// Design. GroupNorm's statistics span a whole batch row, so no block can
// finish from its own tile, and blocks do not run in order as the TPU's grid
// does. Three kernels on one stream, with two small scratch buffers between
// them, instead of one block walking a row twice:
//   1. conv_kernel: an implicit GEMM with M = the Tout rows of one batch
//      row, N = Cout and the contraction over (tap, Cin). A block of 8 warps
//      owns a (128 rows x 64 channels) tile, each warp 32 x 32 as 2 x 4
//      m16n8k8 tiles. It walks Cin in chunks of 8 channels; for each chunk
//      it stages, once for all taps, the input rows the tile needs,
//      (128 - 1) * s + K of them (261 at s=2, k=7), by cp.async with
//      zero-fill for the SAME padding at both ends of the row, and the
//      chunk's rows of w for every tap, and splits both into TF32 hi and lo
//      once, in place, before any product reads them. Tap k's A operand is
//      then rows k, k+s, k+2s, ... of that one window. The window is stored
//      by stride phase (window row j at phase j % s, position j / s), so a
//      tap's rows are consecutive: at a pitch of 12 words one ldmatrix.x4
//      loads a fragment without bank conflicts at any stride, and only the
//      phases a tap reaches are staged. w stays N-major (mma.sync takes B
//      from shared memory in any layout) at a pitch of 72 words. Each
//      chunk's products go into fresh accumulators that are added into the
//      f32 sum on the CUDA cores: the tensor cores add by truncation. Taps
//      are taken in groups small enough that a block's shared memory stays
//      under 100 KB (all 7 taps at the main shapes, 57 KB; two blocks an
//      SM), so any K and any s are taken. Tiles of 128 rows stage and split
//      w for twice the outputs of 64-row tiles (w is most of what a block
//      stages at the call site: 7 x 8 x 64 words a chunk against 2 x 131 x
//      8 of the window). Copying the next chunk under this one's products,
//      and B's fragments by ldmatrix from a transposed w, measured no
//      faster (PERF.md): the block is bound by the instructions it runs.
//      The tile is written to `out` with its bias, and for each of its
//      channels the tile's mean and its sum of squares about that mean go
//      to `partial`. The convolution is computed here, by this code: no
//      library is called.
//   2. stats_kernel: one block per (batch row, group) merges the partials
//      of its channels and tiles with the pairwise-merge formula (Chan et
//      al.) in double precision: mean and 1 / sqrt(var + eps) to `stats`.
//   3. norm_kernel: elementwise over `out`, in place, a block per 32 rows
//      of one batch row: (v - mean) * rstd * gamma + beta [+ skip] [gelu].
// bf16 form (conv_gn_fwd_bf16): x, w, bias, gamma, beta and skip in bf16,
// the same three kernels. A bf16 value is exact in TF32 and the product of
// two is exact in f32, so the convolution takes ONE TF32 product per
// product (no split, no lo arrays: half the shared memory and a third of
// the tensor-core work) with f32 accumulation. The convolution's f32 result
// goes to an f32 scratch buffer; the statistics and the epilogue stay f32,
// and norm_kernel rounds once to bf16 at the end, as the JAX package's
// conv_gn_reference does (conv_gn_pallas.py:255-276; its Pallas kernel
// rounds the convolution to bf16 between its two passes, a second bf16
// function, ROADMAP.md Queue 3). Bound: 2 * B * Tout * K * Cin * Cout
// operations at the dense bf16 rate, or the bf16 bytes.
// Centred partial sums, not sum and sum of squares (what the TPU kernel
// accumulates): E[v^2] - mean^2 in f32 loses the variance when the mean is
// far from zero. All reductions run in a fixed order, without atomics, so a
// call gives the same bits every time. Any K >= 1, any s >= 1 and any
// groups | Cout are taken: the TPU kernel's two geometry guards came from its
// DMA window.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using tf32x3::cp_async16;
using tf32x3::ldmatrix_x4;
using tf32x3::mma;
using tf32x3::mma3;
using tf32x3::split;

using bf16_t = uint16_t;        // the bits of a bfloat16 value

// bf16 -> f32 is exact: the bf16 bits are the high half of the f32's
__device__ __forceinline__ uint32_t bf16_bits_to_f32(uint32_t b) {
  return b << 16;
}
__device__ __forceinline__ float load_f32(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load_f32(const bf16_t* p, long long i) {
  return __uint_as_float(bf16_bits_to_f32(p[i]));
}
// f32 -> bf16, to nearest even (one cvt.rn.bf16.f32)
__device__ __forceinline__ bf16_t to_bf16(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store(bf16_t* p, long long i, float v) {
  p[i] = to_bf16(v);
}

constexpr int kTM = 128;         // output rows per tile
constexpr int kTN = 64;          // output channels per tile
constexpr int kKC = 8;           // input channels per chunk (one k-step)
constexpr int kXP = kKC + 4;     // pitch of the window rows, words
constexpr int kWP = kTN + 8;     // pitch of the w rows, words
constexpr int kWarps = 8;        // 4 along the rows x 2 along the channels
constexpr int kThreads = 32 * kWarps;
constexpr int kSmemBudget = 100 * 1024;  // two blocks an SM; one tap at a
                                         // time takes 17 KB at any stride

// shared memory of a block that takes `taps` taps at a time at stride s:
// (phases x rows a phase) window rows and the taps' w rows, hi and lo
__host__ __device__ constexpr int phases(int taps, int s) {
  return taps < s ? taps : s;
}
__host__ __device__ constexpr int phase_rows(int taps, int s) {
  return kTM - 1 + (taps + s - 1) / s;
}
// f32 inputs keep hi and lo of each staged value, bf16 inputs only hi
inline int smem_bytes(int taps, int s, int copies) {
  return copies * 4 * (phases(taps, s) * phase_rows(taps, s) * kXP +
                       taps * kKC * kWP);
}

// Elem = float: split TF32, three products per product; Elem = bf16_t: the
// staged values are exact in TF32, one product per product
template <typename Elem>
__global__ void __launch_bounds__(kThreads, 2)
conv_kernel(const Elem* __restrict__ x, const Elem* __restrict__ w,
            const Elem* __restrict__ bias, float* __restrict__ out,
            float* __restrict__ partial, int T, int Cin, int Cout, int K,
            int s, int pad_left, int Tout, int n_tiles, int n_chunks,
            int taps, int vec_x, int vec_w) {
  constexpr bool kSplit = sizeof(Elem) == 4;
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ float red[4][kTN];
  __shared__ float tile_mean[kTN];
  const int rp = phase_rows(taps, s);
  const int x_words = phases(taps, s) * rp * kXP;
  const int w_words = taps * kKC * kWP;
  uint32_t* xh = smem;                                  // [phases * rp][kXP]
  uint32_t* xl = xh + x_words;                          // f32 only
  uint32_t* wh = kSplit ? xl + x_words : xh + x_words;  // [taps][kKC][kWP]
  uint32_t* wl = wh + w_words;                          // f32 only

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;      // warp tile: rows 32wm, cols 32wn
  // this lane's row of the A tiles for ldmatrix: (lane & 7) + 8 * bit 3,
  // at word 4 * bit 4
  const int a_row = 32 * wm + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int a_word = 4 * (lane >> 4);
  const int tile = blockIdx.x / n_chunks;
  const int n0 = (blockIdx.x - tile * n_chunks) * kTN;
  const int row0 = tile * kTM;
  const int b = blockIdx.y;
  const Elem* xb = x + (long long)b * T * Cin;

  float sum[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[i][j][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += taps) {
    const int kt = K - k0 < taps ? K - k0 : taps;
    const int nph = phases(kt, s);
    const int n_rows = nph * rp;                    // window rows staged
    const long long t_first = (long long)row0 * s - pad_left + k0;
    for (int c0 = 0; c0 < Cin; c0 += kKC) {
      __syncthreads();             // the previous chunk's products are done
      // window row j = pos * s + phase -> input row t_first + j, channels
      // c0 .. c0 + 7 as two 16-byte pieces; zeros outside [0, T) and Cin
      {
        const int piece = tid & 1;
        const int c = c0 + 4 * piece;
        for (int phase = 0; phase < nph; ++phase) {
          for (int pos = tid >> 1; pos < rp; pos += kThreads / 2) {
            const long long t_in = t_first + (long long)pos * s + phase;
            uint32_t* dst = xh + (phase * rp + pos) * kXP + 4 * piece;
            const bool in_t = t_in >= 0 && t_in < T;
            if (kSplit && vec_x) {
              const bool ok = in_t && c < Cin;
              cp_async16(dst, ok ? (const void*)(xb + t_in * Cin + c)
                                 : (const void*)x, ok);
            } else if (!kSplit && vec_x) {       // four bf16 in 8 bytes
              uint2 u = make_uint2(0u, 0u);
              if (in_t && c < Cin)
                u = *reinterpret_cast<const uint2*>(xb + t_in * Cin + c);
              dst[0] = u.x << 16;
              dst[1] = u.x & 0xFFFF0000u;
              dst[2] = u.y << 16;
              dst[3] = u.y & 0xFFFF0000u;
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                dst[j] = __float_as_uint(in_t && c + j < Cin
                                             ? load_f32(xb, t_in * Cin + c + j)
                                             : 0.f);
            }
          }
        }
      }
      // w rows (k0 + tap, c0 + ci), columns n0 .. n0 + 63 as 16 pieces
      for (int i = tid; i < kt * kKC * (kTN / 4); i += kThreads) {
        const int row = i / (kTN / 4);               // tap * kKC + ci
        const int c4 = 4 * (i - row * (kTN / 4));
        const int tap = row / kKC, ci = c0 + row - tap * kKC;
        const long long src = ((long long)(k0 + tap) * Cin + ci) * Cout + n0 + c4;
        uint32_t* dst = wh + row * kWP + c4;
        if (kSplit && vec_w) {
          const bool ok = ci < Cin && n0 + c4 < Cout;
          cp_async16(dst, ok ? (const void*)(w + src) : (const void*)w, ok);
        } else if (!kSplit && vec_w) {
          uint2 u = make_uint2(0u, 0u);
          if (ci < Cin && n0 + c4 < Cout)
            u = *reinterpret_cast<const uint2*>(w + src);
          dst[0] = u.x << 16;
          dst[1] = u.x & 0xFFFF0000u;
          dst[2] = u.y << 16;
          dst[3] = u.y & 0xFFFF0000u;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            dst[j] = __float_as_uint(ci < Cin && n0 + c4 + j < Cout
                                         ? load_f32(w, src + j) : 0.f);
        }
      }
      if (kSplit) {
        tf32x3::cp_async_commit();
        tf32x3::cp_async_wait<0>();
        __syncthreads();
        // split once, in place: hi over the staged value, lo beside it
        for (int i = tid; i < n_rows * kKC; i += kThreads) {
          const int o = (i >> 3) * kXP + (i & 7);
          uint32_t hi, lo;
          split(__uint_as_float(xh[o]), hi, lo);
          xh[o] = hi;
          xl[o] = lo;
        }
        for (int i = tid; i < kt * kKC * kTN; i += kThreads) {
          const int o = (i / kTN) * kWP + (i & (kTN - 1));
          uint32_t hi, lo;
          split(__uint_as_float(wh[o]), hi, lo);
          wh[o] = hi;
          wl[o] = lo;
        }
      }
      __syncthreads();

      // the chunk's products, all taps, in fresh accumulators
      float acc[2][4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      int phase = 0, shift = 0;                 // tap % s, tap / s
      for (int tap = 0; tap < kt; ++tap) {
        uint32_t ah[2][4], al[2][4];
        const int ao = (phase * rp + shift + a_row) * kXP + a_word;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          ldmatrix_x4(ah[mt], xh + ao + 16 * mt * kXP);
          if (kSplit) ldmatrix_x4(al[mt], xl + ao + 16 * mt * kXP);
        }
        const int wo = (tap * kKC + t) * kWP + 32 * wn + g;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const uint32_t bh[2] = {wh[wo + 8 * nt], wh[wo + 4 * kWP + 8 * nt]};
          if (kSplit) {
            const uint32_t bl[2] = {wl[wo + 8 * nt],
                                    wl[wo + 4 * kWP + 8 * nt]};
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              mma3(acc[mt][nt], ah[mt], al[mt], bh, bl);
          } else {
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) mma(acc[mt][nt], ah[mt], bh);
          }
        }
        if (++phase == s) {
          phase = 0;
          ++shift;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sum[i][j][e] += acc[i][j][e];
    }
  }

  // bias, store, and the tile's per-channel mean and centred sum of
  // squares. Thread (g, t) holds rows 32wm + 16mt + g (+8) and columns
  // 32wn + 8nt + 2t (+1).
  const int valid_rows = (Tout - row0) < kTM ? (Tout - row0) : kTM;
  float colsum[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = 32 * wn + 8 * nt + 2 * t;
    const float b0 = n0 + col < Cout ? load_f32(bias, n0 + col) : 0.f;
    const float b1 = n0 + col + 1 < Cout ? load_f32(bias, n0 + col + 1) : 0.f;
    colsum[nt][0] = colsum[nt][1] = 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 32 * wm + 16 * mt + g + 8 * half;
        float* v = &sum[mt][nt][2 * half];
        v[0] += b0;
        v[1] += b1;
        if (r < valid_rows) {
          float* o = out + ((long long)b * Tout + row0 + r) * Cout + n0 + col;
          if (n0 + col + 1 < Cout && (Cout & 1) == 0) {
            *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
          } else {
            if (n0 + col < Cout) o[0] = v[0];
            if (n0 + col + 1 < Cout) o[1] = v[1];
          }
          colsum[nt][0] += v[0];
          colsum[nt][1] += v[1];
        }
      }
  }
  // the 8 lanes of one t hold the same columns: sum over g, then over the
  // four warps of a column half in a fixed order
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float v = colsum[nt][c];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (g == 0) red[wm][32 * wn + 8 * nt + 2 * t + c] = v;
    }
  __syncthreads();
  if (tid < kTN)
    tile_mean[tid] = (red[0][tid] + red[1][tid] + red[2][tid] + red[3][tid]) /
                     (float)valid_rows;
  __syncthreads();
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float mu = tile_mean[32 * wn + 8 * nt + 2 * t + c];
      float sq = 0.f;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float d = sum[mt][nt][2 * half + c] - mu;
          if (32 * wm + 16 * mt + g + 8 * half < valid_rows) sq += d * d;
        }
      sq += __shfl_xor_sync(0xffffffffu, sq, 4);
      sq += __shfl_xor_sync(0xffffffffu, sq, 8);
      sq += __shfl_xor_sync(0xffffffffu, sq, 16);
      if (g == 0) red[wm][32 * wn + 8 * nt + 2 * t + c] = sq;
    }
  __syncthreads();
  if (tid < kTN && n0 + tid < Cout) {
    float* p = partial + (((long long)b * n_tiles + tile) * Cout + n0 + tid) * 2;
    p[0] = tile_mean[tid];
    p[1] = red[0][tid] + red[1][tid] + red[2][tid] + red[3][tid];
  }
}

// One block per (group, batch row): merge the (tile, channel) partials of
// the group. Entry e = tile * cg + channel holds (mean_e, M2_e) over n_e
// rows; mean = sum n_e mean_e / n, M2 = sum M2_e + n_e (mean_e - mean)^2.
__global__ void __launch_bounds__(128)
stats_kernel(const float* __restrict__ partial, float* __restrict__ stats,
             int Cout, int cg, int Tout, int n_tiles, float eps) {
  __shared__ double red[128];
  __shared__ double mean_sh;
  const int g = blockIdx.x, b = blockIdx.y;
  const int groups = gridDim.x;
  const int tid = threadIdx.x;
  const long long entries = (long long)n_tiles * cg;
  const float* base = partial + (long long)b * n_tiles * Cout * 2;
  const double n_total = (double)Tout * (double)cg;

  double acc = 0.0;
  for (long long e = tid; e < entries; e += 128) {
    const int tile = (int)(e / cg), c = g * cg + (int)(e % cg);
    const int rows = (Tout - tile * kTM) < kTM ? (Tout - tile * kTM) : kTM;
    acc += (double)rows * (double)base[((long long)tile * Cout + c) * 2];
  }
  red[tid] = acc;
  __syncthreads();
  for (int off = 64; off > 0; off >>= 1) {
    if (tid < off) red[tid] += red[tid + off];
    __syncthreads();
  }
  if (tid == 0) mean_sh = red[0] / n_total;
  __syncthreads();
  const double mean = mean_sh;

  acc = 0.0;
  for (long long e = tid; e < entries; e += 128) {
    const int tile = (int)(e / cg), c = g * cg + (int)(e % cg);
    const int rows = (Tout - tile * kTM) < kTM ? (Tout - tile * kTM) : kTM;
    const float* p = base + ((long long)tile * Cout + c) * 2;
    const double d = (double)p[0] - mean;
    acc += (double)p[1] + (double)rows * d * d;
  }
  red[tid] = acc;
  __syncthreads();
  for (int off = 64; off > 0; off >>= 1) {
    if (tid < off) red[tid] += red[tid + off];
    __syncthreads();
  }
  if (tid == 0) {
    const double var = red[0] / n_total;
    float* o = stats + ((long long)b * groups + g) * 2;
    o[0] = (float)mean;
    o[1] = (float)(1.0 / sqrt(var + (double)eps));
  }
}

__device__ __forceinline__ float gelu_tanh(float v) {
  const float inner = 0.7978845608028654f * (v + 0.044715f * (v * v * v));
  return v * (0.5f * (1.0f + tanhf(inner)));
}

// A block per (kNormRows rows, batch row): the batch row's statistics,
// (v - mean) * rstd * gamma + beta [+ skip] [gelu] from the f32
// convolution `src` into `dst` (in place for f32: src == dst), four channels
// a thread where Cout % 4 == 0 and the pointers allow it; 32-bit index
// arithmetic within the block. gamma, beta, skip and dst are of type T.
constexpr int kNormRows = 32;

template <typename T>
__device__ __forceinline__ float normalise(float v, const float* st, int c,
                                           int cg, const T* gamma,
                                           const T* beta) {
  const float* sg = st + (c / cg) * 2;
  return (v - sg[0]) * sg[1] * load_f32(gamma, c) + load_f32(beta, c);
}

__device__ __forceinline__ void load4(const float* p, float (&r)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
}
__device__ __forceinline__ void load4(const bf16_t* p, float (&r)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  r[0] = __uint_as_float(u.x << 16);
  r[1] = __uint_as_float(u.x & 0xFFFF0000u);
  r[2] = __uint_as_float(u.y << 16);
  r[3] = __uint_as_float(u.y & 0xFFFF0000u);
}
__device__ __forceinline__ void store4(float* p, const float (&r)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
}
__device__ __forceinline__ void store4(bf16_t* p, const float (&r)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(
      (uint32_t)to_bf16(r[0]) | ((uint32_t)to_bf16(r[1]) << 16),
      (uint32_t)to_bf16(r[2]) | ((uint32_t)to_bf16(r[3]) << 16));
}

template <typename T>
__global__ void __launch_bounds__(256)
norm_kernel(const float* src, T* dst, const float* __restrict__ stats,
            const T* __restrict__ gamma, const T* __restrict__ beta,
            const T* __restrict__ skip, int Tout, int Cout, int cg,
            int groups, int act, int vec) {
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kNormRows;
  const int rows = Tout - r0 < kNormRows ? Tout - r0 : kNormRows;
  const long long base = ((long long)b * Tout + r0) * Cout;
  const float* in = src + base;
  T* o = dst + base;
  const T* sk = skip != nullptr ? skip + base : nullptr;
  const float* st = stats + (long long)b * groups * 2;
  const int n = rows * Cout;
  if (vec) {
    for (int i = 4 * threadIdx.x; i < n; i += 4 * blockDim.x) {
      const int c = i % Cout;
      float r[4], add[4] = {0.f, 0.f, 0.f, 0.f};
      load4(in + i, r);
      if (sk != nullptr) load4(sk + i, add);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        r[j] = normalise(r[j], st, c + j, cg, gamma, beta) + add[j];
        if (act) r[j] = gelu_tanh(r[j]);
      }
      store4(o + i, r);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      float v = normalise(in[i], st, i % Cout, cg, gamma, beta);
      if (sk != nullptr) v += load_f32(sk, i);
      if (act) v = gelu_tanh(v);
      store(o, i, v);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* bias, const void* gamma,
           const void* beta, const void* skip, void* out, float* conv,
           void* partial, void* stats, int B, int T_len, int Cin, int Cout,
           int K, int s, int pad_left, int Tout, int groups, float eps,
           int act, void* stream) {
  if (B <= 0 || T_len <= 0 || Cin <= 0 || Cout <= 0 || K <= 0 || s <= 0 ||
      Tout <= 0 || groups <= 0 || Cout % groups != 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  constexpr int kCopies = sizeof(T) == 4 ? 2 : 1;   // hi and lo, or hi
  constexpr unsigned kVecAlign = sizeof(T) == 4 ? 15u : 7u;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (Tout + kTM - 1) / kTM;
  const int n_chunks = (Cout + kTN - 1) / kTN;
  if ((long long)n_tiles * n_chunks > 0x7FFFFFFFll ||
      (long long)kNormRows * Cout > 0x7FFFFFFFll)
    return (int)cudaErrorInvalidValue;
  // the most taps a block takes at once within its shared-memory budget
  int taps = K;
  while (taps > 1 && smem_bytes(taps, s, kCopies) > kSmemBudget) --taps;
  const int smem = smem_bytes(taps, s, kCopies);
  static int ready[64];
  cudaError_t err = tf32x3::allow_smem(conv_kernel<T>, kSmemBudget, ready);
  if (err != cudaSuccess) return (int)err;
  const int vec_x = (Cin % 4 == 0 && ((uintptr_t)x & kVecAlign) == 0) ? 1 : 0;
  const int vec_w = (Cout % 4 == 0 && ((uintptr_t)w & kVecAlign) == 0) ? 1 : 0;
  const int cg = Cout / groups;
  conv_kernel<T><<<dim3((unsigned)(n_tiles * n_chunks), B), kThreads, smem,
                   st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), conv, static_cast<float*>(partial), T_len,
      Cin, Cout, K, s, pad_left, Tout, n_tiles, n_chunks, taps, vec_x,
      vec_w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_kernel<<<dim3(groups, B), 128, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(stats), Cout,
      cg, Tout, n_tiles, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int vec = (Cout % 4 == 0 &&
                   (((uintptr_t)out | (uintptr_t)skip) & kVecAlign) == 0 &&
                   ((uintptr_t)conv & 15u) == 0) ? 1 : 0;
  norm_kernel<T><<<dim3((Tout + kNormRows - 1) / kNormRows, B), 256, 0, st>>>(
      conv, static_cast<T*>(out), static_cast<const float*>(stats),
      static_cast<const T*>(gamma), static_cast<const T*>(beta),
      static_cast<const T*>(skip), Tout, Cout, cg, groups, act, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, T, Cin), w (K, Cin, Cout), bias/gamma/beta (Cout,), skip (B, Tout,
// Cout) or null, out (B, Tout, Cout), partial (B, n_tiles, Cout, 2) with
// n_tiles = ceil(Tout / 128), stats (B, groups, 2); all contiguous f32 on the
// device. Returns the first cudaError_t of the three launches (0 on
// success).
extern "C" int conv_gn_fwd(const void* x, const void* w, const void* bias,
                           const void* gamma, const void* beta,
                           const void* skip, void* out, void* partial,
                           void* stats, int B, int T, int Cin, int Cout,
                           int K, int s, int pad_left, int Tout, int groups,
                           float eps, int act, void* stream) {
  return launch<float>(x, w, bias, gamma, beta, skip, out,
                       static_cast<float*>(out), partial, stats, B, T, Cin,
                       Cout, K, s, pad_left, Tout, groups, eps, act, stream);
}

// The bf16 form: x, w, bias, gamma, beta, skip and out bf16, conv an f32
// (B, Tout, Cout) scratch for the convolution before the GroupNorm; partial
// and stats f32 as above.
extern "C" int conv_gn_fwd_bf16(const void* x, const void* w,
                                const void* bias, const void* gamma,
                                const void* beta, const void* skip, void* out,
                                void* conv, void* partial, void* stats, int B,
                                int T, int Cin, int Cout, int K, int s,
                                int pad_left, int Tout, int groups, float eps,
                                int act, void* stream) {
  return launch<bf16_t>(x, w, bias, gamma, beta, skip, out,
                        static_cast<float*>(conv), partial, stats, B, T, Cin,
                        Cout, K, s, pad_left, Tout, groups, eps, act, stream);
}
