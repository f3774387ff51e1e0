// Strided SAME Conv1d -> GroupNorm [-> + skip] [-> tanh-GELU] for Hopper
// (sm_90a): f32, the convolution on the tensor cores in split TF32; bf16
// (below), by wgmma.
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
// the function of the JAX package's conv_gn_reference (conv_gn_pallas.py:
// 255-276): the convolution summed in f32, the statistics and the epilogue
// in f32, one rounding to bf16 at the end (its Pallas kernel also rounds
// between its two passes, a second bf16 function, ROADMAP.md Queue 3).
// Bound: 2 * B * Tout * K * Cin * Cout operations at the dense bf16 rate or
// the bf16 bytes: 29.4 GFLOP (0.030 ms) and 131 MB (0.039 ms) at the call
// site (16, 32,000, 64 -> 128, k 7, s 2); 5.87 GFLOP (0.0059 ms) at the
// flagship block (16, 400, 256 -> 256, k 7, s 1). Design (bf16form below;
// its times and ablations in PERF.md section 6):
//   * Products on the bf16 tensor cores: wgmma m64nNTk16 (NT 16, 32 or
//     128) from shared memory into f32 accumulators kept over the whole
//     contraction (the product of two bf16 values is exact in f32). Three
//     warpgroups: one fills the ring (setmaxnreg 56), two consume (224).
//   * Unswizzled operands, core matrices of 8 rows x 16 bytes: the window
//     by stride phase as in the f32 form, as columns of 8 input channels,
//     so that tap k's A is a descriptor into the one window at row k / s,
//     any row (a swizzled layout wants 8-row-aligned starts; 128-byte
//     swizzled descriptors timed no faster). w N-major as it lies in memory
//     ([tap][8 outputs][input channel][8]), staged once for the block where
//     it fits (K * Cin * NT bf16: 112 KB at both timed shapes), else with
//     each stage, in groups of taps.
//   * A ring of stages filled by the producer with cp.async, zero-filled
//     for the SAME padding and past Cin and Cout; a stage's `full` mbarrier
//     completes when its copies land (cp.async.mbarrier.arrive), its
//     `empty` when the products that read it are done: the next stages
//     arrive while this one's products run.
//   * Fused where a block's registers hold a batch row's groups: Tout <=
//     128 MT rows, MT 64-row sub-tiles per consumer warpgroup (MT x NT <=
//     128, 64 accumulators a thread), nb (a multiple of Cout / groups)
//     channels a block. The MT accumulator chains keep the tensor cores fed
//     at a narrow NT. One launch and no f32 tensor: per-channel sums by
//     thread, over lanes by a reduce-scatter butterfly, over warps through
//     shared memory, per group in double in a fixed order (the mean, then
//     the variance about it), then the epilogue from registers. The
//     flagship block: 400 rows x 32 channels, MT 4, 128 blocks, one wave
//     of one block an SM (width 16, 256 blocks in two waves, timed 1.6x
//     slower; PERF.md). Widths 16 and 32 fused, 128 for wider groups and
//     for two passes past 32 channels: eight instantiations.
//   * Two passes where a group does not fit (the call site: 16,000 rows x 8
//     channels is 512 KB): 64-row tiles, each warpgroup every other tile of
//     its block from a ring of its own (one warpgroup's epilogue runs under
//     the other's products; a shared ring would let a warpgroup wait on a
//     later use of a slot than its own, a parity the barrier cannot tell
//     apart). The statistics pass writes only the tiles' centred partials,
//     stats_kernel<64> merges them, and the norm pass computes the
//     convolution again and normalises from registers: x read twice (65.5
//     MB more, a second 0.030 ms of products at the bf16 peak) and no f32
//     tensor, where an f32 scratch between the passes costs 262 MB (0.078
//     ms). Blocks are persistent: each keeps one slab of channels.
//   * The epilogue: (v - mean) * rstd * gamma + beta [+ skip] [GELU] in
//     f32, the GELU as v / (1 + 2^(-2 u log2 e)) (gelu_bf16_out), rounded
//     once into a bf16 copy of the tile in shared memory, written out in
//     16-byte pieces. No branch per element and no shuffle per channel:
//     with 8 warps an SM, the epilogue is bound by its latencies.
//   * The warpgroup role comes from __shfl_sync: with a role ptxas cannot
//     prove warp-uniform it serializes every wgmma (warning C7520).
// The host's plan (ops/conv_gn.py::bf16_plan) picks the path, NT, MT, the
// ring and the grid; geometry() checks it against the shared memory.
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

#include <type_traits>

#include "tf32x3.cuh"
#include "wgmma.cuh"

namespace {

using tf32x3::cp_async16;
using tf32x3::ldmatrix_x4;
using tf32x3::mma;
using tf32x3::mma3;
using tf32x3::split;

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
// (phases x rows a phase) window rows and the taps' rows of w (phases() is
// the bf16 form's too)
__host__ __device__ constexpr int phases(int taps, int s) {
  return taps < s ? taps : s;
}
__host__ __device__ constexpr int phase_rows(int taps, int s) {
  return kTM - 1 + (taps + s - 1) / s;
}
// each staged value is kept as hi and lo
inline int smem_bytes(int taps, int s) {
  return 2 * 4 * (phases(taps, s) * phase_rows(taps, s) * kXP +
                  taps * kKC * kWP);
}

// split TF32, three products per product
__global__ void __launch_bounds__(kThreads, 2)
conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, float* __restrict__ out,
            float* __restrict__ partial, int T, int Cin, int Cout, int K,
            int s, int pad_left, int Tout, int n_tiles, int n_chunks,
            int taps, int vec_x, int vec_w) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ float red[4][kTN];
  __shared__ float tile_mean[kTN];
  const int rp = phase_rows(taps, s);
  const int x_words = phases(taps, s) * rp * kXP;
  const int w_words = taps * kKC * kWP;
  uint32_t* xh = smem;                                  // [phases * rp][kXP]
  uint32_t* xl = xh + x_words;
  uint32_t* wh = xl + x_words;                          // [taps][kKC][kWP]
  uint32_t* wl = wh + w_words;

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
  const float* xb = x + (long long)b * T * Cin;

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
            if (vec_x) {
              const bool ok = in_t && c < Cin;
              cp_async16(dst, ok ? (const void*)(xb + t_in * Cin + c)
                                 : (const void*)x, ok);
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                dst[j] = __float_as_uint(in_t && c + j < Cin
                                             ? xb[t_in * Cin + c + j] : 0.f);
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
        if (vec_w) {
          const bool ok = ci < Cin && n0 + c4 < Cout;
          cp_async16(dst, ok ? (const void*)(w + src) : (const void*)w, ok);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            dst[j] = __float_as_uint(ci < Cin && n0 + c4 + j < Cout
                                         ? w[src + j] : 0.f);
        }
      }
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
          ldmatrix_x4(al[mt], xl + ao + 16 * mt * kXP);
        }
        const int wo = (tap * kKC + t) * kWP + 32 * wn + g;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const uint32_t bh[2] = {wh[wo + 8 * nt], wh[wo + 4 * kWP + 8 * nt]};
          const uint32_t bl[2] = {wl[wo + 8 * nt],
                                  wl[wo + 4 * kWP + 8 * nt]};
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mma3(acc[mt][nt], ah[mt], al[mt], bh, bl);
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
    const float b0 = n0 + col < Cout ? bias[n0 + col] : 0.f;
    const float b1 = n0 + col + 1 < Cout ? bias[n0 + col + 1] : 0.f;
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
template <int kRowsT>
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
    const int rows =
        (Tout - tile * kRowsT) < kRowsT ? (Tout - tile * kRowsT) : kRowsT;
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
    const int rows =
        (Tout - tile * kRowsT) < kRowsT ? (Tout - tile * kRowsT) : kRowsT;
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
// (v - mean) * rstd * gamma + beta [+ skip] [gelu] from the convolution
// `src` into `dst` (in place: src == dst), four channels a thread where
// Cout % 4 == 0 and the pointers allow it; 32-bit index arithmetic within
// the block.
constexpr int kNormRows = 32;

__device__ __forceinline__ float normalise(float v, const float* st, int c,
                                           int cg, const float* gamma,
                                           const float* beta) {
  const float* sg = st + (c / cg) * 2;
  return (v - sg[0]) * sg[1] * gamma[c] + beta[c];
}

__device__ __forceinline__ void load4(const float* p, float (&r)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
}
__device__ __forceinline__ void store4(float* p, const float (&r)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
}

__global__ void __launch_bounds__(256)
norm_kernel(const float* src, float* dst, const float* __restrict__ stats,
            const float* __restrict__ gamma, const float* __restrict__ beta,
            const float* __restrict__ skip, int Tout, int Cout, int cg,
            int groups, int act, int vec) {
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kNormRows;
  const int rows = Tout - r0 < kNormRows ? Tout - r0 : kNormRows;
  const long long base = ((long long)b * Tout + r0) * Cout;
  const float* in = src + base;
  float* o = dst + base;
  const float* sk = skip != nullptr ? skip + base : nullptr;
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
      if (sk != nullptr) v += sk[i];
      if (act) v = gelu_tanh(v);
      o[i] = v;
    }
  }
}

int launch(const float* x, const float* w, const float* bias,
           const float* gamma, const float* beta, const float* skip,
           float* out, float* partial, float* stats, int B, int T_len,
           int Cin, int Cout, int K, int s, int pad_left, int Tout,
           int groups, float eps, int act, void* stream) {
  if (B <= 0 || T_len <= 0 || Cin <= 0 || Cout <= 0 || K <= 0 || s <= 0 ||
      Tout <= 0 || groups <= 0 || Cout % groups != 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (Tout + kTM - 1) / kTM;
  const int n_chunks = (Cout + kTN - 1) / kTN;
  if ((long long)n_tiles * n_chunks > 0x7FFFFFFFll ||
      (long long)kNormRows * Cout > 0x7FFFFFFFll)
    return (int)cudaErrorInvalidValue;
  // the most taps a block takes at once within its shared-memory budget
  int taps = K;
  while (taps > 1 && smem_bytes(taps, s) > kSmemBudget) --taps;
  const int smem = smem_bytes(taps, s);
  static int ready[64];
  cudaError_t err = tf32x3::allow_smem(conv_kernel, kSmemBudget, ready);
  if (err != cudaSuccess) return (int)err;
  const int vec_x = (Cin % 4 == 0 && ((uintptr_t)x & 15u) == 0) ? 1 : 0;
  const int vec_w = (Cout % 4 == 0 && ((uintptr_t)w & 15u) == 0) ? 1 : 0;
  const int cg = Cout / groups;
  conv_kernel<<<dim3((unsigned)(n_tiles * n_chunks), B), kThreads, smem,
                st>>>(x, w, bias, out, partial, T_len, Cin, Cout, K, s,
                      pad_left, Tout, n_tiles, n_chunks, taps, vec_x, vec_w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_kernel<kTM><<<dim3(groups, B), 128, 0, st>>>(partial, stats, Cout, cg,
                                                      Tout, n_tiles, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int vec = (Cout % 4 == 0 &&
                   (((uintptr_t)out | (uintptr_t)skip) & 15u) == 0) ? 1 : 0;
  norm_kernel<<<dim3((Tout + kNormRows - 1) / kNormRows, B), 256, 0, st>>>(
      out, out, stats, gamma, beta, skip, Tout, Cout, cg, groups, act, vec);
  return (int)cudaGetLastError();
}

// ── the bf16 form ───────────────────────────────────────────────────────
namespace bf16form {

using bf16 = __nv_bfloat16;
using wgmma::smem_u32;

constexpr int kRows = 128;       // rows of a fused sub-tile pair: 64 a
                                 // consumer warpgroup
constexpr int kRowsPP = 64;      // rows of a tile of the two passes
constexpr int kThreads = 384;    // warpgroups 0 and 1 consume, 2 produces
constexpr int kProducers = 128;
// registers a thread of the producer and of the consumers (the 64K of an
// SM: 128 x 56 + 256 x 224)
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
constexpr int kMinStages = 2, kMaxStages = 8;
// dynamic shared memory; the static arrays of the kernel take 8.5 KB of the
// 227 KB a block may use
constexpr int kSmemBudget = 218 * 1024;
enum { kFused = 0, kStats = 1, kNorm = 2 };

// Geometry of one call, from the host's plan (ops/conv_gn.py::bf16_plan,
// whose byte counts are these): tiles of `rows` rows x nt channels (nt the
// wgmma width, 16, 32 or 128; a block owns nb <= nt of them); each ring
// stage holds the window of one tap group (`taps` taps) for ck input
// channels, and that group's w where w is not resident. Fused, one tile is
// a whole batch row (Tout <= 128 MT rows, both warpgroups); otherwise MT is
// 1 and a tile is 64 rows of one warpgroup.
struct Geo {
  int B, T, Cin, Cout, K, s, pad_left, Tout, groups, cg, act, mode;
  float eps;
  int nb, ck, taps, stages, resident;
  int rows, cin16, n_chunks, n_tg, rp, n_slabs, n_tiles;
  int ring_stages;   // stages a ring: all fused; half, a warpgroup each,
                     // in the two passes
  int slot_x, slot, w_res, out_extra;   // bytes
  int vec_x, vec_w;
};

// Fills g from the call and the plan; returns the dynamic shared memory in
// bytes, or -1 where the plan does not fit the call.
inline int geometry(Geo& g, int B, int T, int Cin, int Cout, int K, int s,
                    int pad_left, int Tout, int groups, float eps, int act,
                    int fused, int nt, int mt, int nb, int ck, int taps,
                    int stages, int resident) {
  if (B <= 0 || T <= 0 || Cin <= 0 || Cout <= 0 || K <= 0 || s <= 0 ||
      Tout <= 0 || groups <= 0 || Cout % groups != 0)
    return -1;
  if ((nt != 16 && nt != 32 && nt != 128) ||
      (mt != 1 && mt != 2 && mt != 4 && mt != 8) || mt * nt > 128 ||
      (!fused && mt != 1) || nb <= 0 || nb > nt || ck <= 0 ||
      ck % 16 != 0 || taps <= 0 || taps > K || stages < kMinStages ||
      stages > kMaxStages || (resident && taps != K) ||
      (!fused && stages % 2 != 0) || (!fused && stages < 2 * kMinStages))
    return -1;
  g = Geo{};
  g.B = B; g.T = T; g.Cin = Cin; g.Cout = Cout; g.K = K; g.s = s;
  g.pad_left = pad_left; g.Tout = Tout; g.groups = groups;
  g.cg = Cout / groups; g.act = act; g.eps = eps;
  g.mode = fused ? kFused : kStats;
  g.nb = nb; g.ck = ck; g.taps = taps;
  g.stages = stages; g.resident = resident;
  if (fused && (nb % g.cg != 0 || Tout > kRows * mt)) return -1;
  g.cin16 = (Cin + 15) / 16 * 16;
  g.n_chunks = (g.cin16 + ck - 1) / ck;
  g.n_tg = (K + taps - 1) / taps;
  g.rows = fused ? kRows * mt : kRowsPP;
  g.ring_stages = fused ? stages : stages / 2;
  g.rp = g.rows - 1 + (taps + s - 1) / s;
  g.n_slabs = (Cout + nb - 1) / nb;
  g.n_tiles = (Tout + g.rows - 1) / g.rows;
  const long long slot_x = 16ll * phases(taps, s) * (ck / 8) * g.rp;
  const long long slot_w = resident ? 0 : 16ll * taps * (nt / 8) * ck;
  const long long w_res = resident ? 16ll * K * (nt / 8) * g.cin16 : 0;
  // the bf16 copy of a normalised tile (rows of 2 nt + 16 bytes): in the
  // ring when fused and the ring holds it, else one a warpgroup after it
  const long long ring = stages * (slot_x + slot_w);
  const long long out_tile = (long long)kRows * mt * (2 * nt + 16);
  const long long out_extra =
      fused ? (out_tile > ring ? out_tile - ring : 0) : out_tile;
  const long long total = w_res + ring + out_extra + 16ll * stages;
  if (total > kSmemBudget) return -1;
  g.slot_x = (int)slot_x;
  g.slot = (int)(slot_x + slot_w);
  g.w_res = (int)w_res;
  g.out_extra = (int)out_extra;
  return (int)total;
}

__device__ __forceinline__ void bar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("{\n\t.reg .b64 state;\n\t"
               "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}"
               :: "r"(bar) : "memory");
}

// Wait (acquire) until the phase of the given parity has completed; a wait
// that lasts seconds is a fault of the protocol and traps. The loop is in
// the asm, so no branch of the C++ follows the barrier's answer.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  asm volatile("{\n\t.reg .pred p;\n\t.reg .u32 n;\n\tmov.u32 n, 0;\n"
               "WAIT:\n\t"
               "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
               "@p bra DONE;\n\t"
               "add.u32 n, n, 1;\n\t"
               "setp.eq.u32 p, n, 16777216;\n\t"
               "@p trap;\n\t"
               "bra WAIT;\n"
               "DONE:\n\t}" :: "r"(bar), "r"(parity) : "memory");
}

// one arrival on bar once every cp.async this thread has issued has landed
// (counted among the arrivals the barrier was set up for)
__device__ __forceinline__ void bar_arrive_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
               :: "r"(bar) : "memory");
}

// the two consumer warpgroups alone (the producer may have left)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// shared memory written through the generic proxy (by this thread, or seen
// by it through a barrier) is seen by the products that follow (wgmma reads
// through the async proxy)
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16 bytes of shared memory at dst: the n_ok bf16 values at src, zeros
// after them (plain loads: src need not be aligned)
__device__ __forceinline__ void put8(unsigned char* dst, const bf16* src,
                                     int n_ok) {
  uint32_t v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    v[e] = e < n_ok ? (uint32_t)__bfloat16_as_ushort(src[e]) : 0u;
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16, v[4] | v[5] << 16,
                 v[6] | v[7] << 16);
}

__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }

// The tanh-GELU as 0.5 v (1 + tanh(u)) = v / (1 + 2^(-2 u log2 e)), u =
// sqrt(2 / pi) (v + 0.044715 v^3), by ex2.approx and a fast division:
// about a third of the instructions of gelu_tanh's accurate tanhf, within a
// few f32 ulps of it (the term 1 + tanh(u) needs tanh to an absolute, not a
// relative, error), so that the output's one rounding to bf16 differs from
// the plain version's only where the two straddle a rounding boundary. For
// v far below zero the power is infinite and the quotient -0. gelu_tanh in
// its place timed 6 % slower at the call site and raised the share of
// outputs bit-equal to the plain version by 4e-5 of 1.4e-4 to 4.5e-4 that
// differ, the rest from the tensor cores' order of sums (PERF.md).
__device__ __forceinline__ float gelu_bf16_out(float v) {
  const float u = v + 0.044715f * (v * v * v);
  float e;
  asm("ex2.approx.f32 %0, %1;" : "=f"(e) : "f"(-2.302208198f * u));
  return __fdividef(v, 1.0f + e);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The tiles a block takes: every block keeps one slab of nb channels (its
// resident w); the blocks of a slab share out the (batch row, tile) items.
// Fused, a tile is a whole batch row.
struct Walk {
  int slab, first, step, n_items;
  __device__ Walk(const Geo& g) {
    slab = blockIdx.x % g.n_slabs;
    first = blockIdx.x / g.n_slabs;
    step = gridDim.x / g.n_slabs;
    n_items = g.B * g.n_tiles;
  }
};

// Conv [-> statistics | -> norm, skip, GELU], one tile of 128 MT rows x NT
// channels at a time. Consumer warpgroup wg takes the 64-row sub-tiles
// rows 128 m + 64 wg .. + 63 (m < MT), each in its own accumulators, so
// that MT chains of wgmma are in flight per warpgroup; warpgroup 2 fills
// the ring.
template <int NT, int MT>
__global__ void __launch_bounds__(kThreads, 1)
conv_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 const bf16* __restrict__ bias, const bf16* __restrict__ gamma,
                 const bf16* __restrict__ beta, const bf16* __restrict__ skip,
                 bf16* __restrict__ out, float* __restrict__ partial,
                 const float* __restrict__ stats, const Geo g) {
  constexpr int NQ = NT / 8;            // core matrices of 8 channels
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[8][NT];          // per consumer warp, per channel
  __shared__ float col_mean[2][NT], col_rstd[2][NT];   // per warpgroup
  __shared__ float col_bias[NT], col_gamma[NT], col_beta[NT];
  __shared__ double col_total[NT];      // kFused: a channel's total
  unsigned char* wres = smem;                          // [K][NQ][cin16][8]
  unsigned char* ring = smem + g.w_res;                // [stages][slot]
  // the normalised tile in bf16: the ring itself when fused (by then every
  // stage has been read), else its own rows after the ring
  unsigned char* sout = g.mode == kFused ? ring : ring + g.stages * g.slot;
  const uint32_t full = smem_u32(ring + g.stages * g.slot + g.out_extra);
  const uint32_t empty = full + 8 * g.stages;

  const Walk walk(g);
  const int n0 = walk.slab * g.nb;
  const int n_end = min(g.Cout, n0 + g.nb);   // channels this block stores
  const int nbv = n_end - n0;

  if (g.resident) {   // w of the slab, once, by every thread
    const int n = g.K * NQ * g.cin16;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int q = i % NQ, rest = i / NQ;
      const int ci = rest % g.cin16, k = rest / g.cin16;
      const int nn = n0 + 8 * q;
      unsigned char* dst = wres + 16 * ((k * NQ + q) * g.cin16 + ci);
      const bool ok = ci < g.Cin && nn < n_end;
      const bf16* src = w + ((long long)k * g.Cin + ci) * g.Cout + nn;
      if (g.vec_w) {
        tf32x3::cp_async16(dst, ok ? (const void*)src : (const void*)w, ok);
      } else {
        put8(dst, src, ok ? min(8, n_end - nn) : 0);
      }
    }
    tf32x3::cp_async_commit();
    tf32x3::cp_async_wait<0>();
    proxy_fence();
  }
  if (threadIdx.x < NT) {   // the slab's bias and affine, as f32
    const bool ok = (int)threadIdx.x < nbv;
    col_bias[threadIdx.x] = ok ? widen(bias[n0 + threadIdx.x]) : 0.f;
    col_gamma[threadIdx.x] = ok ? widen(gamma[n0 + threadIdx.x]) : 0.f;
    col_beta[threadIdx.x] = ok ? widen(beta[n0 + threadIdx.x]) : 0.f;
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < g.stages; ++i) {
      bar_init(full + 8 * i, kProducers);
      // one arrival per warp that reads the stage: both consumer
      // warpgroups fused, one in the two passes
      bar_init(empty + 8 * i, g.mode == kFused ? 8 : 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the warpgroup's role, warp-uniform to the compiler (shuffled from lane
  // 0): with a role it cannot prove uniform, ptxas serializes every wgmma
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 2) {
    // ── the producer: the window (and w where it is not resident) of each
    // stage by cp.async; it gives registers to the consumers ──
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    const int p = threadIdx.x - 256;
    const int jn = g.ck / 8;
    // all of a stage's copies by cp.async: its `full` completes when they
    // land (cp.async.mbarrier.arrive), and the producer goes on to the next
    // slot at once; with plain loads among them, once they are stored
    const bool async = g.vec_x && (g.resident || g.vec_w);
    int used[2] = {0, 0};   // stages filled in each ring
    for (int k = 0;; ++k) {
      const int it = walk.first + k * walk.step;
      if (it >= walk.n_items) break;
      const int b = it / g.n_tiles, tile = it % g.n_tiles;
      const int ring_of = g.mode == kFused ? 0 : (k & 1);
      const bf16* xb = x + (long long)b * g.T * g.Cin;
      for (int tg = 0; tg < g.n_tg; ++tg) {
        const int k0 = tg * g.taps;
        const int kt = min(g.taps, g.K - k0);
        const long long t_first =
            (long long)tile * g.rows * g.s - g.pad_left + k0;
        const int nx = phases(kt, g.s) * g.rp * jn;
        for (int c = 0; c < g.n_chunks; ++c) {
          const int j = used[ring_of]++;
          const int slot = ring_of * g.ring_stages + j % g.ring_stages;
          if (j >= g.ring_stages)
            bar_wait(empty + 8 * slot, (j / g.ring_stages - 1) & 1);
          unsigned char* sx = ring + slot * g.slot;
          // piece i = (ph * rp + r) * jn + j: jn divides the 128 producers,
          // so a thread keeps its column j and steps r
          {
            const int j = p % jn, cin = c * g.ck + 8 * j;
            const int dr = kProducers / jn;
            int r = p / jn, ph = 0;
            for (int i = p; i < nx; i += kProducers, r += dr) {
              while (r >= g.rp) {
                r -= g.rp;
                ++ph;
              }
              const long long t_in = t_first + (long long)r * g.s + ph;
              unsigned char* dst = sx + 16 * ((ph * jn + j) * g.rp + r);
              const bool ok = t_in >= 0 && t_in < g.T && cin < g.Cin;
              const bf16* src = xb + t_in * g.Cin + cin;
              if (g.vec_x) {
                tf32x3::cp_async16(dst, ok ? (const void*)src
                                           : (const void*)x, ok);
              } else {
                put8(dst, src, ok ? min(8, g.Cin - cin) : 0);
              }
            }
          }
          if (!g.resident) {
            // piece i = (tl * ck + ci) * NQ + q, q fixed for a thread
            unsigned char* sw = sx + g.slot_x;
            const int nw = kt * NQ * g.ck;
            const int q = p % NQ, nn = n0 + 8 * q;
            const int dci = kProducers / NQ;
            int ci = p / NQ, tl = 0;
            for (int i = p; i < nw; i += kProducers, ci += dci) {
              while (ci >= g.ck) {
                ci -= g.ck;
                ++tl;
              }
              const int cig = c * g.ck + ci;
              unsigned char* dst = sw + 16 * ((tl * NQ + q) * g.ck + ci);
              const bool ok = cig < g.Cin && nn < n_end;
              const bf16* src =
                  w + ((long long)(k0 + tl) * g.Cin + cig) * g.Cout + nn;
              if (g.vec_w) {
                tf32x3::cp_async16(dst, ok ? (const void*)src
                                           : (const void*)w, ok);
              } else {
                put8(dst, src, ok ? min(8, n_end - nn) : 0);
              }
            }
          }
          if (async) {
            bar_arrive_copies(full + 8 * slot);
          } else {
            tf32x3::cp_async_commit();
            tf32x3::cp_async_wait<0>();
            proxy_fence();
            bar_arrive(full + 8 * slot);
          }
        }
      }
    }
    tf32x3::cp_async_commit();
    tf32x3::cp_async_wait<0>();   // no copy outlives its thread
    return;
  }

  // ── the consumers: the accumulators and the epilogue's values of a
  // 128-channel tile need more than the 168 registers a thread of a
  // 384-thread block gets (ptxas spilled the epilogue without this) ──
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(kConsumerRegs));
  const int tid = threadIdx.x;           // 0 .. 255
  const int wg = role, warp = tid / 32, wq = warp % 4;
  const int lane = tid & 31, gq = lane >> 2, t = lane & 3;
  const int cg = g.cg;
  const uint32_t wres_a = smem_u32(wres);
  // Fused, both warpgroups take each tile (warpgroup wg its rows 128 m +
  // 64 wg ..); in the two passes each warpgroup takes every other tile of
  // the block's (ping-pong): while one normalises or reduces its tile, the
  // other's products run.
  const bool pp = g.mode != kFused;
  const int lt = pp ? tid - 128 * wg : tid;   // a thread among its tile's
  const int n_thr = pp ? 128 : 256;
  const int w0 = pp ? 4 * wg : 0, n_w = pp ? 4 : 8;   // the tile's warps
  auto tile_sync = [&]() {
    if (pp) {
      asm volatile("bar.sync %0, 128;\n" :: "r"(2 + wg) : "memory");
    } else {
      consumers_sync();
    }
  };
  float* const cmean = col_mean[pp ? wg : 0];
  float* const crstd = col_rstd[pp ? wg : 0];
  constexpr int P = 2 * NT + 16;        // bytes of a row of the bf16 copy
  unsigned char* const my_out = sout + (pp ? wg * kRowsPP * P : 0);
  // Thread (gq, t) of warp wq of its warpgroup holds, in acc[m][4 i + 2 h
  // + c], row 128 m + row_base + 8 h of the tile and column 8 i + 2 t + c.
  const int row_base = (pp ? 0 : 64 * wg) + 16 * wq + gq;
  auto release = [&](int slot) {
    __syncwarp();
    if (lane == 0) bar_arrive(empty + 8 * slot);
  };

  float acc[MT][NT / 2];
  // Each channel's sum of value(v, col) over the tile's first `valid`
  // rows into red[warp][col]: by thread in registers, then over the 8
  // lanes gq that hold the same channels by a reduce-scatter butterfly
  // (each round a lane keeps half of its channels and receives its
  // partner's half of them: NT / 4 - NT / 32 shuffles, not 3 NT / 4). No
  // branch inside: a branch per element keeps the compiler from
  // interleaving them.
  auto column_sums = [&](int valid, auto value) {
    constexpr int J = NT / 4;                  // channels a thread holds
    float cs[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int col = 8 * (j / 2) + 2 * t + (j & 1);
      float v = 0.f;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float e = value(acc[m][4 * (j / 2) + 2 * h + (j & 1)], col);
          v += 128 * m + row_base + 8 * h < valid ? e : 0.f;
        }
      cs[j] = v;
    }
    int off = 0;                               // first channel index kept
#pragma unroll
    for (int r = 0, n = J; r < 3; ++r) {
      const int o = 4 << r;
      const bool upper = (gq >> r) & 1;
      if (n > 1) {
        n /= 2;
#pragma unroll
        for (int j = 0; j < J / 2; ++j) {
          if (j < n) {
            const float send = upper ? cs[j] : cs[j + n];
            const float keep = upper ? cs[j + n] : cs[j];
            cs[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
          }
        }
        off += upper ? n : 0;
      } else {
        cs[0] += __shfl_xor_sync(0xffffffffu, cs[0], o);
      }
    }
    constexpr int kept = J >= 8 ? J / 8 : 1;
#pragma unroll
    for (int j = 0; j < kept; ++j) {
      const int jj = off + j;
      red[warp][8 * (jj / 2) + 2 * t + (jj & 1)] = cs[j];
    }
  };
  // a channel's total over the tile's warps, in a fixed order
  auto warp_total = [&](int col) {
    float s = 0.f;
    for (int i = 0; i < n_w; ++i) s += red[w0 + i][col];
    return s;
  };
  // kFused: each group's total of red, over the 8 warps for each channel,
  // then over the group's channels, in double in a fixed order; calls
  // store(gi, total) for each group
  auto group_totals = [&](auto store) {
    if (tid < nbv) {
      double s = 0.0;
#pragma unroll
      for (int i = 0; i < 8; ++i) s += red[i][tid];
      col_total[tid] = s;
    }
    consumers_sync();
    if (tid < nbv / cg) {
      double s = 0.0;
      for (int col = tid * cg; col < (tid + 1) * cg; ++col)
        s += col_total[col];
      store(tid, s);
    }
    consumers_sync();
  };
  // (v - mean) * rstd * gamma + beta [+ skip] [gelu] from registers, with
  // cmean and crstd, without a branch (the skip read at clamped indices),
  // rounded once into the tile's bf16 copy in shared memory (rows of 2 NT
  // + 16 bytes: the 8 rows a warp writes fall in distinct banks); then
  // the tile's threads write whole 16-byte pieces of its rows. Stored from
  // the accumulators' layout, each warp instruction wrote 8 rows of 16
  // bytes and took a 64-bit address and branches a pair.
  auto normalise_store = [&](auto with_skip, auto with_act, int b, int row0,
                             int valid) {
#pragma unroll
    for (int i = 0; i < NT / 8; ++i) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = min(8 * i + 2 * t + c, nbv - 1);
        const float mu = cmean[col], rs = crstd[col];
        const float ga = col_gamma[col], be = col_beta[col];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float& v = acc[m][4 * i + 2 * h + c];
            v = (v - mu) * rs * ga + be;
            if constexpr (decltype(with_skip)::value) {
              const int r = min(128 * m + row_base + 8 * h, valid - 1);
              v += widen(skip[((long long)b * g.Tout + row0 + r) * g.Cout +
                              n0 + col]);
            }
            if constexpr (decltype(with_act)::value) v = gelu_bf16_out(v);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < NT / 8; ++i)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(
              my_out + (128 * m + row_base + 8 * h) * P + 4 * (4 * i + t)) =
              pack2(acc[m][4 * i + 2 * h], acc[m][4 * i + 2 * h + 1]);
    tile_sync();
    const int pieces = (nbv + 7) / 8;
    const bool vec =
        ((n0 | g.Cout) & 7) == 0 && ((uintptr_t)out & 15u) == 0;
    for (int e = lt; e < valid * pieces; e += n_thr) {
      const int r = e / pieces, q = e - r * pieces;
      bf16* dst = out + ((long long)b * g.Tout + row0 + r) * g.Cout + n0 +
                  8 * q;
      const unsigned char* src = my_out + r * P + 16 * q;
      if (vec && 8 * q + 8 <= nbv) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int k = 0; k < 8 && 8 * q + k < nbv; ++k)
          dst[k] = reinterpret_cast<const bf16*>(src)[k];
      }
    }
  };

  auto normalise = [&](int b, int row0, int valid) {
    using yes = std::true_type;
    using no = std::false_type;
    if (skip != nullptr) {
      if (g.act) normalise_store(yes(), yes(), b, row0, valid);
      else normalise_store(yes(), no(), b, row0, valid);
    } else {
      if (g.act) normalise_store(no(), yes(), b, row0, valid);
      else normalise_store(no(), no(), b, row0, valid);
    }
  };

  // the stages this warpgroup reads, in its ring (fused, the one ring of
  // both): stage j is slot j % ring_stages of the ring, its use j /
  // ring_stages. A ring of its own keeps a warpgroup within one phase of
  // each slot's barriers: waiting on a parity, it could not tell a later
  // use from an earlier one.
  const int slot0 = pp ? wg * g.ring_stages : 0;
  int j = 0;
  for (int k = pp ? wg : 0;; k += pp ? 2 : 1) {
    const int it = walk.first + k * walk.step;
    if (it >= walk.n_items) break;
    const int b = it / g.n_tiles, tile = it % g.n_tiles;
    const int row0 = tile * g.rows;
    int pend = -1;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) acc[m][i] = 0.f;
    for (int tg = 0; tg < g.n_tg; ++tg) {
      const int k0 = tg * g.taps;
      const int kt = min(g.taps, g.K - k0);
      for (int c = 0; c < g.n_chunks; ++c, ++j) {
        const int slot = slot0 + j % g.ring_stages;
        const int steps = min(g.ck, g.cin16 - c * g.ck) / 16;
        bar_wait(full + 8 * slot, (j / g.ring_stages) & 1);
        proxy_fence();   // the copies, written by the generic proxy, are
                         // read by wgmma through the async proxy
        const uint32_t sx = smem_u32(ring + slot * g.slot);
        const uint32_t sw = g.resident
            ? wres_a + 16 * (k0 * NQ * g.cin16 + c * g.ck)
            : sx + g.slot_x;
        // B: 8 K rows (input channels) of 16 bytes a core matrix, the next
        // 8 channels of the output NQ rows of K further on
        const uint32_t b_sbo = 16 * (g.resident ? g.cin16 : g.ck);
        const uint32_t tap_b = NQ * b_sbo;
        wgmma::fence();
        for (int tl = 0; tl < kt; ++tl) {
          // tap tl's rows: phase tl % s, from position tl / s on; A's 8
          // input channels of a core matrix are one column of the window,
          // the next 8 the next column (rp rows further)
          const uint32_t a = sx + 16 * ((tl % g.s) * (g.ck / 8) * g.rp +
                                        tl / g.s + (pp ? 0 : 64 * wg));
          const uint32_t bt = sw + tl * tap_b;
          for (int kk = 0; kk < steps; ++kk) {
            const uint64_t bd = wgmma::desc_plain(bt + 256 * kk, 128, b_sbo);
#pragma unroll
            for (int m = 0; m < MT; ++m)
              wgmma::ss<NT, 1>(
                  acc[m],
                  wgmma::desc_plain(a + 2048 * m + 32 * kk * g.rp,
                                    16 * g.rp, 128),
                  bd, 1);
          }
        }
        wgmma::commit();
        if (pend >= 0) {
          wgmma::wait1();
          release(pend);
        }
        pend = slot;
      }
    }
    wgmma::wait0();
#pragma unroll
    for (int m = 0; m < MT; ++m) wgmma::fence_regs(acc[m]);
    release(pend);

    // ── the tile's epilogue ──
    const int valid = min(g.rows, g.Tout - row0);
#pragma unroll
    for (int j = 0; j < NT / 4; ++j) {
      const float bv = col_bias[8 * (j / 2) + 2 * t + (j & 1)];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        acc[m][4 * (j / 2) + (j & 1)] += bv;
        acc[m][4 * (j / 2) + 2 + (j & 1)] += bv;
      }
    }
    if (g.mode == kStats) {
      // the tile's mean and centred sum of squares of each channel
      column_sums(valid, [](float v, int) { return v; });
      tile_sync();
      if (lt < NT) cmean[lt] = warp_total(lt) / (float)valid;
      tile_sync();
      column_sums(valid, [&](float v, int col) {
        const float d = v - cmean[col];
        return d * d;
      });
      tile_sync();
      if (lt < nbv) {
        float* pr = partial +
            (((long long)b * g.n_tiles + tile) * g.Cout + n0 + lt) * 2;
        pr[0] = cmean[lt];
        pr[1] = warp_total(lt);
      }
      tile_sync();
    } else if (g.mode == kNorm) {
      // normalise from registers with the batch row's statistics
      if (lt < nbv) {
        const float* st =
            stats + ((long long)b * g.groups + (n0 + lt) / cg) * 2;
        cmean[lt] = st[0];
        crstd[lt] = st[1];
      }
      tile_sync();
      normalise(b, row0, valid);
      tile_sync();
    } else {
      // kFused: the batch row is in registers; each group's mean, then its
      // variance about the mean, merged in double in a fixed order
      const double n_el = (double)g.Tout * cg;
      column_sums(valid, [](float v, int) { return v; });
      consumers_sync();
      group_totals([&](int gi, double total) {
        const float mean = (float)(total / n_el);
        for (int col = gi * cg; col < (gi + 1) * cg; ++col)
          cmean[col] = mean;
      });
      column_sums(valid, [&](float v, int col) {
        const float d = v - cmean[col];
        return d * d;
      });
      consumers_sync();
      group_totals([&](int gi, double total) {
        const float rstd =
            (float)(1.0 / sqrt(total / n_el + (double)g.eps));
        for (int col = gi * cg; col < (gi + 1) * cg; ++col)
          crstd[col] = rstd;
      });
      normalise(b, row0, valid);
      consumers_sync();
    }
  }
}

template <int NT, int MT>
int launch_nt(const bf16* x, const bf16* w, const bf16* bias,
              const bf16* gamma, const bf16* beta, const bf16* skip,
              bf16* out, float* partial, float* stats, Geo g, int smem,
              int blocks, cudaStream_t st) {
  static int ready[64];
  cudaError_t err =
      tf32x3::allow_smem(conv_bf16_kernel<NT, MT>, kSmemBudget, ready);
  if (err != cudaSuccess) return (int)err;
  if (g.mode == kFused) {
    conv_bf16_kernel<NT, MT><<<blocks, kThreads, smem, st>>>(
        x, w, bias, gamma, beta, skip, out, partial, stats, g);
    return (int)cudaGetLastError();
  }
  // the statistics pass writes only the tiles' centred partials; the norm
  // pass computes the convolution again and normalises from registers
  conv_bf16_kernel<NT, MT><<<blocks, kThreads, smem, st>>>(
      x, w, bias, gamma, beta, skip, out, partial, stats, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_kernel<kRowsPP><<<dim3(g.groups, g.B), 128, 0, st>>>(
      partial, stats, g.Cout, g.cg, g.Tout, g.n_tiles, g.eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  g.mode = kNorm;
  conv_bf16_kernel<NT, MT><<<blocks, kThreads, smem, st>>>(
      x, w, bias, gamma, beta, skip, out, partial, stats, g);
  return (int)cudaGetLastError();
}

}  // namespace bf16form

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
  return launch(static_cast<const float*>(x), static_cast<const float*>(w),
                static_cast<const float*>(bias),
                static_cast<const float*>(gamma),
                static_cast<const float*>(beta),
                static_cast<const float*>(skip), static_cast<float*>(out),
                static_cast<float*>(partial), static_cast<float*>(stats), B,
                T, Cin, Cout, K, s, pad_left, Tout, groups, eps, act, stream);
}

// The bf16 form: x, w, bias, gamma, beta, skip and out bf16; the plan
// (fused, nt, mt, nb, ck, taps, stages, resident, blocks) from
// ops/conv_gn.py::bf16_plan. Fused: one launch, partial and stats unused
// (may be null). Otherwise partial (B, ceil(Tout / kRowsPP), Cout, 2), tiles
// of 64 rows, and stats (B, groups, 2) f32, three launches. Returns the first
// cudaError_t (cudaErrorInvalidValue for a plan that does not fit).
extern "C" int conv_gn_fwd_bf16(const void* x, const void* w,
                                const void* bias, const void* gamma,
                                const void* beta, const void* skip, void* out,
                                void* partial, void* stats, int B, int T,
                                int Cin, int Cout, int K, int s, int pad_left,
                                int Tout, int groups, float eps, int act,
                                int fused, int nt, int mt, int nb, int ck,
                                int taps, int stages, int resident,
                                int blocks, void* stream) {
  using namespace bf16form;
  Geo g;
  const int smem = geometry(g, B, T, Cin, Cout, K, s, pad_left, Tout, groups,
                            eps, act, fused, nt, mt, nb, ck, taps, stages,
                            resident);
  if (smem < 0 || blocks <= 0 || blocks % g.n_slabs != 0 ||
      (fused && blocks != B * g.n_slabs) ||
      (!fused && (partial == nullptr || stats == nullptr)))
    return (int)cudaErrorInvalidValue;
  g.vec_x = (Cin % 8 == 0 && ((uintptr_t)x & 15u) == 0) ? 1 : 0;
  g.vec_w = (Cout % 8 == 0 && (g.n_slabs == 1 || nb % 8 == 0) &&
             ((uintptr_t)w & 15u) == 0) ? 1 : 0;
  const bf16* xx = static_cast<const bf16*>(x);
  const bf16* ww = static_cast<const bf16*>(w);
  const bf16* bb = static_cast<const bf16*>(bias);
  const bf16* ga = static_cast<const bf16*>(gamma);
  const bf16* be = static_cast<const bf16*>(beta);
  const bf16* sk = static_cast<const bf16*>(skip);
  bf16* o = static_cast<bf16*>(out);
  float* pa = static_cast<float*>(partial);
  float* sta = static_cast<float*>(stats);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CONV_GN_BF16(NT, MT)                                              \
  if (nt == NT && mt == MT)                                              \
    return launch_nt<NT, MT>(xx, ww, bb, ga, be, sk, o, pa, sta, g, smem, \
                             blocks, st);
  CONV_GN_BF16(16, 1) CONV_GN_BF16(16, 2) CONV_GN_BF16(16, 4)
  CONV_GN_BF16(16, 8) CONV_GN_BF16(32, 1) CONV_GN_BF16(32, 2)
  CONV_GN_BF16(32, 4) CONV_GN_BF16(128, 1)
#undef CONV_GN_BF16
  return (int)cudaErrorInvalidValue;
}
