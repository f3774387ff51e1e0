// Strided SAME Conv1d -> GroupNorm [-> + skip] [-> tanh-GELU] for Hopper
// (sm_90a), f32.
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
// T=32,000, 64 -> 128, k=7, s=2: 0.44 ms at the 67 TFLOP/s of f32 outside the
// tensor cores; the bytes of the same call, 262 MB, are 0.08 ms).
//
// Design. GroupNorm's statistics span a whole batch row, so no block can
// finish from its own tile, and blocks do not run in order as the TPU's grid
// does. Three kernels on one stream, with two small scratch buffers between
// them, instead of one block walking a row twice:
//   1. conv_kernel: a (64 rows x 64 channels) output tile per block, 4 x 4
//      outputs per thread, the contraction over (tap, 16 input channels)
//      staged through shared memory. The tile is written to `out` with its
//      bias, and for each of its channels the tile's mean and its sum of
//      squares about that mean go to `partial`. The convolution is computed
//      here, by this code: no library is called.
//   2. stats_kernel: one block per (batch row, group) merges the partials
//      of its channels and tiles with the pairwise-merge formula (Chan et
//      al.) in double precision: mean and 1 / sqrt(var + eps) to `stats`.
//   3. norm_kernel: elementwise over `out`, in place:
//      (v - mean) * rstd * gamma + beta [+ skip] [gelu].
// Centred partial sums, not sum and sum of squares (what the TPU kernel
// accumulates): E[v^2] - mean^2 in f32 loses the variance when the mean is
// far from zero. All reductions run in a fixed order, without atomics, so a
// call gives the same bits every time. Any K >= 1, any s >= 1 and any
// groups | Cout are taken: the TPU kernel's two geometry guards came from its
// DMA window.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTM = 64;          // output rows per tile
constexpr int kTN = 64;          // output channels per tile
constexpr int kKC = 16;          // input channels per staged slice
constexpr int kAP = kTM + 4;     // pitch of the A slice (keeps float4 aligned)
constexpr int kThreads = 256;    // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kThreads)
conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, float* __restrict__ out,
            float* __restrict__ partial, int T, int Cin, int Cout, int K,
            int s, int pad_left, int Tout, int n_tiles) {
  __shared__ __align__(16) float As[kKC][kAP];
  __shared__ __align__(16) float Bs[kKC][kTN];
  __shared__ float red[16][kTN];
  __shared__ float tile_mean[kTN];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int tile = blockIdx.x;
  const int row0 = tile * kTM;
  const int n0 = blockIdx.y * kTN;
  const int b = blockIdx.z;
  const float* xb = x + (long long)b * T * Cin;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k = 0; k < K; ++k) {
    for (int c0 = 0; c0 < Cin; c0 += kKC) {
      // A slice: As[kk][m] = x[b, (row0 + m) * s + k - pad_left, c0 + kk]
#pragma unroll
      for (int j = 0; j < (kTM * kKC) / kThreads; ++j) {
        const int e = tid + j * kThreads;
        const int kk = e & (kKC - 1), m = e / kKC;
        const long long t_in = (long long)(row0 + m) * s + k - pad_left;
        float v = 0.0f;
        if (row0 + m < Tout && t_in >= 0 && t_in < T && c0 + kk < Cin)
          v = xb[t_in * Cin + c0 + kk];
        As[kk][m] = v;
      }
      // B slice: Bs[kk][n] = w[k, c0 + kk, n0 + n]
#pragma unroll
      for (int j = 0; j < (kKC * kTN) / kThreads; ++j) {
        const int e = tid + j * kThreads;
        const int n = e & (kTN - 1), kk = e / kTN;
        float v = 0.0f;
        if (c0 + kk < Cin && n0 + n < Cout)
          v = w[((long long)k * Cin + c0 + kk) * Cout + n0 + n];
        Bs[kk][n] = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kKC; ++kk) {
        const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
        const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * bb[j];
      }
      __syncthreads();
    }
  }

  // bias, store, and the tile's per-channel mean and centred sum of squares
  const int valid_rows = (Tout - row0) < kTM ? (Tout - row0) : kTM;
  float colsum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = n0 + tx * 4 + j;
    const float bv = c < Cout ? bias[c] : 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty * 4 + i;
      acc[i][j] += bv;
      if (r < Tout && c < Cout) {
        out[((long long)b * Tout + r) * Cout + c] = acc[i][j];
        colsum[j] += acc[i][j];
      }
    }
    red[ty][tx * 4 + j] = colsum[j];
  }
  __syncthreads();
  if (tid < kTN) {
    float sum = 0.0f;
#pragma unroll
    for (int r = 0; r < 16; ++r) sum += red[r][tid];
    tile_mean[tid] = sum / (float)valid_rows;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float mu = tile_mean[tx * 4 + j];
    float sq = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float d = acc[i][j] - mu;
      if (row0 + ty * 4 + i < Tout) sq += d * d;
    }
    red[ty][tx * 4 + j] = sq;
  }
  __syncthreads();
  if (tid < kTN && n0 + tid < Cout) {
    float m2 = 0.0f;
#pragma unroll
    for (int r = 0; r < 16; ++r) m2 += red[r][tid];
    float* p = partial + (((long long)b * n_tiles + tile) * Cout + n0 + tid) * 2;
    p[0] = tile_mean[tid];
    p[1] = m2;
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

__global__ void __launch_bounds__(kThreads)
norm_kernel(float* __restrict__ out, const float* __restrict__ stats,
            const float* __restrict__ gamma, const float* __restrict__ beta,
            const float* __restrict__ skip, long long total,
            long long per_batch, int Cout, int cg, int groups, int act) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const int c = (int)(e % Cout);
    const long long b = e / per_batch;
    const float* st = stats + (b * groups + c / cg) * 2;
    float v = (out[e] - st[0]) * st[1] * gamma[c] + beta[c];
    if (skip != nullptr) v += skip[e];
    if (act) v = gelu_tanh(v);
    out[e] = v;
  }
}

}  // namespace

// x (B, T, Cin), w (K, Cin, Cout), bias/gamma/beta (Cout,), skip (B, Tout,
// Cout) or null, out (B, Tout, Cout), partial (B, n_tiles, Cout, 2) with
// n_tiles = ceil(Tout / 64), stats (B, groups, 2); all contiguous f32 on the
// device. Returns the first cudaError_t of the three launches (0 on
// success).
extern "C" int conv_gn_fwd(const void* x, const void* w, const void* bias,
                           const void* gamma, const void* beta,
                           const void* skip, void* out, void* partial,
                           void* stats, int B, int T, int Cin, int Cout,
                           int K, int s, int pad_left, int Tout, int groups,
                           float eps, int act, void* stream) {
  if (B <= 0 || T <= 0 || Cin <= 0 || Cout <= 0 || K <= 0 || s <= 0 ||
      Tout <= 0 || groups <= 0 || Cout % groups != 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (Tout + kTM - 1) / kTM;
  const int n_chunks = (Cout + kTN - 1) / kTN;
  if (n_chunks > 65535) return (int)cudaErrorInvalidValue;
  const int cg = Cout / groups;
  conv_kernel<<<dim3(n_tiles, n_chunks, B), kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out),
      static_cast<float*>(partial), T, Cin, Cout, K, s, pad_left, Tout,
      n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_kernel<<<dim3(groups, B), 128, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(stats), Cout,
      cg, Tout, n_tiles, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long per_batch = (long long)Tout * Cout;
  const long long total = per_batch * B;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;   // grid-stride beyond that
  norm_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<float*>(out), static_cast<const float*>(stats),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float*>(skip), total, per_batch, Cout, cg, groups,
      act);
  return (int)cudaGetLastError();
}
