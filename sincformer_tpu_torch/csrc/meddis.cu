// Meddis (1986) inner-hair-cell recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel sincformer_tpu/ops/meddis_pallas.py::_kernel
// (launched by meddis_pallas). For every column (one batch x channel signal
// of N samples) the transmitter state (q, c, w) starts at the steady state
// for zero input and is advanced by forward Euler, one step per sample:
//     s = max(x + A, 0);  k = s / (s + B)
//     q = max(q + dt * (y * (M - q) + x_r * w - k * q), 0)
//     c = max(c + dt * (k * q - l * c - r * c), 0)
//     w = max(w + dt * (r * c - x_r * w), 0)
//     out = h * c
//
// Bound: not the bytes (4 read and 4 written per sample: 262 MB at 1024
// columns x 32,000 samples, 0.08 ms at 3.35 TB/s) but the chain: the N steps
// of one column depend on each other, and from one step's w to the next
// step's w run 17 dependent f32 operations (q, then c, then w). That chain
// alone, in registers (chain_probe_kernel below, timed by chip_smoke.py),
// takes 1.23 ms for 32,000 steps on an H100 at 1.98 GHz, 38 ns a step, the
// same for 1 column and for 4,000.
//
// Design: one thread per column carries (q, c, w) in registers over all N
// samples; the state never touches memory, nothing is padded and there is no
// grid over time (the TPU kernel's sequential grid, its VMEM state and its
// 128-lane padding are not carried over). Only the chain may sit on the
// walking thread's critical path, so a block is four warps with two jobs:
//   * warp 0 walks: lane l integrates column l of the block's 32 columns. It
//     touches shared memory only: it reads the permeability k 16 samples
//     ahead into registers, steps, and writes h * c back in place.
//   * warps 1-3 move: the input is (M, N) with time last, so neighbouring
//     columns sit N floats apart. Instead of transposing it in device memory
//     (as the TPU wrapper does), the movers stage (32 columns x 64 steps)
//     tiles through shared memory, every global load and store a row segment
//     of consecutive bytes, all of a mover's loads in flight together. On the
//     way in they turn x into k = s / (s + B), which depends on the input
//     alone: the IEEE division, a subroutine with a branch, stays off the
//     walker's instruction stream. On the way out they store the finished
//     tile as coalesced rows.
// Three tile buffers rotate: while tile j is walked, tile j + 1 is loaded
// and tile j - 1 stored, one __syncthreads per step of that rotation. The
// tile's pitch is odd, so the per-column walk is free of bank conflicts.
// One warp cannot do both jobs: its shared-memory accesses queue behind its
// own outstanding global copies, and the division's branch keeps the
// compiler from scheduling the loads of the next steps under the chain (a
// single-warp version took 6.6 ms at 1024 x 32,000 where this one takes 2.2).
//
// Bits: every product, sum and quotient is spelled with a round-to-nearest
// intrinsic, which the compiler may not contract into a fused multiply-add,
// and in the order of the plain PyTorch loop (ops/meddis.py::_meddis_plain,
// the counterpart of the lax.scan in dsp/haircell.py). The two are therefore
// expected to be equal, not merely close.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;            // columns per block: the walker's lanes
constexpr int kMovers = 3;           // warps that stage tiles and compute k
constexpr int kThreads = 32 * (1 + kMovers);
constexpr int kRows = (kCols + kMovers - 1) / kMovers;   // rows per mover
constexpr int kTile = 64;            // samples per staged tile
constexpr int kSegs = kTile / 32;    // 32-sample row segments per tile row
constexpr int kBatch = 16;           // steps whose k is read ahead
constexpr int kStages = 3;           // tiles in flight: load, walk, store
// floats per column in shared memory: the tile, kBatch floats that the
// read-ahead may touch, and one more to make the pitch odd
constexpr int kPitch = kTile + kBatch + 1;

// Meddis (1986) constants; must match ops/meddis.py
constexpr float kA = 5.0f, kB = 300.0f;
constexpr float kY = 5.05f, kL = 2500.0f, kR = 6580.0f;
constexpr float kX = 66.31f, kH = 50000.0f, kM = 1.0f;

// One forward-Euler step of (q, c, w) under permeability k; returns h * c.
__device__ __forceinline__ float euler_step(float k, float dt, float& q,
                                            float& c, float& w) {
  const float dq = __fmul_rn(dt, __fsub_rn(
      __fadd_rn(__fmul_rn(kY, __fsub_rn(kM, q)), __fmul_rn(kX, w)),
      __fmul_rn(k, q)));
  q = fmaxf(__fadd_rn(q, dq), 0.0f);
  const float dc = __fmul_rn(dt, __fsub_rn(
      __fsub_rn(__fmul_rn(k, q), __fmul_rn(kL, c)), __fmul_rn(kR, c)));
  c = fmaxf(__fadd_rn(c, dc), 0.0f);
  const float dw = __fmul_rn(dt, __fsub_rn(__fmul_rn(kR, c),
                                           __fmul_rn(kX, w)));
  w = fmaxf(__fadd_rn(w, dw), 0.0f);
  return __fmul_rn(kH, c);
}

// Walker: `steps` Euler steps of one column over its row of k values, which
// the outputs replace. Reads up to kBatch floats past the tile (the row's
// padding; those values are never used).
__device__ __forceinline__ void walk(float* mine, int steps, float dt,
                                     float& q, float& c, float& w) {
  float k[kBatch], k_next[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u) k[u] = mine[u];
  for (int t = 0; t < steps; t += kBatch) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) k_next[u] = mine[t + kBatch + u];
    if (t + kBatch <= steps) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) k[u] = euler_step(k[u], dt, q, c, w);
    } else {
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (t + u < steps) k[u] = euler_step(k[u], dt, q, c, w);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      mine[t + u] = k[u];
      k[u] = k_next[u];
    }
  }
}

// Mover `m`: rows m, m + kMovers, ... of the tile at sample t0, as
// k = s / (s + B) with s = max(x + A, 0).
__device__ __forceinline__ void load_tile(float* tile, const float* x,
                                          long long col0, int cols, int N,
                                          int t0, int m, int lane) {
  float v[kRows][kSegs];
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int r = m + a * kMovers;
#pragma unroll
    for (int j = 0; j < kSegs; ++j) {
      const int t = t0 + lane + 32 * j;
      v[a][j] = (r < cols && t < N) ? x[(col0 + r) * (long long)N + t] : 0.0f;
    }
  }
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int r = m + a * kMovers;
    if (r < cols) {
#pragma unroll
      for (int j = 0; j < kSegs; ++j) {
        const float s = fmaxf(__fadd_rn(v[a][j], kA), 0.0f);
        tile[r * kPitch + lane + 32 * j] = __fdiv_rn(s, __fadd_rn(s, kB));
      }
    }
  }
}

// Mover `m`: its rows of the finished tile at sample t0, to device memory.
__device__ __forceinline__ void store_tile(const float* tile, float* out,
                                           long long col0, int cols, int N,
                                           int t0, int m, int lane) {
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int r = m + a * kMovers;
#pragma unroll
    for (int j = 0; j < kSegs; ++j) {
      const int t = t0 + lane + 32 * j;
      if (r < cols && t < N)
        out[(col0 + r) * (long long)N + t] = tile[r * kPitch + lane + 32 * j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
meddis_kernel(const float* __restrict__ x, float* __restrict__ out,
              long long M, int N, float dt, float q0, float c0, float w0) {
  __shared__ float tiles[kStages][kCols * kPitch];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long col0 = (long long)blockIdx.x * kCols;
  const int cols = (int)((M - col0) < kCols ? (M - col0) : kCols);
  const int n_tiles = (N + kTile - 1) / kTile;

  float q = q0, c = c0, w = w0;
  // step i of the rotation: tile i is loaded, tile i - 1 walked, tile i - 2
  // stored, each in its own buffer
  for (int i = 0; i < n_tiles + 2; ++i) {
    if (warp == 0) {
      const int j = i - 1;
      if (j >= 0 && j < n_tiles && lane < cols) {
        const int steps = (N - j * kTile) < kTile ? (N - j * kTile) : kTile;
        walk(tiles[j % kStages] + lane * kPitch, steps, dt, q, c, w);
      }
    } else {
      if (i < n_tiles)
        load_tile(tiles[i % kStages], x, col0, cols, N, i * kTile, warp - 1,
                  lane);
      if (i >= 2)
        store_tile(tiles[(i - 2) % kStages], out, col0, cols, N,
                   (i - 2) * kTile, warp - 1, lane);
    }
    __syncthreads();
  }
}

// The chain alone: N steps in registers under a constant permeability, no
// loads, no division. Its time is the recurrence's latency floor on this
// card; chip_smoke.py measures it beside the kernel.
__global__ void __launch_bounds__(kCols)
chain_probe_kernel(float* __restrict__ out, int N, float dt, float k,
                   float q0, float c0, float w0) {
  float q = q0, c = c0, w = w0, last = 0.0f;
  for (int t = 0; t < N; ++t) last = euler_step(k, dt, q, c, w);
  out[blockIdx.x * kCols + threadIdx.x] = last;
}

}  // namespace

// out: (32 * blocks,) f32 on the device. Returns the launch's cudaError_t.
extern "C" int meddis_chain_probe(void* out, int blocks, int N, float dt,
                                  float k, float q0, float c0, float w0,
                                  void* stream) {
  if (blocks <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  chain_probe_kernel<<<(unsigned)blocks, kCols, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), N, dt, k, q0, c0, w0);
  return (int)cudaGetLastError();
}

// x, out: (M, N) contiguous f32 on the device, time last. dt is 1/sample
// rate rounded to f32 once; (q0, c0, w0) is the steady state at zero input.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int meddis_fwd(const void* x, void* out, long long M, int N,
                          float dt, float q0, float c0, float w0,
                          void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (M + kCols - 1) / kCols;
  if (blocks > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  meddis_kernel<<<(unsigned)blocks, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), M, N, dt, q0,
      c0, w0);
  return (int)cudaGetLastError();
}
