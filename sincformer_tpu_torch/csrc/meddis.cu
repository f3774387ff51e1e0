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
// alone, in registers (chain_probe_kernel below), takes 1.23 ms for 32,000
// steps on an H100 at 1.98 GHz, 38 ns a step, the same for 1 column and for
// 4,000. The kernel's aim is that the thread that walks a column pays for
// the chain and for little else.
//
// Design: one thread per column carries (q, c, w) in registers over all N
// samples; the state never touches memory and there is no grid over time
// (the TPU kernel's sequential grid, its VMEM state and its 128-lane padding
// are not carried over). A block is four warps with two jobs:
//   * warp 0 walks: lane l integrates column l of the block's kCols = 8
//     columns. It touches shared memory only, 16 bytes at a time: it reads
//     the permeability k one batch of 16 steps ahead, steps, and writes
//     h * c back in place.
//   * warps 1-3 move, each a whole (kCols x kTile) tile in turn. The input
//     is (M, N) with time last, so a tile's rows are row segments of
//     consecutive bytes; all of a tile's loads are in flight together. On
//     the way in a mover turns x into k = s / (s + B), which depends on the
//     input alone: the IEEE division (a subroutine with a branch, about 260
//     cycles a step when it is on the walker's stream) stays off the chain.
//     Before it fills a slot, the mover stores the slot's walked tile.
// The tiles sit in a ring of kSlots slots with two mbarriers each: "full"
// (the mover's 32 lanes arrive when k is in) and "walked" (the walker's 32
// lanes arrive when the outputs are in). The walker waits only for its next
// tile and only when that tile is late; a mover waits only for its slot.
// No thread waits for the whole block inside the time loop.
//
// Why this shape (scripts/torch_kernel_ablation.py on an H100, PERF.md):
// the kernel before it had 32 columns a block and one __syncthreads per
// 64-sample tile. Its movers alone took as long as the kernel (2.26 ms): at
// every tile the walker waited for their global loads and their 22
// divisions a lane. With 8 columns a block, 1024 columns are 128 blocks on
// 132 SMs and a mover has 32 divisions a lane for every 3 x 128 steps of
// the walker; the ring lets a mover run ahead. The walker as first written
// for the ring took a fifth longer (addresses recomputed between batches, k
// copied between registers, a branch around the idle lanes' steps, a
// blocking wait at every tile): the batches now go in pairs over shared
// addresses computed once, every lane steps, and the walker tests the next
// tile's barrier without waiting unless the tile is not in.
//
// Bits: every product, sum and quotient is spelled with a round-to-nearest
// intrinsic, which the compiler may not contract into a fused multiply-add,
// and in the order of the plain PyTorch loop (ops/meddis.py::_meddis_plain,
// the counterpart of the lax.scan in dsp/haircell.py). The two are therefore
// expected to be equal, not merely close.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 8;             // columns per block: the walker's lanes
constexpr int kMovers = 3;           // warps that stage tiles and compute k
constexpr int kThreads = 32 * (1 + kMovers);
constexpr int kTile = 128;           // samples per tile
constexpr int kSegs = kTile / 32;    // 32-sample row segments per tile row
constexpr int kSlots = 4;            // tiles in the ring
constexpr int kBatch = 16;           // steps whose k the walker holds
// floats per column of a slot: the tile, and a multiple of 4 whose quarter
// is odd, so that eight lanes' 16-byte accesses meet all 32 banks once
constexpr int kPitch = kTile + 4;
constexpr int kSlotFloats = kCols * kPitch;
static_assert(kTile % kBatch == 0 && kTile % 32 == 0, "tile shape");
static_assert(kPitch % 4 == 0 && (kPitch / 4) % 2 == 1, "pitch");

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

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The walker's shared-memory accesses and the ring's mbarriers, by 32-bit
// shared address (computed once, outside the time loop).
__device__ __forceinline__ float4 lds128(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts128(uint32_t a, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "r"(a), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ void bar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

// Arrive (release: this thread's shared-memory accesses before it are seen
// by whoever waits for the phase).
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("{\n\t.reg .b64 state;\n\t"
               "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}"
               :: "r"(bar) : "memory");
}

// Has the phase of the given parity completed? (acquire when it has; does
// not wait)
__device__ __forceinline__ bool bar_test(uint32_t bar, unsigned parity) {
  uint32_t done;
  asm volatile("{\n\t.reg .pred p;\n\t"
               "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
               "selp.u32 %0, 1, 0, p;\n\t}"
               : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait (acquire) until the phase of the given parity has completed. A wait
// that lasts seconds is a fault of the protocol: the kernel traps (the
// launch fails) instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, unsigned parity) {
  for (int tries = 0; !bar_test(bar, parity); ++tries)
    if (tries == (1 << 28)) __trap();
}

constexpr int kBpt = kTile / kBatch;   // batches per tile

// kBatch steps over k; the outputs replace k.
__device__ __forceinline__ void steps_full(float4 (&k)[kBatch / 4], float dt,
                                           float& q, float& c, float& w) {
#pragma unroll
  for (int v = 0; v < kBatch / 4; ++v) {
    k[v].x = euler_step(k[v].x, dt, q, c, w);
    k[v].y = euler_step(k[v].y, dt, q, c, w);
    k[v].z = euler_step(k[v].z, dt, q, c, w);
    k[v].w = euler_step(k[v].w, dt, q, c, w);
  }
}

// The first `steps` (< kBatch or not) of a batch.
__device__ __forceinline__ void steps_part(float4 (&k)[kBatch / 4],
                                           int steps, float dt, float& q,
                                           float& c, float& w) {
#pragma unroll
  for (int v = 0; v < kBatch / 4; ++v) {
    if (4 * v < steps) k[v].x = euler_step(k[v].x, dt, q, c, w);
    if (4 * v + 1 < steps) k[v].y = euler_step(k[v].y, dt, q, c, w);
    if (4 * v + 2 < steps) k[v].z = euler_step(k[v].z, dt, q, c, w);
    if (4 * v + 3 < steps) k[v].w = euler_step(k[v].w, dt, q, c, w);
  }
}

__device__ __forceinline__ void load_batch(float4 (&k)[kBatch / 4],
                                           uint32_t a) {
#pragma unroll
  for (int v = 0; v < kBatch / 4; ++v) k[v] = lds128(a + 16 * v);
}

__device__ __forceinline__ void store_batch(const float4 (&k)[kBatch / 4],
                                            uint32_t a) {
#pragma unroll
  for (int v = 0; v < kBatch / 4; ++v) sts128(a + 16 * v, k[v]);
}

// Warp 0: walks the column's N samples in batches of kBatch, tile after
// tile around the ring. Every lane walks row lane % kCols, so that the warp
// never diverges; only lanes below kCols (`writes`) store. row0: the shared
// address of the lane's row in slot 0.
//
// Batches go in pairs (k in ka, then kb) so that no batch's k is copied
// between registers. The next tile's "full" phase is tested without
// waiting; the walker waits only when the tile is not in.
__device__ __forceinline__ void walker(uint32_t row0, uint32_t full0,
                                       uint32_t walked0, bool writes, int N,
                                       float dt, float q, float c, float w) {
  const auto at = [&](int b) {           // shared address of batch b
    return row0 + 4u * (((b / kBpt) % kSlots) * kSlotFloats +
                        (b % kBpt) * kBatch);
  };
  const auto full_of = [&](int j) { return full0 + 8u * (j % kSlots); };
  const int nb = (N + kBatch - 1) / kBatch, n_full = N / kBatch;
  float4 ka[kBatch / 4], kb[kBatch / 4];
  bar_wait(full0, 0);
  load_batch(ka, at(0));
  int b = 0;
  for (; b + 2 <= n_full; b += 2) {       // b is even: b + 1 is in b's tile
    load_batch(kb, at(b + 1));
    const int jn = (b + 2) / kBpt;
    const bool in = bar_test(full_of(jn), (jn / kSlots) & 1);
    steps_full(ka, dt, q, c, w);
    if (writes) store_batch(ka, at(b));
    if (b + 2 < nb) {
      if ((b + 2) % kBpt == 0 && !in) bar_wait(full_of(jn), (jn / kSlots) & 1);
      load_batch(ka, at(b + 2));
    }
    steps_full(kb, dt, q, c, w);
    if (writes) store_batch(kb, at(b + 1));
    if ((b + 2) % kBpt == 0 || b + 2 == nb)
      bar_arrive(walked0 + 8u * ((b / kBpt) % kSlots));
  }
  // at most two batches are left, the last perhaps short; ka holds batch b
  for (; b < nb; ++b) {
    if (b + 1 < nb) {
      const int j = (b + 1) / kBpt;
      if ((b + 1) % kBpt == 0) bar_wait(full_of(j), (j / kSlots) & 1);
      load_batch(kb, at(b + 1));
    }
    steps_part(ka, N - b * kBatch, dt, q, c, w);
    if (writes) store_batch(ka, at(b));
    if ((b + 1) % kBpt == 0 || b + 1 == nb)
      bar_arrive(walked0 + 8u * ((b / kBpt) % kSlots));
#pragma unroll
    for (int v = 0; v < kBatch / 4; ++v) ka[v] = kb[v];
  }
}

// Mover m (0 .. kMovers - 1): tiles m, m + kMovers, ...; for tile i it
// loads x, stores tile i - kSlots from the slot they share once it is
// walked, then fills the slot with k of tile i. The last kSlots tiles are
// stored after the loop's end.
__device__ __forceinline__ void mover(float* ring, uint32_t full0,
                                      uint32_t walked0, const float* x,
                                      float* out, long long col0, int cols,
                                      int N, int n_tiles, int m, int lane) {
  for (int i = m; i < n_tiles + kSlots; i += kMovers) {
    float* slot = ring + (i % kSlots) * kSlotFloats;
    float v[kCols][kSegs];
    if (i < n_tiles) {
#pragma unroll
      for (int r = 0; r < kCols; ++r)
#pragma unroll
        for (int j = 0; j < kSegs; ++j) {
          const int t = i * kTile + 32 * j + lane;
          v[r][j] = (r < cols && t < N) ? x[(col0 + r) * (long long)N + t]
                                        : 0.0f;
        }
    }
    if (i >= kSlots) {
      const int t0 = (i - kSlots) * kTile;
      bar_wait(walked0 + 8u * (i % kSlots), ((i - kSlots) / kSlots) & 1);
#pragma unroll
      for (int r = 0; r < kCols; ++r)
#pragma unroll
        for (int j = 0; j < kSegs; ++j) {
          const int t = t0 + 32 * j + lane;
          if (r < cols && t < N)
            out[(col0 + r) * (long long)N + t] = slot[r * kPitch + 32 * j +
                                                      lane];
        }
    }
    if (i < n_tiles) {
#pragma unroll
      for (int r = 0; r < kCols; ++r)
#pragma unroll
        for (int j = 0; j < kSegs; ++j) {
          const float s = fmaxf(__fadd_rn(v[r][j], kA), 0.0f);
          slot[r * kPitch + 32 * j + lane] = __fdiv_rn(s, __fadd_rn(s, kB));
        }
      bar_arrive(full0 + 8u * (i % kSlots));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
meddis_kernel(const float* __restrict__ x, float* __restrict__ out,
              long long M, int N, float dt, float q0, float c0, float w0) {
  __shared__ __align__(16) float ring[kSlots * kSlotFloats];
  __shared__ uint64_t full[kSlots], walked[kSlots];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long col0 = (long long)blockIdx.x * kCols;
  const int cols = (int)((M - col0) < kCols ? (M - col0) : kCols);
  const uint32_t full0 = smem(full), walked0 = smem(walked);
  if (threadIdx.x < kSlots) {
    bar_init(full0 + 8u * threadIdx.x, 32);
    bar_init(walked0 + 8u * threadIdx.x, 32);
  }
  __syncthreads();
  if (warp == 0)
    walker(smem(ring) + 4u * (lane % kCols) * kPitch, full0, walked0,
           lane < kCols, N, dt, q0, c0, w0);
  else
    mover(ring, full0, walked0, x, out, col0, cols, N,
          (N + kTile - 1) / kTile, warp - 1, lane);
}

// The chain alone: N steps in registers under a constant permeability, no
// loads, no division. Its time is the recurrence's latency floor on this
// card; chip_smoke.py measures it beside the kernel.
__global__ void __launch_bounds__(32)
chain_probe_kernel(float* __restrict__ out, int N, float dt, float k,
                   float q0, float c0, float w0) {
  float q = q0, c = c0, w = w0, last = 0.0f;
  for (int t = 0; t < N; ++t) last = euler_step(k, dt, q, c, w);
  out[blockIdx.x * 32 + threadIdx.x] = last;
}

}  // namespace

// out: (32 * blocks,) f32 on the device. Returns the launch's cudaError_t.
extern "C" int meddis_chain_probe(void* out, int blocks, int N, float dt,
                                  float k, float q0, float c0, float w0,
                                  void* stream) {
  if (blocks <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  chain_probe_kernel<<<(unsigned)blocks, 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), N, dt, k, q0, c0, w0);
  return (int)cudaGetLastError();
}

// *columns: how many columns one wave of blocks holds on the current
// device (blocks resident per SM x SMs x columns per block).
extern "C" int meddis_wave_columns(long long* columns) {
  int dev = 0, sms = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, meddis_kernel,
                                                        kThreads, 0);
  *columns = (long long)blocks * sms * kCols;
  return (int)err;
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
