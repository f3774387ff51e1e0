// Int8 stochastic rounding with per-channel scales for a whole tree of
// parameters in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel sincformer_tpu/ops/quantize.py::_round_kernel
// (launched by _quantize_pallas). For every quantized leaf, an (R, C) f32
// matrix scaled per row (axis 0) or per column (axis 1):
//     scale  = max(amax |x| over the channel, 1e-12) / 127
//     scaled = clip(x / scale, -127, 127)
//     q      = floor(scaled) + (u < scaled - floor(scaled))        -> int8
// with u uniform in [0, 1): the top 24 of 32 random bits times 2^-24. The
// TPU kernel takes its scales from XLA; here the amax, the scale and the
// rounding are one kernel.
//
// Bound: 4 bytes read and 1 written per element, ~25 integer operations per
// element for the generator: bytes. The flagship's 73 leaves (15.46 M
// elements, 77.3 MB) take 0.023 ms at 3.35 TB/s.
//
// Design. The host builds a table of the tree's leaves (pointers, R, C,
// axis, Philox key, rows or columns per block, first block) and copies it
// to the card in one copy; the grid covers every leaf's blocks, and a block
// finds its leaf by a binary search over the first blocks. A channel never
// spans two blocks, so no grid-wide sync is needed:
//   * axis 0: a block takes `unit` rows (1, 2, 4 or 8: at most four float4
//     per thread and row where a row allows), 256 / unit threads a row; a
//     thread loads its four float4 at once and keeps them in registers for
//     the rounding; the row's |x| is reduced with warp shuffles and the
//     row's warps through shared memory;
//   * axis 1: a block takes a strip of 128 columns (4 per lane) over all
//     rows, its 8 warps walk the rows, and the column maxima of the warps
//     meet in shared memory.
// The block then writes the scales (an IEEE division, no fast-math: the
// same bits as torch.clamp(amax, min=1e-12) / 127.0 on the CPU) and rounds
// the same elements: from registers, or (long rows, column strips) read
// again from L1 or L2, so device memory sees each element once. The maximum
// propagates NaN as torch.amax does (fmaxf would drop it).
//
// The random bits come from Philox-4x32-10 keyed by (leaf key, flat element
// index within the leaf / 4): element i takes word i % 4 of the block of
// counter i / 4. The result is independent of the launch shape, and the
// plain PyTorch version (ops/quantize.py::_quantize_plain) computes the
// same bits with integer tensor arithmetic, so the two are compared for
// equality. A group of four that straddles two rows (C % 4 != 0) is
// computed by both rows' threads, each taking its own words. Rows with
// C % 4 == 0 and 16-byte aligned x move as float4 / char4.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStrip = 128;       // columns per block of an axis-1 leaf
constexpr int kCached = 4;        // float4 a thread keeps of an axis-0 row
constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

// one entry of the host's table (ops/quantize.py packs it: 64 bytes)
struct Leaf {
  const float* x;         // (R, C) contiguous
  signed char* q;         // (R, C)
  float* scale;           // (R,) for axis 0, (C,) for axis 1
  long long R, C;
  unsigned long long key; // Philox key: seed + k for the k-th leaf
  int axis;               // 0: one scale per row, 1: one per column
  int unit;               // rows (axis 0) or columns (axis 1) per block
  long long first_block;
};
static_assert(sizeof(Leaf) == 64, "the host packs 64-byte entries");

// Philox-4x32-10 (Salmon et al., SC 2011) of counter (c0, c1, 0, 0).
__device__ __forceinline__ void philox4x32_10(uint32_t c0, uint32_t c1,
                                              uint32_t k0, uint32_t k1,
                                              uint32_t out[4]) {
  uint32_t c2 = 0u, c3 = 0u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(kPhiloxM0, c0);
    const uint32_t lo0 = kPhiloxM0 * c0;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c2);
    const uint32_t lo1 = kPhiloxM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  out[0] = c0; out[1] = c1; out[2] = c2; out[3] = c3;
}

__device__ __forceinline__ void philox_group(long long g, uint32_t k0,
                                             uint32_t k1, uint32_t out[4]) {
  philox4x32_10((uint32_t)(g & 0xFFFFFFFFll), (uint32_t)(g >> 32), k0, k1,
                out);
}

__device__ __forceinline__ signed char round_one(float x, float scale,
                                                 uint32_t bits) {
  const float scaled = fminf(fmaxf(x / scale, -127.f), 127.f);
  const float fl = floorf(scaled);
  const float u = (float)(bits >> 8) * (1.0f / 16777216.0f);
  return (signed char)(int)(fl + (u < scaled - fl ? 1.f : 0.f));
}

// max that keeps a NaN, as torch.amax does
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// torch.clamp(amax, min=1e-12) / 127.0 in f32, NaN kept
__device__ __forceinline__ float scale_of(float amax) {
  return __fdiv_rn(amax < 1e-12f ? 1e-12f : amax, 127.0f);
}

// |x| of the up to four elements [c, c + 4) of a row that lie below `end`
__device__ __forceinline__ void load4(const float* row, long long c,
                                      long long end, bool vec, float v[4]) {
  if (vec) {
    const float4 f = *reinterpret_cast<const float4*>(row + c);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = c + j < end ? row[c + j] : 0.f;
  }
}

// Round the four elements at flat index i0 (a multiple of 4: one Philox
// group) from values already loaded; scale s[j] for element i0 + j.
__device__ __forceinline__ void round4_vec(const Leaf& L, long long i0,
                                           float4 f, const float s[4],
                                           uint32_t k0, uint32_t k1) {
  uint32_t bits[4];
  philox_group(i0 >> 2, k0, k1, bits);
  char4 q;
  q.x = round_one(f.x, s[0], bits[0]);
  q.y = round_one(f.y, s[1], bits[1]);
  q.z = round_one(f.z, s[2], bits[2]);
  q.w = round_one(f.w, s[3], bits[3]);
  *reinterpret_cast<char4*>(L.q + i0) = q;
}

// Round the elements [c, c + 4) (those below `end`) of row r; scale s[j]
// for element c + j. vec: C % 4 == 0 and aligned, so the four are the
// whole Philox group (r * C + c) / 4.
__device__ __forceinline__ void round4(const Leaf& L, long long r,
                                       long long c, long long end, bool vec,
                                       const float s[4], uint32_t k0,
                                       uint32_t k1) {
  const long long i0 = r * L.C + c;
  if (vec) {
    round4_vec(L, i0, *reinterpret_cast<const float4*>(L.x + i0), s, k0, k1);
    return;
  }
  uint32_t bits[4];
  long long group = -1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (c + j >= end) break;
    const long long i = i0 + j;
    if ((i >> 2) != group) {
      group = i >> 2;
      philox_group(group, k0, k1, bits);
    }
    L.q[i] = round_one(L.x[i], s[j], bits[i & 3]);
  }
}

__global__ void __launch_bounds__(kThreads)
quantize_tree_kernel(const Leaf* __restrict__ leaves, int n_leaves) {
  __shared__ float red[kWarps][kStrip];
  __shared__ float strip_scale[kStrip];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  int lo = 0, hi = n_leaves - 1;        // last leaf with first_block <= block
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (leaves[mid].first_block <= (long long)blockIdx.x) lo = mid;
    else hi = mid - 1;
  }
  const Leaf L = leaves[lo];
  const long long blk = (long long)blockIdx.x - L.first_block;
  const uint32_t k0 = (uint32_t)(L.key & 0xFFFFFFFFull);
  const uint32_t k1 = (uint32_t)(L.key >> 32);
  const bool vec = L.C % 4 == 0 && ((uintptr_t)L.x & 15u) == 0 &&
                   ((uintptr_t)L.q & 3u) == 0;

  if (L.axis == 0) {
    const int per_row = kThreads / L.unit;     // a multiple of 32
    const int rg = tid / per_row, tr = tid - rg * per_row;
    const long long r = blk * L.unit + rg;
    const bool live = r < L.R;
    const float* row = L.x + r * L.C;
    const long long step = 4ll * per_row;
    // a row of at most kCached float4 a thread stays in registers between
    // the two passes; a longer one is read again from L1 or L2
    const bool cached = vec && L.C <= kCached * step;
    float4 kept[kCached];
    float m = 0.f;
    if (live && cached) {
#pragma unroll
      for (int j = 0; j < kCached; ++j) {
        const long long c = 4ll * tr + j * step;
        kept[j] = c < L.C ? *reinterpret_cast<const float4*>(row + c)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < kCached; ++j)
        m = nan_max(nan_max(nan_max(nan_max(m, fabsf(kept[j].x)),
                                    fabsf(kept[j].y)),
                            fabsf(kept[j].z)),
                    fabsf(kept[j].w));
    } else if (live) {
#pragma unroll 4
      for (long long c = 4ll * tr; c < L.C; c += step) {
        float v[4];
        load4(row, c, L.C, vec, v);
#pragma unroll
        for (int j = 0; j < 4; ++j) m = nan_max(m, fabsf(v[j]));
      }
    }
    m = warp_max(m);
    if (lane == 0) red[0][warp] = m;
    __syncthreads();
    if (!live) return;
    const int w0 = rg * (per_row / 32);
    float amax = red[0][w0];
    for (int w = 1; w < per_row / 32; ++w) amax = nan_max(amax, red[0][w0 + w]);
    const float s = scale_of(amax);
    if (tr == 0) L.scale[r] = s;
    const float s4[4] = {s, s, s, s};
    if (cached) {
#pragma unroll
      for (int j = 0; j < kCached; ++j) {
        const long long c = 4ll * tr + j * step;
        if (c < L.C) round4_vec(L, r * L.C + c, kept[j], s4, k0, k1);
      }
    } else {
#pragma unroll 4
      for (long long c = 4ll * tr; c < L.C; c += step)
        round4(L, r, c, L.C, vec, s4, k0, k1);
    }
    return;
  }

  // axis 1: columns [c0, c0 + 128), this thread's four at c
  const long long c0 = blk * kStrip;
  const long long c = c0 + 4 * lane;
  const long long end = c0 + kStrip < L.C ? c0 + kStrip : L.C;
  float m[4] = {0.f, 0.f, 0.f, 0.f};
  if (c < end) {
    for (long long r = warp; r < L.R; r += kWarps) {
      float v[4];
      load4(L.x + r * L.C, c, end, vec, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) m[j] = nan_max(m[j], fabsf(v[j]));
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) red[warp][4 * lane + j] = m[j];
  __syncthreads();
  if (tid < kStrip) {
    float amax = red[0][tid];
    for (int w = 1; w < kWarps; ++w) amax = nan_max(amax, red[w][tid]);
    const float s = scale_of(amax);
    strip_scale[tid] = s;
    if (c0 + tid < L.C) L.scale[c0 + tid] = s;
  }
  __syncthreads();
  if (c >= end) return;
  float s4[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) s4[j] = strip_scale[4 * lane + j];
  for (long long r = warp; r < L.R; r += kWarps)
    round4(L, r, c, end, vec, s4, k0, k1);
}

}  // namespace

// Launch over a table already on the device: `leaves` holds n_leaves
// entries (64 bytes each, in order of first_block, the first 0) covering
// n_blocks blocks. Returns the cudaError_t of the launch (0 on success).
extern "C" int quantize_tree_launch(const void* leaves, int n_leaves,
                                    long long n_blocks, void* stream) {
  if (n_leaves <= 0 || n_blocks <= 0 || n_blocks > 0x7FFFFFFFll)
    return (int)cudaErrorInvalidValue;
  quantize_tree_kernel<<<(unsigned)n_blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(leaves), n_leaves);
  return (int)cudaGetLastError();
}

// The whole call: one copy of the host's table into `leaves_dev`
// (n_leaves * 64 bytes on the device), then the launch, both on `stream`.
extern "C" int quantize_tree_fwd(const void* table, void* leaves_dev,
                                 int n_leaves, long long n_blocks,
                                 void* stream) {
  if (n_leaves <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cudaMemcpyAsync(leaves_dev, table, (size_t)n_leaves * sizeof(Leaf),
                      cudaMemcpyHostToDevice, st);
  if (err != cudaSuccess) return (int)err;
  return quantize_tree_launch(leaves_dev, n_leaves, n_blocks, stream);
}
