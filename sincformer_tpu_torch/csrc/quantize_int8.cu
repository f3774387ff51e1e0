// Int8 stochastic rounding against precomputed per-channel scales, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel sincformer_tpu/ops/quantize.py::_round_kernel
// (launched by _quantize_pallas). For every element of an (R, C) f32 matrix
//     scaled = clip(x / scale, -127, 127)
//     q      = floor(scaled) + (u < scaled - floor(scaled))        -> int8
// with u uniform in [0, 1): the top 24 of 32 random bits times 2^-24. The
// scale (one per row or one per column, amax/127) is computed outside, as in
// the TPU kernel; only the random bits need a kernel.
//
// Bound: 4 bytes read and 1 written per element and ~100 integer operations
// for the generator, so it is bound by bytes (a 256 x 1024 leaf moves 1.3 MB:
// 0.4 us at 3.35 TB/s, far under a launch).
//
// Design: the TPU kernel seeds the core's generator once per row block, so
// its bits depend on the grid. Here the bits come from Philox-4x32-10 keyed
// by (seed, flat element index / 4): element i takes word i % 4 of the block
// of counter i / 4. The result is independent of the launch shape, and the
// plain PyTorch version (ops/quantize.py::_quantize_plain) computes the same
// bits with integer tensor arithmetic, so the two are compared for equality.
// Each thread owns one counter, i.e. four neighbouring elements: one 16-byte
// load and one 4-byte store when C is a multiple of 4 and the pointers are
// aligned, element by element otherwise. Built without fast-math: x / scale
// is the IEEE quotient on both sides.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

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

__device__ __forceinline__ signed char round_one(float x, float scale,
                                                 uint32_t bits) {
  const float scaled = fminf(fmaxf(x / scale, -127.f), 127.f);
  const float fl = floorf(scaled);
  const float u = (float)(bits >> 8) * (1.0f / 16777216.0f);
  return (signed char)(int)(fl + (u < scaled - fl ? 1.f : 0.f));
}

__global__ void __launch_bounds__(kThreads)
quantize_int8_kernel(const float* __restrict__ x,
                     const float* __restrict__ scale,
                     signed char* __restrict__ out, long long n, int C,
                     int scale_per_row, uint32_t k0, uint32_t k1, int vec) {
  const long long groups = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    uint32_t r[4];
    philox4x32_10((uint32_t)(g & 0xFFFFFFFFll), (uint32_t)(g >> 32), k0, k1, r);
    const long long base = 4 * g;
    if (vec) {
      // C % 4 == 0: the four elements share a row and all exist
      const float4 xv = *reinterpret_cast<const float4*>(x + base);
      float4 sv;
      if (scale_per_row) {
        const float s = scale[base / C];
        sv = make_float4(s, s, s, s);
      } else {
        sv = *reinterpret_cast<const float4*>(scale + base % C);
      }
      char4 q;
      q.x = round_one(xv.x, sv.x, r[0]);
      q.y = round_one(xv.y, sv.y, r[1]);
      q.z = round_one(xv.z, sv.z, r[2]);
      q.w = round_one(xv.w, sv.w, r[3]);
      *reinterpret_cast<char4*>(out + base) = q;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long i = base + j;
        if (i < n) {
          const float s = scale[scale_per_row ? i / C : i % C];
          out[i] = round_one(x[i], s, r[j]);
        }
      }
    }
  }
}

}  // namespace

// x: (R, C) contiguous f32; scale: (R,) f32 when scale_per_row, else (C,);
// out: (R, C) int8; all on the device. The 64-bit seed is the Philox key.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int quantize_int8_fwd(const void* x, const void* scale, void* out,
                                 long long R, long long C, int scale_per_row,
                                 unsigned long long seed, void* stream) {
  if (R <= 0 || C <= 0 || C > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  const long long n = R * C;
  const long long groups = (n + 3) / 4;
  const bool aligned = (((uintptr_t)x | (uintptr_t)scale) & 15u) == 0 &&
                       ((uintptr_t)out & 3u) == 0;
  const int vec = (C % 4 == 0 && aligned) ? 1 : 0;
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;   // grid-stride beyond that
  quantize_int8_kernel<<<(unsigned)blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<signed char*>(out), n, (int)C, scale_per_row,
      (uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32), vec);
  return (int)cudaGetLastError();
}
