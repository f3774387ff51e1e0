// Split-TF32 ("3xTF32") tensor-core products for Hopper (sm_90a), shared by
// speech_attention.cu (K1), fused_ffn.cu (K3) and conv_gn.cu (K5).
//
// A float x is split into hi = tf32(x) and lo = tf32(x - hi), both rounded
// to nearest with ties away from zero (as cvt.rna.tf32.f32 rounds). A product a.b is
// then taken as lo(a).hi(b) + hi(a).lo(b) + hi(a).hi(b), the small terms
// first, each an m16n8k8 TF32 mma.sync accumulating in f32; the dropped
// lo.lo term is below f32's rounding. This keeps f32-level results (the
// kernels' parity bars are 1e-5) where one TF32 product alone loses about
// three decimal digits. It is the arithmetic of CUTLASS's
// OpMultiplyAddFastF32.
//
// Fragment layouts of mma.sync.m16n8k8 with TF32 operands, for lane l,
// g = l / 4, t = l % 4 (PTX ISA):
//   A (16 x 8, row major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                          a3 (g + 8, t + 4)
//   B (8 x 8, column major): b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C, D (16 x 8): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                  c3 (g + 8, 2t + 1)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// Rounds as cvt.rna.tf32.f32 does (to nearest, ties away from zero) for
// every finite x, with two integer operations: adding half a unit of the
// kept last place to the sign-magnitude pattern rounds the magnitude half
// up, and the mask clears the 13 dropped bits. cvt runs at a quarter of the
// integer rate, and the split takes two roundings per operand element.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo to about 21 bits of mantissa
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a . b, one TF32 tensor-core product
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a . b in split TF32: lo.hi + hi.lo + hi.hi, small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&a_hi)[4],
                                     const uint32_t (&a_lo)[4],
                                     const uint32_t (&b_hi)[2],
                                     const uint32_t (&b_lo)[2]) {
  mma(d, a_lo, b_hi);
  mma(d, a_hi, b_lo);
  mma(d, a_hi, b_hi);
}

// Four 8 x 4-word matrices of 32-bit words from shared memory in one
// ldmatrix.x4: lanes 8i .. 8i + 7 give the addresses of matrix i's eight
// rows (16-byte aligned), and lane l receives in r[i] the word at row l / 4,
// word l % 4 of matrix i: the (g, t) element of an mma.sync.m16n8k8 TF32
// fragment. For A (16 x 8, row major) the matrices are rows 0-7 and 8-15
// of words 0-3, then of words 4-7: r holds a0 .. a3.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const uint32_t* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// 16-byte asynchronous copy global -> shared; with full == false nothing is
// read and the 16 bytes are zero-filled (gmem must still be a valid address)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool full) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = full ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Raise a kernel's dynamic shared-memory limit to `bytes` once per device
// (the first launch on each device; later calls, also those made while a
// stream is being captured into a CUDA graph, only read a flag). Each
// kernel passes its own static array of 64 flags, one per device.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, int (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = 1;
  return err;
}

}  // namespace tf32x3
