// One pass over the sinc filterbank output for Hopper (sm_90a): the fine
// activation and the pooled log envelope.
//
// Replaces the TPU kernel sincformer_tpu/ops/envact_pallas.py::_kernel
// (launched by env_act). For x (B, N, C), channel last, and scale (C,):
//     y   = gelu_tanh(x * scale)                        (B, N, C)
//     env = log1p(mean over 8 consecutive rows of |x|)  (B, N/8, C)
// |x| is pooled before the scale is applied; the mean is taken in f32.
//
// Bound: bytes. Each x is read once, each y written once and one env value
// is written per 8 inputs: (2 + 1/8) * 4 bytes per element, 278 MB at
// (16, 32,000, 64), 0.083 ms at 3.35 TB/s. The arithmetic (a tanh per
// element, a log1p per 8) is far below the f32 rate.
//
// Design: the TPU kernel tiles N in blocks of 64 rows because of its
// sublane rule and refuses lengths without such a tiling; here N only has
// to be a multiple of 8. A thread owns one (group of 8 rows, channel)
// column, or four neighbouring channels when C is a multiple of 4 and the
// pointers are aligned to 16 bytes: its 8 loads are independent and in
// flight together, neighbouring threads touch neighbouring addresses, and
// the 8 values stay in registers for both outputs, so x is read exactly
// once. Built without fast-math: tanhf and log1pf are the accurate ones.
//
// bf16 form (envact_fwd_bf16): x, scale, y and env in bf16, rounded where
// the JAX package's bf16 env_act_reference rounds (envact_pallas.py:89-94):
// x * scale and every operation of jax.nn.gelu's expansion (its two
// constants too) round to bf16; the envelope is the mean of |x| over 8 rows
// in f32 from the widened inputs, log1p in f32, rounded once. Bound: bytes,
// (2 + 1/8) * 2 bytes per element, half the f32 form's: 139 MB, 0.042 ms at
// (16, 32,000, 64). Its first form rounded each f32 operation by a scalar
// cvt.rn.bf16.f32 (eleven an element) and was bound by those instructions,
// not by bytes (0.109 ms). Here the GELU runs on pairs of neighbouring
// channels in packed bf16: mul.rn.bf16x2 and add.rn.bf16x2 (mul2, add2, as
// __hmul2_rn and __hadd2_rn) round the exact result once, which for bf16
// operands is what the plain version's f32 operation and rounding give (the
// product of two bf16 values is exact in f32; their sum is exact in f32 or
// rounds to the same bf16 value), and the _rn forms are never contracted
// into a fused multiply-add, which would skip the rounding between product
// and sum (their SASS has none: scripts/torch_kernel_ablation.py counts). tanh
// stays the accurate tanhf of the widened pair (the plain version rounds
// torch.tanh's f32 result), rounded two at a time by cvt.rn.bf16x2.f32, as
// are the envelope's log1pf. A thread owns eight neighbouring channels of a
// group of 8 rows where C % 8 == 0 (16-byte loads and stores, the 8 rows in
// flight together); other C take one channel a thread through the same
// packed GELU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPool = 8;

__device__ __forceinline__ float gelu_tanh(float v) {
  // jax.nn.gelu(approximate=True)
  const float inner = 0.7978845608028654f * (v + 0.044715f * (v * v * v));
  return v * (0.5f * (1.0f + tanhf(inner)));
}

__global__ void __launch_bounds__(kThreads)
envact_kernel(const float* __restrict__ x, const float* __restrict__ scale,
              float* __restrict__ y, float* __restrict__ env,
              long long groups, int C) {
  const long long total = groups * C;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long g = i / C;
    const int c = (int)(i - g * C);
    const long long base = g * kPool * C + c;
    float v[kPool];
#pragma unroll
    for (int j = 0; j < kPool; ++j) v[j] = x[base + (long long)j * C];
    const float s = scale[c];
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kPool; ++j) {
      sum += fabsf(v[j]);
      y[base + (long long)j * C] = gelu_tanh(v[j] * s);
    }
    env[i] = log1pf(sum * (1.0f / kPool));
  }
}

__global__ void __launch_bounds__(kThreads)
envact_kernel_vec4(const float4* __restrict__ x,
                   const float4* __restrict__ scale, float4* __restrict__ y,
                   float4* __restrict__ env, long long groups, int C4) {
  const long long total = groups * C4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long g = i / C4;
    const int c = (int)(i - g * C4);
    const long long base = g * kPool * C4 + c;
    float4 v[kPool];
#pragma unroll
    for (int j = 0; j < kPool; ++j) v[j] = x[base + (long long)j * C4];
    const float4 s = scale[c];
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < kPool; ++j) {
      sum.x += fabsf(v[j].x);
      sum.y += fabsf(v[j].y);
      sum.z += fabsf(v[j].z);
      sum.w += fabsf(v[j].w);
      y[base + (long long)j * C4] =
          make_float4(gelu_tanh(v[j].x * s.x), gelu_tanh(v[j].y * s.y),
                      gelu_tanh(v[j].z * s.z), gelu_tanh(v[j].w * s.w));
    }
    env[i] = make_float4(log1pf(sum.x * (1.0f / kPool)),
                         log1pf(sum.y * (1.0f / kPool)),
                         log1pf(sum.z * (1.0f / kPool)),
                         log1pf(sum.w * (1.0f / kPool)));
  }
}

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

// packed products and sums that round the exact result once and are never
// contracted (what __hmul2_rn and __hadd2_rn give, spelled in PTX so that
// no header version decides it)
__device__ __forceinline__ bf162 mul2(bf162 a, bf162 b) {
  uint32_t r;
  asm("mul.rn.bf16x2 %0, %1, %2;"
      : "=r"(r)
      : "r"(*reinterpret_cast<const uint32_t*>(&a)),
        "r"(*reinterpret_cast<const uint32_t*>(&b)));
  return *reinterpret_cast<const bf162*>(&r);
}
__device__ __forceinline__ bf162 add2(bf162 a, bf162 b) {
  uint32_t r;
  asm("add.rn.bf16x2 %0, %1, %2;"
      : "=r"(r)
      : "r"(*reinterpret_cast<const uint32_t*>(&a)),
        "r"(*reinterpret_cast<const uint32_t*>(&b)));
  return *reinterpret_cast<const bf162*>(&r);
}

// jax.nn.gelu(approximate=True) on two bf16 values, every operation rounded
// to bf16: x * (0.5 * (1 + tanh(c * (x + k * (x * (x * x)))))), with
// c = bf16(sqrt(2 / pi)) = 0.796875 and k = bf16(0.044715) = 0.044677734375
__device__ __forceinline__ bf162 gelu2(bf162 v) {
  const bf162 c = __float2bfloat162_rn(0.796875f);
  const bf162 k = __float2bfloat162_rn(0.044677734375f);
  const bf162 half = __float2bfloat162_rn(0.5f);
  const bf162 one = __float2bfloat162_rn(1.0f);
  const bf162 cube = mul2(v, mul2(v, v));
  const float2 inner = __bfloat1622float2(mul2(c, add2(v, mul2(k, cube))));
  const bf162 th = __floats2bfloat162_rn(tanhf(inner.x), tanhf(inner.y));
  return mul2(v, mul2(half, add2(one, th)));
}

__global__ void __launch_bounds__(kThreads)
envact_kernel_bf16(const bf16* __restrict__ x, const bf16* __restrict__ scale,
                   bf16* __restrict__ y, bf16* __restrict__ env,
                   long long groups, int C) {
  const long long total = groups * C;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long g = i / C;
    const int c = (int)(i - g * C);
    const long long base = g * kPool * C + c;
    bf16 v[kPool];
#pragma unroll
    for (int j = 0; j < kPool; ++j) v[j] = x[base + (long long)j * C];
    const bf162 s = __bfloat162bfloat162(scale[c]);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kPool; ++j) {
      sum += fabsf(__bfloat162float(v[j]));
      y[base + (long long)j * C] =
          __low2bfloat16(gelu2(mul2(__bfloat162bfloat162(v[j]), s)));
    }
    env[i] = __float2bfloat16_rn(log1pf(sum * (1.0f / kPool)));
  }
}

// eight channels a thread: x, y, scale and env as uint4 (4 pairs of bf16)
__global__ void __launch_bounds__(kThreads)
envact_kernel_bf16_vec8(const uint4* __restrict__ x,
                        const uint4* __restrict__ scale,
                        uint4* __restrict__ y, uint4* __restrict__ env,
                        long long groups, int C8) {
  const long long total = groups * C8;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long g = i / C8;
    const int c = (int)(i - g * C8);
    const long long base = g * kPool * C8 + c;
    uint4 sv = scale[c];
    const bf162* s = reinterpret_cast<const bf162*>(&sv);
    uint4 xv[kPool];
#pragma unroll
    for (int j = 0; j < kPool; ++j) xv[j] = x[base + (long long)j * C8];
    float2 sum[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) sum[q] = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int j = 0; j < kPool; ++j) {
      const bf162* v = reinterpret_cast<const bf162*>(&xv[j]);
      uint4 out;
      bf162* o = reinterpret_cast<bf162*>(&out);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(v[q]);
        sum[q].x += fabsf(f.x);
        sum[q].y += fabsf(f.y);
        o[q] = gelu2(mul2(v[q], s[q]));
      }
      y[base + (long long)j * C8] = out;
    }
    uint4 e;
    bf162* eo = reinterpret_cast<bf162*>(&e);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      eo[q] = __floats2bfloat162_rn(log1pf(sum[q].x * (1.0f / kPool)),
                                    log1pf(sum[q].y * (1.0f / kPool)));
    env[i] = e;
  }
}

}  // namespace

// x, y: (rows, C) contiguous f32 with rows = B * N and 8 | N; scale: (C,);
// env: (rows / 8, C); all on the device. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int envact_fwd(const void* x, const void* scale, void* y,
                          void* env, long long rows, int C, void* stream) {
  if (rows <= 0 || C <= 0 || rows % kPool != 0)
    return (int)cudaErrorInvalidValue;
  const long long groups = rows / kPool;
  const bool aligned = (((uintptr_t)x | (uintptr_t)scale | (uintptr_t)y |
                         (uintptr_t)env) & 15u) == 0;
  const bool vec = (C % 4 == 0) && aligned;
  const long long work = groups * (vec ? C / 4 : C);
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;   // grid-stride beyond that
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    envact_kernel_vec4<<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const float4*>(x), static_cast<const float4*>(scale),
        static_cast<float4*>(y), static_cast<float4*>(env), groups, C / 4);
  } else {
    envact_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<float*>(y), static_cast<float*>(env), groups, C);
  }
  return (int)cudaGetLastError();
}

// The bf16 form: x, y (rows, C), scale (C,) and env (rows / 8, C), all
// contiguous bf16 on the device. Returns the cudaError_t of the launch.
extern "C" int envact_fwd_bf16(const void* x, const void* scale, void* y,
                               void* env, long long rows, int C,
                               void* stream) {
  if (rows <= 0 || C <= 0 || rows % kPool != 0)
    return (int)cudaErrorInvalidValue;
  const long long groups = rows / kPool;
  const bool aligned = (((uintptr_t)x | (uintptr_t)scale | (uintptr_t)y |
                         (uintptr_t)env) & 15u) == 0;
  const bool vec = (C % 8 == 0) && aligned;
  const long long work = groups * (vec ? C / 8 : C);
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;   // grid-stride beyond that
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    envact_kernel_bf16_vec8<<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const uint4*>(x), static_cast<const uint4*>(scale),
        static_cast<uint4*>(y), static_cast<uint4*>(env), groups, C / 8);
  } else {
    envact_kernel_bf16<<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(scale),
        static_cast<bf16*>(y), static_cast<bf16*>(env), groups, C);
  }
  return (int)cudaGetLastError();
}
