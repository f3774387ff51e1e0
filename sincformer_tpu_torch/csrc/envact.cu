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
// in f32 from the widened inputs, log1p in f32, rounded once. A thread owns
// eight neighbouring channels of a group of 8 rows where C % 8 == 0 (16-byte
// loads and stores), one channel otherwise. Bound: bytes, (2 + 1/8) * 2
// bytes per element, half the f32 form's.

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

using bf16_t = uint16_t;        // the bits of a bfloat16 value

__device__ __forceinline__ float from_bf16(uint32_t bits) {
  return __uint_as_float(bits << 16);
}
// f32 -> bf16 bits, to nearest even: one cvt.rn.bf16.f32 on sm_90 (an
// integer emulation of the rounding took K6 to twice the f32 form's time)
__device__ __forceinline__ uint32_t to_bf16(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
// v rounded to bf16, as f32
__device__ __forceinline__ float rb(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// jax.nn.gelu(approximate=True) on a bf16 value, every operation rounded
// to bf16: x * (0.5 * (1 + tanh(c * (x + k * (x * (x * x)))))), with
// c = bf16(sqrt(2 / pi)) and k = bf16(0.044715)
__device__ __forceinline__ float gelu_bf16(float v) {
  const float c = 0.796875f;        // bf16(0.7978845608)
  const float k = 0.044677734375f;  // bf16(0.044715)
  const float cube = rb(v * rb(v * v));
  const float inner = rb(c * rb(v + rb(k * cube)));
  return rb(v * rb(0.5f * rb(1.0f + rb(tanhf(inner)))));
}

__global__ void __launch_bounds__(kThreads)
envact_kernel_bf16(const bf16_t* __restrict__ x,
                   const bf16_t* __restrict__ scale, bf16_t* __restrict__ y,
                   bf16_t* __restrict__ env, long long groups, int C) {
  const long long total = groups * C;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long g = i / C;
    const int c = (int)(i - g * C);
    const long long base = g * kPool * C + c;
    float v[kPool];
#pragma unroll
    for (int j = 0; j < kPool; ++j) v[j] = from_bf16(x[base + (long long)j * C]);
    const float s = from_bf16(scale[c]);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kPool; ++j) {
      sum += fabsf(v[j]);
      y[base + (long long)j * C] = (bf16_t)to_bf16(gelu_bf16(rb(v[j] * s)));
    }
    env[i] = (bf16_t)to_bf16(log1pf(sum * (1.0f / kPool)));
  }
}

// eight channels a thread: x, y, scale and env as uint4 (8 bf16 each)
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
    const uint4 sv = scale[c];
    const uint32_t sw[4] = {sv.x, sv.y, sv.z, sv.w};
    float s[8], sum[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s[e] = from_bf16((sw[e / 2] >> (16 * (e & 1))) & 0xFFFFu);
      sum[e] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kPool; ++j) {
      const uint4 xv = x[base + (long long)j * C8];
      const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w};
      uint32_t out[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v0 = from_bf16(xw[q] & 0xFFFFu);
        const float v1 = from_bf16(xw[q] >> 16);
        sum[2 * q] += fabsf(v0);
        sum[2 * q + 1] += fabsf(v1);
        out[q] = to_bf16(gelu_bf16(rb(v0 * s[2 * q]))) |
                 (to_bf16(gelu_bf16(rb(v1 * s[2 * q + 1]))) << 16);
      }
      y[base + (long long)j * C8] = make_uint4(out[0], out[1], out[2], out[3]);
    }
    uint32_t e4[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      e4[q] = to_bf16(log1pf(sum[2 * q] * (1.0f / kPool))) |
              (to_bf16(log1pf(sum[2 * q + 1] * (1.0f / kPool))) << 16);
    env[i] = make_uint4(e4[0], e4[1], e4[2], e4[3]);
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
        static_cast<const bf16_t*>(x), static_cast<const bf16_t*>(scale),
        static_cast<bf16_t*>(y), static_cast<bf16_t*>(env), groups, C);
  }
  return (int)cudaGetLastError();
}
