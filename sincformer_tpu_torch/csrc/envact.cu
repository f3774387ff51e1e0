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
