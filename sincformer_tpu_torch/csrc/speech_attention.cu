// Speech attention forward for Hopper (sm_90a), f32 on CUDA cores.
//
// Replaces the TPU kernel sincformer_tpu/ops/speech_attention.py::_attn_kernel
// (launched by _speech_attention_fwd). Same function, not a block-by-block
// copy: for every (batch, head, query row)
//     s_j = (q . k_j) * scale + bias[b, j]        (bias optional, 0 / -1e9)
//     o   = sum_j softmax(s)_j * v_j
// over all T keys, one f32 softmax per row. q, k, v, out are (B, T, H*dh)
// with the heads packed in the last dimension, as in the TPU kernel.
//
// Bound at the main-path shape (B=4, T=400, H=4, dh=64, D=256): 4*B*T^2*D
// = 0.66 GFLOP of f32 FMA work against 4*B*T*D*4 = 6.6 MB of traffic, so
// it is compute bound (9.8 us at 67 TFLOP/s f32 vs 2 us at 3.35 TB/s).
//
// Design: one block of 128 threads per (batch, head, 32 query rows). Four
// neighbouring lanes share a query row; each holds a quarter of the row's
// dh values of q and of the output accumulator in registers, and the
// partial dot products are summed with two warp shuffles. Key and value
// tiles of the head are staged through shared memory and read there as
// broadcasts; the four lanes of a row read interleaved 16-byte chunks so a
// quarter-warp touches 64 contiguous bytes (no bank conflicts). The softmax
// is online (running max and sum, rescaled every 8 keys), so any T runs
// with fixed shared memory: this covers the T > 2048 range that the JAX
// dispatch sends to its flash kernel. Keys past T are excluded outright
// (probability 0), matching the unpadded reference. No tensor cores yet:
// the work is 4*dh FMAs per (row, key) pair, done at full f32 precision.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kLanesPerRow = 4;
constexpr int kRowsPerBlock = kThreads / kLanesPerRow;   // 32
constexpr int kKeysPerStep = 8;

template <int DH>
__global__ void __launch_bounds__(kThreads)
speech_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ bias,
                        float* __restrict__ out,
                        int T, int H, float scale) {
  constexpr int kChunks = DH / 16;                 // float4 chunks per lane
  constexpr int kTileKeys = DH <= 64 ? 64 : 32;    // 32 KB of K+V per tile
  constexpr int kVec = DH / 4;                     // float4 per key row
  __shared__ __align__(16) float ks[kTileKeys * DH];
  __shared__ __align__(16) float vs[kTileKeys * DH];
  __shared__ float bs[kTileKeys];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int part = tid & (kLanesPerRow - 1);
  const int row = blockIdx.x * kRowsPerBlock + tid / kLanesPerRow;
  const bool row_ok = row < T;
  const long long D = (long long)H * DH;
  const long long head_base = (long long)b * T * D + (long long)h * DH;

  // lane `part` owns float4 chunks part, part+4, part+8, ... of the row
  float4 qr[kChunks], acc[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = 4 * (part + kLanesPerRow * c);
    qr[c] = row_ok
        ? *reinterpret_cast<const float4*>(q + head_base + row * D + col)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -INFINITY;
  float l = 0.f;

  for (int k0 = 0; k0 < T; k0 += kTileKeys) {
    __syncthreads();   // the previous tile is no longer read
    for (int idx = tid; idx < kTileKeys * kVec; idx += kThreads) {
      const int j = idx / kVec;
      const int c4 = idx - j * kVec;
      const int key = k0 + j;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kk;
      if (key < T) {
        const long long off = head_base + key * D + 4 * c4;
        kk = *reinterpret_cast<const float4*>(k + off);
        vv = *reinterpret_cast<const float4*>(v + off);
      }
      *reinterpret_cast<float4*>(ks + j * DH + 4 * c4) = kk;
      *reinterpret_cast<float4*>(vs + j * DH + 4 * c4) = vv;
    }
    for (int j = tid; j < kTileKeys; j += kThreads) {
      const int key = k0 + j;
      bs[j] = key < T ? (bias != nullptr ? bias[(long long)b * T + key] : 0.f)
                      : -INFINITY;
    }
    __syncthreads();

    const int n_keys = min(kTileKeys, T - k0);
    for (int j0 = 0; j0 < n_keys; j0 += kKeysPerStep) {
      // scores of 8 keys; keys past T carry -inf and drop out below
      float s[kKeysPerStep];
#pragma unroll
      for (int u = 0; u < kKeysPerStep; ++u) {
        const float* kr = ks + (j0 + u) * DH;
        float p = 0.f;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const float4 kk = *reinterpret_cast<const float4*>(
              kr + 4 * (part + kLanesPerRow * c));
          p = fmaf(qr[c].x, kk.x, p);
          p = fmaf(qr[c].y, kk.y, p);
          p = fmaf(qr[c].z, kk.z, p);
          p = fmaf(qr[c].w, kk.w, p);
        }
        p += __shfl_xor_sync(0xffffffffu, p, 1);
        p += __shfl_xor_sync(0xffffffffu, p, 2);
        s[u] = p * scale + bs[j0 + u];
      }
      float step_max = s[0];
#pragma unroll
      for (int u = 1; u < kKeysPerStep; ++u) step_max = fmaxf(step_max, s[u]);
      // the step holds at least one key < T, so m_new is finite
      const float m_new = fmaxf(m, step_max);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        acc[c].x *= corr; acc[c].y *= corr; acc[c].z *= corr; acc[c].w *= corr;
      }
#pragma unroll
      for (int u = 0; u < kKeysPerStep; ++u) {
        const float p = expf(s[u] - m_new);
        l += p;
        const float* vr = vs + (j0 + u) * DH;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(
              vr + 4 * (part + kLanesPerRow * c));
          acc[c].x = fmaf(p, vv.x, acc[c].x);
          acc[c].y = fmaf(p, vv.y, acc[c].y);
          acc[c].z = fmaf(p, vv.z, acc[c].z);
          acc[c].w = fmaf(p, vv.w, acc[c].w);
        }
      }
      m = m_new;
    }
  }

  if (row_ok) {
    const float inv = 1.f / l;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = 4 * (part + kLanesPerRow * c);
      float4 o = acc[c];
      o.x *= inv; o.y *= inv; o.z *= inv; o.w *= inv;
      *reinterpret_cast<float4*>(out + head_base + row * D + col) = o;
    }
  }
}

template <int DH>
void launch(const float* q, const float* k, const float* v, const float* bias,
            float* out, int B, int T, int H, float scale, cudaStream_t stream) {
  const dim3 grid((T + kRowsPerBlock - 1) / kRowsPerBlock, H, B);
  speech_attention_kernel<DH><<<grid, kThreads, 0, stream>>>(
      q, k, v, bias, out, T, H, scale);
}

}  // namespace

// q, k, v, out: (B, T, H*dh) contiguous f32 on the device; bias: (B, T) f32
// or null. Returns the cudaError_t of the launch (0 on success).
extern "C" int speech_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* bias,
                                    void* out, int B, int T, int H, int dh,
                                    float scale, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || B > 65535 || H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* bf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: launch<16>(qf, kf, vf, bf, of, B, T, H, scale, s); break;
    case 32: launch<32>(qf, kf, vf, bf, of, B, T, H, scale, s); break;
    case 64: launch<64>(qf, kf, vf, bf, of, B, T, H, scale, s); break;
    case 128: launch<128>(qf, kf, vf, bf, of, B, T, H, scale, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
