// Shared device helpers for the port's kernels (float32 and bfloat16 inputs).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dllama {

constexpr float NEG_INF = -1e30f;  // the JAX package's masked-score value
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Round a float32 value to the input type and back: identity for float32,
// round-to-nearest-even for bfloat16 (what torch's .to(bfloat16) does).
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

// Eight consecutive elements as float; p must be 16-byte aligned.
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL_MASK, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL_MASK, x, o));
  return x;
}

// One online-softmax step for a row whose 32 scores of this tile are spread
// one per lane (masked lanes hold NEG_INF). Updates (m, l), returns this
// lane's probability and the factor that rescales the row's accumulator.
// The fully-masked guards are the JAX kernel's (ops/flash_attention.py
// _flash_stats_kernel): exp(-inf - -inf) never enters the sums.
__device__ __forceinline__ float online_softmax(float s, float& m, float& l, float& alpha) {
  const float m_new = fmaxf(m, warp_max(s));
  const float p = (m_new <= NEG_INF / 2) ? 0.f : expf(s - m_new);
  alpha = (m <= NEG_INF / 2) ? 0.f : expf(m - m_new);
  l = alpha * l + warp_sum(p);
  m = m_new;
  return p;
}

}  // namespace dllama
