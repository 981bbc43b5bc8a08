// Shared device helpers for the port's kernels (float32 and bfloat16 inputs,
// int8 KV cache values, float16 KV cache values under a float query).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dllama {

// The C entries' type codes of a tensor whose type is not implied by the
// entry (the mixed-type attention entries: q's type and the cache's; the
// int8 cache's code only where an entry names every cache type).
enum TypeCode { TYPE_F32 = 0, TYPE_BF16 = 1, TYPE_F16 = 2, TYPE_I8 = 3 };

constexpr float NEG_INF = -1e30f;  // the JAX package's masked-score value
constexpr unsigned FULL_MASK = 0xffffffffu;

// floor(a / b) for b > 0 and any sign of a (C++ division truncates): the
// last key row a query sees on a strided shard, negative when the shard
// starts past it
__host__ __device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

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

// K/V rows through a page table (the paged pool [P, KH, ps, hd]): logical
// row r of a lane lives in pool page pt[r / ps] at page row r % ps. Page
// sizes divide 32 or are multiples of 32, so a 32-row key tile spans
// 32 / ps whole pages or lies inside one page; the tile's page ids are
// staged in shared memory once (`stage_page_ids`) and every row of the
// tile is addressed from there (`paged_row`).
__device__ __forceinline__ int tile_pages(int ps) { return ps >= 32 ? 1 : 32 / ps; }

// Thread t < tile_pages(ps) stages the id of the t-th page of the tile at
// logical row s0 (a multiple of 32). A page whose first row in the tile lies
// at or past n_keys (the lane's causal frontier) is not read from the page
// table: its slot holds the scratch page 0, and no row of it is loaded.
__device__ __forceinline__ void stage_page_ids(int* ids, const int* __restrict__ pt_row, int s0,
                                               int n_keys, int ps, int t) {
  if (t < tile_pages(ps)) {
    const int slot = s0 / ps + t;
    ids[t] = max(slot * ps, s0) < n_keys ? __ldg(pt_row + slot) : 0;
  }
}

// Element offset of tile row r (logical row s0 + r) of KV head kh.
__device__ __forceinline__ size_t paged_row(const int* ids, int s0, int r, int ps, int kh,
                                            int n_kh, int hd) {
  const int page = ids[ps >= 32 ? 0 : r / ps];
  return (((size_t)page * n_kh + kh) * ps + (s0 + r) % ps) * hd;
}

// The dynamic shared memory a kernel may take above 48 KB is an attribute
// of the kernel on the CURRENT device (cudaFuncSetAttribute acts on it
// alone), so a launcher keeps the size it set per device: a second card in
// the same process gets its own call. One static instance a kernel.
struct SmemLimit {
  static constexpr int MAX_DEVICES = 64;
  int bytes[MAX_DEVICES] = {};

  // Raise the kernel's limit on the current device to at least `need`.
  template <typename K>
  cudaError_t raise(K* kernel, int need) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (need <= bytes[dev]) return cudaSuccess;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, need);
    if (e == cudaSuccess) bytes[dev] = need;
    return e;
  }
};

}  // namespace dllama
