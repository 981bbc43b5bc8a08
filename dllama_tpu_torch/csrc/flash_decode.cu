// Single-token causal GQA decode attention on Hopper (sm_90a).
//
// Replaces the TPU kernel dllama_tpu/ops/flash_attention.py
// _flash_decode_impl (_flash_decode_kernel, wrapper flash_decode): the G
// query heads of each KV head attend to cache rows 0..pos[b] of the
// head-major cache [B, KH, S, hd]; the output [B, 1, H, hd] is normalized
// and in q's type.
//
// Bound on an H100: each visible K/V row is read once and used for G heads
// (~4 * G * hd flops per 4 * hd bytes in bf16), so the kernel is bound by
// bytes: 2 * KH * (pos + 1) * hd * 2 B over 3.35 TB/s. The design reads
// only rows 0..pos: the loop stops at pos (the TPU kernel's clamped index
// map could not skip the copies past pos, which is why the JAX engine
// windowed the cache instead). One block per (KV head, lane); its warps
// form up to 4 splits of G warps. Split i walks key tiles i, i + 4, ...,
// staging each 32-row K/V tile in shared memory once for its G warps (one
// warp per query head: lane j scores key j, then each lane accumulates its
// hd / 32 output dims); the splits' online-softmax states merge by
// log-sum-exp at the end. With B * KH blocks the card is far from full at
// batch 1; splitting S across blocks is later work.

#include "common.cuh"

using namespace dllama;

namespace {

constexpr int BS = 32;  // keys per tile

template <typename T, int HD>
__global__ void __launch_bounds__(1024)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ pos, int s_pos0, T* __restrict__ out, int n_h,
                    int n_kh, int n_s, float scale, int n_split) {
  constexpr int DPL = HD / 32;
  constexpr int TILE = BS * (HD + 1) + BS * HD;  // one split's K and V tiles
  extern __shared__ __align__(16) float smem[];
  const int g_n = n_h / n_kh;
  const int kh = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int split = warp / g_n, g = warp % g_n;
  const int group_threads = g_n * 32, tid_g = threadIdx.x - split * group_threads;
  float* Qs = smem;  // [G][HD]
  float* Ks = smem + g_n * HD + split * TILE;  // [BS][HD + 1]
  float* Vs = Ks + BS * (HD + 1);              // [BS][HD]

  const T* qb = q + ((size_t)b * n_h + kh * g_n) * HD;
  for (int e = threadIdx.x; e < g_n * HD; e += blockDim.x) Qs[e] = to_float(qb[e]);

  const int limit = pos[b] - s_pos0;  // highest visible local row
  const int n_keys = max(0, min(n_s, limit + 1));
  const int n_tiles = (n_keys + BS - 1) / BS;
  const T* kb = k + (size_t)(b * n_kh + kh) * n_s * HD;
  const T* vb = v + (size_t)(b * n_kh + kh) * n_s * HD;

  float m = NEG_INF, l = 0.f, acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  for (int it = 0; it * n_split < n_tiles; ++it) {
    const int tile = it * n_split + split;
    const int s0 = tile * BS;
    __syncthreads();  // Qs written / previous tiles consumed
    if (tile < n_tiles) {
      for (int e = tid_g * 8; e < BS * HD; e += group_threads * 8) {
        const int r = e / HD, c = e % HD;
        float kv[8], vv[8];
        if (s0 + r < n_s) {
          load8(kb + (size_t)(s0 + r) * HD + c, kv);
          load8(vb + (size_t)(s0 + r) * HD + c, vv);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) kv[j] = vv[j] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          Ks[r * (HD + 1) + c + j] = kv[j];
          Vs[r * HD + c + j] = vv[j];
        }
      }
    }
    __syncthreads();
    if (tile < n_tiles) {
      float s = 0.f;
      const float* qg = Qs + g * HD;
      const float* kr = Ks + lane * (HD + 1);
#pragma unroll 8
      for (int c = 0; c < HD; ++c) s = fmaf(qg[c], kr[c], s);
      const int key = s0 + lane;
      const bool visible = key < n_s && key <= limit;
      float alpha;
      const float p = online_softmax(visible ? s * scale : NEG_INF, m, l, alpha);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
#pragma unroll 4
      for (int j = 0; j < BS; ++j) {
        const float pj = __shfl_sync(FULL_MASK, p, j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[i] = fmaf(pj, Vs[j * HD + lane * DPL + i], acc[i]);
      }
    }
  }

  // merge the splits' states by log-sum-exp, in the K/V area
  __syncthreads();
  float* Ms = smem + g_n * HD;
  float* Ls = Ms + n_split * g_n;
  float* As = Ls + n_split * g_n;
  const int slot = split * g_n + g;
  if (lane == 0) {
    Ms[slot] = m;
    Ls[slot] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) As[slot * HD + lane * DPL + i] = acc[i];
  __syncthreads();
  if (split != 0) return;
  float m_all = NEG_INF;
  for (int sp = 0; sp < n_split; ++sp) m_all = fmaxf(m_all, Ms[sp * g_n + g]);
  float l_all = 0.f, o[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) o[i] = 0.f;
  for (int sp = 0; sp < n_split; ++sp) {
    const int sl = sp * g_n + g;
    const float w = Ms[sl] <= NEG_INF / 2 ? 0.f : expf(Ms[sl] - m_all);
    l_all += w * Ls[sl];
#pragma unroll
    for (int i = 0; i < DPL; ++i) o[i] += w * As[sl * HD + lane * DPL + i];
  }
  const float l_safe = l_all == 0.f ? 1.f : l_all;
  T* ob = out + ((size_t)b * n_h + kh * g_n + g) * HD;
#pragma unroll
  for (int i = 0; i < DPL; ++i) ob[lane * DPL + i] = from_float<T>(o[i] / l_safe);
}

template <typename T, int HD>
int launch_hd(const T* q, const T* k, const T* v, const int* pos, int s_pos0, T* out, int n_b,
              int n_h, int n_kh, int n_s, float scale, cudaStream_t s) {
  const int g_n = n_h / n_kh;
  const int n_split = max(1, min(4, 32 / g_n));
  const int threads = n_split * g_n * 32;
  const size_t loop_smem = (size_t)g_n * HD + (size_t)n_split * (BS * (HD + 1) + BS * HD);
  const size_t merge_smem = (size_t)g_n * HD + (size_t)n_split * g_n * (HD + 2);
  const size_t bytes = sizeof(float) * (loop_smem > merge_smem ? loop_smem : merge_smem);
  static size_t configured = 0;
  if (bytes > configured) {
    cudaFuncSetAttribute(flash_decode_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
    configured = bytes;
  }
  flash_decode_kernel<T, HD><<<dim3(n_kh, n_b), threads, bytes, s>>>(q, k, v, pos, s_pos0, out,
                                                                      n_h, n_kh, n_s, scale,
                                                                      n_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* q, const T* k, const T* v, const int* pos, int s_pos0, T* out, int n_b,
           int n_h, int n_kh, int n_s, int hd, float scale, cudaStream_t s) {
  if (n_h % n_kh != 0 || n_h / n_kh > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (hd == 128) return launch_hd<T, 128>(q, k, v, pos, s_pos0, out, n_b, n_h, n_kh, n_s, scale, s);
  if (hd == 64) return launch_hd<T, 64>(q, k, v, pos, s_pos0, out, n_b, n_h, n_kh, n_s, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q [B, 1, H, hd], k/v [B, KH, S, hd] (bf16 when bf16 else f32), pos int32
// [B]; out [B, 1, H, hd] in q's type. hd 64 or 128, H / KH <= 32.
// Returns cudaGetLastError().
extern "C" int flash_decode(const void* q, const void* k, const void* v, const void* pos,
                            int s_pos0, void* out, int n_b, int n_h, int n_kh, int n_s, int hd,
                            float scale, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  if (bf16) {
    using B = __nv_bfloat16;
    return launch(static_cast<const B*>(q), static_cast<const B*>(k), static_cast<const B*>(v), p,
                  s_pos0, static_cast<B*>(out), n_b, n_h, n_kh, n_s, hd, scale, s);
  }
  return launch(static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), p, s_pos0, static_cast<float*>(out), n_b, n_h, n_kh,
                n_s, hd, scale, s);
}
