// Single-token causal GQA decode attention on Hopper (sm_90a), over a slab
// cache or through a page table.
//
// Replaces two TPU kernels of dllama_tpu/ops/flash_attention.py:
// * _flash_decode_impl (_flash_decode_kernel, wrapper flash_decode): the G
//   query heads of each KV head attend to cache rows 0..pos[b] of the
//   head-major cache [B, KH, S, hd] (C entry `flash_decode`);
// * paged_flash_decode (_paged_decode_kernel): the same over the paged pool
//   [P, KH, ps, hd], logical row r of lane b read from pool page
//   page_table[b, r / ps] at page row r % ps (C entry `paged_flash_decode`).
// The output [B, 1, H, hd] is normalized and in q's type.
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
//
// The row address is the only difference between the two entries (the
// template parameter PAGED): the paged body stages each tile's page ids in
// shared memory one tile ahead (written while the current tile is scored,
// read after the next barrier), loads no row at or past the lane's frontier
// and never reads a page-table slot past it (unfilled slots point at the
// scratch page 0). Everything else is the same code, so with an identity
// page table the paged entry gives flash_decode's bits.

#include "common.cuh"

using namespace dllama;

namespace {

constexpr int BS = 32;  // keys per tile

template <typename T, int HD, bool PAGED>
__global__ void __launch_bounds__(1024)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ pos, int s_pos0, const int* __restrict__ pt,
                    int n_blocks, int ps, T* __restrict__ out, int n_h, int n_kh, int n_s,
                    float scale, int n_split) {
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
  // page ids of the tiles, two buffers per split, past the float area
  const int loop_f = g_n * HD + n_split * TILE;
  const int merge_f = g_n * HD + n_split * g_n * (HD + 2);
  int* Pid = reinterpret_cast<int*>(smem + max(loop_f, merge_f));

  const T* qb = q + ((size_t)b * n_h + kh * g_n) * HD;
  for (int e = threadIdx.x; e < g_n * HD; e += blockDim.x) Qs[e] = to_float(qb[e]);

  const int limit = pos[b] - s_pos0;  // highest visible local row
  const int n_keys = max(0, min(n_s, limit + 1));
  const int n_tiles = (n_keys + BS - 1) / BS;
  const T* kb = k;
  const T* vb = v;
  if (!PAGED) {
    kb += (size_t)(b * n_kh + kh) * n_s * HD;
    vb += (size_t)(b * n_kh + kh) * n_s * HD;
  }
  const int* pt_b = PAGED ? pt + (size_t)b * n_blocks : nullptr;
  if (PAGED && split < n_tiles)
    stage_page_ids(Pid + split * BS, pt_b, split * BS, n_keys, ps, tid_g);

  float m = NEG_INF, l = 0.f, acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  for (int it = 0; it * n_split < n_tiles; ++it) {
    const int tile = it * n_split + split;
    const int s0 = tile * BS;
    const int* ids = Pid + ((it & 1) * n_split + split) * BS;
    __syncthreads();  // Qs and page ids written / previous tiles consumed
    if (tile < n_tiles) {
      for (int e = tid_g * 8; e < BS * HD; e += group_threads * 8) {
        const int r = e / HD, c = e % HD;
        float kv[8], vv[8];
        if (s0 + r < (PAGED ? n_keys : n_s)) {
          const size_t row = PAGED ? paged_row(ids, s0, r, ps, kh, n_kh, HD)
                                   : (size_t)(s0 + r) * HD;
          load8(kb + row + c, kv);
          load8(vb + row + c, vv);
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
    if (PAGED && tile + n_split < n_tiles)  // the next tile's page ids, other buffer
      stage_page_ids(Pid + (((it + 1) & 1) * n_split + split) * BS, pt_b, s0 + n_split * BS,
                     n_keys, ps, tid_g);
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

template <typename T, int HD, bool PAGED>
int launch_hd(const T* q, const T* k, const T* v, const int* pos, int s_pos0, const int* pt,
              int n_blocks, int ps, T* out, int n_b, int n_h, int n_kh, int n_s, float scale,
              cudaStream_t s) {
  const int g_n = n_h / n_kh;
  const int n_split = max(1, min(4, 32 / g_n));
  const int threads = n_split * g_n * 32;
  const size_t loop_smem = (size_t)g_n * HD + (size_t)n_split * (BS * (HD + 1) + BS * HD);
  const size_t merge_smem = (size_t)g_n * HD + (size_t)n_split * g_n * (HD + 2);
  const size_t ids = PAGED ? (size_t)2 * n_split * BS : 0;  // int page ids
  const size_t bytes = sizeof(float) * ((loop_smem > merge_smem ? loop_smem : merge_smem) + ids);
  static size_t configured = 0;
  if (bytes > configured) {
    cudaFuncSetAttribute(flash_decode_kernel<T, HD, PAGED>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    configured = bytes;
  }
  flash_decode_kernel<T, HD, PAGED><<<dim3(n_kh, n_b), threads, bytes, s>>>(
      q, k, v, pos, s_pos0, pt, n_blocks, ps, out, n_h, n_kh, n_s, scale, n_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool PAGED>
int launch(const T* q, const T* k, const T* v, const int* pos, int s_pos0, const int* pt,
           int n_blocks, int ps, T* out, int n_b, int n_h, int n_kh, int n_s, int hd,
           float scale, cudaStream_t s) {
  if (n_h % n_kh != 0 || n_h / n_kh > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (PAGED && (ps < 1 || (ps < BS ? BS % ps : ps % BS))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (hd == 128) {
    return launch_hd<T, 128, PAGED>(q, k, v, pos, s_pos0, pt, n_blocks, ps, out, n_b, n_h, n_kh,
                                    n_s, scale, s);
  }
  if (hd == 64) {
    return launch_hd<T, 64, PAGED>(q, k, v, pos, s_pos0, pt, n_blocks, ps, out, n_b, n_h, n_kh,
                                   n_s, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool PAGED>
int dispatch(const void* q, const void* k, const void* v, const void* pos, int s_pos0,
             const void* pt, int n_blocks, int ps, void* out, int n_b, int n_h, int n_kh,
             int n_s, int hd, float scale, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  const int* t = static_cast<const int*>(pt);
  if (bf16) {
    using B = __nv_bfloat16;
    return launch<B, PAGED>(static_cast<const B*>(q), static_cast<const B*>(k),
                            static_cast<const B*>(v), p, s_pos0, t, n_blocks, ps,
                            static_cast<B*>(out), n_b, n_h, n_kh, n_s, hd, scale, s);
  }
  return launch<float, PAGED>(static_cast<const float*>(q), static_cast<const float*>(k),
                              static_cast<const float*>(v), p, s_pos0, t, n_blocks, ps,
                              static_cast<float*>(out), n_b, n_h, n_kh, n_s, hd, scale, s);
}

}  // namespace

// q [B, 1, H, hd], k/v [B, KH, S, hd] (bf16 when bf16 else f32), pos int32
// [B]; out [B, 1, H, hd] in q's type. hd 64 or 128, H / KH <= 32.
// Returns cudaGetLastError().
extern "C" int flash_decode(const void* q, const void* k, const void* v, const void* pos,
                            int s_pos0, void* out, int n_b, int n_h, int n_kh, int n_s, int hd,
                            float scale, int bf16, void* stream) {
  return dispatch<false>(q, k, v, pos, s_pos0, nullptr, 0, 0, out, n_b, n_h, n_kh, n_s, hd,
                         scale, bf16, stream);
}

// q [B, 1, H, hd], k/v pages [P, KH, ps, hd], page_table int32 [B, n_blocks],
// pos int32 [B] (a lane at pos < 0 reads nothing and gets zeros); out as
// flash_decode's. ps divides 32 or is a multiple of 32.
extern "C" int paged_flash_decode(const void* q, const void* k_pages, const void* v_pages,
                                  const void* page_table, const void* pos, void* out, int n_b,
                                  int n_h, int n_kh, int n_blocks, int ps, int hd, float scale,
                                  int bf16, void* stream) {
  return dispatch<true>(q, k_pages, v_pages, pos, 0, page_table, n_blocks, ps, out, n_b, n_h,
                        n_kh, n_blocks * ps, hd, scale, bf16, stream);
}
