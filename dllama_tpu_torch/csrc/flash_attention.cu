// Blockwise causal GQA attention statistics for prefill on Hopper (sm_90a).
//
// Replaces the TPU kernel dllama_tpu/ops/flash_attention.py
// flash_attention_stats (_flash_stats_kernel): for T query rows per lane
// starting at q_pos0[b], keys of the head-major cache [B, KH, S, hd] at
// positions s_pos0 + j, query head h reading KV head h / (H / KH), it emits
// the unnormalized online-softmax state: acc f32 [B, KH, G, T, hd] and the
// row max m and denominator l, f32 [B, KH, G, T].
//
// Bound on an H100: prefill does ~4 * hd flops per (query row, visible key)
// and reads each K/V row once per query tile, so at T = 512 it is bound by
// operations (989 TFLOP/s bf16). This simple design runs on CUDA cores:
// one block per (16-row query tile, query head, lane); 4 warps own 4 rows
// each. The block loops over 32-key tiles only up to the causal frontier of
// its last row (the TPU grid instead walked every S block and clamped the
// copy index), staging K and V in shared memory as f32; lane j scores key j
// for the warp's 4 rows, and each lane then accumulates 4 (hd 128) or 2
// (hd 64) output dims. Masking is by position only: rows past a chunk's
// real width hold garbage (padded prefill) and are hidden by the causal
// mask, never by zeroed rows. A lane whose position is <= -T has an empty
// frontier and emits m = -1e30, l = 0, acc = 0 (the parked-lane contract).
//
// A second C entry, `flash_attention_stats_paged`, runs the same body over
// the paged pool [P, KH, ps, hd]: logical key row r of lane b is read from
// pool page page_table[b, r / ps] at page row r % ps (the template
// parameter PAGED; the page ids of each tile are staged in shared memory
// one tile ahead, and no row or page-table slot past the block's frontier
// is read). It serves admission chunks that attend to a lane's adopted
// prefix pages; the JAX engine gathers those pages into a slab view
// instead (dllama_tpu/runtime/engine.py _paged_gather).

#include "common.cuh"

using namespace dllama;

namespace {

constexpr int ROWS = 4;               // query rows per warp
constexpr int WARPS = 4;
constexpr int BT = ROWS * WARPS;      // query rows per block
constexpr int BS = 32;                // keys per tile

template <typename T, int HD, bool PAGED>
__global__ void __launch_bounds__(WARPS * 32)
flash_stats_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const int* __restrict__ q_pos0, int s_pos0, const int* __restrict__ pt,
                   int n_blocks, int ps, float* __restrict__ acc_out,
                   float* __restrict__ m_out, float* __restrict__ l_out, int n_t, int n_h,
                   int n_kh, int n_s, float scale) {
  constexpr int DPL = HD / 32;  // output dims per lane
  __shared__ __align__(16) float Qs[BT][HD];
  __shared__ float Ks[BS][HD + 1];  // padded: lane j reads row j conflict-free
  __shared__ __align__(16) float Vs[BS][HD];
  __shared__ int Pid[2][BS];  // page ids of this tile and the next (PAGED)

  const int t0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (n_h / n_kh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pos0 = q_pos0[b] + t0;  // position of the tile's first row

  for (int e = threadIdx.x; e < BT * HD; e += blockDim.x) {
    const int r = e / HD, c = e % HD, t = t0 + r;
    Qs[r][c] = t < n_t ? to_float(q[((size_t)(b * n_t + t) * n_h + h) * HD + c]) : 0.f;
  }

  // causal frontier of the tile's last real row, in local key rows
  const int last_pos = pos0 + min(BT, n_t - t0) - 1;
  const int n_keys = max(0, min(n_s, last_pos - s_pos0 + 1));
  const T* kb = k;
  const T* vb = v;
  if (!PAGED) {
    kb += (size_t)(b * n_kh + kh) * n_s * HD;
    vb += (size_t)(b * n_kh + kh) * n_s * HD;
  }
  const int* pt_b = PAGED ? pt + (size_t)b * n_blocks : nullptr;
  if (PAGED && n_keys > 0) stage_page_ids(Pid[0], pt_b, 0, n_keys, ps, threadIdx.x);

  float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  for (int s0 = 0; s0 < n_keys; s0 += BS) {
    const int* ids = Pid[(s0 / BS) & 1];
    __syncthreads();  // Qs and page ids written / previous tile consumed
    for (int e = threadIdx.x * 8; e < BS * HD; e += blockDim.x * 8) {
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
        Ks[r][c + j] = kv[j];
        Vs[r][c + j] = vv[j];
      }
    }
    __syncthreads();
    if (PAGED && s0 + BS < n_keys)  // the next tile's page ids, other buffer
      stage_page_ids(Pid[(s0 / BS + 1) & 1], pt_b, s0 + BS, n_keys, ps, threadIdx.x);

    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
#pragma unroll 8
    for (int c = 0; c < HD; ++c) {
      const float kc = Ks[lane][c];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) s[r] = fmaf(Qs[warp * ROWS + r][c], kc, s[r]);
    }
    const int key = s0 + lane;
    float p[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qpos = pos0 + warp * ROWS + r;
      const bool visible = key < n_s && s_pos0 + key <= qpos;
      float alpha;
      p[r] = online_softmax(visible ? s[r] * scale : NEG_INF, m[r], l[r], alpha);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < BS; ++j) {
      float vv[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) vv[i] = Vs[j][lane * DPL + i];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float pj = __shfl_sync(FULL_MASK, p[r], j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(pj, vv[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int t = t0 + warp * ROWS + r;
    if (t >= n_t) continue;
    const size_t row = (size_t)(b * n_h + h) * n_t + t;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc_out[row * HD + lane * DPL + i] = acc[r][i];
    if (lane == 0) {
      m_out[row] = m[r];
      l_out[row] = l[r];
    }
  }
}

template <typename T, bool PAGED>
int launch(const T* q, const T* k, const T* v, const int* q_pos0, int s_pos0, const int* pt,
           int n_blocks, int ps, float* acc, float* m, float* l, int n_b, int n_t, int n_h,
           int n_kh, int n_s, int hd, float scale, cudaStream_t s) {
  if (PAGED && (ps < 1 || (ps < BS ? BS % ps : ps % BS))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n_t + BT - 1) / BT, n_h, n_b);
  if (hd == 128) {
    flash_stats_kernel<T, 128, PAGED><<<grid, WARPS * 32, 0, s>>>(
        q, k, v, q_pos0, s_pos0, pt, n_blocks, ps, acc, m, l, n_t, n_h, n_kh, n_s, scale);
  } else if (hd == 64) {
    flash_stats_kernel<T, 64, PAGED><<<grid, WARPS * 32, 0, s>>>(
        q, k, v, q_pos0, s_pos0, pt, n_blocks, ps, acc, m, l, n_t, n_h, n_kh, n_s, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool PAGED>
int dispatch(const void* q, const void* k, const void* v, const void* q_pos0, int s_pos0,
             const void* pt, int n_blocks, int ps, void* acc, void* m, void* l, int n_b,
             int n_t, int n_h, int n_kh, int n_s, int hd, float scale, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pos = static_cast<const int*>(q_pos0);
  const int* t = static_cast<const int*>(pt);
  float* a = static_cast<float*>(acc);
  float* mm = static_cast<float*>(m);
  float* ll = static_cast<float*>(l);
  if (bf16) {
    using B = __nv_bfloat16;
    return launch<B, PAGED>(static_cast<const B*>(q), static_cast<const B*>(k),
                            static_cast<const B*>(v), pos, s_pos0, t, n_blocks, ps, a, mm, ll,
                            n_b, n_t, n_h, n_kh, n_s, hd, scale, s);
  }
  return launch<float, PAGED>(static_cast<const float*>(q), static_cast<const float*>(k),
                              static_cast<const float*>(v), pos, s_pos0, t, n_blocks, ps, a, mm,
                              ll, n_b, n_t, n_h, n_kh, n_s, hd, scale, s);
}

}  // namespace

// q [B, T, H, hd], k/v [B, KH, S, hd] (bf16 when bf16 else f32), q_pos0
// int32 [B]; outputs f32 acc [B, H, T, hd] (= [B, KH, G, T, hd]), m and l
// [B, H, T]. hd must be 64 or 128. Returns cudaGetLastError().
extern "C" int flash_attention_stats(const void* q, const void* k, const void* v,
                                     const void* q_pos0, int s_pos0, void* acc, void* m,
                                     void* l, int n_b, int n_t, int n_h, int n_kh, int n_s,
                                     int hd, float scale, int bf16, void* stream) {
  return dispatch<false>(q, k, v, q_pos0, s_pos0, nullptr, 0, 0, acc, m, l, n_b, n_t, n_h, n_kh,
                         n_s, hd, scale, bf16, stream);
}

// The same over k/v pages [P, KH, ps, hd] read through page_table int32
// [B, n_blocks] (keys at logical rows 0 .. n_blocks * ps - 1, s_pos0 0); ps
// divides 32 or is a multiple of 32.
extern "C" int flash_attention_stats_paged(const void* q, const void* k_pages,
                                           const void* v_pages, const void* page_table,
                                           const void* q_pos0, void* acc, void* m, void* l,
                                           int n_b, int n_t, int n_h, int n_kh, int n_blocks,
                                           int ps, int hd, float scale, int bf16, void* stream) {
  return dispatch<true>(q, k_pages, v_pages, q_pos0, 0, page_table, n_blocks, ps, acc, m, l, n_b,
                        n_t, n_h, n_kh, n_blocks * ps, hd, scale, bf16, stream);
}
