// Blockwise causal GQA attention statistics for prefill on Hopper (sm_90a).
//
// Replaces the TPU kernel dllama_tpu/ops/flash_attention.py
// flash_attention_stats (_flash_stats_kernel): for T query rows per lane
// starting at q_pos0[b], keys of the head-major cache [B, KH, S, hd] at
// positions s_pos0 + j, query head h reading KV head h / (H / KH), it emits
// the unnormalized online-softmax state: acc f32 [B, KH, G, T, hd] and the
// row max m and denominator l, f32 [B, KH, G, T].
//
// Bound on an H100: prefill does ~4 * hd operations per (query row, visible
// key) and needs each K/V row once, so at T = 512 it is bound by operations
// (989 TFLOP/s bf16), which only the tensor cores reach. A block loops over
// key tiles only up to the causal frontier of its last row (the TPU grid
// instead walked every S block and clamped the copy index). Masking is by
// position only: rows past a chunk's real width hold garbage (padded
// prefill) and are hidden by the causal mask, never by zeroed rows. A lane
// whose position is <= -T has an empty frontier and emits m = -1e30, l = 0,
// acc = 0 (the parked-lane contract). Key rows at or past the frontier are
// never read (zero-filled in shared memory).
//
// bf16 inputs run on the tensor cores (`flash_stats_tc_kernel`, wgmma from
// wgmma.cuh). A warpgroup's 64-row M tile packs the G query heads of one KV
// head over 64 / G consecutive positions (row r: head r / (64 / G), position
// r % (64 / G)), each row masked by its own position, so every K/V tile is
// staged once for all G heads; a block is two warpgroups over 2 * 64 / G
// positions sharing the tiles. Blocks run the latest query tiles (the longest
// frontiers) first. Per 64-key tile: S = Q K^T with Q as A fragments held in
// registers for the whole loop (bf16 Q is exact) and K as B in shared memory
// (hd-contiguous rows, 128-byte swizzle); the f32 online softmax on S in
// registers, each row reduced over the four threads of a quad; then
// O += P V with V as an MN-major B operand (wgmma's transposed B: the same
// swizzled rows as K, no transposition). P is not rounded to bf16: it enters
// as two bf16 A fragments, hi = bf16(p) and lo = bf16(p - hi), issued into
// the same accumulator, so P V differs from the f32 product by ~2^-18 p and
// the result from `attention_stats` by sum order only; l is the f32 sum of p.
// That costs 6 * hd operations per pair instead of 4 * hd (the bound counts
// the algorithm's 4 * hd). K/V tiles stream through a two-stage cp.async
// ring: tile j + 1's copy is in flight during tile j's math. What holds it
// above the bound: the QK^T and PV products of a tile and its softmax run one
// after the other in each warpgroup (no ping-pong between warpgroups), and
// at pos 0 the causal work is uneven across blocks (PERF.md).
//
// f32 inputs keep the CUDA-core body (`flash_stats_kernel`): no tensor-core
// type holds f32 exactly, and TF32 would be a new rounding. One block per
// (16-row query tile, query head, lane); 4 warps own 4 rows each; K and V
// 32-key tiles staged in shared memory; lane j scores key j for the warp's
// 4 rows, and each lane then accumulates hd / 32 output dims.
//
// A second C entry, `flash_attention_stats_paged`, runs the same bodies over
// the paged pool [P, KH, ps, hd]: logical key row r of lane b is read from
// pool page page_table[b, r / ps] at page row r % ps (the template
// parameter PAGED; the page ids of each 32-row (sub-)tile are staged in
// shared memory ahead of its copy, and no row or page-table slot past the
// block's frontier is read), so an identity page table gives the slab
// entry's bits. It serves admission chunks that attend to a lane's adopted
// prefix pages; the JAX engine gathers those pages into a slab view instead
// (dllama_tpu/runtime/engine.py _paged_gather).

#include "wgmma.cuh"

using namespace dllama;

namespace {

// ---- the f32 body on CUDA cores ----

constexpr int ROWS = 4;               // query rows per warp
constexpr int WARPS = 4;
constexpr int BT = ROWS * WARPS;      // query rows per block
constexpr int BS = 32;                // keys per tile (also the page contract's unit)

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

// ---- the bf16 body on tensor cores (see the note at the top) ----

constexpr int TC_WG = 2;  // warpgroups a block, sharing the K/V tiles
constexpr int TC_THREADS = 128 * TC_WG;
constexpr int TC_BN = 64;              // keys a tile: two 32-row sub-tiles of page ids
constexpr int TC_CHUNK = TC_BN * 128;  // bytes of 64 columns of a K or V tile

template <int HD> __host__ __device__ constexpr int tc_tile_bytes() { return TC_BN * HD * 2; }
// two stages of a K and a V tile, each [HD / 64][TC_BN rows][128 B] swizzled
template <int HD> __host__ __device__ constexpr int tc_smem_bytes() {
  return 2 * 2 * tc_tile_bytes<HD>();
}

// O[64 x HD] += P[64 x 16] . V[16 x HD], V MN-major: 16 key rows of the tile
template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2], const uint32_t (&p)[4], uint64_t v) {
  if constexpr (HD == 128) {
    wgmma_m64n128k16<1>(o, p, v);
  } else {
    wgmma_m64n64k16<1>(o, p, v);
  }
}

template <int HD, bool PAGED>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_stats_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const int* __restrict__ q_pos0,
                      int s_pos0, const int* __restrict__ pt, int n_blocks, int ps,
                      float* __restrict__ acc_out, float* __restrict__ m_out,
                      float* __restrict__ l_out, int n_t, int n_h, int n_kh, int n_s,
                      float scale) {
  constexpr int KS = HD / 16;  // k16 steps of Q K^T
  constexpr int CH = HD / 8;   // 16-byte chunks of a K/V row
  extern __shared__ __align__(1024) uint8_t smem[];
  __shared__ int Pid[2][TC_BN];  // page ids of a tile (PAGED), by tile parity

  const int g_n = n_h / n_kh, per = 64 / g_n, block_rows = per * TC_WG;
  const int kh = blockIdx.x, b = blockIdx.y;
  const int t0 = (gridDim.z - 1 - blockIdx.z) * block_rows;  // the latest rows first
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int tq = lane & 3;

  // this thread's two fragment rows (16 warp + lane / 4, + 8): head and query row
  int gr[2], tr[2], qpos[2];
  bool real[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + (lane >> 2) + 8 * h;
    gr[h] = r / per;
    tr[h] = t0 + wg * per + r % per;
    qpos[h] = q_pos0[b] + tr[h];
    real[h] = gr[h] < g_n && tr[h] < n_t;
  }
  // Q as A fragments for the whole loop: k16 step s holds columns
  // 16 s + 2 tq, +1 (f 0, 1: rows h) and + 8, + 9 (f 2, 3)
  uint32_t qa[KS][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const __nv_bfloat16* qr =
        q + ((size_t)(b * n_t + tr[h]) * n_h + kh * g_n + gr[h]) * HD + 2 * tq;
#pragma unroll
    for (int s = 0; s < KS; ++s)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        qa[s][h + 2 * c] =
            real[h] ? __ldg(reinterpret_cast<const unsigned*>(qr + 16 * s + 8 * c)) : 0u;
  }

  // causal frontier of the block's last real row, in local key rows
  const int last_pos = q_pos0[b] + t0 + min(block_rows, n_t - t0) - 1;
  const int n_keys = max(0, min(n_s, last_pos - s_pos0 + 1));
  const int n_tiles = (n_keys + TC_BN - 1) / TC_BN;
  const __nv_bfloat16* kb = k;
  const __nv_bfloat16* vb = v;
  if (!PAGED) {
    kb += (size_t)(b * n_kh + kh) * n_s * HD;
    vb += (size_t)(b * n_kh + kh) * n_s * HD;
  }
  const int* pt_b = PAGED ? pt + (size_t)b * n_blocks : nullptr;

  // page ids of tile j into Pid[j & 1]: a warp for each 32-row sub-tile
  auto stage_ids = [&](int j) {
    if (PAGED && tid < 64 && j < n_tiles)
      stage_page_ids(Pid[j & 1] + (tid & 32), pt_b, j * TC_BN + (tid & 32), n_keys, ps, tid & 31);
  };
  // cp.async of tile j into stage j & 1; rows at or past n_keys are zero-filled
  auto load_tile = [&](int j) {
    uint8_t* ks = smem + (j & 1) * 2 * tc_tile_bytes<HD>();
    uint8_t* vs = ks + tc_tile_bytes<HD>();
    const int s0 = j * TC_BN;
#pragma unroll
    for (int i = 0; i < TC_BN * CH / TC_THREADS; ++i) {
      const int e = tid + TC_THREADS * i, r = e / CH, c = e % CH;
      const bool ok = s0 + r < n_keys;
      size_t row = 0;
      if (ok) {
        row = PAGED ? paged_row(Pid[j & 1] + (r & 32), s0 + (r & 32), r & 31, ps, kh, n_kh, HD)
                    : (size_t)(s0 + r) * HD;
      }
      const int off = (c >> 3) * TC_CHUNK + sw128(r, c & 7);
      cp_async16(smem_addr(ks + off), kb + row + c * 8, ok);
      cp_async16(smem_addr(vs + off), vb + row + c * 8, ok);
    }
  };

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;

  stage_ids(0);
  stage_ids(1);
  __syncthreads();
  if (n_tiles > 0) load_tile(0);
  cp_async_commit();
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_tile(j + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile j's copy has landed
    fence_proxy_async();
    __syncthreads();
    stage_ids(j + 2);  // into the buffer tile j's copy read; used after the barrier below
    const uint32_t ka = smem_addr(smem + (j & 1) * 2 * tc_tile_bytes<HD>());
    const uint32_t va = ka + tc_tile_bytes<HD>();

    // S = Q K^T: k16 step st starts 32 bytes into each swizzled row of its 64-column chunk
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < KS; ++st)
      wgmma_m64n64k16<0>(s, qa[st], wgmma_desc_sw128(ka + (st >> 2) * TC_CHUNK + (st & 3) * 32));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // the online softmax with the JAX kernel's guards (common.cuh
    // online_softmax): s[i] is row h = (i >> 1) & 1, key 8 (i >> 2) + 2 tq + (i & 1)
    const int key0 = j * TC_BN + 2 * tq;
    float mx[2] = {NEG_INF, NEG_INF}, sum[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1, key = key0 + 8 * (i >> 2) + (i & 1);
      s[i] = key < n_s && s_pos0 + key <= qpos[h] ? s[i] * scale : NEG_INF;
      mx[h] = fmaxf(mx[h], s[i]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL_MASK, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL_MASK, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = m[h] <= NEG_INF / 2 ? 0.f : expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      s[i] = m[h] <= NEG_INF / 2 ? 0.f : expf(s[i] - m[h]);
      sum[h] += s[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(FULL_MASK, sum[h], 1);
      sum[h] += __shfl_xor_sync(FULL_MASK, sum[h], 2);
      l[h] = alpha[h] * l[h] + sum[h];
    }
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    // P as A fragments in two bf16 parts: p = hi + lo + O(2^-18 p), no new rounding
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float x0 = s[8 * kk + 2 * f], x1 = s[8 * kk + 2 * f + 1];
        ph[kk][f] = pack_bf16(x0, x1);
        const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ph[kk][f]));
        pl[kk][f] = pack_bf16(x0 - hi.x, x1 - hi.y);
      }

    // O += P V: k16 step kk is key rows 16 kk .., 2048 bytes into the tile
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = wgmma_desc_sw128(va + kk * 2048, TC_CHUNK);
      wgmma_pv<HD>(o, ph[kk], dv);
      wgmma_pv<HD>(o, pl[kk], dv);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    __syncthreads();  // stage j & 1 consumed, Pid[j & 1] staged
  }

  // o[i]: row h = (i >> 1) & 1, column 8 (i >> 2) + 2 tq + (i & 1)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!real[h]) continue;
    const size_t row = (size_t)(b * n_h + kh * g_n + gr[h]) * n_t + tr[h];
#pragma unroll
    for (int c = 0; c < HD / 8; ++c)
      *reinterpret_cast<float2*>(acc_out + row * HD + 8 * c + 2 * tq) =
          make_float2(o[4 * c + 2 * h], o[4 * c + 2 * h + 1]);
    if (tq == 0) {
      m_out[row] = m[h];
      l_out[row] = l[h];
    }
  }
}

template <int HD, bool PAGED>
void launch_tc(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
               const int* q_pos0, int s_pos0, const int* pt, int n_blocks, int ps, float* acc,
               float* m, float* l, int n_b, int n_t, int n_h, int n_kh, int n_s, float scale,
               cudaStream_t s) {
  constexpr int smem = tc_smem_bytes<HD>();
  cudaFuncSetAttribute(flash_stats_tc_kernel<HD, PAGED>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int rows = 64 / (n_h / n_kh) * TC_WG;  // query rows a block
  const dim3 grid(n_kh, n_b, (n_t + rows - 1) / rows);
  flash_stats_tc_kernel<HD, PAGED><<<grid, TC_THREADS, smem, s>>>(
      q, k, v, q_pos0, s_pos0, pt, n_blocks, ps, acc, m, l, n_t, n_h, n_kh, n_s, scale);
}

template <int HD, bool PAGED>
void launch_hd(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
               const int* q_pos0, int s_pos0, const int* pt, int n_blocks, int ps, float* acc,
               float* m, float* l, int n_b, int n_t, int n_h, int n_kh, int n_s, float scale,
               cudaStream_t s) {
  launch_tc<HD, PAGED>(q, k, v, q_pos0, s_pos0, pt, n_blocks, ps, acc, m, l, n_b, n_t, n_h,
                       n_kh, n_s, scale, s);
}
template <int HD, bool PAGED>
void launch_hd(const float* q, const float* k, const float* v, const int* q_pos0, int s_pos0,
               const int* pt, int n_blocks, int ps, float* acc, float* m, float* l, int n_b,
               int n_t, int n_h, int n_kh, int n_s, float scale, cudaStream_t s) {
  const dim3 grid((n_t + BT - 1) / BT, n_h, n_b);
  flash_stats_kernel<float, HD, PAGED><<<grid, WARPS * 32, 0, s>>>(
      q, k, v, q_pos0, s_pos0, pt, n_blocks, ps, acc, m, l, n_t, n_h, n_kh, n_s, scale);
}

template <typename T, bool PAGED>
int launch(const T* q, const T* k, const T* v, const int* q_pos0, int s_pos0, const int* pt,
           int n_blocks, int ps, float* acc, float* m, float* l, int n_b, int n_t, int n_h,
           int n_kh, int n_s, int hd, float scale, cudaStream_t s) {
  if (n_h % n_kh != 0 || n_h / n_kh > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (PAGED && (ps < 1 || (ps < BS ? BS % ps : ps % BS))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (hd == 128) {
    launch_hd<128, PAGED>(q, k, v, q_pos0, s_pos0, pt, n_blocks, ps, acc, m, l, n_b, n_t, n_h,
                          n_kh, n_s, scale, s);
  } else if (hd == 64) {
    launch_hd<64, PAGED>(q, k, v, q_pos0, s_pos0, pt, n_blocks, ps, acc, m, l, n_b, n_t, n_h,
                         n_kh, n_s, scale, s);
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
