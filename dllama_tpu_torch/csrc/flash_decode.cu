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
// (~4 * G * hd operations per 4 * hd bytes in bf16), so the kernel is bound
// by bytes: 2 * KH * (pos + 1) * hd * 2 B over 3.35 TB/s. Reaching that
// takes bytes in flight on many SMs, while batch-1 decode has only B * KH
// (KV head, lane) pairs (8 for llama-8b, 4 for qwen3-30b-a3b). So each pair
// is a thread-block cluster of CLUSTER = 8 blocks (the portable size): 64
// blocks at llama-8b batch 1, 32 at qwen3-30b-a3b, 256 and 128 at 4 serving
// lanes. Block `rank` of a cluster takes the contiguous share [rank * n / 8,
// (rank + 1) * n / 8) of the lane's n 32-row key tiles, computed on the card
// from pos alone, so the slab and paged entries split alike (at pos 0 all but
// one block are empty and merge with weight 0). Within a block, splits walk
// the block's tiles i, i + n_split, ..., each split streaming its K/V tiles,
// in the input type, through its own two-stage cp.async ring (the next tile
// is in flight while this one is scored); rows are stored with their 16-byte
// chunks XOR-swizzled by row, conflict-free for both bodies' reads. The
// splits' states merge by log-sum-exp in shared memory; after
// cluster.sync() rank 0 reads every block's state through distributed shared
// memory and merges them in rank order, then normalizes and writes the
// output (`merge_store`). No scratch in device memory, no atomics, no second
// launch, no counter to reset: the bits repeat from run to run. The loop
// reads only rows 0..pos (the TPU kernel's clamped index map could not skip
// the copies past pos, which is why the JAX engine windowed the cache
// instead).
//
// Two bodies share that structure:
// * bf16 with G <= 16 (`flash_decode_mma_kernel`): a split is one warp that
//   scores a 32-key tile for all G heads at once with mma.sync m16n8k16 (the
//   G query heads are the 16 rows of A, zero-padded, held in registers; K
//   and V fragments by ldmatrix, V's transposed), with the f32 online
//   softmax on the fragments and P entering P V as two bf16 parts, hi =
//   bf16(p) and lo = bf16(p - hi), so nothing is rounded that the plain
//   version keeps in f32. Four warps a block at batch 1, three above. The
//   CUDA-core body below was bound by its own instructions on bf16
//   (scripts/torch_decode_variants.py: KH 4 pos 4095 0.0366 ms on CUDA
//   cores, 0.0198 on tensor cores, 0.0154 copying the tiles alone).
// * f32, or more than 16 heads a KV head (`flash_decode_kernel`): a split is
//   G warps, one per query head; lane j scores key j from its K row, then
//   each lane accumulates its hd / 32 output dims from the V rows. No
//   tensor-core type holds f32 exactly.
// What holds it above the bound: a fixed ~10 us on the timer at pos 0 (the
// launch, the cluster's barriers; SDPA reads about the same) against the
// ~5 us of bytes at pos 4095, and one warp's serial tile loop per split.
//
// The row address is the only difference between the two entries (the
// template parameter PAGED): the paged body stages each tile's page ids in
// shared memory ahead of its copy, loads no row at or past the lane's
// frontier and never reads a page-table slot past it (unfilled slots point
// at the scratch page 0). Everything else is the same code, so with an
// identity page table the paged entry gives flash_decode's bits.
//
// The int8 KV cache (C entries `flash_decode_q8` and `paged_flash_decode_q8`,
// the KV type a template parameter of both bodies): K/V rows stream through
// the same ring as int8 (hd / 16 chunks a row: 8 at hd 128, 4 at hd 64, the
// 64-byte rows swizzled by row pair), each tile's 32 K and 32 V f32 row
// scales with it (4-byte cp.async, zero-filled past the frontier like the
// rows). The paged entry replaces the TPU kernel's QuantKV branch
// (_paged_decode_kernel quant_kv); the slab entry is the port's own route,
// where the JAX engine decodes an int8 slab with dequant_kv and XLA
// attention (dllama_tpu/models/transformer.py). The CUDA-core body reads
// the int8 values as floats and scales each score by K's row scale and
// each probability by V's. The tensor-core body builds its fragments from
// int8 in registers (ldmatrix cannot convert): a K fragment is one 32-bit
// word of a key row (the query's dims taken in the matching order, 16 s +
// 4 tq .. + 3), a V fragment four bytes of four key rows; K's scales go on
// the score columns before the mask, V's on P's columns before the hi / lo
// split, and l sums the unscaled p. Bytes: 2 * KH * (pos + 1) * (hd + 4) B.
//
// A float cache type unlike q's (C entries `flash_decode_mx` and
// `paged_flash_decode_mx`, q's and the cache's types as codes; `--kv-dtype`
// f32, f16 or bf16 under either model dtype) ports what the JAX decode
// kernels do for any pair: q, K and V upcast to f32 inside the kernel
// (_flash_decode_kernel, _paged_decode_kernel). bf16 q over a bf16 cache
// keeps the tensor-core body; every other pair runs the CUDA-core body, the
// ring holding the rows in the cache's type (f16 rows convert 8 values a
// chunk), q staged in f32 from its own type and the output written in q's.

//
// Sequence parallelism (C entry `flash_decode_stats`, the TPU kernel's
// emit_stats): over one cyclic shard whose row j sits at position s_pos0 +
// j * s_stride, the same bodies, instantiated with the template flag SP,
// stop short of the division: rank 0 of the
// cluster writes the merged unnormalized acc and the row max m and
// denominator l (`Stats`) in attention_stats' layout, which the ranks merge
// by log-sum-exp. The highest visible row is floor((pos - s_pos0) /
// s_stride); a shard wholly in the query's future reads no row and writes
// m = -1e30, l = 0, acc = 0. An int8 shard (C entry `flash_decode_stats_q8`)
// runs the `_q8` bodies with the flag set: the int8 rows and their scales
// stream as in flash_decode_q8, the state is written as above.

#include <cooperative_groups.h>

#include <type_traits>

#include "wgmma.cuh"

using namespace dllama;
namespace cg = cooperative_groups;

namespace {

// The unnormalized state of a stats launch (C entry `flash_decode_stats`):
// acc f32 [B, H, hd] and m, l f32 [B, H], the attention_stats contract at
// T = 1. Read only by the instantiations with the template flag SP set
// (a stats launch over a strided shard); the normalized entries compile
// without it and with a stride of 1
struct Stats {
  float* acc = nullptr;
  float* m = nullptr;
  float* l = nullptr;
};

constexpr int BS = 32;  // keys per tile
constexpr int CLUSTER = 8;  // blocks a (KV head, lane): the portable cluster size
constexpr int STAGES = 2;  // cp.async ring depth of a split
constexpr int SMEM_BUDGET = 227 * 1024;  // dynamic shared memory a block may take

template <typename KV, int HD> struct Tile {
  static constexpr bool Q8 = std::is_same<KV, int8_t>::value;  // the int8 KV cache
  static constexpr int ROW = HD * (int)sizeof(KV);  // bytes of a K/V row
  static constexpr int CH = ROW / 16;               // 16-byte chunks a row
  static constexpr int EPC = 16 / (int)sizeof(KV);  // elements a chunk
  static constexpr int BYTES = BS * ROW;            // a K or a V tile
  static constexpr int SCALES = Q8 ? BS * 4 : 0;    // a K or a V tile's f32 row scales
  static constexpr int STAGE = 2 * (BYTES + SCALES);  // K tile, V tile, K scales, V scales
  static constexpr int STATE = HD + 2;              // m, l and acc of a head, f32
  // byte offset of chunk c in row r: XOR-swizzled by row so that eight
  // rows read at one chunk lie on distinct banks; rows narrower than 128
  // bytes (int8 at hd 64: 4 chunks) swizzle by the row pair
  __host__ __device__ static constexpr int at(int r, int c) {
    return (CH >= 8 ? c ^ (r & 7) : c ^ ((r * CH / 8) & (CH - 1))) << 4;
  }
  // bytes of the tile ring ([n_split][STAGES] stages), which the splits'
  // merge reuses
  __host__ __device__ static constexpr int area(int n_split, int g_n) {
    return ((n_split * STAGES * STAGE > n_split * g_n * STATE * 4
                 ? n_split * STAGES * STAGE
                 : n_split * g_n * STATE * 4) +
            15) & ~15;
  }
  // the ring, Qs f32 [G][HD], the block's state f32 [G][STATE], page ids
  // [STAGES][n_split][BS]
  __host__ __device__ static constexpr int smem(int n_split, int g_n) {
    return area(n_split, g_n) + g_n * HD * 4 + g_n * STATE * 4 + STAGES * n_split * BS * 4;
  }
};

// a 16-byte chunk of shared memory as floats
__device__ __forceinline__ void chunk_floats(const uint8_t* p, float (&f)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
}
__device__ __forceinline__ void chunk_floats(const uint8_t* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 x = __bfloat1622float2(h[j]);
    f[2 * j] = x.x;
    f[2 * j + 1] = x.y;
  }
}
__device__ __forceinline__ void chunk_floats(const uint8_t* p, float (&f)[16]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 16; ++j) f[j] = static_cast<float>(static_cast<int8_t>(w[j >> 2] >> (8 * (j & 3))));
}
// a 16-byte chunk of f16 values (a cache type unlike q's)
__device__ __forceinline__ void chunk_floats_f16(const uint8_t* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 x = __half22float2(h[j]);
    f[2 * j] = x.x;
    f[2 * j + 1] = x.y;
  }
}
__device__ __forceinline__ float2 pair_floats(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair_floats(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 pair_floats(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}
__device__ __forceinline__ float2 pair_floats(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(c.x, c.y);
}

// cp.async of the 32-row K/V tile at lane row s0 into the stage st (K, then
// V at st + BYTES; for the int8 cache the tile's K and V row scales after
// them, from ksb and vsb) by n threads, this one i: 16-byte chunk c of row r
// lands at Tile::at(r, c) of its row (conflict-free both for a lane reading
// its own row and for the fragment reads); rows at or past n_keys, and their
// scales, are zero-filled, never read
template <typename KV, int HD, bool PAGED>
__device__ __forceinline__ void load_tile(uint8_t* st, const KV* kb, const KV* vb,
                                          const float* ksb, const float* vsb, const int* ids,
                                          int s0, int n_keys, int ps, int kh, int n_kh, int i,
                                          int n) {
  using TL = Tile<KV, HD>;
  for (int e = i; e < BS * TL::CH; e += n) {
    const int r = e / TL::CH, c = e % TL::CH;
    const bool ok = s0 + r < n_keys;
    size_t row = 0;
    if (ok) row = PAGED ? paged_row(ids, s0, r, ps, kh, n_kh, HD) : (size_t)(s0 + r) * HD;
    const int off = r * TL::ROW + TL::at(r, c);
    cp_async16(smem_addr(st + off), kb + row + c * TL::EPC, ok);
    cp_async16(smem_addr(st + TL::BYTES + off), vb + row + c * TL::EPC, ok);
  }
  if constexpr (TL::Q8) {
    for (int r = i; r < BS; r += n) {
      const bool ok = s0 + r < n_keys;
      size_t row = 0;
      if (ok) row = PAGED ? paged_row(ids, s0, r, ps, kh, n_kh, 1) : (size_t)(s0 + r);
      cp_async4(smem_addr(st + 2 * TL::BYTES + 4 * r), ksb + row, ok);
      cp_async4(smem_addr(st + 2 * TL::BYTES + TL::SCALES + 4 * r), vsb + row, ok);
    }
  }
}

// The end of both bodies. The splits' states (Ms, Ls [n_split][G], As
// [n_split][G][HD], written before the call) merge by log-sum-exp into the
// block's state R [G][STATE]; after cluster.sync() rank 0 reads every block's
// R through distributed shared memory, merges them in rank order (all ranks'
// loads issued before any is used; a block with no rows takes part with
// weight 0), normalizes and writes the G heads at ob. Warp w merges heads w,
// w + n_warps, ...
template <typename T, int HD, bool SP>
__device__ __forceinline__ void merge_store(const float* Ms, const float* Ls, const float* As,
                                            int n_split, int g_n, float* R, T* ob, Stats stats,
                                            size_t row0, cg::cluster_group& cluster) {
  constexpr int DPL = HD / 32, STATE = HD + 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
  __syncthreads();
  for (int g = warp; g < g_n; g += n_warps) {
    float m_blk = NEG_INF;
    for (int sp = 0; sp < n_split; ++sp) m_blk = fmaxf(m_blk, Ms[sp * g_n + g]);
    float l_blk = 0.f, o[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) o[i] = 0.f;
    for (int sp = 0; sp < n_split; ++sp) {
      const int sl = sp * g_n + g;
      const float w = Ms[sl] <= NEG_INF / 2 ? 0.f : expf(Ms[sl] - m_blk);
      l_blk += w * Ls[sl];
#pragma unroll
      for (int i = 0; i < DPL; ++i) o[i] += w * As[sl * HD + lane * DPL + i];
    }
    float* rg = R + g * STATE;
    if (lane == 0) {
      rg[0] = m_blk;
      rg[1] = l_blk;
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) rg[2 + lane * DPL + i] = o[i];
  }
  cluster.sync();
  if (cluster.block_rank() == 0) {
    for (int g = warp; g < g_n; g += n_warps) {
      const float* pr[CLUSTER];
      float mr[CLUSTER], m_all = NEG_INF, l_all = 0.f, o[DPL];
#pragma unroll
      for (int rr = 0; rr < CLUSTER; ++rr) {
        pr[rr] = cluster.map_shared_rank(R, rr) + g * STATE;
        mr[rr] = pr[rr][0];
        m_all = fmaxf(m_all, mr[rr]);
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) o[i] = 0.f;
#pragma unroll
      for (int rr = 0; rr < CLUSTER; ++rr) {
        const float w = mr[rr] <= NEG_INF / 2 ? 0.f : expf(mr[rr] - m_all);
        l_all += w * pr[rr][1];
#pragma unroll
        for (int i = 0; i < DPL; ++i) o[i] += w * pr[rr][2 + lane * DPL + i];
      }
      if constexpr (SP) {  // the merged state, not divided: row row0 + g
#pragma unroll
        for (int i = 0; i < DPL; ++i) stats.acc[(row0 + g) * HD + lane * DPL + i] = o[i];
        if (lane == 0) {
          stats.m[row0 + g] = m_all;
          stats.l[row0 + g] = l_all;
        }
        continue;
      }
      const float l_safe = l_all == 0.f ? 1.f : l_all;
#pragma unroll
      for (int i = 0; i < DPL; ++i) ob[g * HD + lane * DPL + i] = from_float<T>(o[i] / l_safe);
    }
  }
  cluster.sync();  // every block's state stays until rank 0 has read it
}

// ---- the CUDA-core body: f32 inputs, and bf16 with more than 16 heads a KV head ----

template <typename T, typename KV, int HD, bool PAGED, bool SP>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(1024)
flash_decode_kernel(const T* __restrict__ q, const KV* __restrict__ k, const KV* __restrict__ v,
                    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                    const int* __restrict__ pos, int s_pos0, int s_stride, Stats stats, const int* __restrict__ pt,
                    int n_blocks, int ps, T* __restrict__ out, int n_h, int n_kh, int n_s,
                    float scale, int n_split) {
  using TL = Tile<KV, HD>;
  constexpr int DPL = HD / 32;  // output dims a lane
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cluster.block_rank(), g_n = n_h / n_kh;
  const int kh = blockIdx.x / CLUSTER, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int split = warp / g_n, g = warp % g_n;
  const int group_threads = g_n * 32, tid_g = threadIdx.x - split * group_threads;
  uint8_t* ring = smem;
  float* Qs = reinterpret_cast<float*>(smem + TL::area(n_split, g_n));
  float* R = Qs + g_n * HD;  // the block's merged state, read by rank 0
  int* Pid = reinterpret_cast<int*>(R + g_n * TL::STATE);

  const T* qb = q + ((size_t)b * n_h + kh * g_n) * HD;
  for (int e = threadIdx.x; e < g_n * HD; e += blockDim.x) Qs[e] = to_float(qb[e]);

  // highest visible local row (a strided shard only in a stats launch)
  const int limit = SP ? floor_div(pos[b] - s_pos0, s_stride) : pos[b] - s_pos0;
  const int n_keys = max(0, min(n_s, limit + 1));
  const int n_tiles = (n_keys + BS - 1) / BS;
  const int lo = rank * n_tiles / CLUSTER, hi = (rank + 1) * n_tiles / CLUSTER;  // its tiles
  const KV* kb = k;
  const KV* vb = v;
  const float* ksb = k_scale;
  const float* vsb = v_scale;
  if (!PAGED) {
    kb += (size_t)(b * n_kh + kh) * n_s * HD;
    vb += (size_t)(b * n_kh + kh) * n_s * HD;
    if constexpr (TL::Q8) {
      ksb += (size_t)(b * n_kh + kh) * n_s;
      vsb += (size_t)(b * n_kh + kh) * n_s;
    }
  }
  const int* pt_b = PAGED ? pt + (size_t)b * n_blocks : nullptr;

  // iteration it of this split: tile lo + it * n_split + split, ring stage
  // and page-id buffer it % STAGES
  auto tile_of = [&](int it) { return lo + it * n_split + split; };
  auto ids_of = [&](int it) { return Pid + ((it % STAGES) * n_split + split) * BS; };
  auto stage_of = [&](int it) { return ring + (split * STAGES + it % STAGES) * TL::STAGE; };
  auto stage_ids = [&](int it) {
    if (PAGED && tile_of(it) < hi)
      stage_page_ids(ids_of(it), pt_b, tile_of(it) * BS, n_keys, ps, tid_g);
  };
  auto load = [&](int it) {
    if (tile_of(it) < hi)
      load_tile<KV, HD, PAGED>(stage_of(it), kb, vb, ksb, vsb, ids_of(it), tile_of(it) * BS,
                               n_keys, ps, kh, n_kh, tid_g, group_threads);
  };

  float m = NEG_INF, l = 0.f, acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  const int v_off = lane * DPL * (int)sizeof(KV);  // byte of this lane's dims in a V row

  for (int it = 0; it < STAGES; ++it) stage_ids(it);
  __syncthreads();  // Qs and the first page ids
  for (int it = 0; it < STAGES - 1; ++it) {
    load(it);
    cp_async_commit();
  }
  const int n_it = (hi - lo + n_split - 1) / n_split;
  for (int it = 0; it < n_it; ++it) {
    load(it + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // this iteration's tile has landed
    __syncthreads();
    stage_ids(it + STAGES);  // into the buffer this tile's copy read; used after a barrier
    const int t = tile_of(it);
    if (t < hi) {
      const uint8_t* ks = stage_of(it);
      const uint8_t* vs = ks + TL::BYTES;
      // the int8 cache's row scales: K's on the score, V's on the probability
      const float* k_sc = reinterpret_cast<const float*>(ks + 2 * TL::BYTES);
      const float* v_sc = k_sc + BS;
      const uint8_t* kr = ks + lane * TL::ROW;
      const float* qg = Qs + g * HD;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < TL::CH; ++c) {
        float f[TL::EPC];
        if constexpr (std::is_same<KV, __half>::value) {
          chunk_floats_f16(kr + TL::at(lane, c), f);
        } else {
          chunk_floats(kr + TL::at(lane, c), f);
        }
#pragma unroll
        for (int e = 0; e < TL::EPC; ++e) s = fmaf(qg[c * TL::EPC + e], f[e], s);
      }
      if constexpr (TL::Q8) s *= k_sc[lane];
      const int key = t * BS + lane;
      const bool visible = key < n_s && key <= limit;
      float alpha;
      const float p = online_softmax(visible ? s * scale : NEG_INF, m, l, alpha);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
#pragma unroll 4
      for (int j = 0; j < BS; ++j) {
        float pj = __shfl_sync(FULL_MASK, p, j);
        if constexpr (TL::Q8) pj *= v_sc[j];
        const KV* vr = reinterpret_cast<const KV*>(vs + j * TL::ROW + TL::at(j, v_off >> 4) +
                                                   (v_off & 15));
#pragma unroll
        for (int i = 0; i < DPL / 2; ++i) {
          const float2 f = pair_floats(vr + 2 * i);
          acc[2 * i] = fmaf(pj, f.x, acc[2 * i]);
          acc[2 * i + 1] = fmaf(pj, f.y, acc[2 * i + 1]);
        }
      }
    }
    __syncthreads();  // the stage consumed, the page ids staged
  }
  cp_async_wait<0>();

  float* Ms = reinterpret_cast<float*>(ring);
  float* Ls = Ms + n_split * g_n;
  float* As = Ls + n_split * g_n;
  const int slot = split * g_n + g;
  if (lane == 0) {
    Ms[slot] = m;
    Ls[slot] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) As[slot * HD + lane * DPL + i] = acc[i];
  merge_store<T, HD, SP>(Ms, Ls, As, n_split, g_n, R, out + ((size_t)b * n_h + kh * g_n) * HD,
                     stats, (size_t)b * n_h + kh * g_n, cluster);
}

// ---- the tensor-core body: bf16, up to 16 query heads a KV head ----

constexpr int MMA_WARPS = 4;  // the most splits a block: a warp each, all G heads

// four 8 x 8 b16 matrices; lane l gives row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

template <typename KV, int HD, bool PAGED, bool SP>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(MMA_WARPS * 32)
flash_decode_mma_kernel(const __nv_bfloat16* __restrict__ q, const KV* __restrict__ k,
                        const KV* __restrict__ v, const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale, const int* __restrict__ pos,
                        int s_pos0, int s_stride, Stats stats, const int* __restrict__ pt, int n_blocks, int ps,
                        __nv_bfloat16* __restrict__ out, int n_h, int n_kh, int n_s,
                        float scale, int n_split) {
  using B16 = __nv_bfloat16;
  using TL = Tile<KV, HD>;
  constexpr bool Q8 = TL::Q8;
  constexpr int KS = HD / 16;  // k16 steps of q . k
  constexpr int NT = HD / 8;   // 8-column tiles of the output (a 16-byte chunk each)
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cluster.block_rank(), g_n = n_h / n_kh;
  const int kh = blockIdx.x / CLUSTER, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  uint8_t* ring = smem;
  float* R = reinterpret_cast<float*>(smem + TL::area(n_split, g_n)) + g_n * HD;
  int* Pid = reinterpret_cast<int*>(R + g_n * TL::STATE);

  // the G query heads as m16n8k16 A fragments (rows G .. 15 zero): k16 step
  // s holds row gq + 8 (f & 1) at k 2 tq, + 1 (f < 2) and 2 tq + 8, + 9
  // (f >= 2). Those k are dims 16 s + 2 tq, + 1 and + 8, + 9; for the int8
  // cache dims 16 s + 4 tq .. + 3 in that order, so that a lane's K
  // fragment is the four int8 values of one 32-bit word of a key row (the
  // sum over dims does not depend on their order)
  uint32_t qa[KS][4];
  const B16* qb = q + ((size_t)b * n_h + kh * g_n) * HD;
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int row = gq + 8 * (f & 1);
      const int col = Q8 ? 16 * s + 4 * tq + 2 * (f >> 1) : 16 * s + 8 * (f >> 1) + 2 * tq;
      qa[s][f] = row < g_n ? __ldg(reinterpret_cast<const unsigned*>(qb + row * HD + col)) : 0u;
    }

  // highest visible local row (a strided shard only in a stats launch)
  const int limit = SP ? floor_div(pos[b] - s_pos0, s_stride) : pos[b] - s_pos0;
  const int n_keys = max(0, min(n_s, limit + 1));
  const int n_tiles = (n_keys + BS - 1) / BS;
  const int lo = rank * n_tiles / CLUSTER, hi = (rank + 1) * n_tiles / CLUSTER;  // its tiles
  const KV* kb = k;
  const KV* vb = v;
  const float* ksb = k_scale;
  const float* vsb = v_scale;
  if (!PAGED) {
    kb += (size_t)(b * n_kh + kh) * n_s * HD;
    vb += (size_t)(b * n_kh + kh) * n_s * HD;
    if constexpr (Q8) {
      ksb += (size_t)(b * n_kh + kh) * n_s;
      vsb += (size_t)(b * n_kh + kh) * n_s;
    }
  }
  const int* pt_b = PAGED ? pt + (size_t)b * n_blocks : nullptr;

  // iteration it of warp (split) w: tile lo + it * n_split + w; each warp
  // streams its own tiles through its own ring, so a warp barrier suffices
  auto tile_of = [&](int it) { return lo + it * n_split + warp; };
  auto ids_of = [&](int it) { return Pid + ((it % STAGES) * n_split + warp) * BS; };
  auto stage_of = [&](int it) { return ring + (warp * STAGES + it % STAGES) * TL::STAGE; };
  auto stage_ids = [&](int it) {
    if (PAGED && tile_of(it) < hi)
      stage_page_ids(ids_of(it), pt_b, tile_of(it) * BS, n_keys, ps, lane);
  };
  auto load = [&](int it) {
    if (tile_of(it) < hi)
      load_tile<KV, HD, PAGED>(stage_of(it), kb, vb, ksb, vsb, ids_of(it), tile_of(it) * BS,
                               n_keys, ps, kh, n_kh, lane, 32);
  };

  // rows gq (h 0) and gq + 8 (h 1): their m, l and output tiles
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int it = 0; it < STAGES; ++it) stage_ids(it);
  __syncwarp();
  for (int it = 0; it < STAGES - 1; ++it) {
    load(it);
    cp_async_commit();
  }
  const int n_it = hi - lo > warp ? (hi - lo - warp + n_split - 1) / n_split : 0;
  for (int it = 0; it < n_it; ++it) {
    load(it + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // this iteration's tile has landed
    __syncwarp();
    stage_ids(it + STAGES);  // into the buffer this tile's copy read; used after a barrier
    const uint8_t* st = stage_of(it);
    const uint32_t ka = smem_addr(st), va = ka + TL::BYTES;  // the bf16 fragments' addresses

    // S = Q K^T over the tile's four 8-key column tiles; bf16: ldmatrix x4
    // gives the K fragments of key tiles 2 np and 2 np + 1 at k16 step s;
    // int8: lane (gq, tq) reads the word of dims 16 s + 4 tq .. of key row
    // 8 j + gq and converts it (exact in bf16)
    float sc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    if constexpr (Q8) {
#pragma unroll
      for (int s = 0; s < KS; ++s)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = 8 * j + gq;
          const uint32_t w =
              *reinterpret_cast<const uint32_t*>(st + r * TL::ROW + TL::at(r, s) + 4 * tq);
          mma_bf16(sc[j], qa[s], s8x2_bf16(w), s8x2_bf16(w >> 16));
        }
    } else {
#pragma unroll
      for (int s = 0; s < KS; ++s)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int r = 16 * np + 8 * (lane >> 4) + (lane & 7), c = 2 * s + ((lane >> 3) & 1);
          uint32_t kf[4];
          ldsm_x4(ka + r * TL::ROW + TL::at(r, c), kf);
          mma_bf16(sc[2 * np], qa[s], kf[0], kf[1]);
          mma_bf16(sc[2 * np + 1], qa[s], kf[2], kf[3]);
        }
    }
    // the int8 cache's row scales of this lane's keys 8 j + 2 tq, + 1: K's
    // on the score, V's on the probability (not on l)
    float2 k_sc[4], v_sc[4];
    if constexpr (Q8) {
      const float* sk = reinterpret_cast<const float*>(st + 2 * TL::BYTES);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        k_sc[j] = *reinterpret_cast<const float2*>(sk + 8 * j + 2 * tq);
        v_sc[j] = *reinterpret_cast<const float2*>(sk + BS + 8 * j + 2 * tq);
      }
    }

    // the online softmax with the JAX kernel's guards (common.cuh
    // online_softmax): sc[j][e] is row h = e >> 1, key 8 j + 2 tq + (e & 1)
    const int key0 = tile_of(it) * BS + 2 * tq;
    float mx[2] = {NEG_INF, NEG_INF}, sum[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 8 * j + (e & 1);
        float x = sc[j][e];
        if constexpr (Q8) x *= (e & 1) ? k_sc[j].y : k_sc[j].x;
        sc[j][e] = key < n_s && key <= limit ? x * scale : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
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
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        sc[j][e] = m[h] <= NEG_INF / 2 ? 0.f : expf(sc[j][e] - m[h]);
        sum[h] += sc[j][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(FULL_MASK, sum[h], 1);
      sum[h] += __shfl_xor_sync(FULL_MASK, sum[h], 2);
      l[h] = alpha[h] * l[h] + sum[h];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];

    // P as A fragments in two bf16 parts, p = hi + lo + O(2^-18 p): k16 step
    // kk is key tiles 2 kk (f 0, 1) and 2 kk + 1 (f 2, 3)
    uint32_t ph[2][4], pl[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        float x0 = sc[2 * kk + (f >> 1)][2 * (f & 1)];
        float x1 = sc[2 * kk + (f >> 1)][2 * (f & 1) + 1];
        if constexpr (Q8) {
          x0 *= v_sc[2 * kk + (f >> 1)].x;
          x1 *= v_sc[2 * kk + (f >> 1)].y;
        }
        ph[kk][f] = pack_bf16(x0, x1);
        const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ph[kk][f]));
        pl[kk][f] = pack_bf16(x0 - hi.x, x1 - hi.y);
      }

    // O += P V; bf16: ldmatrix x4 .trans gives the V fragments of output
    // tiles 2 np and 2 np + 1 at k16 step kk; int8: lane (gq, tq) reads dim
    // 8 n + gq of key rows 16 kk + 2 tq, + 1, + 8, + 9 (one byte each)
    if constexpr (Q8) {
      const int8_t* vt = reinterpret_cast<const int8_t*>(st + TL::BYTES);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int d = 8 * n + gq, r = 16 * kk + 2 * tq;
          auto val = [&](int rr) {
            return static_cast<float>(vt[rr * TL::ROW + TL::at(rr, d >> 4) + (d & 15)]);
          };
          const uint32_t b0 = pack_bf16(val(r), val(r + 1)), b1 = pack_bf16(val(r + 8), val(r + 9));
          mma_bf16(o[n], ph[kk], b0, b1);
          mma_bf16(o[n], pl[kk], b0, b1);
        }
    } else {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          const int r = 16 * kk + 8 * ((lane >> 3) & 1) + (lane & 7), c = 2 * np + (lane >> 4);
          uint32_t vf[4];
          ldsm_x4_trans(va + r * TL::ROW + TL::at(r, c), vf);
          mma_bf16(o[2 * np], ph[kk], vf[0], vf[1]);
          mma_bf16(o[2 * np], pl[kk], vf[0], vf[1]);
          mma_bf16(o[2 * np + 1], ph[kk], vf[2], vf[3]);
          mma_bf16(o[2 * np + 1], pl[kk], vf[2], vf[3]);
        }
    }
    __syncwarp();  // the stage consumed, the page ids staged
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring, which the merge reuses

  float* Ms = reinterpret_cast<float*>(ring);
  float* Ls = Ms + n_split * g_n;
  float* As = Ls + n_split * g_n;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = gq + 8 * h, slot = warp * g_n + row;
    if (row >= g_n) continue;
    if (tq == 0) {
      Ms[slot] = m[h];
      Ls[slot] = l[h];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(As + slot * HD + 8 * n + 2 * tq) =
          make_float2(o[n][2 * h], o[n][2 * h + 1]);
  }
  merge_store<B16, HD, SP>(Ms, Ls, As, n_split, g_n, R, out + ((size_t)b * n_h + kh * g_n) * HD,
                       stats, (size_t)b * n_h + kh * g_n, cluster);
}

template <typename KV, int HD, bool PAGED, bool SP>
int launch_mma(const __nv_bfloat16* q, const KV* k, const KV* v, const float* ksc,
               const float* vsc, const int* pos, int s_pos0, int s_stride, Stats stats, const int* pt, int n_blocks, int ps,
               __nv_bfloat16* out, int n_b, int n_h, int n_kh, int n_s, float scale,
               cudaStream_t s) {
  // four warps a block while the clusters are few (batch 1); three past
  // that, so that two blocks fit an SM and more clusters of 8 fit the GPCs
  // at once (scripts/torch_decode_variants.py on an H100: 4 lanes at pos
  // ~500 take 0.0271 / 0.0193 ms at KH 8 / 4 with three, 0.0350 / 0.0286
  // with four; one lane at pos 4095 0.0188 with four, 0.0220 with three)
  const int n_split = n_b * n_kh <= 8 ? MMA_WARPS : MMA_WARPS - 1;
  const int bytes = Tile<KV, HD>::smem(n_split, n_h / n_kh);
  static SmemLimit limit;
  const cudaError_t e = limit.raise(flash_decode_mma_kernel<KV, HD, PAGED, SP>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_decode_mma_kernel<KV, HD, PAGED, SP><<<dim3(CLUSTER * n_kh, n_b), n_split * 32, bytes, s>>>(
      q, k, v, ksc, vsc, pos, s_pos0, s_stride, stats, pt, n_blocks, ps, out, n_h, n_kh, n_s, scale, n_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename KV, int HD, bool PAGED, bool SP>
int launch_hd(const T* q, const KV* k, const KV* v, const float* ksc, const float* vsc,
              const int* pos, int s_pos0, int s_stride, Stats stats, const int* pt, int n_blocks, int ps, T* out, int n_b,
              int n_h, int n_kh, int n_s, float scale, cudaStream_t s) {
  using TL = Tile<KV, HD>;
  const int g_n = n_h / n_kh;
  // the tensor-core body takes bf16 q over a bf16 or int8 cache; every
  // other pair of types (a cache type unlike q's) the CUDA-core body
  if constexpr (std::is_same<T, __nv_bfloat16>::value &&
                (std::is_same<KV, __nv_bfloat16>::value || std::is_same<KV, int8_t>::value)) {
    if (g_n <= 16) {
      return launch_mma<KV, HD, PAGED, SP>(q, k, v, ksc, vsc, pos, s_pos0, s_stride, stats, pt, n_blocks, ps, out,
                                       n_b, n_h, n_kh, n_s, scale, s);
    }
  }
  int n_split = max(1, min(4, 32 / g_n));
  while (n_split > 1 && TL::smem(n_split, g_n) > SMEM_BUDGET) --n_split;
  const int bytes = TL::smem(n_split, g_n);
  static SmemLimit limit;
  const cudaError_t e = limit.raise(flash_decode_kernel<T, KV, HD, PAGED, SP>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_decode_kernel<T, KV, HD, PAGED, SP>
      <<<dim3(CLUSTER * n_kh, n_b), n_split * g_n * 32, bytes, s>>>(
          q, k, v, ksc, vsc, pos, s_pos0, s_stride, stats, pt, n_blocks, ps, out, n_h, n_kh, n_s, scale, n_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename KV, bool PAGED, bool SP = false>
int launch(const T* q, const KV* k, const KV* v, const float* ksc, const float* vsc,
           const int* pos, int s_pos0, int s_stride, Stats stats, const int* pt, int n_blocks, int ps, T* out, int n_b,
           int n_h, int n_kh, int n_s, int hd, float scale, cudaStream_t s) {
  if (n_h % n_kh != 0 || n_h / n_kh > 32 || s_stride < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (PAGED && (ps < 1 || (ps < BS ? BS % ps : ps % BS))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (hd == 128) {
    return launch_hd<T, KV, 128, PAGED, SP>(q, k, v, ksc, vsc, pos, s_pos0, s_stride, stats, pt, n_blocks, ps, out,
                                        n_b, n_h, n_kh, n_s, scale, s);
  }
  if (hd == 64) {
    return launch_hd<T, KV, 64, PAGED, SP>(q, k, v, ksc, vsc, pos, s_pos0, s_stride, stats, pt, n_blocks, ps, out,
                                       n_b, n_h, n_kh, n_s, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Q8: k and v are the int8 cache's values, ksc and vsc its f32 row scales
// (the cache's shape with a last dim of 1); else k and v are in q's type
template <bool PAGED, bool Q8, bool SP = false>
int dispatch(const void* q, const void* k, const void* v, const void* ksc, const void* vsc,
             const void* pos, int s_pos0, int s_stride, Stats stats, const void* pt, int n_blocks, int ps, void* out,
             int n_b, int n_h, int n_kh, int n_s, int hd, float scale, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  const int* t = static_cast<const int*>(pt);
  const float* ks = static_cast<const float*>(ksc);
  const float* vs = static_cast<const float*>(vsc);
  if (bf16) {
    using B = __nv_bfloat16;
    using KV = typename std::conditional<Q8, int8_t, B>::type;
    return launch<B, KV, PAGED, SP>(static_cast<const B*>(q), static_cast<const KV*>(k),
                                    static_cast<const KV*>(v), ks, vs, p, s_pos0, s_stride, stats,
                                    t, n_blocks, ps, static_cast<B*>(out), n_b, n_h, n_kh, n_s,
                                    hd, scale, s);
  }
  using KV = typename std::conditional<Q8, int8_t, float>::type;
  return launch<float, KV, PAGED, SP>(static_cast<const float*>(q), static_cast<const KV*>(k),
                                  static_cast<const KV*>(v), ks, vs, p, s_pos0, s_stride, stats, t, n_blocks, ps,
                                  static_cast<float*>(out), n_b, n_h, n_kh, n_s, hd, scale, s);
}

// The mixed-type entries: q and out in q_type (TYPE_F32 or TYPE_BF16), k
// and v in kv_type (TYPE_F32, TYPE_BF16 or TYPE_F16), each read in its own type
template <typename T, bool PAGED, bool SP>
int dispatch_kv(const T* q, const void* k, const void* v, int kv_type, const int* pos,
                int s_pos0, int s_stride, Stats stats, const int* pt, int n_blocks, int ps, T* out, int n_b, int n_h,
                int n_kh, int n_s, int hd, float scale, cudaStream_t s) {
  switch (kv_type) {
    case TYPE_F32:
      return launch<T, float, PAGED, SP>(q, static_cast<const float*>(k),
                                     static_cast<const float*>(v), nullptr, nullptr, pos, s_pos0, s_stride, stats,
                                     pt, n_blocks, ps, out, n_b, n_h, n_kh, n_s, hd, scale, s);
    case TYPE_BF16:
      return launch<T, __nv_bfloat16, PAGED, SP>(q, static_cast<const __nv_bfloat16*>(k),
                                             static_cast<const __nv_bfloat16*>(v), nullptr,
                                             nullptr, pos, s_pos0, s_stride, stats, pt, n_blocks, ps, out, n_b,
                                             n_h, n_kh, n_s, hd, scale, s);
    case TYPE_F16:
      return launch<T, __half, PAGED, SP>(q, static_cast<const __half*>(k),
                                      static_cast<const __half*>(v), nullptr, nullptr, pos,
                                      s_pos0, s_stride, stats, pt, n_blocks, ps, out, n_b, n_h, n_kh, n_s, hd,
                                      scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool PAGED, bool SP = false>
int dispatch_mixed(const void* q, const void* k, const void* v, const void* pos, int s_pos0, int s_stride, Stats stats,
                   const void* pt, int n_blocks, int ps, void* out, int n_b, int n_h, int n_kh,
                   int n_s, int hd, float scale, int q_type, int kv_type, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  const int* t = static_cast<const int*>(pt);
  if (q_type == TYPE_BF16) {
    using B = __nv_bfloat16;
    return dispatch_kv<B, PAGED, SP>(static_cast<const B*>(q), k, v, kv_type, p, s_pos0, s_stride, stats, t,
                                 n_blocks, ps, static_cast<B*>(out), n_b, n_h, n_kh, n_s, hd,
                                 scale, s);
  }
  if (q_type == TYPE_F32)
    return dispatch_kv<float, PAGED, SP>(static_cast<const float*>(q), k, v, kv_type, p, s_pos0, s_stride, stats, t,
                                     n_blocks, ps, static_cast<float*>(out), n_b, n_h, n_kh, n_s,
                                     hd, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q [B, 1, H, hd], k/v [B, KH, S, hd] (bf16 when bf16 else f32), pos int32
// [B]; out [B, 1, H, hd] in q's type. hd 64 or 128, H / KH <= 32.
// Returns cudaGetLastError().
extern "C" int flash_decode(const void* q, const void* k, const void* v, const void* pos,
                            int s_pos0, void* out, int n_b, int n_h, int n_kh, int n_s, int hd,
                            float scale, int bf16, void* stream) {
  return dispatch<false, false>(q, k, v, nullptr, nullptr, pos, s_pos0, 1, Stats{}, nullptr, 0, 0, out, n_b,
                                n_h, n_kh, n_s, hd, scale, bf16, stream);
}

// q [B, 1, H, hd], k/v pages [P, KH, ps, hd], page_table int32 [B, n_blocks],
// pos int32 [B] (a lane at pos < 0 reads nothing and gets zeros); out as
// flash_decode's. ps divides 32 or is a multiple of 32.
extern "C" int paged_flash_decode(const void* q, const void* k_pages, const void* v_pages,
                                  const void* page_table, const void* pos, void* out, int n_b,
                                  int n_h, int n_kh, int n_blocks, int ps, int hd, float scale,
                                  int bf16, void* stream) {
  return dispatch<true, false>(q, k_pages, v_pages, nullptr, nullptr, pos, 0, 1, Stats{}, page_table,
                               n_blocks, ps, out, n_b, n_h, n_kh, n_blocks * ps, hd, scale, bf16,
                               stream);
}

// flash_decode over the int8 cache: k/v int8 [B, KH, S, hd] with f32 row
// scales k_scale/v_scale [B, KH, S, 1]; q and out bf16 when bf16 else f32.
extern "C" int flash_decode_q8(const void* q, const void* k, const void* k_scale, const void* v,
                               const void* v_scale, const void* pos, int s_pos0, void* out,
                               int n_b, int n_h, int n_kh, int n_s, int hd, float scale, int bf16,
                               void* stream) {
  return dispatch<false, true>(q, k, v, k_scale, v_scale, pos, s_pos0, 1, Stats{}, nullptr, 0, 0, out, n_b,
                               n_h, n_kh, n_s, hd, scale, bf16, stream);
}

// paged_flash_decode over an int8 pool: pages int8 [P, KH, ps, hd] with f32
// row scales [P, KH, ps, 1]; no row or scale at or past a lane's frontier is read.
extern "C" int paged_flash_decode_q8(const void* q, const void* k_pages, const void* k_scale,
                                     const void* v_pages, const void* v_scale,
                                     const void* page_table, const void* pos, void* out, int n_b,
                                     int n_h, int n_kh, int n_blocks, int ps, int hd, float scale,
                                     int bf16, void* stream) {
  return dispatch<true, true>(q, k_pages, v_pages, k_scale, v_scale, pos, 0, 1, Stats{}, page_table,
                              n_blocks, ps, out, n_b, n_h, n_kh, n_blocks * ps, hd, scale, bf16,
                              stream);
}

// flash_decode with q and the cache in their own float types (q_type
// TYPE_F32 or TYPE_BF16, out in q's; kv_type TYPE_F32, TYPE_BF16 or
// TYPE_F16): a float cache type unlike the model's (`--kv-dtype`).
extern "C" int flash_decode_mx(const void* q, const void* k, const void* v, const void* pos,
                               int s_pos0, void* out, int n_b, int n_h, int n_kh, int n_s, int hd,
                               float scale, int q_type, int kv_type, void* stream) {
  return dispatch_mixed<false>(q, k, v, pos, s_pos0, 1, Stats{}, nullptr, 0, 0, out, n_b, n_h, n_kh, n_s, hd,
                               scale, q_type, kv_type, stream);
}

// paged_flash_decode with q and the pool in their own float types.
extern "C" int paged_flash_decode_mx(const void* q, const void* k_pages, const void* v_pages,
                                     const void* page_table, const void* pos, void* out, int n_b,
                                     int n_h, int n_kh, int n_blocks, int ps, int hd, float scale,
                                     int q_type, int kv_type, void* stream) {
  return dispatch_mixed<true>(q, k_pages, v_pages, pos, 0, 1, Stats{}, page_table, n_blocks, ps, out, n_b,
                              n_h, n_kh, n_blocks * ps, hd, scale, q_type, kv_type, stream);
}

// The decode body emitting its state (the TPU kernel's emit_stats, surface
// flash_decode_stats): over one sequence shard of the cache [B, KH, S, hd]
// whose key row j sits at position s_pos0 + j * s_stride (sequence
// parallelism's cyclic layout: shard i of sp at s_pos0 i, stride sp), the
// unnormalized acc f32 [B, H, hd] (= [B, KH, G, 1, hd]) and the row max m
// and denominator l f32 [B, H]. The cluster's blocks merge their states as
// in flash_decode and rank 0 writes the merged state without dividing; a
// shard wholly in the query's future (the last visible row < 0) reads no
// row and gives m = -1e30, l = 0, acc = 0. q and the cache in their own
// float types (q_type, kv_type as in flash_decode_mx); out is not written.
extern "C" int flash_decode_stats(const void* q, const void* k, const void* v, const void* pos,
                                  int s_pos0, int s_stride, void* acc, void* m, void* l, int n_b,
                                  int n_h, int n_kh, int n_s, int hd, float scale, int q_type,
                                  int kv_type, void* stream) {
  Stats st;
  st.acc = static_cast<float*>(acc);
  st.m = static_cast<float*>(m);
  st.l = static_cast<float*>(l);
  return dispatch_mixed<false, true>(q, k, v, pos, s_pos0, s_stride, st, nullptr, 0, 0, nullptr, n_b,
                               n_h, n_kh, n_s, hd, scale, q_type, kv_type, stream);
}

// flash_decode_stats over the int8 cache: one cyclic shard of int8 values
// k/v [B, KH, S, hd] with f32 row scales k_scale/v_scale [B, KH, S, 1], key
// row j at position s_pos0 + j * s_stride; q bf16 when bf16 else f32. The
// int8 rows and scales stream as in flash_decode_q8, the state is written as
// in flash_decode_stats (the port's route: the JAX engine decodes its int8
// sp cache with dequant_kv and jnp stats).
extern "C" int flash_decode_stats_q8(const void* q, const void* k, const void* k_scale,
                                     const void* v, const void* v_scale, const void* pos,
                                     int s_pos0, int s_stride, void* acc, void* m, void* l,
                                     int n_b, int n_h, int n_kh, int n_s, int hd, float scale,
                                     int bf16, void* stream) {
  Stats st;
  st.acc = static_cast<float*>(acc);
  st.m = static_cast<float*>(m);
  st.l = static_cast<float*>(l);
  return dispatch<false, true, true>(q, k, v, k_scale, v_scale, pos, s_pos0, s_stride, st, nullptr,
                                     0, 0, nullptr, n_b, n_h, n_kh, n_s, hd, scale, bf16, stream);
}
