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
// One body for every pair of types (`flash_stats_tc_kernel`, wgmma from
// wgmma.cuh): q f32 or bf16, the cache f32, bf16, f16 or int8. A
// warpgroup's 64-row M tile packs the G query heads of one KV head over
// 64 / G consecutive positions (row r: head r / (64 / G), position
// r % (64 / G)), each row masked by its own position, so every K/V tile is
// staged once for all G heads; a block is two warpgroups over 2 * 64 / G
// positions sharing the tiles. Blocks run the latest query tiles (the longest
// frontiers) first. Per 64-key tile: S = Q K^T with K as B in shared memory
// (hd-contiguous rows, 128-byte swizzle); the f32 online softmax on S in
// registers, each row reduced over the four threads of a quad; then
// O += P V with V as an MN-major B operand (wgmma's transposed B: the same
// swizzled rows as K, no transposition).
//
// Every TPU kernel upcasts q, K and V to f32 and takes f32 dots
// (flash_attention.py _flash_stats_kernel). The tensor cores take bf16, so
// each operand enters as a sum of bf16 parts, each part the exact remainder
// of the ones before (x0 = bf16(x), x1 = bf16(x - x0), x2 = bf16(x - x0 -
// x1)), and the products of two parts, exact in f32, are issued into one
// f32 accumulator:
//
//   | type | bf16 parts that hold it exactly          |
//   | bf16, int8 | 1                                  |
//   | f16  | 2 (11 significand bits = 8 + 3)          |
//   | f32  | 3 (24 = 8 + 8 + 8; for |x| >= 2^-110)    |
//
// S sums q_i K_j over the part pairs with i + j <= 2 (scale >= 2^-16 of
// the leading product; part i is <= 2^-9i of its value); O sums P_i V_j
// over i + j <= 1, where P = hi + lo (hi = bf16(p), lo = bf16(p - hi),
// p - hi - lo <= 2^-18 p) and V takes at most its first two parts. Passes
// a key tile (bf16 products of the whole tile), and the largest term left
// out, relative to the product of the two values:
//
//   | q / cache  | QK^T passes | PV passes | largest term left out           |
//   | bf16/bf16  | 1 | 2 | p - hi - lo: 2^-18                             |
//   | bf16/int8  | 1 | 2 | 2^-18 (P)                                      |
//   | bf16/f16   | 2 | 3 | lo V1: 2^-18                                   |
//   | bf16/f32   | 3 | 3 | lo V1, hi V2: 2^-18                            |
//   | f32/bf16   | 3 | 2 | 2^-18 (P)                                      |
//   | f32/int8   | 3 | 2 | 2^-18 (P)                                      |
//   | f32/f16    | 5 | 3 | q2 K1: 2^-27 (S); 2^-18 (O)                    |
//   | f32/f32    | 6 | 3 | q1 K2, q2 K1: 2^-27 (S); 2^-18 (O)             |
//
// so the result is the TPU kernel's f32 arithmetic up to sum order and
// terms at or below 2^-18 of a product, the size of the bf16 body's P
// split. q's part 0 is held as A fragments in registers for the whole loop;
// f32 q's parts 1 and 2 are stored once in shared memory as K-major A tiles
// (wgmma reads them by descriptor), which keeps the registers of the bf16
// body. A bf16 cache is copied by cp.async straight into the swizzled tiles
// (a two-stage ring: tile j + 1's copy in flight during tile j's math).
// Any other cache type is copied in its own type into a raw stage of the
// ring, and both warpgroups convert it into its bf16 part tiles while the
// tensor cores run: tile j's V parts during S = Q K^T of tile j, tile j +
// 1's K parts during O += P V of tile j (tile 0's K ahead of the loop),
// with two barriers a tile. The cache's bytes stay its own (1, 2 or 4 B a
// value) and nothing is widened on the host. Shared memory at hd 128 (16
// KB a part tile of 64 rows): bf16 64 KB; int8 65 KB; f16 128 KB; f32 208
// KB; f32 q adds its four low-part tiles (64 KB) and, over an f32 cache,
// keeps one raw stage (a 32 KB K and a 32 KB V tile) instead of two: tile
// j + 1's copy starts once tile j's V is converted, and a third barrier a
// tile guards the stage.
//
// What holds it above its bound: the products of a tile and its softmax run
// one after the other in each warpgroup (no ping-pong between warpgroups),
// each extra pass is a whole wgmma of the tile, and at pos 0 the causal
// work is uneven across blocks (PERF.md).
//
// A second C entry, `flash_attention_stats_paged`, runs the same body over
// the paged pool [P, KH, ps, hd]: logical key row r of lane b is read from
// pool page page_table[b, r / ps] at page row r % ps (the template
// parameter PAGED; the page ids of each 32-row sub-tile are staged in
// shared memory ahead of its copy, and no row or page-table slot past the
// block's frontier is read), so an identity page table gives the slab
// entry's bits. It serves admission chunks that attend to a lane's adopted
// prefix pages; the JAX engine gathers those pages into a slab view instead
// (dllama_tpu/runtime/engine.py _paged_gather).
//
// The int8 KV cache (C entries `flash_attention_stats_q8` and
// `flash_attention_stats_paged_q8`) replaces the TPU kernel's QuantKV branch
// (_flash_stats_kernel quant_kv: int8 tiles and [bs, 1] f32 scale refs,
// dequantized in f32 on the tile). K/V arrive as int8 rows [.., S, hd] and
// one f32 scale a row [.., S, 1]: half the tile bytes of bf16, plus 4 B a
// row. The raw stage holds the int8 tiles and their 64 + 64 scales; K's row
// scale multiplies the score column after Q K^T, before the mask and the
// max, and V's row scale multiplies P's column before P is split into its
// hi and lo parts (l sums the unscaled p), so the result differs from
// `attention_stats` on the dequantized cache by where the scale multiplies
// and sum order only.
//
// A float cache type unlike q's (`--kv-dtype` f32, f16 or bf16 under either
// model dtype; C entries `flash_attention_stats_mx` and
// `flash_attention_stats_paged_mx`, q's and the cache's types as codes)
// runs the same body at that pair of types; `flash_attention_stats_plan`
// reports the passes the body issues for a pair.
//
// Sequence parallelism (C entry `flash_attention_stats_strided`, the TPU
// kernel's s_stride): the keys are a cyclic shard whose row j sits at
// position s_pos0 + j * s_stride. The body takes the stride as a runtime
// argument, read only by its instantiations with the template flag SP
// (the other entries compile without it, their code unchanged): the mask
// compares s_pos0 + key * s_stride with the query's position, and the
// frontier, the last visible row floor((p - s_pos0) / s_stride), bounds the
// key tiles read, so a shard in the block's future reads nothing. A dense
// cache takes q and the cache in their own types, as the `_mx` entries; an
// int8 cache (C entry `flash_attention_stats_strided_q8`, the TPU kernel's
// QuantKV branch under s_stride) the int8 instantiations with the flag set.

#include <type_traits>

#include "wgmma.cuh"

using namespace dllama;

namespace {

constexpr int PAGE_UNIT = 32;  // page sizes divide it or are multiples of it
constexpr int TC_WG = 2;       // warpgroups a block, sharing the K/V tiles
constexpr int TC_THREADS = 128 * TC_WG;
constexpr int TC_BN = 64;              // keys a tile: two 32-row sub-tiles of page ids
constexpr int TC_CHUNK = TC_BN * 128;  // bytes of 64 columns of a K or V tile

template <typename X> __host__ __device__ constexpr bool is_bf16() {
  return std::is_same<X, __nv_bfloat16>::value;
}
template <typename X> __host__ __device__ constexpr bool is_i8() {
  return std::is_same<X, int8_t>::value;
}

// the bf16 parts that hold a value of type X exactly (the table at the top)
template <typename X> __host__ __device__ constexpr int n_parts() {
  return std::is_same<X, float>::value ? 3 : std::is_same<X, __half>::value ? 2 : 1;
}
// V's parts in O += P V: P's lo part meets V's part 0 only, so at most two
template <typename KV> __host__ __device__ constexpr int v_parts() {
  return n_parts<KV>() > 1 ? 2 : 1;
}
// the part pairs (i, j) of q and K with i + j <= 2
template <typename T, typename KV> __host__ __device__ constexpr int qk_passes() {
  int n = 0;
  for (int i = 0; i < n_parts<T>(); ++i)
    for (int j = 0; j < n_parts<KV>(); ++j) n += i + j <= 2;
  return n;
}
template <typename KV> __host__ __device__ constexpr int pv_passes() { return 1 + v_parts<KV>(); }

// a bf16 tile of 64 rows: [HD / 64][64 rows][128 B] swizzled
template <int HD> __host__ __device__ constexpr int tc_tile_bytes() { return TC_BN * HD * 2; }
// a raw stage (any cache type but bf16): the K and V tiles [TC_BN][HD] in
// the cache's type, then (int8) their f32 row scales [TC_BN] each
template <typename KV, int HD> __host__ __device__ constexpr int raw_tile_bytes() {
  return TC_BN * HD * (int)sizeof(KV);
}
template <typename KV, int HD> __host__ __device__ constexpr int raw_stage_bytes() {
  return 2 * raw_tile_bytes<KV, HD>() + (is_i8<KV>() ? 2 * TC_BN * 4 : 0);
}
// raw stages in the ring: one where f32 q's low parts and an f32 cache's
// parts leave no room for two
template <typename T, typename KV> __host__ __device__ constexpr int raw_stages() {
  return n_parts<T>() > 1 && n_parts<KV>() > 2 ? 1 : 2;
}
// bf16 tiles: a bf16 cache's two stages of a K and a V tile, else the K and
// V part tiles; then f32 q's parts 1 and 2 of each warpgroup's 64 rows
template <typename KV> __host__ __device__ constexpr int kv_tiles() {
  return is_bf16<KV>() ? 4 : n_parts<KV>() + v_parts<KV>();
}
template <typename T> __host__ __device__ constexpr int q_tiles() {
  return TC_WG * (n_parts<T>() - 1);
}
template <typename T, typename KV, int HD> __host__ __device__ constexpr int tc_smem_bytes() {
  return (kv_tiles<KV>() + q_tiles<T>()) * tc_tile_bytes<HD>() +
         (is_bf16<KV>() ? 0 : raw_stages<T, KV>() * raw_stage_bytes<KV, HD>());
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

__device__ __forceinline__ float2 bf16x2_float2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// Eight values of a raw stage row (shared memory) as float: exact for every
// cache type
__device__ __forceinline__ void smem8(const int8_t* p, float (&x)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x[j] = static_cast<float>(static_cast<int8_t>(u.x >> (8 * j)));
    x[4 + j] = static_cast<float>(static_cast<int8_t>(u.y >> (8 * j)));
  }
}
__device__ __forceinline__ void smem8(const __half* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __half22float2(h[j]);
    x[2 * j] = f.x;
    x[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void smem8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// The first NP bf16 parts of eight values into NP part tiles (tile bytes
// apart) at byte offset off: part p is bf16 of what parts 0 .. p - 1 left
// (each subtraction exact in f32)
template <int NP, int TILE>
__device__ __forceinline__ void store_parts(float (&x)[8], uint8_t* dst, int off) {
  uint32_t w[NP][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      w[p][i] = pack_bf16(x[2 * i], x[2 * i + 1]);
      if (p + 1 < NP) {
        const float2 f = bf16x2_float2(w[p][i]);
        x[2 * i] -= f.x;
        x[2 * i + 1] -= f.y;
      }
    }
#pragma unroll
  for (int p = 0; p < NP; ++p)
    *reinterpret_cast<uint4*>(dst + p * TILE + off) =
        make_uint4(w[p][0], w[p][1], w[p][2], w[p][3]);
}

template <typename T, typename KV, int HD, bool PAGED, bool SP>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_stats_tc_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                      const KV* __restrict__ v, const float* __restrict__ k_scale,
                      const float* __restrict__ v_scale, const int* __restrict__ q_pos0,
                      int s_pos0, int s_stride, const int* __restrict__ pt, int n_blocks, int ps,
                      float* __restrict__ acc_out, float* __restrict__ m_out,
                      float* __restrict__ l_out, int n_t, int n_h, int n_kh, int n_s,
                      float scale) {
  constexpr bool Q8 = is_i8<KV>();     // the int8 KV cache
  constexpr bool RAW = !is_bf16<KV>();  // the cache converted from a raw stage
  constexpr int NQ = n_parts<T>(), NK = n_parts<KV>(), NV = v_parts<KV>();
  constexpr int STAGES = raw_stages<T, KV>();
  constexpr int TILE = tc_tile_bytes<HD>();
  constexpr int RAW_TILE = raw_tile_bytes<KV, HD>();
  constexpr int KS = HD / 16;                 // k16 steps of Q K^T
  constexpr int CH = HD / 8;                  // 16-byte chunks of a bf16 K/V row
  constexpr int RC = HD * (int)sizeof(KV) / 16;  // 16-byte chunks of a raw row
  extern __shared__ __align__(1024) uint8_t smem[];
  __shared__ int Pid[2][TC_BN];  // page ids of a tile (PAGED), by tile parity

  const int g_n = n_h / n_kh, per = 64 / g_n, block_rows = per * TC_WG;
  const int kh = blockIdx.x, b = blockIdx.y;
  const int t0 = (gridDim.z - 1 - blockIdx.z) * block_rows;  // the latest rows first
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int tq = lane & 3;
  // f32 q's parts 1 and 2 of this warpgroup's rows, then the raw stages
  uint8_t* const q_lo = smem + kv_tiles<KV>() * TILE + wg * (NQ - 1) * TILE;
  uint8_t* const raw0 = smem + (kv_tiles<KV>() + q_tiles<T>()) * TILE;

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
  // q's part 0 as A fragments for the whole loop: k16 step s holds columns
  // 16 s + 2 tq, +1 (f 0, 1: rows h) and + 8, + 9 (f 2, 3); f32 q's parts 1
  // and 2 at the same places of its K-major A tiles in shared memory
  uint32_t qa[KS][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const T* qr = q + ((size_t)(b * n_t + tr[h]) * n_h + kh * g_n + gr[h]) * HD + 2 * tq;
    const int row = 16 * warp + (lane >> 2) + 8 * h;
#pragma unroll
    for (int s = 0; s < KS; ++s)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if constexpr (NQ == 1) {
          qa[s][h + 2 * c] =
              real[h] ? __ldg(reinterpret_cast<const unsigned*>(qr + 16 * s + 8 * c)) : 0u;
        } else {
          float2 x = real[h] ? __ldg(reinterpret_cast<const float2*>(qr + 16 * s + 8 * c))
                             : make_float2(0.f, 0.f);
          uint32_t w = pack_bf16(x.x, x.y);
          qa[s][h + 2 * c] = w;
          const int col = 16 * s + 8 * c + 2 * tq;
          const int off = (col >> 6) * TC_CHUNK + sw128(row, (col & 63) >> 3) + (col & 7) * 2;
#pragma unroll
          for (int p = 1; p < NQ; ++p) {  // what the parts before left, exact in f32
            const float2 f = bf16x2_float2(w);
            x.x -= f.x;
            x.y -= f.y;
            w = pack_bf16(x.x, x.y);
            *reinterpret_cast<uint32_t*>(q_lo + (p - 1) * TILE + off) = w;
          }
        }
      }
  }

  // causal frontier of the block's last real row, in local key rows
  const int last_pos = q_pos0[b] + t0 + min(block_rows, n_t - t0) - 1;
  const int n_keys =
      max(0, min(n_s, (SP ? floor_div(last_pos - s_pos0, s_stride) : last_pos - s_pos0) + 1));
  const int n_tiles = (n_keys + TC_BN - 1) / TC_BN;
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
  // the raw stage of tile j
  auto raw_stage = [&](int j) { return raw0 + (j % STAGES) * raw_stage_bytes<KV, HD>(); };

  // page ids of tile j into Pid[j & 1]: a warp for each 32-row sub-tile
  auto stage_ids = [&](int j) {
    if (PAGED && tid < 64 && j < n_tiles)
      stage_page_ids(Pid[j & 1] + (tid & 32), pt_b, j * TC_BN + (tid & 32), n_keys, ps, tid & 31);
  };
  // the lane row r's offset in tile j's source (page table or slab); 0 past n_keys
  auto src_row = [&](int j, int r, int hd) -> size_t {
    const int s0 = j * TC_BN;
    if (s0 + r >= n_keys) return 0;
    return PAGED ? paged_row(Pid[j & 1] + (r & 32), s0 + (r & 32), r & 31, ps, kh, n_kh, hd)
                 : (size_t)(s0 + r) * hd;
  };
  // cp.async of tile j; rows at or past n_keys are zero-filled. bf16: into
  // stage j & 1's swizzled tiles; else the rows as they are (and the int8
  // scales) into its raw stage
  auto load_tile = [&](int j) {
    const int s0 = j * TC_BN;
    if constexpr (RAW) {
      uint8_t* st = raw_stage(j);
#pragma unroll
      for (int i = 0; i < TC_BN * RC / TC_THREADS; ++i) {
        const int e = tid + TC_THREADS * i, r = e / RC, c = e % RC;
        const size_t row = src_row(j, r, HD);
        const bool ok = s0 + r < n_keys;
        const int off = r * HD * (int)sizeof(KV) + c * 16;
        const uint8_t* ksrc = reinterpret_cast<const uint8_t*>(kb + row) + c * 16;
        const uint8_t* vsrc = reinterpret_cast<const uint8_t*>(vb + row) + c * 16;
        cp_async16(smem_addr(st + off), ksrc, ok);
        cp_async16(smem_addr(st + RAW_TILE + off), vsrc, ok);
      }
      if constexpr (Q8) {
        if (tid < 2 * TC_BN) {
          const int r = tid % TC_BN;
          cp_async4(smem_addr(st + 2 * RAW_TILE + 4 * tid),
                    (tid < TC_BN ? ksb : vsb) + src_row(j, r, 1), s0 + r < n_keys);
        }
      }
    } else {
      uint8_t* ks = smem + (j & 1) * 2 * TILE;
      uint8_t* vs = ks + TILE;
#pragma unroll
      for (int i = 0; i < TC_BN * CH / TC_THREADS; ++i) {
        const int e = tid + TC_THREADS * i, r = e / CH, c = e % CH;
        const bool ok = s0 + r < n_keys;
        const size_t row = src_row(j, r, HD);
        const int off = (c >> 3) * TC_CHUNK + sw128(r, c & 7);
        cp_async16(smem_addr(ks + off), kb + row + c * 8, ok);
        cp_async16(smem_addr(vs + off), vb + row + c * 8, ok);
      }
    }
  };
  // raw tile W (0: K, 1: V) of tile j into its NP bf16 part tiles, in the
  // swizzled layout of the bf16 copies
  auto convert = [&](int j, auto w) {
    if constexpr (RAW) {
      constexpr int W = decltype(w)::value, NP = W ? NV : NK;
      const KV* st = reinterpret_cast<const KV*>(raw_stage(j) + W * RAW_TILE);
      uint8_t* parts = smem + W * NK * TILE;
#pragma unroll
      for (int i = 0; i < TC_BN * CH / TC_THREADS; ++i) {
        const int e = tid + TC_THREADS * i, r = e / CH, c = e % CH;
        float x[8];
        smem8(st + r * HD + c * 8, x);
        store_parts<NP, TILE>(x, parts, (c >> 3) * TC_CHUNK + sw128(r, c & 7));
      }
    }
  };

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;

  constexpr auto K_TILE = std::integral_constant<int, 0>{};
  constexpr auto V_TILE = std::integral_constant<int, 1>{};
  stage_ids(0);
  stage_ids(1);
  __syncthreads();
  if (n_tiles > 0) load_tile(0);
  cp_async_commit();
  if constexpr (RAW) {  // tile 0's K parts ahead of the loop, tile 1's copy in flight
    if constexpr (STAGES == 2) {
      if (n_tiles > 1) load_tile(1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (n_tiles > 0) convert(0, K_TILE);
  }
  for (int j = 0; j < n_tiles; ++j) {
    if constexpr (!RAW) {
      if (j + 1 < n_tiles) load_tile(j + 1);
      cp_async_commit();
      cp_async_wait<1>();  // tile j's copy has landed
    }
    // the converted K parts of tile j (or the copied bf16 tiles), and f32 q's
    // low parts written before the loop, made visible to wgmma; V's parts
    // of tile j - 1 consumed
    fence_proxy_async();
    __syncthreads();
    stage_ids(j + 2);  // into the buffer tile j's copy read; used after a barrier below
    // the int8 cache's row scales stay in the raw stage
    const float* k_sc = reinterpret_cast<const float*>(raw_stage(j) + 2 * RAW_TILE);
    const float* v_sc = k_sc + TC_BN;
    const uint32_t ka = smem_addr(smem + (RAW ? 0 : (j & 1) * 2 * TILE));
    const uint32_t va = RAW ? ka + NK * TILE : ka + TILE;

    // S = sum of q_i K_j^T over i + j <= 2: k16 step st starts 32 bytes into
    // each swizzled row of its 64-column chunk, in K's tiles and q's alike
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kp = 0; kp < NK; ++kp)
#pragma unroll
      for (int st = 0; st < KS; ++st)
        wgmma_m64n64k16<0>(
            s, qa[st], wgmma_desc_sw128(ka + kp * TILE + (st >> 2) * TC_CHUNK + (st & 3) * 32));
#pragma unroll
    for (int qp = 1; qp < NQ; ++qp)
#pragma unroll
      for (int kp = 0; kp < NK && qp + kp <= 2; ++kp)
#pragma unroll
        for (int st = 0; st < KS; ++st) {
          const uint32_t step = (st >> 2) * TC_CHUNK + (st & 3) * 32;
          wgmma_m64n64k16_ss(s, wgmma_desc_sw128(smem_addr(q_lo + (qp - 1) * TILE) + step),
                             wgmma_desc_sw128(ka + kp * TILE + step));
        }
    wgmma_commit();
    if constexpr (RAW) {  // V's parts while S runs on the tensor cores
      convert(j, V_TILE);
      fence_proxy_async();
      if constexpr (STAGES == 1) {
        __syncthreads();  // the raw stage read by both warpgroups
        if (j + 1 < n_tiles) load_tile(j + 1);
        cp_async_commit();
      }
    }
    wgmma_wait<0>();
    fence_regs(s);

    // the online softmax with the JAX kernel's guards (common.cuh
    // online_softmax): s[i] is row h = (i >> 1) & 1, key 8 (i >> 2) + 2 tq + (i & 1)
    const int key0 = j * TC_BN + 2 * tq;
    float mx[2] = {NEG_INF, NEG_INF}, sum[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1, key = key0 + 8 * (i >> 2) + (i & 1);
      float x = s[i];
      if constexpr (Q8) x *= k_sc[key - j * TC_BN];  // K's row scale on its score column
      s[i] = key < n_s && s_pos0 + (SP ? key * s_stride : key) <= qpos[h] ? x * scale : NEG_INF;
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

    // P as A fragments in two bf16 parts: p = hi + lo + O(2^-18 p), no new
    // rounding; the int8 cache's V row scale goes on P's column here, after
    // l took the unscaled sum
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        float x0 = s[8 * kk + 2 * f], x1 = s[8 * kk + 2 * f + 1];
        if constexpr (Q8) {
          const float* w = v_sc + 8 * ((8 * kk + 2 * f) >> 2) + 2 * tq;
          x0 *= w[0];
          x1 *= w[1];
        }
        ph[kk][f] = pack_bf16(x0, x1);
        const float2 hi = bf16x2_float2(ph[kk][f]);
        pl[kk][f] = pack_bf16(x0 - hi.x, x1 - hi.y);
      }

    if constexpr (RAW) {
      // V's parts in place for both warpgroups, both past S (K's parts
      // free), tile j + 1's raw copy landed and tile j's read
      cp_async_wait<0>();
      __syncthreads();
      if constexpr (STAGES == 2) {
        if (j + 2 < n_tiles) load_tile(j + 2);
        cp_async_commit();
      }
    }

    // O += hi V0 + lo V0 (+ hi V1): k16 step kk is key rows 16 kk .., 2048
    // bytes into each part tile
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = wgmma_desc_sw128(va + kk * 2048, TC_CHUNK);
      wgmma_pv<HD>(o, ph[kk], dv);
      wgmma_pv<HD>(o, pl[kk], dv);
      if constexpr (NV > 1)
        wgmma_pv<HD>(o, ph[kk], wgmma_desc_sw128(va + TILE + kk * 2048, TC_CHUNK));
    }
    wgmma_commit();
    if constexpr (RAW) {  // tile j + 1's K parts while P V runs on the tensor cores
      if (j + 1 < n_tiles) convert(j + 1, K_TILE);
    }
    wgmma_wait<0>();
    fence_regs(o);
    if constexpr (!RAW) __syncthreads();  // the tiles consumed, Pid[j & 1] staged
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

template <typename T, typename KV, int HD, bool PAGED, bool SP>
void launch_hd(const T* q, const KV* k, const KV* v, const float* ksc, const float* vsc,
               const int* q_pos0, int s_pos0, int s_stride, const int* pt, int n_blocks, int ps,
               float* acc, float* m, float* l, int n_b, int n_t, int n_h, int n_kh, int n_s,
               float scale, cudaStream_t s) {
  constexpr int smem = tc_smem_bytes<T, KV, HD>();
  static_assert(smem + 2 * TC_BN * 4 <= 232448, "more shared memory than a block may take");
  cudaFuncSetAttribute(flash_stats_tc_kernel<T, KV, HD, PAGED, SP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int rows = 64 / (n_h / n_kh) * TC_WG;  // query rows a block
  const dim3 grid(n_kh, n_b, (n_t + rows - 1) / rows);
  flash_stats_tc_kernel<T, KV, HD, PAGED, SP><<<grid, TC_THREADS, smem, s>>>(
      q, k, v, ksc, vsc, q_pos0, s_pos0, s_stride, pt, n_blocks, ps, acc, m, l, n_t, n_h, n_kh,
      n_s, scale);
}

template <typename T, typename KV, bool PAGED, bool SP = false>
int launch(const T* q, const KV* k, const KV* v, const float* ksc, const float* vsc,
           const int* q_pos0, int s_pos0, int s_stride, const int* pt, int n_blocks, int ps, float* acc,
           float* m, float* l, int n_b, int n_t, int n_h, int n_kh, int n_s, int hd, float scale,
           cudaStream_t s) {
  if (n_h % n_kh != 0 || n_h / n_kh > 32 || s_stride < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (PAGED && (ps < 1 || (ps < PAGE_UNIT ? PAGE_UNIT % ps : ps % PAGE_UNIT))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (hd == 128) {
    launch_hd<T, KV, 128, PAGED, SP>(q, k, v, ksc, vsc, q_pos0, s_pos0, s_stride, pt, n_blocks, ps, acc, m,
                                 l, n_b, n_t, n_h, n_kh, n_s, scale, s);
  } else if (hd == 64) {
    launch_hd<T, KV, 64, PAGED, SP>(q, k, v, ksc, vsc, q_pos0, s_pos0, s_stride, pt, n_blocks, ps, acc, m, l,
                                n_b, n_t, n_h, n_kh, n_s, scale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Q8: k and v are the int8 cache's values, ksc and vsc its f32 row scales
// (the cache's shape with a last dim of 1); else k and v are in q's type
template <bool PAGED, bool Q8, bool SP = false>
int dispatch(const void* q, const void* k, const void* v, const void* ksc, const void* vsc,
             const void* q_pos0, int s_pos0, int s_stride, const void* pt, int n_blocks, int ps, void* acc,
             void* m, void* l, int n_b, int n_t, int n_h, int n_kh, int n_s, int hd, float scale,
             int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pos = static_cast<const int*>(q_pos0);
  const int* t = static_cast<const int*>(pt);
  const float* ks = static_cast<const float*>(ksc);
  const float* vs = static_cast<const float*>(vsc);
  float* a = static_cast<float*>(acc);
  float* mm = static_cast<float*>(m);
  float* ll = static_cast<float*>(l);
  if (bf16) {
    using B = __nv_bfloat16;
    using KV = typename std::conditional<Q8, int8_t, B>::type;
    return launch<B, KV, PAGED, SP>(static_cast<const B*>(q), static_cast<const KV*>(k),
                                    static_cast<const KV*>(v), ks, vs, pos, s_pos0, s_stride, t,
                                    n_blocks, ps, a, mm, ll, n_b, n_t, n_h, n_kh, n_s, hd, scale, s);
  }
  using KV = typename std::conditional<Q8, int8_t, float>::type;
  return launch<float, KV, PAGED, SP>(static_cast<const float*>(q), static_cast<const KV*>(k),
                                  static_cast<const KV*>(v), ks, vs, pos, s_pos0, s_stride, t, n_blocks,
                                  ps, a, mm, ll, n_b, n_t, n_h, n_kh, n_s, hd, scale, s);
}

// The mixed-type entries: q in q_type (TYPE_F32 or TYPE_BF16), k and v in
// kv_type (TYPE_F32, TYPE_BF16 or TYPE_F16), each read in its own type
template <typename T, bool PAGED, bool SP>
int dispatch_kv(const T* q, const void* k, const void* v, int kv_type, const int* q_pos0,
                int s_pos0, int s_stride, const int* pt, int n_blocks, int ps, float* acc, float* m, float* l,
                int n_b, int n_t, int n_h, int n_kh, int n_s, int hd, float scale,
                cudaStream_t s) {
  switch (kv_type) {
    case TYPE_F32:
      return launch<T, float, PAGED, SP>(q, static_cast<const float*>(k),
                                     static_cast<const float*>(v), nullptr, nullptr, q_pos0,
                                     s_pos0, s_stride, pt, n_blocks, ps, acc, m, l, n_b, n_t, n_h, n_kh,
                                     n_s, hd, scale, s);
    case TYPE_BF16:
      return launch<T, __nv_bfloat16, PAGED, SP>(q, static_cast<const __nv_bfloat16*>(k),
                                             static_cast<const __nv_bfloat16*>(v), nullptr,
                                             nullptr, q_pos0, s_pos0, s_stride, pt, n_blocks, ps, acc, m, l,
                                             n_b, n_t, n_h, n_kh, n_s, hd, scale, s);
    case TYPE_F16:
      return launch<T, __half, PAGED, SP>(q, static_cast<const __half*>(k),
                                      static_cast<const __half*>(v), nullptr, nullptr, q_pos0,
                                      s_pos0, s_stride, pt, n_blocks, ps, acc, m, l, n_b, n_t, n_h, n_kh,
                                      n_s, hd, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool PAGED, bool SP = false>
int dispatch_mixed(const void* q, const void* k, const void* v, const void* q_pos0, int s_pos0, int s_stride,
                   const void* pt, int n_blocks, int ps, void* acc, void* m, void* l, int n_b,
                   int n_t, int n_h, int n_kh, int n_s, int hd, float scale, int q_type,
                   int kv_type, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pos = static_cast<const int*>(q_pos0);
  const int* t = static_cast<const int*>(pt);
  float* a = static_cast<float*>(acc);
  float* mm = static_cast<float*>(m);
  float* ll = static_cast<float*>(l);
  if (q_type == TYPE_BF16)
    return dispatch_kv<__nv_bfloat16, PAGED, SP>(static_cast<const __nv_bfloat16*>(q), k, v, kv_type,
                                             pos, s_pos0, s_stride, t, n_blocks, ps, a, mm, ll, n_b, n_t,
                                             n_h, n_kh, n_s, hd, scale, s);
  if (q_type == TYPE_F32)
    return dispatch_kv<float, PAGED, SP>(static_cast<const float*>(q), k, v, kv_type, pos, s_pos0, s_stride, t,
                                     n_blocks, ps, a, mm, ll, n_b, n_t, n_h, n_kh, n_s, hd, scale,
                                     s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the bf16 wgmma passes a key tile for a pair of types (the table at the top)
template <typename T> int plan_kv(int kv_type) {
  switch (kv_type) {
    case TYPE_F32: return qk_passes<T, float>() * 16 + pv_passes<float>();
    case TYPE_BF16: return qk_passes<T, __nv_bfloat16>() * 16 + pv_passes<__nv_bfloat16>();
    case TYPE_F16: return qk_passes<T, __half>() * 16 + pv_passes<__half>();
    case TYPE_I8: return qk_passes<T, int8_t>() * 16 + pv_passes<int8_t>();
    default: return -1;
  }
}

}  // namespace

// q [B, T, H, hd], k/v [B, KH, S, hd] (bf16 when bf16 else f32), q_pos0
// int32 [B]; outputs f32 acc [B, H, T, hd] (= [B, KH, G, T, hd]), m and l
// [B, H, T]. hd must be 64 or 128. Returns cudaGetLastError().
extern "C" int flash_attention_stats(const void* q, const void* k, const void* v,
                                     const void* q_pos0, int s_pos0, void* acc, void* m,
                                     void* l, int n_b, int n_t, int n_h, int n_kh, int n_s,
                                     int hd, float scale, int bf16, void* stream) {
  return dispatch<false, false>(q, k, v, nullptr, nullptr, q_pos0, s_pos0, 1, nullptr, 0, 0, acc, m,
                                l, n_b, n_t, n_h, n_kh, n_s, hd, scale, bf16, stream);
}

// The same over k/v pages [P, KH, ps, hd] read through page_table int32
// [B, n_blocks] (keys at logical rows 0 .. n_blocks * ps - 1, s_pos0 0); ps
// divides 32 or is a multiple of 32.
extern "C" int flash_attention_stats_paged(const void* q, const void* k_pages,
                                           const void* v_pages, const void* page_table,
                                           const void* q_pos0, void* acc, void* m, void* l,
                                           int n_b, int n_t, int n_h, int n_kh, int n_blocks,
                                           int ps, int hd, float scale, int bf16, void* stream) {
  return dispatch<true, false>(q, k_pages, v_pages, nullptr, nullptr, q_pos0, 0, 1, page_table,
                               n_blocks, ps, acc, m, l, n_b, n_t, n_h, n_kh, n_blocks * ps, hd,
                               scale, bf16, stream);
}

// flash_attention_stats over the int8 cache: k/v int8 [B, KH, S, hd] with
// f32 row scales k_scale/v_scale [B, KH, S, 1]; q bf16 when bf16 else f32.
extern "C" int flash_attention_stats_q8(const void* q, const void* k, const void* k_scale,
                                        const void* v, const void* v_scale, const void* q_pos0,
                                        int s_pos0, void* acc, void* m, void* l, int n_b,
                                        int n_t, int n_h, int n_kh, int n_s, int hd, float scale,
                                        int bf16, void* stream) {
  return dispatch<false, true>(q, k, v, k_scale, v_scale, q_pos0, s_pos0, 1, nullptr, 0, 0, acc, m,
                               l, n_b, n_t, n_h, n_kh, n_s, hd, scale, bf16, stream);
}

// flash_attention_stats_paged over an int8 pool: pages int8 [P, KH, ps, hd]
// with f32 row scales [P, KH, ps, 1].
extern "C" int flash_attention_stats_paged_q8(const void* q, const void* k_pages,
                                              const void* k_scale, const void* v_pages,
                                              const void* v_scale, const void* page_table,
                                              const void* q_pos0, void* acc, void* m, void* l,
                                              int n_b, int n_t, int n_h, int n_kh, int n_blocks,
                                              int ps, int hd, float scale, int bf16,
                                              void* stream) {
  return dispatch<true, true>(q, k_pages, v_pages, k_scale, v_scale, q_pos0, 0, 1, page_table,
                              n_blocks, ps, acc, m, l, n_b, n_t, n_h, n_kh, n_blocks * ps, hd,
                              scale, bf16, stream);
}

// flash_attention_stats with q and the cache in their own float types
// (q_type TYPE_F32 or TYPE_BF16; kv_type TYPE_F32, TYPE_BF16 or TYPE_F16):
// a float cache type unlike the model's (`--kv-dtype`), on the one body.
extern "C" int flash_attention_stats_mx(const void* q, const void* k, const void* v,
                                        const void* q_pos0, int s_pos0, void* acc, void* m,
                                        void* l, int n_b, int n_t, int n_h, int n_kh, int n_s,
                                        int hd, float scale, int q_type, int kv_type,
                                        void* stream) {
  return dispatch_mixed<false>(q, k, v, q_pos0, s_pos0, 1, nullptr, 0, 0, acc, m, l, n_b, n_t, n_h,
                               n_kh, n_s, hd, scale, q_type, kv_type, stream);
}

// flash_attention_stats_paged with q and the pool in their own float types.
extern "C" int flash_attention_stats_paged_mx(const void* q, const void* k_pages,
                                              const void* v_pages, const void* page_table,
                                              const void* q_pos0, void* acc, void* m, void* l,
                                              int n_b, int n_t, int n_h, int n_kh, int n_blocks,
                                              int ps, int hd, float scale, int q_type,
                                              int kv_type, void* stream) {
  return dispatch_mixed<true>(q, k_pages, v_pages, q_pos0, 0, 1, page_table, n_blocks, ps, acc, m, l,
                              n_b, n_t, n_h, n_kh, n_blocks * ps, hd, scale, q_type, kv_type,
                              stream);
}

// flash_attention_stats over a strided sequence shard: key row j sits at
// position s_pos0 + j * s_stride (the cyclic layout of sequence
// parallelism, where shard i of sp holds positions i, i + sp, ...), q and
// the cache in their own float types as in flash_attention_stats_mx. The
// causal mask, the frontier (the last visible row (p - s_pos0) / s_stride)
// and the skip of key tiles past it follow the stride.
extern "C" int flash_attention_stats_strided(const void* q, const void* k, const void* v,
                                             const void* q_pos0, int s_pos0, int s_stride,
                                             void* acc, void* m, void* l, int n_b, int n_t,
                                             int n_h, int n_kh, int n_s, int hd, float scale,
                                             int q_type, int kv_type, void* stream) {
  return dispatch_mixed<false, true>(q, k, v, q_pos0, s_pos0, s_stride, nullptr, 0, 0, acc, m, l, n_b,
                               n_t, n_h, n_kh, n_s, hd, scale, q_type, kv_type, stream);
}

// flash_attention_stats_strided over the int8 cache (the TPU kernel's QuantKV
// branch with s_stride): k/v int8 [B, KH, S, hd] with f32 row scales
// k_scale/v_scale [B, KH, S, 1], key row j at position s_pos0 + j * s_stride;
// q bf16 when bf16 else f32. The int8 tiles and their scales go through the
// bodies of flash_attention_stats_q8, the mask, the frontier and the tile skip
// through those of flash_attention_stats_strided.
extern "C" int flash_attention_stats_strided_q8(const void* q, const void* k, const void* k_scale,
                                                const void* v, const void* v_scale,
                                                const void* q_pos0, int s_pos0, int s_stride,
                                                void* acc, void* m, void* l, int n_b, int n_t,
                                                int n_h, int n_kh, int n_s, int hd, float scale,
                                                int bf16, void* stream) {
  return dispatch<false, true, true>(q, k, v, k_scale, v_scale, q_pos0, s_pos0, s_stride, nullptr,
                                     0, 0, acc, m, l, n_b, n_t, n_h, n_kh, n_s, hd, scale, bf16,
                                     stream);
}

// The passes the body issues a key tile for q in q_type (TYPE_F32 or
// TYPE_BF16) over a cache in kv_type (TYPE_F32, TYPE_BF16, TYPE_F16 or
// TYPE_I8): QK^T passes * 16 + PV passes, each a bf16 wgmma of the whole
// tile; -1 for a pair no entry takes. Launches nothing.
extern "C" int flash_attention_stats_plan(int q_type, int kv_type) {
  if (q_type == TYPE_BF16) return plan_kv<__nv_bfloat16>(kv_type);
  if (q_type == TYPE_F32) return plan_kv<float>(kv_type);
  return -1;
}
