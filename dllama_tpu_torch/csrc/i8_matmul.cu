// Grouped-int8 matrix product for Hopper (sm_90a), weight_format q40i8.
//
// Replaces the TPU kernel dllama_tpu/ops/int8_matmul.py i8matmul_2d
// (_i8mm_kernel): out[m, n] = sum_g sx[m, g] * s[n, g] * idot[m, g, n], with
// idot the exact int32 dot of group g (G inputs) of the int8 activations
// xq [m, k] and weights q [n, k]. Each group's dot is exact; it is scaled
// once per (row, group, column) by sx * s, and the groups are summed in
// f32, as the TPU kernel does. The plain version
// (ops/int8_matmul.i8matmul_2d_ref) forms the same scaled group sums and
// adds them in group order; both paths here do too (the product is rounded
// on its own, __fmul_rn, not fused into the add), so the kernel gives the
// plain version's bits. That matters: the activation quantization that
// feeds the next layer's matmuls is discontinuous, so any difference in a
// layer's output can flip its rounding and grow through the layers.
//
// Layout: the .m file's rows, q int8 [n, k] and s f32 [n, k / G]
// (1 + 4 / G B per weight); xq int8 [m, k] and sx f32 [m, k / G] come from
// ops/int8_matmul.quantize_acts (torch ops, outside the kernel, as in JAX).
//
// Bound on an H100: decode (m = 1) reads every weight byte once for 2
// integer operations a weight, so it is bound by bytes (over 3.35 TB/s).
// The GEMV (m <= 8, `i8_gemv_kernel`) runs mma.sync m16n8k32 s8: 16 weight
// rows are A, the <= 8 x rows the N = 8 columns (rows past m are zero and
// never stored), so the work a weight byte is the same at m = 8 as at 1. A
// group's int32 dot is exact in any order, so the k slots of a lane may take
// any k, the same map for A and B. k is cut into items (16 rows by 4 RUN
// bytes inside one group: 512 bytes a row at G 512, 256 at G 256); each warp
// copies its item, and the m x rows at the same k, into its stage in shared
// memory by cp.async, 32 lanes on whole 128-byte lines, then reads its
// fragments from there (a quad's reads of 8 rows on distinct banks). Loading
// the fragments straight into registers (a quad reading 64 bytes of a row a
// load, 16 rows a warp) ran 20% slower at w1, and lane runs of 128
// contiguous bytes (half a sector a load) at half the speed (PERF.md). The
// items of a 16-row tile are split over a block's warps in rounds and, where
// the tiles are fewer than the SMs (n = 512, 1024), over a cluster of up to
// 8 blocks, so that every SM has loads in flight. Each item's int32 sums,
// and its group's scales (loaded once a group, with its bytes), go to rank
// 0's shared memory; one warp adds each group's parts in int32, scales the
// sum once and adds the terms from 0 in group order, as the plain version
// does. No atomics, no scratch in device memory: the plain version's bits on
// every row, repeated from run to run. What holds it near 70% of its bound
// at w1 (0.0254 ms with a clean L2, PERF.md): a fixed ~8 us a launch that
// the narrow weights show (n = 512 and 1024 take 0.008-0.011 ms for 1-4 MB);
// the classifier's 526 MB run at 3.0 TB/s. Walking tiles from resident
// blocks, or copying the next item while this one's mmas run, was slower
// (the warps' barriers each round).
//
// Prefill (m > 8; 512 rows a chunk) does 2m integer operations a weight
// byte, far above the ridge, so it is bound by operations: 1,979 TOP/s on
// the int8 tensor cores, which only wgmma reaches (the SIMT __dp4a tile it
// replaced ran at ~74 TOP/s). The tile (`i8_wgmma_kernel`) runs
// wgmma m64n128k32 s32.s8.s8 with both operands in shared memory: xq rows
// as A and q rows as B are both k-contiguous, the one layout wgmma takes
// for 8-bit types, in the 128-byte swizzle (a k32 step is 32 bytes, as a
// bf16 k16 step, so the descriptors advance as the bf16 tiles' do). A block
// is 128 x rows by 128 weight rows: a producer warpgroup, whose one thread
// keeps a 4-stage ring of TMA copies in flight (2-D tensor maps encoded on
// the host, 128 k-bytes a box, rows past m or n zero-filled, completion on
// mbarriers), and two consumer warpgroups of 64 x rows each. Every G / 32
// k32 steps a consumer drains its wgmma pipe and scales its exact int32
// sums into the f32 sums (the product sx * s first, the term rounded on its
// own, the groups added in order, from staged scales in shared memory); the
// next group's first wgmma overwrites the int32 sums (scale-d 0). The
// blocks that share a weight tile run next to each other, so each weight
// byte comes from device memory once. What holds it at ~5x the operations
// bound and ~1.6x torch._int_mm at m = 512 (PERF.md): the group flush,
// half the time (its 64 int-to-float conversions a thread run at 16 a
// clock an SM, and the warpgroup's wgmma pipe drains for it), and a
// wgmma rate under peak without it; 448 tiles at n = 14336 make 3.4
// waves. setmaxnreg (the producer gives its registers to the consumers)
// removed the consumers' spills; 6 stages, staggered warpgroups and
// clusters sharing the weight tile by TMA multicast did not help.

#include <cooperative_groups.h>

#include "wgmma.cuh"

using namespace dllama;
namespace cg = cooperative_groups;

namespace {

// ---- the GEMV (m <= 8) on mma.sync m16n8k32 s8 (see the note at the top) ----

constexpr int NUM_SMS = 132;             // H100 SXM: the plan's sizes
constexpr int GEMV_MAX_WARPS = 16;       // warps a block
constexpr int GEMV_NW = 32;              // items a round of a cluster, at most
constexpr int GEMV_MIN_ITEMS = NUM_SMS * 8;  // fewer items a launch: shorter runs, more items
constexpr int GEMV_STAGE_BYTES = 48 * 1024;  // a block's stages of its warps' items, at most

// One warp's item: 16 weight rows by IB = 4 RUN bytes of k inside one
// group, and the m x rows at the same k, staged in shared memory (row r at r
// IB, weight rows first, its 16-byte chunk c at c ^ (r % 8) when a row has 8
// chunks or more, so that the quads' reads of 8 rows fall on distinct
// banks). Lane (g, t) reads its pieces v of VB bytes at (4 v + t) VB of
// weight rows g and g + 8 and x row g (a quad reads 4 VB contiguous bytes),
// and each 8 bytes of them are its k slots of one k32 step: any map of k to
// slots gives the same exact sums if A and B share it.
template <int RUN>
struct Item {
  static constexpr int IB = 4 * RUN, CH = IB / 16, VB = RUN >= 16 ? 16 : 8, NV = RUN / VB;
  __device__ static __forceinline__ int at(int r, int b) {  // staged byte b of row r
    const int sw = CH >= 8 ? (r & 7) : 0;
    return r * IB + ((((b >> 4) ^ sw)) << 4) + (b & 15);
  }
  // cp.async of the item's 16 weight rows (rows past n read row n - 1) and m
  // x rows: each copy of the warp moves whole 128-byte lines (32 lanes on 1,
  // 2 or 4 rows; fewer bytes for RUN < 32), which asks the memory for a line
  // once where 16 rows' 64-byte pieces a load ask twice
  __device__ static __forceinline__ void copy(const int8_t* q, const int8_t* xq, int k, int m,
                                              int r0, int n, size_t off, uint8_t* ws, int lane) {
    constexpr int RPI = 32 / CH;  // rows a copy
#pragma unroll
    for (int i = 0; i < 16 / RPI; ++i) {
      const int r = RPI * i + lane / CH, ch = lane % CH;
      const int8_t* src = q + (size_t)min(r0 + r, n - 1) * k + off + ch * 16;
      cp_async16(smem_addr(ws + at(r, ch * 16)), src, true);
    }
    for (int i = lane; i < m * CH; i += 32) {
      const int r = i / CH, ch = i % CH;
      cp_async16(smem_addr(ws + at(16 + r, ch * 16)), xq + (size_t)r * k + off + ch * 16, true);
    }
  }
  // the exact int32 dots of the staged item, once its copies have landed,
  // and x row g (zero if g >= m)
  __device__ static __forceinline__ void dot(const uint8_t* ws, bool has_x, int g, int t,
                                             int (&c)[4]) {
    cp_async_wait<0>();
    __syncwarp();
    if constexpr (VB == 16) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int b = (4 * v + t) * VB;
        const uint4 wa = *reinterpret_cast<const uint4*>(ws + at(g, b));
        const uint4 wb = *reinterpret_cast<const uint4*>(ws + at(g + 8, b));
        const uint4 xv = has_x ? *reinterpret_cast<const uint4*>(ws + at(16 + g, b))
                               : make_uint4(0, 0, 0, 0);
        const uint32_t a0[4] = {wa.x, wb.x, wa.y, wb.y};
        mma_s8(c, a0, xv.x, xv.y);
        const uint32_t a1[4] = {wa.z, wb.z, wa.w, wb.w};
        mma_s8(c, a1, xv.z, xv.w);
      }
    } else {  // RUN 8 (a group of an odd number of 32s): one k32 step
      const uint2 wa = *reinterpret_cast<const uint2*>(ws + at(g, t * 8));
      const uint2 wb = *reinterpret_cast<const uint2*>(ws + at(g + 8, t * 8));
      const uint2 xv = has_x ? *reinterpret_cast<const uint2*>(ws + at(16 + g, t * 8))
                             : make_uint2(0, 0);
      const uint32_t a[4] = {wa.x, wb.x, wa.y, wb.y};
      mma_s8(c, a, xv.x, xv.y);
    }
  }
};

// out [m <= 8, n] f32: a cluster of cs blocks (blockIdx.x = tile * cs +
// rank) takes weight rows 16 tile .. (mma's M; the x rows are its N = 8).
// k is cut into items of 4 RUN bytes, `parts` a group, taken in rounds of
// cs * ks items, one a warp (a group's parts may span rounds). Each warp
// copies its item of the round into its stage, and puts its exact int32
// sums (and, for a group's first item, the group's 16 weight and 8 x
// scales, loaded with its bytes) into its slot of rank 0's shared memory;
// after the cluster's barrier, warp 0 of rank 0 walks the round's items in
// order, adds a group's parts in int32 (carried across rounds), scales the
// sum once (__fmul_rn of the sum and sx * s) and adds the term to its sums
// from 0 in group order: i8matmul_2d_ref's bits. Two buffers of the round's
// sums: the next round fills one while warp 0 reads the other.
template <int RUN>
__global__ void __launch_bounds__(GEMV_MAX_WARPS * 32)
i8_gemv_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
               const int8_t* __restrict__ q, const float* __restrict__ s,
               float* __restrict__ out, int m, int n, int k, int group) {
  using It = Item<RUN>;
  // shared memory: the round's sums, part [2][nw][32], and group scales, scl
  // [2][nw][24] (16 weight rows, then 8 x rows), both used at rank 0 only;
  // then a stage of (16 + m) x IB bytes a warp
  extern __shared__ __align__(16) uint8_t gemv_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = cluster.num_blocks(), rank = cluster.block_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ks = blockDim.x >> 5, nw = cs * ks, gw = rank * ks + warp;
  int4* part = reinterpret_cast<int4*>(gemv_smem);
  float* scl = reinterpret_cast<float*>(part + 2 * nw * 32);
  uint8_t* ws = reinterpret_cast<uint8_t*>(scl + 2 * nw * 24) + warp * (16 + m) * It::IB;
  const int r0 = blockIdx.x / cs * 16, ng = k / group, parts = group / It::IB, ni = ng * parts;
  const int rounds = (ni + nw - 1) / nw;
  const bool has_x = g < m;
  int4* rpart = cluster.map_shared_rank(part, 0);
  float* rscl = cluster.map_shared_rank(scl, 0);
  // warp 0 of rank 0: the sums, and the open group's int32 parts, scales
  // and next part
  float acc[4] = {0.f, 0.f, 0.f, 0.f}, prod[4] = {0.f, 0.f, 0.f, 0.f};
  int v[4] = {0, 0, 0, 0}, p = 0;

  for (int round = 0; round < rounds; ++round) {
    const int it = round * nw + gw, buf = round & 1;
    if (it < ni) {
      It::copy(q, xq, k, m, r0, n, (size_t)it * It::IB, ws, lane);
      cp_async_commit();
      float sa = 0.f, sb = 0.f, sx0 = 0.f, sx1 = 0.f;
      const bool first = it % parts == 0;
      if (first) {  // the group's scales, loaded with its bytes
        const int gi = it / parts;
        if (t == 0) {
          sa = __ldg(s + (size_t)min(r0 + g, n - 1) * ng + gi);
          sb = __ldg(s + (size_t)min(r0 + g + 8, n - 1) * ng + gi);
        }
        if (g == 0) {
          if (2 * t < m) sx0 = __ldg(sx + (size_t)(2 * t) * ng + gi);
          if (2 * t + 1 < m) sx1 = __ldg(sx + (size_t)(2 * t + 1) * ng + gi);
        }
      }
      int c[4] = {0, 0, 0, 0};
      It::dot(ws, has_x, g, t, c);
      __syncwarp();  // the stage is read: the next round copies into it
      rpart[(buf * nw + gw) * 32 + lane] = make_int4(c[0], c[1], c[2], c[3]);
      if (first) {
        float* sc = rscl + (buf * nw + gw) * 24;
        if (t == 0) {
          sc[g] = sa;
          sc[g + 8] = sb;
        }
        if (g == 0) {
          sc[16 + 2 * t] = sx0;
          sc[17 + 2 * t] = sx1;
        }
      }
    }
    if (cs > 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
    if (rank == 0 && warp == 0) {
      // c[i]: weight row r0 + g + 8 (i / 2), x row 2 t + i % 2
      const int n_items = min(ni - round * nw, nw);
      for (int j = 0; j < n_items; ++j) {
        const int4 c = part[(buf * nw + j) * 32 + lane];
        if (p == 0) {  // a group's first part: its scales
          const float* sc = scl + (buf * nw + j) * 24;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            prod[i] = __fmul_rn(sc[16 + 2 * t + (i & 1)], sc[g + 8 * (i >> 1)]);
          v[0] = v[1] = v[2] = v[3] = 0;
        }
        v[0] += c.x;
        v[1] += c.y;
        v[2] += c.z;
        v[3] += c.w;
        if (++p == parts) {
          p = 0;
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn((float)v[i], prod[i]));
        }
      }
    }
  }
  if (rank == 0 && warp == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + g + 8 * (i >> 1), xrow = 2 * t + (i & 1);
      if (row < n && xrow < m) out[(size_t)xrow * n + row] = acc[i];
    }
  }
}

// The GEMV's launch. Lane run: the longest of 128 .. 8 bytes dividing G /
// 4, halved down to 32 while the launch has fewer than GEMV_MIN_ITEMS
// items. Cluster size: doubled up to 8 while the tiles fill fewer blocks
// than SMs and each block keeps 4 items a tile. Warps a block: one item each
// a round, at most GEMV_MAX_WARPS, GEMV_NW / cs and what GEMV_STAGE_BYTES
// of stages hold, the fewest idle warps over a tile's rounds (then the most
// warps).
struct GemvPlan {
  int run, cs, ks;
};
GemvPlan gemv_plan(int m, int n, int k, int group) {
  const int tiles = (n + 15) / 16, ng = k / group, quarter = group / 4;
  int run = 128;
  while (quarter % run) run /= 2;
  while (run > 32 && quarter % (run / 2) == 0 &&
         (long)tiles * ng * (quarter / run) < GEMV_MIN_ITEMS)
    run /= 2;
  const int parts = quarter / run, ni = ng * parts;
  int cs = 1;
  while (cs < 8 && tiles * cs < NUM_SMS && ni >= 8 * cs) cs *= 2;
  int ks_max = GEMV_STAGE_BYTES / ((16 + m) * 4 * run);
  ks_max = ks_max < GEMV_MAX_WARPS ? ks_max : GEMV_MAX_WARPS;
  ks_max = ks_max < GEMV_NW / cs ? ks_max : GEMV_NW / cs;
  int ks = 0, best = 1 << 30;
  for (int w = 1; w <= ks_max; ++w) {
    const int nw = cs * w, idle = (ni + nw - 1) / nw * nw - ni;
    if (idle <= best) {
      best = idle;
      ks = w;
    }
  }
  return {run, cs, ks};
}

template <int RUN>
cudaError_t launch_gemv(const GemvPlan& p, const int8_t* xq, const float* sx, const int8_t* q,
                        const float* s, float* out, int m, int n, int k, int group,
                        cudaStream_t st) {
  const int smem = p.cs * p.ks * 2 * (32 * 16 + 24 * 4) + p.ks * (16 + m) * 4 * RUN;
  static int configured = 0;
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        i8_gemv_kernel<RUN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + 15) / 16 * p.cs);
  cfg.blockDim = dim3(p.ks * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, i8_gemv_kernel<RUN>, xq, sx, q, s, out, m, n, k, group);
}

// ---- the tile (m > 8) on the int8 tensor cores (see the note at the top) ----

constexpr int TM = 128;  // x rows a block: two consumer warpgroups of 64
constexpr int TN = 128;  // weight rows (out columns) a block: wgmma N
constexpr int TK = 128;  // k bytes a stage: one 128-byte swizzled row, four k32 steps
constexpr int STAGES = 4;
constexpr int TILE_BYTES = TM * TK;  // = TN * TK: 16 KB each operand
constexpr int STAGE_BYTES = 2 * TILE_BYTES;
constexpr int SCALE_WIN = 32;  // groups whose scales are staged at once
constexpr int TC_THREADS = 384;  // a producer warpgroup and two consumers
constexpr int TC_SMEM = 1024 + STAGES * STAGE_BYTES + SCALE_WIN * (TM + TN) * 4 + 2 * STAGES * 8;

// the 256 consumer threads' own barrier (barrier 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

// scales of groups g0 .. g0 + SCALE_WIN - 1 of the block's x rows and
// weight rows into shared memory, [group][row], zero past m, n or the
// last group
__device__ __forceinline__ void stage_scales(float* ssx, float* ss, const float* __restrict__ sx,
                                             const float* __restrict__ s, int m, int n, int ng,
                                             int m0, int n0, int g0, int tid) {
  for (int i = tid; i < SCALE_WIN * TM; i += 256) {
    const int g = g0 + i / TM, r = m0 + i % TM;
    ssx[i] = g < ng && r < m ? __ldg(sx + (size_t)r * ng + g) : 0.f;
  }
  for (int i = tid; i < SCALE_WIN * TN; i += 256) {
    const int g = g0 + i / TN, c = n0 + i % TN;
    ss[i] = g < ng && c < n ? __ldg(s + (size_t)c * ng + g) : 0.f;
  }
}

// out [m, n] f32 from xq [m, k] and q [n, k] (TMA maps mx, mq; boxes of
// TK bytes x 128 rows in the 128-byte swizzle): block (blockIdx.x,
// blockIdx.y) takes x rows TM blockIdx.x .. and weight rows TN blockIdx.y
// .. (x rows fastest, so the blocks that share a weight tile run
// together and it is read from device memory once). Warpgroup 0 is the
// producer (one thread issues the TMA copies of a 4-stage ring); consumer
// warpgroup c = 1, 2 runs wgmma on x rows 64 (c - 1) .. of the tile.
__global__ void __launch_bounds__(TC_THREADS, 1)
i8_wgmma_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mq,
                const float* __restrict__ sx, const float* __restrict__ s,
                float* __restrict__ out, int m, int n, int k, int group) {
  extern __shared__ uint8_t i8_smem_raw[];
  uint8_t* smem = i8_smem_raw + ((1024 - (smem_addr(i8_smem_raw) & 1023)) & 1023);
  float* ssx = reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES);  // [SCALE_WIN][TM]
  float* ss = ssx + SCALE_WIN * TM;                                     // [SCALE_WIN][TN]
  uint64_t* full = reinterpret_cast<uint64_t*>(ss + SCALE_WIN * TN);
  uint64_t* empty = full + STAGES;
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
  const int nst = (k + TK - 1) / TK;  // stages (the last may run past k: zero-filled)
  const int ksteps = k / 32, gsteps = group / 32, ng = k / group;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);  // lane 0 of each consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nst; ++kt) {
        const int slot = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[slot], (kt / STAGES - 1) & 1);
        uint8_t* xs = smem + slot * STAGE_BYTES;
        mbar_expect_tx(&full[slot], STAGE_BYTES);
        tma_load_2d(xs, &mx, kt * TK, m0, &full[slot]);
        tma_load_2d(xs + TILE_BYTES, &mq, kt * TK, n0, &full[slot]);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();  // 128 int32 and f32 sums a thread: 168 registers spilled
  const int ctid = threadIdx.x - 128, cw = ctid >> 7;  // consumer warpgroup 0 or 1
  const int warp = (ctid >> 5) & 3, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int xrow = 64 * cw + 16 * warp + g;  // this thread's first tile row (and + 8)
  int iacc[64];
  float facc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    iacc[i] = 0;
    facc[i] = 0.f;
  }
  stage_scales(ssx, ss, sx, s, m, n, ng, m0, n0, 0, ctid);
  consumers_sync();

  for (int kt = 0; kt < nst; ++kt) {
    const int slot = kt % STAGES;
    mbar_wait(&full[slot], (kt / STAGES) & 1);
    const uint32_t xa = smem_addr(smem + slot * STAGE_BYTES) + cw * 64 * TK;
    const uint32_t qa = smem_addr(smem + slot * STAGE_BYTES + TILE_BYTES);
    fence_regs(iacc);
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < TK / 32; ++st) {
      const int kk = kt * (TK / 32) + st;  // k32 step
      if (kk < ksteps) {
        // a group's first step overwrites the int32 sums (scale-d 0)
        wgmma_m64n128k32_s8(iacc, wgmma_desc_sw128(xa + st * 32), wgmma_desc_sw128(qa + st * 32),
                            kk % gsteps != 0);
        if ((kk + 1) % gsteps == 0) {  // the end of group gi: its exact sums, scaled once
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(iacc);
          const int gi = kk / gsteps, gw = gi % SCALE_WIN;
          const float* rs = ssx + gw * TM + xrow;
          const float* cs = ss + gw * TN + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float a = rs[8 * h];
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const float2 b = *reinterpret_cast<const float2*>(cs + 8 * j);
              const int i = 4 * j + 2 * h;
              facc[i] = __fadd_rn(facc[i], __fmul_rn((float)iacc[i], __fmul_rn(a, b.x)));
              facc[i + 1] =
                  __fadd_rn(facc[i + 1], __fmul_rn((float)iacc[i + 1], __fmul_rn(a, b.y)));
            }
          }
          if (gw == SCALE_WIN - 1 && gi + 1 < ng) {  // the next window of scales
            consumers_sync();
            stage_scales(ssx, ss, sx, s, m, n, ng, m0, n0, gi + 1, ctid);
            consumers_sync();
          }
          fence_regs(iacc);
          wgmma_fence();
        }
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // every stage before this one is read: release the last
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  wgmma_wait<0>();

  // facc[i]: tile row xrow + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 t + (i & 1)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + xrow + 8 * h;
    if (r >= m) continue;
    float* orow = out + (size_t)r * n;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = n0 + 8 * j + 2 * t, i = 4 * j + 2 * h;
      if (c + 1 < n && n % 2 == 0) {
        *reinterpret_cast<float2*>(orow + c) = make_float2(facc[i], facc[i + 1]);
      } else {
        if (c < n) orow[c] = facc[i];
        if (c + 1 < n) orow[c + 1] = facc[i + 1];
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that nothing of
// the driver library is linked
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a map of int8 rows [rows, k] in boxes of TK bytes x box_rows rows, in the
// 128-byte swizzle that wgmma's descriptors read
bool map_rows(CUtensorMap* map, const void* base, int rows, int k, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)k};
  const cuuint32_t box[2] = {TK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// xq int8 [m, k], sx f32 [m, k/G], q int8 [n, k], s f32 [n, k/G], out f32
// [m, n]; all contiguous, G a multiple of 32 dividing k. Returns
// cudaGetLastError().
extern "C" int i8_matmul(const void* xq, const void* sx, const void* q, const void* s, void* out,
                         int m, int n, int k, int group, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* x8 = static_cast<const int8_t*>(xq);
  const float* xs = static_cast<const float*>(sx);
  const int8_t* w8 = static_cast<const int8_t*>(q);
  const float* ws = static_cast<const float*>(s);
  float* o = static_cast<float*>(out);
  if (m <= 8) {
    const GemvPlan p = gemv_plan(m, n, k, group);
    cudaError_t e;
    switch (p.run) {
      case 128: e = launch_gemv<128>(p, x8, xs, w8, ws, o, m, n, k, group, st); break;
      case 64: e = launch_gemv<64>(p, x8, xs, w8, ws, o, m, n, k, group, st); break;
      case 32: e = launch_gemv<32>(p, x8, xs, w8, ws, o, m, n, k, group, st); break;
      case 16: e = launch_gemv<16>(p, x8, xs, w8, ws, o, m, n, k, group, st); break;
      default: e = launch_gemv<8>(p, x8, xs, w8, ws, o, m, n, k, group, st); break;
    }
    if (e != cudaSuccess) return static_cast<int>(e);
  } else {
    CUtensorMap mx, mq;
    if (!map_rows(&mx, xq, m, k, TM) || !map_rows(&mq, q, n, k, TN))
      return static_cast<int>(cudaErrorInvalidValue);
    cudaFuncSetAttribute(i8_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
    const dim3 grid((m + TM - 1) / TM, (n + TN - 1) / TN);
    i8_wgmma_kernel<<<grid, TC_THREADS, TC_SMEM, st>>>(mx, mq, xs, ws, o, m, n, k, group);
  }
  return static_cast<int>(cudaGetLastError());
}
