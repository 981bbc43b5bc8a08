// Routed SwiGLU experts for decode-sized batches on Hopper (sm_90a).
//
// Replaces the TPU kernels dllama_tpu/ops/moe_kernel.py moe_active_experts
// (_moe_kernel) and moe_active_experts_q40 (_moe_kernel_q40):
//   out[t] = sum_j w[t, j] * W2[e] round(silu(W1[e] x[t]) * (W3[e] x[t])),
// e = top_i[t, j], over each token's k selected experts; f32 out. The expert
// weights are a template parameter: Q40 (int8 + f16 scales) or dense in the
// activation type (moe_experts.cuh). Roundings as in ops/moe.py: W rounded
// to x's type, f32 products and sums, the hidden rounded to x's type before
// the down projection, the routing weight applied in f32.
//
// Bound on an H100: at m <= 16 tokens the kernel reads the selected
// experts' weights (A3B, m = 1: 8 experts x 3 x 2048 x 768 x 1.0625 B =
// 40.1 MB) and does 2 flops per weight and token, far below the ~295 flops
// per byte where the tensor cores would be the limit: it is bound by bytes.
// The TPU kernel walked a sequential (token, choice, F block) grid with a
// VMEM accumulator; on the card nothing carries between blocks, so the work
// is two launches behind one C entry (the hidden must be complete before
// the down projection), without atomics or counters (a greedy stream
// repeats bit for bit).
//
// bf16 x runs both projections on mma.sync m16n8k16 with the Q40 GEMV's
// fragments (q40_gemm.cuh `gemv_mma_kernel`): expert rows are A, the
// token's vector is column 0 of B (the other 7 columns zero), and a Q40
// weight enters as the exact f32 product rounded once to bf16 with no
// int-to-float conversion (q40::weight_pair; dense bf16 experts need no
// rounding). Sums are f32, so the roundings are moe_experts_ref's: x and W
// in bf16, the hidden rounded to bf16 before the down projection, the
// routing weight applied in f32. Both kinds of rows go straight into
// registers, one chunk of a row a warp at a time (moe_experts.cuh): Q40
// lane t of a quad taking a 32-value block (two 16-byte loads that bypass
// L1), dense bf16 lane t 16 values (two loads through L1, a quad's loads on
// 64 contiguous bytes). Staging dense rows whole in shared memory by
// cp.async took ~20% less time at m = 1 and 16 on an H100 (PERF.md), a
// possible later step.
//   1. up (`moe_up_mma_kernel`): grid (m * k, F / 8), 8 warps splitting D.
//      A rows 0..7 are W1[e]'s rows of 8 hidden units and rows 8..15 W3[e]'s
//      of the same units, so one lane holds h1 and h3 of a unit and stores
//      round(silu(h1) h3) in bf16 (into the f32 scratch's bytes). 768
//      blocks at A3B m = 1; the assignments of a slice of F run side by
//      side, so tokens that share an expert read it through L2.
//   2. down (`moe_down_mma_kernel`): grid (min(k, 8), m, D / 16), a
//      cluster of min(k, 8) blocks a (token, 16 outputs), block r taking
//      experts j = r, r + 8, ..; 4 warps split F. Each expert's 16 results
//      times w[t, j] go to rank 0's shared memory, which adds them from 0
//      in order j = 0 .. k - 1 after the cluster's barrier. 1,024 blocks at
//      A3B m = 1.
// f32 x keeps the CUDA-core kernels (no tensor-core type holds f32
// exactly): up, grid (m * k, F / 32), x[t] staged in shared memory, each
// of 8 warps reading 4 hidden units' W1 and W3 rows whole; down, grid (m,
// D / 16), the token's k hidden rows staged, each warp 2 outputs d over
// all k experts, summed in order j = 0 .. k - 1.
// Tokens that share an expert read it again (through L2), as the TPU
// kernel does. Deduplication across decode lanes is the two-tier decode
// (`--moe-decode-dedup`, the JAX transformer's _moe_ffn_pallas): the C entry
// `moe_active_tier` takes a device predicate that every block reads first,
// returning at once on steps whose lanes share few enough experts for the
// grouped kernel's capped schedule to take them (csrc/moe_grouped.cu).

#include <cooperative_groups.h>

#include "moe_experts.cuh"

using namespace dllama;
namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 8;
constexpr int UP_UNITS = 4;                       // hidden units per warp
constexpr int UP_BLOCK_F = WARPS * UP_UNITS;      // hidden units per block
constexpr int DOWN_OUTS = 2;                      // outputs per warp
constexpr int DOWN_BLOCK_D = WARPS * DOWN_OUTS;   // outputs per block

template <typename W>
__global__ void __launch_bounds__(WARPS * 32)
moe_up_kernel(const float* __restrict__ x, W w1, W w3, const int* __restrict__ top_i,
              float* __restrict__ hidden, int k, int n_d, int n_f,
              const int* __restrict__ skip) {
  if (skip != nullptr && __ldg(skip) != 0) return;  // the step is the grouped tier's
  extern __shared__ __align__(16) float xs[];  // [D]
  const int a = blockIdx.x;  // assignment t * k + j
  const int t = a / k, e = top_i[a];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = threadIdx.x; c < n_d; c += blockDim.x) xs[c] = x[(size_t)t * n_d + c];
  __syncthreads();
  for (int u = 0; u < UP_UNITS; ++u) {
    const int f = blockIdx.y * UP_BLOCK_F + warp * UP_UNITS + u;
    if (f >= n_f) break;
    float s1 = 0.f, s3 = 0.f;
#pragma unroll 4
    for (int c = lane * 8; c < n_d; c += 256) {
      float v1[8], v3[8];
      w1.template get8<float>(e, f, c, v1);
      w3.template get8<float>(e, f, c, v3);
      const float4 xa = *reinterpret_cast<const float4*>(xs + c);
      const float4 xb = *reinterpret_cast<const float4*>(xs + c + 4);
      const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s1 = fmaf(xv[i], v1[i], s1);
        s3 = fmaf(xv[i], v3[i], s3);
      }
    }
    s1 = warp_sum(s1);
    s3 = warp_sum(s3);
    if (lane == 0) hidden[(size_t)a * n_f + f] = silu_mul(s1, s3);
  }
}

template <typename W>
__global__ void __launch_bounds__(WARPS * 32)
moe_down_kernel(const float* __restrict__ hidden, W w2, const int* __restrict__ top_i,
                const float* __restrict__ wts, float* __restrict__ out, int k, int n_d,
                int n_f, const int* __restrict__ skip) {
  if (skip != nullptr && __ldg(skip) != 0) return;  // the step is the grouped tier's
  extern __shared__ __align__(16) float hs[];  // [k][F]
  const int t = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = threadIdx.x; c < k * n_f; c += blockDim.x) hs[c] = hidden[(size_t)t * k * n_f + c];
  __syncthreads();
  for (int o = 0; o < DOWN_OUTS; ++o) {
    const int dd = blockIdx.y * DOWN_BLOCK_D + warp * DOWN_OUTS + o;
    if (dd >= n_d) break;
    float acc = 0.f;
    for (int j = 0; j < k; ++j) {
      const int e = top_i[t * k + j];
      const float* h = hs + j * n_f;
      float s = 0.f;
#pragma unroll 4
      for (int c = lane * 8; c < n_f; c += 256) {
        float v[8];
        w2.template get8<float>(e, dd, c, v);
#pragma unroll
        for (int i = 0; i < 8; ++i) s = fmaf(h[c + i], v[i], s);
      }
      acc += warp_sum(s) * wts[t * k + j];
    }
    if (lane == 0) out[(size_t)t * n_d + dd] = acc;
  }
}

// ---- bf16 x on mma.sync m16n8k16 (see the note at the top) ----

constexpr int UP_TILE = 8;       // hidden units a block: A rows 0..7 W1, 8..15 W3
constexpr int UP_WARPS = 8;      // warps a block, splitting D
constexpr int DOWN_WARPS = 4;    // warps a block, splitting F
constexpr int MAX_CLUSTER = 8;   // the portable cluster size

// acc[16 x 8] += A . B over warp `warp`'s share (of NW) of the chunks of
// a row of cols values: A rows g (wa's row ra + g of expert ea) and g + 8
// (wb's row rb + g of eb), B column 0 the bf16 vector v (lanes with g = 0;
// the other columns zero). Lane (g, t)'s values of a chunk are runs of 8 at
// W::col; a k16 step st takes values 4 st .. 4 st + 3 of them on both
// sides, as the Q40 GEMV does.
template <int NW, typename W>
__device__ __forceinline__ void warp_rows(const W& wa, int ea, int ra, const W& wb, int eb, int rb,
                                          const __nv_bfloat16* __restrict__ v, int cols, int warp,
                                          int g, int t, float (&acc)[4]) {
  constexpr int LV = W::LANE_VALS;
  const int nc = (cols + 4 * LV - 1) / (4 * LV);  // chunks of a row
  for (int c = warp * nc / NW; c < (warp + 1) * nc / NW; ++c) {
    const typename W::Frag fa = wa.fetch(ea, ra + g, c, t), fb = wb.fetch(eb, rb + g, c, t);
    uint32_t xw[LV / 2];
#pragma unroll
    for (int h = 0; h < LV / 8; ++h) {
      const int col = W::col(c, t, h);
      const uint4 xv = g == 0 && col < cols ? __ldg(reinterpret_cast<const uint4*>(v + col))
                                            : make_uint4(0, 0, 0, 0);
      xw[4 * h] = xv.x;
      xw[4 * h + 1] = xv.y;
      xw[4 * h + 2] = xv.z;
      xw[4 * h + 3] = xv.w;
    }
    uint32_t a[LV / 2], b[LV / 2];
    wa.pairs(fa, a);
    wb.pairs(fb, b);
#pragma unroll
    for (int st = 0; st < LV / 4; ++st) {
      const uint32_t f[4] = {a[2 * st], b[2 * st], a[2 * st + 1], b[2 * st + 1]};
      mma_bf16(acc, f, xw[2 * st], xw[2 * st + 1]);
    }
  }
}

// The warps' sums added in warp order; returns warp 0's (d rows g, g + 8 of
// column 0 in v[0], v[2] on lanes t = 0). red must be free on entry.
template <int NW>
__device__ __forceinline__ void warp_order_sum(float4 (&red)[NW][32], const float (&acc)[4],
                                               int warp, int lane, float (&v)[4]) {
  red[warp][lane] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  __syncthreads();
  if (warp == 0) {
    v[0] = acc[0];
    v[1] = acc[1];
    v[2] = acc[2];
    v[3] = acc[3];
#pragma unroll
    for (int w = 1; w < NW; ++w) {
      const float4 o = red[w][lane];
      v[0] += o.x;
      v[1] += o.y;
      v[2] += o.z;
      v[3] += o.w;
    }
  }
}

// up: block (a, blockIdx.y) takes hidden units f0 = 8 blockIdx.y .. of
// assignment a = t * k + j (the assignments of a slice of F run side by
// side, so that tokens sharing an expert read its rows through L2): A rows
// 0..7 are W1[e] rows f0.., rows 8..15 W3[e] rows f0.., so lane (g, 0) ends
// with h1 and h3 of unit f0 + g and stores round(silu(h1) h3) in bf16. The
// 8 warps split D's chunks.
template <typename W>
__global__ void __launch_bounds__(UP_WARPS * 32)
moe_up_mma_kernel(const __nv_bfloat16* __restrict__ x, W w1, W w3, const int* __restrict__ top_i,
                  __nv_bfloat16* __restrict__ hidden, int k, int n_d, int n_f,
                  const int* __restrict__ skip) {
  if (skip != nullptr && __ldg(skip) != 0) return;  // the step is the grouped tier's
  __shared__ float4 red[UP_WARPS][32];
  const int a = blockIdx.x, f0 = blockIdx.y * UP_TILE;
  const int e = __ldg(top_i + a);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  warp_rows<UP_WARPS>(w1, e, f0, w3, e, f0, x + (size_t)(a / k) * n_d, n_d, warp, g, t, acc);
  float v[4];
  warp_order_sum(red, acc, warp, lane, v);
  if (warp == 0 && t == 0)
    hidden[(size_t)a * n_f + f0 + g] = __float2bfloat16(silu_mul(v[0], v[2]));
}

// down: a cluster of cs blocks (blockIdx.x = rank) takes outputs d0 = 16
// blockIdx.z .. of token blockIdx.y (the tokens of a slice of D side by
// side); rank r runs its experts j = r, r + cs,
// ..: A rows are W2[e_j] rows d0.., B column 0 the token's bf16 hidden of
// choice j, the 4 warps split F's chunks. Each expert's 16 results,
// times w[t, j] in f32, go to slot j of rank 0's shared memory; after the
// cluster's barrier rank 0 adds the slots from 0 in order j = 0 .. k - 1.
template <typename W>
__global__ void __launch_bounds__(DOWN_WARPS * 32)
moe_down_mma_kernel(const __nv_bfloat16* __restrict__ hidden, W w2, const int* __restrict__ top_i,
                    const float* __restrict__ wts, float* __restrict__ out, int k, int n_d,
                    int n_f, const int* __restrict__ skip) {
  if (skip != nullptr && __ldg(skip) != 0) return;  // the step is the grouped tier's
  extern __shared__ __align__(16) float terms[];  // [k][16]
  __shared__ float4 red[DOWN_WARPS][32];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = cluster.num_blocks(), rank = cluster.block_rank();
  const int d0 = blockIdx.z * 16, tok = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float* rterms = cluster.map_shared_rank(terms, 0);
  for (int j = rank; j < k; j += cs) {
    const int a = tok * k + j, e = __ldg(top_i + a);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    warp_rows<DOWN_WARPS>(w2, e, d0, w2, e, d0 + 8, hidden + (size_t)a * n_f, n_f, warp, g, t,
                          acc);
    float v[4];
    warp_order_sum(red, acc, warp, lane, v);
    if (warp == 0 && t == 0) {
      const float wj = __ldg(wts + a);
      rterms[j * 16 + g] = __fmul_rn(v[0], wj);
      rterms[j * 16 + g + 8] = __fmul_rn(v[2], wj);
    }
    __syncthreads();  // red is free again
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x < 16) {
    float acc = 0.f;
    for (int j = 0; j < k; ++j) acc = __fadd_rn(acc, terms[j * 16 + threadIdx.x]);
    out[(size_t)tok * n_d + d0 + threadIdx.x] = acc;
  }
}

template <typename K>
bool allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return true;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes)) == cudaSuccess;
}

// f32 x: the CUDA-core kernels, an f32 hidden in the scratch
template <typename W>
int launch(const float* x, W w1, W w3, W w2, const int* top_i, const float* wts, void* hidden,
           float* out, int m, int k, int n_d, int n_f, const int* skip, cudaStream_t s) {
  float* h = static_cast<float*>(hidden);
  const size_t up_smem = sizeof(float) * n_d, down_smem = sizeof(float) * k * n_f;
  if (!allow_smem(moe_up_kernel<W>, up_smem) || !allow_smem(moe_down_kernel<W>, down_smem))
    return static_cast<int>(cudaErrorInvalidValue);
  moe_up_kernel<W><<<dim3(m * k, (n_f + UP_BLOCK_F - 1) / UP_BLOCK_F), WARPS * 32, up_smem, s>>>(
      x, w1, w3, top_i, h, k, n_d, n_f, skip);
  moe_down_kernel<W><<<dim3(m, (n_d + DOWN_BLOCK_D - 1) / DOWN_BLOCK_D), WARPS * 32, down_smem,
                       s>>>(h, w2, top_i, wts, out, k, n_d, n_f, skip);
  return static_cast<int>(cudaGetLastError());
}

// bf16 x: the tensor-core kernels, a bf16 hidden [m, k, F] in the scratch
template <typename W>
int launch(const __nv_bfloat16* x, W w1, W w3, W w2, const int* top_i, const float* wts,
           void* hidden, float* out, int m, int k, int n_d, int n_f, const int* skip,
           cudaStream_t s) {
  auto* h = static_cast<__nv_bfloat16*>(hidden);
  moe_up_mma_kernel<W><<<dim3(m * k, n_f / UP_TILE), UP_WARPS * 32, 0, s>>>(
      x, w1, w3, top_i, h, k, n_d, n_f, skip);
  const int cs = k < MAX_CLUSTER ? k : MAX_CLUSTER;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, m, n_d / 16);
  cfg.blockDim = dim3(DOWN_WARPS * 32);
  cfg.dynamicSmemBytes = sizeof(float) * k * 16;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, moe_down_mma_kernel<W>, h, w2, top_i, wts, out, k, n_d, n_f,
                         skip);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename X>
int run(const void* x, const void* w1, const void* w1d, const void* w3, const void* w3d,
        const void* w2, const void* w2d, const int* top_i, const float* wts, void* hidden,
        float* out, int m, int k, int n_d, int n_f, int q40, const int* skip, cudaStream_t s) {
  return with_experts<X>(q40, w1, w1d, w3, w3d, w2, w2d, n_d, n_f, [&](auto e1, auto e3, auto e2) {
    return launch(static_cast<const X*>(x), e1, e3, e2, top_i, wts, hidden, out, m, k, n_d, n_f,
                  skip, s);
  });
}

}  // namespace

namespace {

int entry(const void* x, const void* w1, const void* w1d, const void* w3, const void* w3d,
          const void* w2, const void* w2d, const void* top_i, const void* wts, void* hidden,
          void* out, const void* skip, int m, int k, int n_d, int n_f, int x_bf16, int q40,
          void* stream) {
  if (n_d % 32 || n_f % 32 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ti = static_cast<const int*>(top_i);
  const float* w = static_cast<const float*>(wts);
  const int* sk = static_cast<const int*>(skip);
  float* o = static_cast<float*>(out);
  if (x_bf16)
    return run<__nv_bfloat16>(x, w1, w1d, w3, w3d, w2, w2d, ti, w, hidden, o, m, k, n_d, n_f, q40,
                              sk, s);
  return run<float>(x, w1, w1d, w3, w3d, w2, w2d, ti, w, hidden, o, m, k, n_d, n_f, q40, sk, s);
}

}  // namespace

// x [m, D] (bf16 when x_bf16 else f32); w1/w3 [E, F, D] and w2 [E, D, F],
// Q40 (int8 values + f16 scales w*d [E, rows, cols / 32]) when q40, else
// dense in x's type (scale pointers unused); top_i int32 [m, k]; wts f32
// [m, k]; hidden scratch of [m, k, F] f32 (bf16 x keeps a bf16 hidden in its
// first half); out f32 [m, D]. All contiguous, D and F multiples of 32.
// Returns cudaGetLastError().
extern "C" int moe_active(const void* x, const void* w1, const void* w1d, const void* w3,
                          const void* w3d, const void* w2, const void* w2d, const void* top_i,
                          const void* wts, void* hidden, void* out, int m, int k, int n_d,
                          int n_f, int x_bf16, int q40, void* stream) {
  return entry(x, w1, w1d, w3, w3d, w2, w2d, top_i, wts, hidden, out, nullptr, m, k, n_d, n_f,
               x_bf16, q40, stream);
}

// moe_active as the active tier of the two-tier decode (ops/moe.py
// `moe_decode_tiers`): every block reads the device int `skip` [1] first
// and returns at once when it is non-zero (the step took the grouped tier),
// so the tier is chosen on the device, inside a captured graph, with no
// readback; `out` is then left as it was.
extern "C" int moe_active_tier(const void* x, const void* w1, const void* w1d, const void* w3,
                               const void* w3d, const void* w2, const void* w2d,
                               const void* top_i, const void* wts, void* hidden, void* out,
                               const void* skip, int m, int k, int n_d, int n_f, int x_bf16,
                               int q40, void* stream) {
  return entry(x, w1, w1d, w3, w3d, w2, w2d, top_i, wts, hidden, out, skip, m, k, n_d, n_f,
               x_bf16, q40, stream);
}
