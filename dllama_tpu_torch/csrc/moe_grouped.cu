// Grouped routed SwiGLU experts for prefill on Hopper (sm_90a).
//
// Replaces the TPU kernels dllama_tpu/ops/moe_kernel.py moe_grouped_experts
// (_grouped_kernel) and moe_grouped_experts_q40 (_grouped_kernel_q40). The
// n * k (token, choice) assignments arrive sorted by expert into row tiles
// of R = 32 (ops/moe.py grouped_schedule, torch ops outside the kernel as
// JAX's _grouped_schedule is jnp outside pallas_call): each expert's
// segment starts on a tile boundary, so a tile belongs to one expert, and
// each row carries its token (-1 for padding) and routing weight. Two
// grids behind one C entry:
//   1. up:   hidden[rows, F] = round(silu(Xt W1[e]^T) * (Xt W3[e]^T)), one
//            block per (tile, 64 hidden units), x rows gathered by token.
//   2. down: out[rows, D] = w_row * (hidden W2[e]^T), one block per
//            (tile, 64 outputs).
// The combine back to tokens (out[inv].view(n, k, D).sum(1)) is torch
// outside the kernel, as JAX's .at[t].add is. Roundings as in ops/moe.py.
//
// The grid is sized from the shapes alone (ceil(A / R) + min(E, A) tiles
// for A = n * k); a block past the real tile count, read from a device int,
// returns at once, so the host never reads the schedule back.
//
// Bound on an H100: at a 512-row chunk of Qwen3-30B-A3B, 4,096 assignments
// touch all 128 experts (641.7 MB of Q40 weights) for 38.7 GFLOP: bytes and
// operations are close (0.19 vs 0.04 ms), and the tensor cores are what
// would reach either. This first design is a shared-memory tiled product
// in f32 FMA on CUDA cores (32 x 64 tile, depth 32 a step, 2 x 4 outputs a
// thread), far from both bounds; wgmma with the dequantized tile in shared
// memory is later work. Each expert's weights stream once per tile of its
// segment (tiles of one expert run side by side, so mostly from L2).

#include "moe_experts.cuh"

using namespace dllama;

namespace {

constexpr int R = 32;         // rows per tile: ops/moe.py GROUP_ROWS
constexpr int BN = 64;        // output columns per block
constexpr int BK = 32;        // depth per step
constexpr int THREADS = 256;  // 16 x 16 threads, 2 rows x 4 columns each

// One depth step's B tile (BN weight rows x BK) into Bs[k][col]: thread
// reads 8 consecutive depth values of weight row c0 + tid / 4.
template <typename X, typename W>
__device__ __forceinline__ void load_b(const W& w, int e, int c0, int n_rows, int k0,
                                       float (&Bs)[BK][BN + 4], int tid) {
  const int col = tid / 4, kk = (tid % 4) * 8;
  float v[8];
  if (c0 + col < n_rows) {
    w.template get8<X>(e, c0 + col, k0 + kk, v);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) Bs[kk + j][col] = v[j];
}

__device__ __forceinline__ void fma_tile(const float (&As)[BK][R + 4], const float (&Bs)[BK][BN + 4],
                                         int kk, int ty, int tx, float (&acc)[2][4]) {
  const float2 a = *reinterpret_cast<const float2*>(&As[kk][ty * 2]);
  const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
  const float av[2] = {a.x, a.y};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

template <typename X, typename W>
__global__ void __launch_bounds__(THREADS)
grouped_up_kernel(const X* __restrict__ x, W w1, W w3, const int* __restrict__ row_token,
                  const int* __restrict__ tile_expert, const int* __restrict__ n_tiles,
                  float* __restrict__ hidden, int n_d, int n_f) {
  const int tile = blockIdx.x;
  if (tile >= *n_tiles) return;
  __shared__ __align__(16) float As[BK][R + 4];
  __shared__ __align__(16) float B1[BK][BN + 4];
  __shared__ __align__(16) float B3[BK][BN + 4];
  const int e = tile_expert[tile], f0 = blockIdx.y * BN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // this thread loads 4 consecutive depth values of tile row a_row
  const int a_row = tid / 8, a_k = (tid % 8) * 4;
  const int tok = row_token[tile * R + a_row];
  const X* xr = x + (size_t)(tok < 0 ? 0 : tok) * n_d + a_k;
  float acc1[2][4] = {}, acc3[2][4] = {};
  for (int k0 = 0; k0 < n_d; k0 += BK) {
#pragma unroll
    for (int j = 0; j < 4; ++j) As[a_k + j][a_row] = tok < 0 ? 0.f : to_float(xr[k0 + j]);
    load_b<X>(w1, e, f0, n_f, k0, B1, tid);
    load_b<X>(w3, e, f0, n_f, k0, B3, tid);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      fma_tile(As, B1, kk, ty, tx, acc1);
      fma_tile(As, B3, kk, ty, tx, acc3);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t row = (size_t)tile * R + ty * 2 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + tx * 4 + j;
      if (f < n_f) hidden[row * n_f + f] = round_to(silu_mul(acc1[i][j], acc3[i][j]), x);
    }
  }
}

template <typename X, typename W>
__global__ void __launch_bounds__(THREADS)
grouped_down_kernel(const float* __restrict__ hidden, W w2, const float* __restrict__ row_weight,
                    const int* __restrict__ tile_expert, const int* __restrict__ n_tiles,
                    float* __restrict__ out, int n_d, int n_f) {
  const int tile = blockIdx.x;
  if (tile >= *n_tiles) return;
  __shared__ __align__(16) float As[BK][R + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];
  const int e = tile_expert[tile], d0 = blockIdx.y * BN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int a_row = tid / 8, a_k = (tid % 8) * 4;
  const float* hrow = hidden + ((size_t)tile * R + a_row) * n_f + a_k;
  float acc[2][4] = {};
  for (int k0 = 0; k0 < n_f; k0 += BK) {
    const float4 h = *reinterpret_cast<const float4*>(hrow + k0);
    As[a_k][a_row] = h.x;
    As[a_k + 1][a_row] = h.y;
    As[a_k + 2][a_row] = h.z;
    As[a_k + 3][a_row] = h.w;
    load_b<X>(w2, e, d0, n_d, k0, Bs, tid);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) fma_tile(As, Bs, kk, ty, tx, acc);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t row = (size_t)tile * R + ty * 2 + i;
    const float w = row_weight[row];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + tx * 4 + j;
      if (d < n_d) out[row * n_d + d] = acc[i][j] * w;
    }
  }
}

template <typename X, typename W>
int launch(const X* x, W w1, W w3, W w2, const int* row_token, const float* row_weight,
           const int* tile_expert, const int* n_tiles, float* hidden, float* out, int max_tiles,
           int n_d, int n_f, cudaStream_t s) {
  grouped_up_kernel<X, W><<<dim3(max_tiles, (n_f + BN - 1) / BN), THREADS, 0, s>>>(
      x, w1, w3, row_token, tile_expert, n_tiles, hidden, n_d, n_f);
  grouped_down_kernel<X, W><<<dim3(max_tiles, (n_d + BN - 1) / BN), THREADS, 0, s>>>(
      hidden, w2, row_weight, tile_expert, n_tiles, out, n_d, n_f);
  return static_cast<int>(cudaGetLastError());
}

template <typename X>
int run(const void* x, const void* w1, const void* w1d, const void* w3, const void* w3d,
        const void* w2, const void* w2d, const int* row_token, const float* row_weight,
        const int* tile_expert, const int* n_tiles, float* hidden, float* out, int max_tiles,
        int n_d, int n_f, int q40, cudaStream_t s) {
  return with_experts<X>(q40, w1, w1d, w3, w3d, w2, w2d, n_d, n_f, [&](auto e1, auto e3, auto e2) {
    return launch(static_cast<const X*>(x), e1, e3, e2, row_token, row_weight, tile_expert,
                  n_tiles, hidden, out, max_tiles, n_d, n_f, s);
  });
}

}  // namespace

// x [n, D] (bf16 when x_bf16 else f32); experts as in moe_active.cu; the
// schedule of ops/moe.py grouped_schedule: row_token int32 [max_tiles * R],
// row_weight f32 [max_tiles * R], tile_expert int32 [max_tiles], n_tiles
// int32 [1] on the device; hidden f32 scratch [max_tiles * R, F]; out f32
// [max_tiles * R, D], rows in schedule order. Returns cudaGetLastError().
extern "C" int moe_grouped(const void* x, const void* w1, const void* w1d, const void* w3,
                           const void* w3d, const void* w2, const void* w2d,
                           const void* row_token, const void* row_weight,
                           const void* tile_expert, const void* n_tiles, void* hidden, void* out,
                           int max_tiles, int n_d, int n_f, int x_bf16, int q40, void* stream) {
  if (n_d % 32 || n_f % 32 || max_tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* rt = static_cast<const int*>(row_token);
  const float* rw = static_cast<const float*>(row_weight);
  const int* te = static_cast<const int*>(tile_expert);
  const int* nt = static_cast<const int*>(n_tiles);
  float* h = static_cast<float*>(hidden);
  float* o = static_cast<float*>(out);
  if (x_bf16)
    return run<__nv_bfloat16>(x, w1, w1d, w3, w3d, w2, w2d, rt, rw, te, nt, h, o, max_tiles, n_d,
                              n_f, q40, s);
  return run<float>(x, w1, w1d, w3, w3d, w2, w2d, rt, rw, te, nt, h, o, max_tiles, n_d, n_f, q40,
                    s);
}
