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
// is two grids behind one C entry, without atomics (a greedy stream repeats
// bit for bit):
//   1. up:   grid (m * k, F / 32). x[t] is staged in shared memory; each of
//            the 8 warps owns 4 hidden units and reads their W1 and W3 rows
//            whole (lanes on 8 consecutive weights, a warp on 256 contiguous
//            columns), so each selected weight byte is read once; the
//            rounded hidden goes to a scratch [m, k, F] f32.
//   2. down: grid (m, D / 16). The token's k hidden rows are staged in
//            shared memory; each warp owns 2 outputs d and reads the W2[e]
//            rows d (contiguous over F) of all k experts, summing the
//            routing-weighted dot products in order j = 0 .. k - 1.
// Tokens that share an expert read it again (through L2); deduplication
// across decode lanes is later work.

#include "moe_experts.cuh"

using namespace dllama;

namespace {

constexpr int WARPS = 8;
constexpr int UP_UNITS = 4;                       // hidden units per warp
constexpr int UP_BLOCK_F = WARPS * UP_UNITS;      // hidden units per block
constexpr int DOWN_OUTS = 2;                      // outputs per warp
constexpr int DOWN_BLOCK_D = WARPS * DOWN_OUTS;   // outputs per block

template <typename X, typename W>
__global__ void __launch_bounds__(WARPS * 32)
moe_up_kernel(const X* __restrict__ x, W w1, W w3, const int* __restrict__ top_i,
              float* __restrict__ hidden, int k, int n_d, int n_f) {
  extern __shared__ __align__(16) float xs[];  // [D]
  const int a = blockIdx.x;  // assignment t * k + j
  const int t = a / k, e = top_i[a];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = threadIdx.x; c < n_d; c += blockDim.x) xs[c] = to_float(x[(size_t)t * n_d + c]);
  __syncthreads();
  for (int u = 0; u < UP_UNITS; ++u) {
    const int f = blockIdx.y * UP_BLOCK_F + warp * UP_UNITS + u;
    if (f >= n_f) break;
    float s1 = 0.f, s3 = 0.f;
#pragma unroll 4
    for (int c = lane * 8; c < n_d; c += 256) {
      float v1[8], v3[8];
      w1.template get8<X>(e, f, c, v1);
      w3.template get8<X>(e, f, c, v3);
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
    if (lane == 0) hidden[(size_t)a * n_f + f] = round_to(silu_mul(s1, s3), x);
  }
}

template <typename X, typename W>
__global__ void __launch_bounds__(WARPS * 32)
moe_down_kernel(const float* __restrict__ hidden, W w2, const int* __restrict__ top_i,
                const float* __restrict__ wts, float* __restrict__ out, int k, int n_d,
                int n_f) {
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
        w2.template get8<X>(e, dd, c, v);
#pragma unroll
        for (int i = 0; i < 8; ++i) s = fmaf(h[c + i], v[i], s);
      }
      acc += warp_sum(s) * wts[t * k + j];
    }
    if (lane == 0) out[(size_t)t * n_d + dd] = acc;
  }
}

template <typename K>
bool allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return true;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes)) == cudaSuccess;
}

template <typename X, typename W>
int launch(const X* x, W w1, W w3, W w2, const int* top_i, const float* wts, float* hidden,
           float* out, int m, int k, int n_d, int n_f, cudaStream_t s) {
  const size_t up_smem = sizeof(float) * n_d, down_smem = sizeof(float) * k * n_f;
  if (!allow_smem(moe_up_kernel<X, W>, up_smem) || !allow_smem(moe_down_kernel<X, W>, down_smem))
    return static_cast<int>(cudaErrorInvalidValue);
  moe_up_kernel<X, W><<<dim3(m * k, (n_f + UP_BLOCK_F - 1) / UP_BLOCK_F), WARPS * 32, up_smem,
                        s>>>(x, w1, w3, top_i, hidden, k, n_d, n_f);
  moe_down_kernel<X, W><<<dim3(m, (n_d + DOWN_BLOCK_D - 1) / DOWN_BLOCK_D), WARPS * 32,
                          down_smem, s>>>(hidden, w2, top_i, wts, out, k, n_d, n_f);
  return static_cast<int>(cudaGetLastError());
}

template <typename X>
int run(const void* x, const void* w1, const void* w1d, const void* w3, const void* w3d,
        const void* w2, const void* w2d, const int* top_i, const float* wts, float* hidden,
        float* out, int m, int k, int n_d, int n_f, int q40, cudaStream_t s) {
  return with_experts<X>(q40, w1, w1d, w3, w3d, w2, w2d, n_d, n_f, [&](auto e1, auto e3, auto e2) {
    return launch(static_cast<const X*>(x), e1, e3, e2, top_i, wts, hidden, out, m, k, n_d, n_f, s);
  });
}

}  // namespace

// x [m, D] (bf16 when x_bf16 else f32); w1/w3 [E, F, D] and w2 [E, D, F],
// Q40 (int8 values + f16 scales w*d [E, rows, cols / 32]) when q40, else
// dense in x's type (scale pointers unused); top_i int32 [m, k]; wts f32
// [m, k]; hidden f32 scratch [m, k, F]; out f32 [m, D]. All contiguous, D
// and F multiples of 32. Returns cudaGetLastError().
extern "C" int moe_active(const void* x, const void* w1, const void* w1d, const void* w3,
                          const void* w3d, const void* w2, const void* w2d, const void* top_i,
                          const void* wts, void* hidden, void* out, int m, int k, int n_d,
                          int n_f, int x_bf16, int q40, void* stream) {
  if (n_d % 32 || n_f % 32 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ti = static_cast<const int*>(top_i);
  const float* w = static_cast<const float*>(wts);
  float* h = static_cast<float*>(hidden);
  float* o = static_cast<float*>(out);
  if (x_bf16)
    return run<__nv_bfloat16>(x, w1, w1d, w3, w3d, w2, w2d, ti, w, h, o, m, k, n_d, n_f, q40, s);
  return run<float>(x, w1, w1d, w3, w3d, w2, w2d, ti, w, h, o, m, k, n_d, n_f, q40, s);
}
