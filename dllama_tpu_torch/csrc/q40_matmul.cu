// Q40 weight-only matrix product for Hopper (sm_90a).
//
// Replaces the TPU kernel dllama_tpu/ops/quant_matmul.py qmatmul_2d
// (_qmm_kernel): out[m, n] = sum_k x[m, k] * W[n, k] with
// W[n, k] = q[n, k] * d[n, k / 32], dequantized on the fly, summed in f32.
//
// Layout: the .m file's own rows, q int8 [n, k] in [-8, 7] and d f16
// [n, k / 32] (1.0625 B per weight), so each output column reads one
// contiguous row. Roundings: W is formed exactly in f32 (an f16 scale times
// a 4-bit value fits its mantissa) and rounded to x's type, so for
// bfloat16 x the kernel rounds where the TPU kernel does (x and the
// dequantized tile in bf16) and for float32 x nothing is rounded. The
// plain version (ops/quant_matmul.qmatmul_ref) applies the same roundings,
// so the two differ only in summation order.
//
// Bound on an H100: decode (m = 1) reads every weight byte once and does
// 2 flops per weight, far below the ~295 flops per byte where the tensor
// cores become the limit, so it is bound by bytes (weights over 3.35 TB/s).
// The GEMV path (m <= 8) gives each warp two output columns; its lanes walk
// k in 16-byte segments so a warp reads 512 contiguous weight bytes per
// column per step, and every weight byte is read once per launch. Prefill
// (m up to 512) is a plain shared-memory tiled product in f32 FMA on CUDA
// cores (64 x 64 tile, 4 x 4 outputs per thread): simple and right, and
// far below the tensor-core peak (wgmma is later work).

#include "common.cuh"

using namespace dllama;

namespace {

constexpr int GEMV_WARPS = 4;  // warps per block
constexpr int GEMV_COLS = 2;   // output columns per warp

template <typename T, int M>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
q40_gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                const __half* __restrict__ d, float* __restrict__ out, int n, int k) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = (blockIdx.x * GEMV_WARPS + warp) * GEMV_COLS;
  if (col0 >= n) return;
  const int nseg = k / 16, nb = k / 32;
  float acc[M][GEMV_COLS];
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int c = 0; c < GEMV_COLS; ++c) acc[r][c] = 0.f;

  for (int s = lane; s < nseg; s += 32) {
    float w[GEMV_COLS][16];
#pragma unroll
    for (int c = 0; c < GEMV_COLS; ++c) {
      const int col = col0 + c;
      if (col < n) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(q + (size_t)col * k) + s);
        const int8_t* qb = reinterpret_cast<const int8_t*>(&u);
        const float sc = __half2float(d[(size_t)col * nb + (s >> 1)]);
#pragma unroll
        for (int i = 0; i < 16; ++i) w[c][i] = round_to((float)qb[i] * sc, x);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) w[c][i] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < M; ++r) {
      float xa[8], xb[8];
      const T* xp = x + (size_t)r * k + s * 16;
      load8(xp, xa);
      load8(xp + 8, xb);
#pragma unroll
      for (int c = 0; c < GEMV_COLS; ++c)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[r][c] = fmaf(xa[i], w[c][i], acc[r][c]);
          acc[r][c] = fmaf(xb[i], w[c][i + 8], acc[r][c]);
        }
    }
  }
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int c = 0; c < GEMV_COLS; ++c) {
      const float v = warp_sum(acc[r][c]);
      const int col = col0 + c;
      if (lane == 0 && col < n) out[(size_t)r * n + col] = v;
    }
}

constexpr int BM = 64, BN = 64, BK = 32, TM = 4, TN = 4;  // 256 threads

template <typename T>
__global__ void __launch_bounds__(256)
q40_gemm_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                const __half* __restrict__ d, float* __restrict__ out, int m, int n, int k) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int lrow = tid / 4;        // tile row this thread loads (0..63)
  const int lk = (tid % 4) * 8;    // its 8 consecutive k values
  const int nb = k / 32;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    float xv[8], wv[8];
    const int gm = m0 + lrow;
    if (gm < m) {
      load8(x + (size_t)gm * k + k0 + lk, xv);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) xv[j] = 0.f;
    }
    const int gn = n0 + lrow;
    if (gn < n) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(q + (size_t)gn * k + k0 + lk));
      const int8_t* qb = reinterpret_cast<const int8_t*>(&u);
      const float sc = __half2float(d[(size_t)gn * nb + k0 / 32]);
#pragma unroll
      for (int j = 0; j < 8; ++j) wv[j] = round_to((float)qb[j] * sc, x);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) wv[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      As[lk + j][lrow] = xv[j];
      Bs[lk + j][lrow] = wv[j];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float a[TM] = {a4.x, a4.y, a4.z, a4.w};
      const float b[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < n) out[(size_t)gm * n + gn] = acc[i][j];
    }
  }
}

template <typename T>
void launch(const T* x, const int8_t* q, const __half* d, float* out, int m, int n, int k,
            cudaStream_t s) {
  if (m <= 8) {
    const dim3 grid((n + GEMV_WARPS * GEMV_COLS - 1) / (GEMV_WARPS * GEMV_COLS));
    const dim3 block(GEMV_WARPS * 32);
    switch (m) {
      case 1: q40_gemv_kernel<T, 1><<<grid, block, 0, s>>>(x, q, d, out, n, k); break;
      case 2: q40_gemv_kernel<T, 2><<<grid, block, 0, s>>>(x, q, d, out, n, k); break;
      case 3: q40_gemv_kernel<T, 3><<<grid, block, 0, s>>>(x, q, d, out, n, k); break;
      case 4: q40_gemv_kernel<T, 4><<<grid, block, 0, s>>>(x, q, d, out, n, k); break;
      case 5: q40_gemv_kernel<T, 5><<<grid, block, 0, s>>>(x, q, d, out, n, k); break;
      case 6: q40_gemv_kernel<T, 6><<<grid, block, 0, s>>>(x, q, d, out, n, k); break;
      case 7: q40_gemv_kernel<T, 7><<<grid, block, 0, s>>>(x, q, d, out, n, k); break;
      default: q40_gemv_kernel<T, 8><<<grid, block, 0, s>>>(x, q, d, out, n, k); break;
    }
  } else {
    const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
    q40_gemm_kernel<T><<<grid, 256, 0, s>>>(x, q, d, out, m, n, k);
  }
}

}  // namespace

// x [m, k] (bf16 when x_bf16 else f32), q int8 [n, k], d f16 [n, k/32],
// out f32 [m, n]; all contiguous, k a multiple of 32. Returns cudaGetLastError().
extern "C" int q40_matmul(const void* x, const void* q, const void* d, void* out, int m, int n,
                          int k, int x_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    launch(static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
           static_cast<const __half*>(d), static_cast<float*>(out), m, n, k, s);
  } else {
    launch(static_cast<const float*>(x), static_cast<const int8_t*>(q),
           static_cast<const __half*>(d), static_cast<float*>(out), m, n, k, s);
  }
  return static_cast<int>(cudaGetLastError());
}
