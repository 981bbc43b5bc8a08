// Q40 weight-only matrix product for Hopper (sm_90a), shared by the two
// weight layouts: q40_matmul.cu (one int8 value a weight) and
// q40i4_matmul.cu (two nibbles a byte). The weight fetch is a template
// parameter; everything else, and so every rounding and the order of every
// sum, is the same code, so the two kernels give the same bits on the same
// values.
//
// Replaces the TPU kernels dllama_tpu/ops/quant_matmul.py qmatmul_2d
// (_qmm_kernel) and qmatmul_i4_2d (_qmm_i4_kernel):
// out[m, n] = sum_k x[m, k] * W[n, k] with W[n, k] = q[n, k] * d[n, k / 32],
// dequantized on the fly, summed in f32.
//
// Layout: the .m file's own rows, d f16 [n, k / 32] and the values either
// int8 [n, k] in [-8, 7] (1.0625 B per weight) or packed uint8 [n, k / 2]
// (0.5625 B per weight), where byte j of a block's 16 holds element j in
// its low nibble and j + 16 in its high one, each as value + 8 (the file's
// Q40 block without its scale). Roundings: W is formed exactly in f32 (an
// f16 scale times a 4-bit value fits its mantissa) and rounded to x's type,
// so for bfloat16 x the kernels round where the TPU kernels do (x and the
// dequantized tile in bf16) and for float32 x nothing is rounded. The plain
// version (ops/quant_matmul.qmatmul_ref) applies the same roundings, so it
// and the kernels differ only in summation order.
//
// Bound on an H100: decode (m = 1) reads every weight byte once and does
// 2 flops per weight (3.6 and 1.9 flops a byte for the two layouts), far
// below the ~295 flops per byte where the tensor cores become the limit, so
// it is bound by bytes (weights over 3.35 TB/s). The GEMV path (m <= 8)
// gives each warp two output columns; each lane takes whole 32-value blocks
// (two 16-byte loads int8, one packed), so a warp reads 1024 or 512
// contiguous weight bytes a column a step, and every weight byte is read
// once a launch. Prefill (m up to 512) is a plain shared-memory tiled
// product in f32 FMA on CUDA cores (64 x 64 tile, 4 x 4 outputs a thread):
// simple and right, and far below the tensor-core peak (wgmma is later work).
#pragma once

#include "common.cuh"

namespace dllama {
namespace q40 {

// One int8 value a weight: a row is k bytes.
struct Int8Values {
  static constexpr int ROW_DIV = 1;  // k / row bytes
  // the 32 values of block b of a row
  __device__ static __forceinline__ void block(const uint8_t* row, int b, float (&v)[32]) {
    const uint4* p = reinterpret_cast<const uint4*>(row) + 2 * b;
    const uint4 u0 = __ldg(p), u1 = __ldg(p + 1);
    const int8_t* a = reinterpret_cast<const int8_t*>(&u0);
    const int8_t* c = reinterpret_cast<const int8_t*>(&u1);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      v[i] = (float)a[i];
      v[16 + i] = (float)c[i];
    }
  }
  // values k0 + lk .. k0 + lk + 7 of a row (k0 a multiple of 32, lk of 8)
  __device__ static __forceinline__ void eight(const uint8_t* row, int k0, int lk, float (&v)[8]) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(row + k0 + lk));
    const int8_t* a = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = (float)a[j];
  }
};

// Two nibbles a byte: a row is k / 2 bytes, one 16-byte load a block.
struct PackedNibbles {
  static constexpr int ROW_DIV = 2;
  __device__ static __forceinline__ void block(const uint8_t* row, int b, float (&v)[32]) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(row) + b);
    const uint8_t* p = reinterpret_cast<const uint8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      v[i] = (float)((int)(p[i] & 0xF) - 8);
      v[16 + i] = (float)((int)(p[i] >> 4) - 8);
    }
  }
  // elements lk .. lk + 7 of the block at k0: the low nibbles of bytes
  // lk .. lk + 7 for lk < 16, the high nibbles of bytes lk - 16 .. for lk >= 16
  __device__ static __forceinline__ void eight(const uint8_t* row, int k0, int lk, float (&v)[8]) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(row + k0 / 2 + (lk & 15)));
    const uint8_t* p = reinterpret_cast<const uint8_t*>(&u);
    const int shift = lk >= 16 ? 4 : 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = (float)((int)((p[j] >> shift) & 0xF) - 8);
  }
};

constexpr int GEMV_WARPS = 4;  // warps per block
constexpr int GEMV_COLS = 2;   // output columns per warp

template <typename W, typename T, int M>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
gemv_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
            const __half* __restrict__ d, float* __restrict__ out, int n, int k) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = (blockIdx.x * GEMV_WARPS + warp) * GEMV_COLS;
  if (col0 >= n) return;
  const int nb = k / 32;
  const size_t row_bytes = (size_t)k / W::ROW_DIV;
  float acc[M][GEMV_COLS];
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int c = 0; c < GEMV_COLS; ++c) acc[r][c] = 0.f;

  for (int b = lane; b < nb; b += 32) {
    float w[GEMV_COLS][32];
#pragma unroll
    for (int c = 0; c < GEMV_COLS; ++c) {
      const int col = col0 + c;
      if (col < n) {
        W::block(q + col * row_bytes, b, w[c]);
        const float sc = __half2float(d[(size_t)col * nb + b]);
#pragma unroll
        for (int i = 0; i < 32; ++i) w[c][i] = round_to(w[c][i] * sc, x);
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) w[c][i] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < M; ++r) {
      float xv[4][8];
      const T* xp = x + (size_t)r * k + b * 32;
#pragma unroll
      for (int h = 0; h < 4; ++h) load8(xp + 8 * h, xv[h]);
#pragma unroll
      for (int c = 0; c < GEMV_COLS; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[r][c] = fmaf(xv[i / 8][i % 8], w[c][i], acc[r][c]);
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

constexpr int BM = 64, BN = 64, BK = 32, TM = 4, TN = 4;  // 256 threads; BK is one block

template <typename W, typename T>
__global__ void __launch_bounds__(256)
gemm_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
            const __half* __restrict__ d, float* __restrict__ out, int m, int n, int k) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int lrow = tid / 4;        // tile row this thread loads (0..63)
  const int lk = (tid % 4) * 8;    // its 8 consecutive k values
  const int nb = k / 32;
  const size_t row_bytes = (size_t)k / W::ROW_DIV;
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
      W::eight(q + gn * row_bytes, k0, lk, wv);
      const float sc = __half2float(d[(size_t)gn * nb + k0 / 32]);
#pragma unroll
      for (int j = 0; j < 8; ++j) wv[j] = round_to(wv[j] * sc, x);
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

template <typename W, typename T>
void launch(const T* x, const uint8_t* q, const __half* d, float* out, int m, int n, int k,
            cudaStream_t s) {
  if (m <= 8) {
    const dim3 grid((n + GEMV_WARPS * GEMV_COLS - 1) / (GEMV_WARPS * GEMV_COLS));
    const dim3 block(GEMV_WARPS * 32);
    switch (m) {
      case 1: gemv_kernel<W, T, 1><<<grid, block, 0, s>>>(x, q, d, out, n, k); break;
      case 2: gemv_kernel<W, T, 2><<<grid, block, 0, s>>>(x, q, d, out, n, k); break;
      case 3: gemv_kernel<W, T, 3><<<grid, block, 0, s>>>(x, q, d, out, n, k); break;
      case 4: gemv_kernel<W, T, 4><<<grid, block, 0, s>>>(x, q, d, out, n, k); break;
      case 5: gemv_kernel<W, T, 5><<<grid, block, 0, s>>>(x, q, d, out, n, k); break;
      case 6: gemv_kernel<W, T, 6><<<grid, block, 0, s>>>(x, q, d, out, n, k); break;
      case 7: gemv_kernel<W, T, 7><<<grid, block, 0, s>>>(x, q, d, out, n, k); break;
      default: gemv_kernel<W, T, 8><<<grid, block, 0, s>>>(x, q, d, out, n, k); break;
    }
  } else {
    const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
    gemm_kernel<W, T><<<grid, 256, 0, s>>>(x, q, d, out, m, n, k);
  }
}

// x [m, k] (bf16 when x_bf16 else f32), q the weight's values (layout W),
// d f16 [n, k/32], out f32 [m, n]; all contiguous, k a multiple of 32.
// Returns cudaGetLastError().
template <typename W>
int run(const void* x, const void* q, const void* d, void* out, int m, int n, int k, int x_bf16,
        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* qb = static_cast<const uint8_t*>(q);
  const __half* dh = static_cast<const __half*>(d);
  float* o = static_cast<float*>(out);
  if (x_bf16) {
    launch<W>(static_cast<const __nv_bfloat16*>(x), qb, dh, o, m, n, k, s);
  } else {
    launch<W>(static_cast<const float*>(x), qb, dh, o, m, n, k, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace q40
}  // namespace dllama
