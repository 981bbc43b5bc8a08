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
// integer operations a weight, so it is bound by bytes (over 3.35 TB/s);
// at m = 512 the 1,979 TOP/s int8 tensor-core rate and the bytes are
// close. The GEMV path (m <= 8) gives each warp two output columns and
// each lane 16-byte loads, four __dp4a a load; a group of G inputs is
// G / 16 lanes (for G <= 512; more groups a pass below 512, a loop above),
// reduced in int32 by shuffles, so a warp reads 512 contiguous bytes a
// column a step. Prefill (m > 8) is a SIMT tiled product (64 x 64 tile, 32
// bytes of k a step, 4 x 4 outputs a thread, __dp4a on int32 words in
// shared memory) that scales its int32 sums at each group's end: simple and
// right, far below the int8 tensor-core peak (mma / wgmma is later work).

#include "common.cuh"

using namespace dllama;

namespace {

constexpr int GEMV_WARPS = 4;  // warps per block
constexpr int GEMV_COLS = 2;   // output columns per warp

__device__ __forceinline__ int dot16(const int4 a, const int4 b, int c) {
  c = __dp4a(a.x, b.x, c);
  c = __dp4a(a.y, b.y, c);
  c = __dp4a(a.z, b.z, c);
  return __dp4a(a.w, b.w, c);
}

template <int M>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
i8_gemv_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
               const int8_t* __restrict__ q, const float* __restrict__ s,
               float* __restrict__ out, int n, int k, int group) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = (blockIdx.x * GEMV_WARPS + warp) * GEMV_COLS;
  if (col0 >= n) return;
  const int ng = k / group, cpg = group / 16;  // 16-byte chunks a group
  const int lanes = (32 % cpg == 0) ? cpg : 32;  // lanes a group (a power of 2)
  const int gi = lane / lanes, ci = lane % lanes;
  float acc[M][GEMV_COLS];
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int c = 0; c < GEMV_COLS; ++c) acc[r][c] = 0.f;

  for (int g0 = 0; g0 < ng; g0 += 32 / lanes) {
    const int g = g0 + gi;
    int idot[M][GEMV_COLS];
#pragma unroll
    for (int r = 0; r < M; ++r)
#pragma unroll
      for (int c = 0; c < GEMV_COLS; ++c) idot[r][c] = 0;
    if (g < ng) {
      for (int ch = ci; ch < cpg; ch += lanes) {
        const size_t off = (size_t)g * group + ch * 16;
        int4 wv[GEMV_COLS];
#pragma unroll
        for (int c = 0; c < GEMV_COLS; ++c) {
          const int col = col0 + c;
          wv[c] = col < n ? __ldg(reinterpret_cast<const int4*>(q + (size_t)col * k + off))
                          : make_int4(0, 0, 0, 0);
        }
#pragma unroll
        for (int r = 0; r < M; ++r) {
          const int4 xv = __ldg(reinterpret_cast<const int4*>(xq + (size_t)r * k + off));
#pragma unroll
          for (int c = 0; c < GEMV_COLS; ++c) idot[r][c] = dot16(xv, wv[c], idot[r][c]);
        }
      }
    }
    // each group's exact int32 dot over its lanes, scaled once, then the
    // pass's groups added to the sum one by one, in group order
#pragma unroll
    for (int r = 0; r < M; ++r)
#pragma unroll
      for (int c = 0; c < GEMV_COLS; ++c) {
        int v = idot[r][c];
        for (int o = lanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
        const int col = col0 + c;
        const float f = (g < ng && col < n)
                            ? __fmul_rn((float)v, sx[(size_t)r * ng + g] * s[(size_t)col * ng + g])
                            : 0.f;
        for (int j = 0; j < 32; j += lanes) {
          const float fj = __shfl_sync(FULL_MASK, f, j);
          if (g0 + j / lanes < ng) acc[r][c] += fj;
        }
      }
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < M; ++r)
#pragma unroll
      for (int c = 0; c < GEMV_COLS; ++c)
        if (col0 + c < n) out[(size_t)r * n + col0 + c] = acc[r][c];
  }
}

constexpr int BM = 64, BN = 64, BK = 32, TM = 4, TN = 4;  // 256 threads; BK bytes of k
constexpr int BKW = BK / 4;  // int32 words of k a tile

__global__ void __launch_bounds__(256)
i8_gemm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
               const int8_t* __restrict__ q, const float* __restrict__ s,
               float* __restrict__ out, int m, int n, int k, int group) {
  __shared__ __align__(16) int As[BKW][BM + 4];
  __shared__ __align__(16) int Bs[BKW][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int lrow = tid / 4;      // tile row this thread loads (0..63)
  const int lw = (tid % 4) * 2;  // its two words of k
  const int ng = k / group;
  float acc[TM][TN];
  int iacc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc[i][j] = 0.f;
      iacc[i][j] = 0;
    }

  for (int k0 = 0; k0 < k; k0 += BK) {
    const int gm = m0 + lrow, gn = n0 + lrow;
    const int2 xa = gm < m ? __ldg(reinterpret_cast<const int2*>(xq + (size_t)gm * k + k0) + lw / 2)
                           : make_int2(0, 0);
    const int2 wb = gn < n ? __ldg(reinterpret_cast<const int2*>(q + (size_t)gn * k + k0) + lw / 2)
                           : make_int2(0, 0);
    As[lw][lrow] = xa.x;
    As[lw + 1][lrow] = xa.y;
    Bs[lw][lrow] = wb.x;
    Bs[lw + 1][lrow] = wb.y;
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < BKW; ++kw) {
      const int4 a4 = *reinterpret_cast<const int4*>(&As[kw][ty * TM]);
      const int4 b4 = *reinterpret_cast<const int4*>(&Bs[kw][tx * TN]);
      const int a[TM] = {a4.x, a4.y, a4.z, a4.w};
      const int b[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) iacc[i][j] = __dp4a(a[i], b[j], iacc[i][j]);
    }
    __syncthreads();
    if ((k0 + BK) % group == 0) {  // the end of group g: scale its exact sums once
      const int g = k0 / group;
      float sa[TM], sb[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = m0 + ty * TM + i;
        sa[i] = r < m ? sx[(size_t)r * ng + g] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = n0 + tx * TN + j;
        sb[j] = c < n ? s[(size_t)c * ng + g] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] += __fmul_rn((float)iacc[i][j], sa[i] * sb[j]);
          iacc[i][j] = 0;
        }
    }
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
    const dim3 grid((n + GEMV_WARPS * GEMV_COLS - 1) / (GEMV_WARPS * GEMV_COLS));
    const dim3 block(GEMV_WARPS * 32);
    switch (m) {
      case 1: i8_gemv_kernel<1><<<grid, block, 0, st>>>(x8, xs, w8, ws, o, n, k, group); break;
      case 2: i8_gemv_kernel<2><<<grid, block, 0, st>>>(x8, xs, w8, ws, o, n, k, group); break;
      case 3: i8_gemv_kernel<3><<<grid, block, 0, st>>>(x8, xs, w8, ws, o, n, k, group); break;
      case 4: i8_gemv_kernel<4><<<grid, block, 0, st>>>(x8, xs, w8, ws, o, n, k, group); break;
      case 5: i8_gemv_kernel<5><<<grid, block, 0, st>>>(x8, xs, w8, ws, o, n, k, group); break;
      case 6: i8_gemv_kernel<6><<<grid, block, 0, st>>>(x8, xs, w8, ws, o, n, k, group); break;
      case 7: i8_gemv_kernel<7><<<grid, block, 0, st>>>(x8, xs, w8, ws, o, n, k, group); break;
      default: i8_gemv_kernel<8><<<grid, block, 0, st>>>(x8, xs, w8, ws, o, n, k, group); break;
    }
  } else {
    const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
    i8_gemm_kernel<<<grid, 256, 0, st>>>(x8, xs, w8, ws, o, m, n, k, group);
  }
  return static_cast<int>(cudaGetLastError());
}
