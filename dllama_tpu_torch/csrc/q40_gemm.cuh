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
// once a launch.
//
// Prefill with bfloat16 x (m > 8; 512 rows a chunk) does 2m flops a weight,
// ~900 flops a byte at m = 512, above the ridge: it is bound by operations
// (989 TFLOP/s bf16), which only the tensor cores reach. The tile
// (`wgmma_kernel`) computes the transposed product out^T = W . x^T with
// wgmma m64n64k16: the dequantized weight is operand A, which wgmma takes
// from registers, so each warpgroup turns its 64 weight rows' raw bytes and
// scales into bf16 fragments in registers (exact f32 product, one
// round-to-nearest-even) and the bf16 weight never goes through memory; x
// is operand B, read from shared memory in its own k-contiguous rows, in
// wgmma's 128-byte swizzle. A block is two warpgroups (128 weight rows)
// over 64 * NT rows of x, NT in {1, 2, 4} picked by m and n (`pick_nt`).
// Raw weight bytes and x tiles stream through a 4-stage cp.async ring (64 k
// a stage, two stages in flight ahead of the consumer); the scales come two
// stages ahead into registers. Each stage's fragments are built while the
// previous stage's wgmma group runs (two fragment buffers, wgmma.wait_group
// 1), with no int-to-float conversion (`nibble_value`). Each weight element
// is dequantized once a block, so m / (64 NT) times a launch (twice at
// m = 512, n = 14336). The output fragments are stored straight from
// registers: the eight lanes that share a column of out^T hold eight
// consecutive floats of a row of out, so every store fills whole 32-byte
// sectors. What holds it at ~3x the operations bound (PERF.md) is the
// fixed work of a stage (barrier, copies issued by the consumers
// themselves, dequantization), which a producer warp feeding cp.async
// could not take over fast enough (measured slower); TMA copies would.
// f32 x keeps the f32-FMA tile on CUDA cores (`gemm_kernel`, 64 x 64,
// 4 x 4 outputs a thread): no tensor-core type holds f32 exactly.
#pragma once

#include "wgmma.cuh"

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
  // the eight values of a block (32 bytes, in shared memory) that lane t of
  // a quad holds in a wgmma A fragment row, as value + 8 in the low nibble
  // of each byte: u[0] elements 2t, 2t + 1, 2t + 8, 2t + 9 (first k16
  // step), u[1] those + 16 (second). (q & 15) ^ 8 is q + 8 for q in [-8, 7].
  __device__ static __forceinline__ void frag(const uint8_t* blk, int t, uint32_t (&u)[2]) {
    const uint16_t* p = reinterpret_cast<const uint16_t*>(blk) + t;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      u[h] = (__byte_perm(p[8 * h], p[8 * h + 4], 0x5410) & 0x0F0F0F0Fu) ^ 0x08080808u;
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
  // Int8Values::frag from a 16-byte block: bytes 2t, 2t + 1, 2t + 8, 2t + 9
  // hold the first four values in their low nibbles and the last four in
  // their high ones
  __device__ static __forceinline__ void frag(const uint8_t* blk, int t, uint32_t (&u)[2]) {
    const uint16_t* p = reinterpret_cast<const uint16_t*>(blk) + t;
    const uint32_t w = __byte_perm(p[0], p[4], 0x5410);
    u[0] = w & 0x0F0F0F0Fu;
    u[1] = (w >> 4) & 0x0F0F0F0Fu;
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

// ---- the bf16 prefill tile on tensor cores (see the note at the top) ----

constexpr int TC_ROWS = 128;  // weight rows a block: two warpgroups of 64
constexpr int TC_BK = 64;     // k a stage: two Q40 blocks, four k16 steps
constexpr int TC_STAGES = 4;  // cp.async ring; TC_STAGES - 2 stages in flight ahead
constexpr int TC_THREADS = 256;
constexpr int NUM_SMS = 132;  // H100 SXM

// Weight bytes a row a stage, and their row stride in shared memory: 16
// bytes of padding put the eight rows a fragment load touches on distinct
// banks.
template <typename W> __host__ __device__ constexpr int tc_row_bytes() {
  return TC_BK / W::ROW_DIV;
}
template <typename W> __host__ __device__ constexpr int tc_row_stride() {
  return tc_row_bytes<W>() + 16;
}
// x rows (NT * 64) of a stage, 128 bytes (64 k) each, in wgmma's 128-byte
// swizzle: 16-byte chunk c of row r at r * 128 + (c ^ (r % 8)) * 16, so the
// eight rows of a core matrix lie on distinct banks
template <int NT> __host__ __device__ constexpr int tc_x_bytes() {
  return NT * 64 * TC_BK * 2;
}
template <typename W, int NT> __host__ __device__ constexpr int tc_stage_bytes() {
  return tc_x_bytes<NT>() + TC_ROWS * tc_row_stride<W>();
}

// keep the compiler from moving accumulator accesses across wgmma issue/wait
template <int NT> __device__ __forceinline__ void fence_acc(float (&acc)[NT][32]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) fence_regs(acc[j]);
}

// byte i of u (a value + 8 in [0, 15]) as the float value: its bits placed
// under the exponent of 2^23 give 2^23 + u exactly, and one exact subtraction
// leaves u - 8 (a byte permute and an add, no int-to-float conversion)
__device__ __forceinline__ float nibble_value(uint32_t u, int i) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 | i)) - 8388616.f;
}

template <typename W, int NT>
struct TcTile {
  const __nv_bfloat16* x;
  const uint8_t* q;
  const __half* d;
  int m, n, k, m0, n0;
  uint8_t* smem;

  // cp.async of stage kt (k columns kt * 64 ..) into ring slot `slot`
  __device__ __forceinline__ void load(int kt, int slot) const {
    uint8_t* xs = smem + slot * tc_stage_bytes<W, NT>();
    uint8_t* ws = xs + tc_x_bytes<NT>();
    const int tid = threadIdx.x;
    // x: NT * 512 chunks of 8 values; a quarter warp copies one row
#pragma unroll
    for (int j = 0; j < NT * 2; ++j) {
      const int i = tid + TC_THREADS * j;
      const int r = i >> 3, c = i & 7;
      const int row = m0 + r, col = kt * TC_BK + c * 8;
      const bool ok = row < m && col < k;
      cp_async16(smem_addr(xs + sw128(r, c)),
                 ok ? x + (size_t)row * k + col : x, ok);
    }
    // raw weight bytes: TC_ROWS rows of tc_row_bytes
    constexpr int CH = tc_row_bytes<W>() / 16;
    const size_t row_bytes = (size_t)k / W::ROW_DIV;
#pragma unroll
    for (int j = 0; j < TC_ROWS * CH / TC_THREADS; ++j) {
      const int i = tid + TC_THREADS * j;
      const int r = i / CH, c = i % CH;
      const bool ok = n0 + r < n && kt * TC_BK + c * 16 * W::ROW_DIV < k;
      const uint8_t* src = q + (size_t)(n0 + r) * row_bytes + kt * tc_row_bytes<W>() + c * 16;
      cp_async16(smem_addr(ws + r * tc_row_stride<W>() + c * 16), ok ? src : q, ok);
    }
  }

  // the scales of this thread's two fragment rows for the two blocks of stage kt
  __device__ __forceinline__ void scales(int kt, int row, float (&sc)[2][2]) const {
    const int nb = k / 32;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int gn = n0 + row + 8 * h, blk = kt * 2 + b;
        sc[h][b] = gn < n && blk < nb ? __half2float(__ldg(d + (size_t)gn * nb + blk)) : 0.f;
      }
  }
};

// One stage: wait for its bytes, refill the slot two stages back, build the
// A fragments in buffer BUF, issue its 4 * NT wgmmas, and wait for the
// previous stage's group (which read the other buffer).
template <typename W, int NT, int BUF>
__device__ __forceinline__ void tc_stage(const TcTile<W, NT>& tile, int kt, int nst, int row,
                                         int t, float (&sc)[2][2][2], uint32_t (&a)[2][4][4],
                                         float (&acc)[NT][32]) {
  constexpr int S = TC_STAGES;
  cp_async_wait<S - 3>();
  fence_proxy_async();  // cp.async bytes -> wgmma
  __syncthreads();
  if (kt + S - 2 < nst) tile.load(kt + S - 2, (kt + S - 2) % S);
  cp_async_commit();

  const uint8_t* xs = tile.smem + (kt % S) * tc_stage_bytes<W, NT>();
  const uint8_t* ws = xs + tc_x_bytes<NT>();
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    float v[2][8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t u[2];
      W::frag(ws + (row + 8 * h) * tc_row_stride<W>() + b * (32 / W::ROW_DIV), t, u);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[h][j] = nibble_value(u[j / 4], j % 4) * sc[BUF][h][b];  // exact in f32
    }
    // k16 steps 2b (elements 0..15 of the block) and 2b + 1 (16..31)
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      a[BUF][2 * b + s][0] = pack_bf16(v[0][4 * s], v[0][4 * s + 1]);
      a[BUF][2 * b + s][1] = pack_bf16(v[1][4 * s], v[1][4 * s + 1]);
      a[BUF][2 * b + s][2] = pack_bf16(v[0][4 * s + 2], v[0][4 * s + 3]);
      a[BUF][2 * b + s][3] = pack_bf16(v[1][4 * s + 2], v[1][4 * s + 3]);
    }
  }
  tile.scales(kt + 2, row, sc[BUF]);  // two stages ahead, into the buffer just read

  // k16 step s starts 32 bytes into each swizzled row; x rows 64 j .. at 8 KB j
  // (one wgmma N = 64 a j: as fast as one of N = 64 NT, measured)
  const uint32_t xa = smem_addr(xs);
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      wgmma_m64n64k16(acc[j], a[BUF][s], wgmma_desc_sw128(xa + j * 8192 + s * 32));
  wgmma_commit();
  wgmma_wait<1>();
  fence_acc(acc);
}

// out [m, n] f32 = x [m, k] bf16 . W^T: block (blockIdx.x, blockIdx.y) takes
// x rows 64 NT blockIdx.x .. and weight rows 128 blockIdx.y ..; warpgroup
// wg of the block its 64 weight rows 64 wg ..
template <typename W, int NT>
__global__ void __launch_bounds__(TC_THREADS, 1)
wgmma_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
             const __half* __restrict__ d, float* __restrict__ out, int m, int n, int k) {
  extern __shared__ __align__(1024) uint8_t tc_smem[];
  const TcTile<W, NT> tile{x, q, d, m, n, k, (int)blockIdx.x * NT * 64,
                           (int)blockIdx.y * TC_ROWS, tc_smem};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row = (warp >> 2) * 64 + (warp & 3) * 16 + g;  // this thread's first fragment row
  const int nst = (k + TC_BK - 1) / TC_BK;

  float acc[NT][32];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
  uint32_t a[2][4][4];
  float sc[2][2][2];  // [stage parity][fragment row][block]

#pragma unroll
  for (int s = 0; s < TC_STAGES - 2; ++s) {
    if (s < nst) tile.load(s, s);
    cp_async_commit();
  }
  tile.scales(0, row, sc[0]);
  tile.scales(1, row, sc[1]);
  for (int kt = 0; kt < nst; kt += 2) {
    tc_stage<W, NT, 0>(tile, kt, nst, row, t, sc, a, acc);
    if (kt + 1 < nst) tc_stage<W, NT, 1>(tile, kt + 1, nst, row, t, sc, a, acc);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // acc[j][i]: weight row `row` + 8 ((i >> 1) & 1), x row 64 j + 8 (i >> 2) + 2 t + (i & 1)
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int gn = tile.n0 + row + 8 * ((i >> 1) & 1);
      const int gm = tile.m0 + 64 * j + 8 * (i >> 2) + 2 * t + (i & 1);
      if (gm < m && gn < n) out[(size_t)gm * n + gn] = acc[j][i];
    }
}

// Of NT = 4, 2, 1: the widest that m needs whose grid has at least 3/4 of
// a block an SM; else 1, the most blocks. A wider tile dequantizes each
// weight element fewer times, which at m = 512 n = 4096 beats a second
// wave of narrower blocks (128 blocks of NT 2: 0.072 ms, 256 of NT 1:
// 0.095 ms on an H100). A weight of few rows (n = 1024: 64 blocks at m =
// 512) leaves SMs idle: filling them would take a split of k and a second
// pass over a scratch buffer.
constexpr int TC_MIN_BLOCKS = NUM_SMS * 3 / 4;
inline int pick_nt(int m, int n) {
  const int row_tiles = (n + TC_ROWS - 1) / TC_ROWS;
  int nt = 4;
  while (nt > 1 &&
         (64 * (nt / 2) >= m || (m + 64 * nt - 1) / (64 * nt) * row_tiles < TC_MIN_BLOCKS))
    nt /= 2;
  return nt;
}

template <typename W, int NT>
void launch_tc(const __nv_bfloat16* x, const uint8_t* q, const __half* d, float* out, int m,
               int n, int k, cudaStream_t s) {
  constexpr int smem = TC_STAGES * tc_stage_bytes<W, NT>();
  cudaFuncSetAttribute(wgmma_kernel<W, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((m + NT * 64 - 1) / (NT * 64), (n + TC_ROWS - 1) / TC_ROWS);
  wgmma_kernel<W, NT><<<grid, TC_THREADS, smem, s>>>(x, q, d, out, m, n, k);
}

// the m > 8 product: tensor cores for bf16 x, the f32-FMA tile for f32 x
template <typename W>
void launch_tile(const __nv_bfloat16* x, const uint8_t* q, const __half* d, float* out, int m,
                 int n, int k, cudaStream_t s) {
  switch (pick_nt(m, n)) {
    case 4: launch_tc<W, 4>(x, q, d, out, m, n, k, s); break;
    case 2: launch_tc<W, 2>(x, q, d, out, m, n, k, s); break;
    default: launch_tc<W, 1>(x, q, d, out, m, n, k, s); break;
  }
}
template <typename W>
void launch_tile(const float* x, const uint8_t* q, const __half* d, float* out, int m, int n,
                 int k, cudaStream_t s) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  gemm_kernel<W, float><<<grid, 256, 0, s>>>(x, q, d, out, m, n, k);
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
    launch_tile<W>(x, q, d, out, m, n, k, s);
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
