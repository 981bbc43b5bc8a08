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
// it is bound by bytes (weights over 3.35 TB/s). What the CUDA-core GEMV it
// replaced spent instead was instructions: an int-to-float conversion and a
// bf16 round trip a weight, then an f32 FMA a weight for each x row, so
// its time grew with m for the same bytes. The bf16 GEMV (m <= 8,
// `gemv_mma_kernel`) makes the weight the A operand of mma.sync m16n8k16
// and the <= 8 x rows its N = 8 columns (rows past m are zero and never
// stored), so the per-weight work is the same at m = 8 as at 1: each warp
// takes 16 weight rows, each lane 16-byte loads that give it 16 values of
// a 64-value block pair (both layouts take the same values to the same
// lanes), dequantized with no conversion in bf16x2 arithmetic that rounds
// each weight once, as the f32 product rounded to bf16 would
// (`weight_pair`), and x read through L1 in the same k order. The
// weights stream past L1 (`ldg_stream`), four block pairs a warp in
// flight. A block's 4 to 16 warps (more for fewer rows) split k; warp 0 adds
// their sums in warp order: no atomics, no scratch, bits that repeat. f32
// x keeps the CUDA-core GEMV (`gemv_kernel`, two output columns a warp):
// no tensor-core type holds f32 exactly. Where it misses its bound (about
// half of it at m = 1, k = 4096, n = 14336 on an H100, PERF.md): the rate
// device memory gives this pattern of 64-byte row pieces (~2 TB/s), and
// for the small weights a fixed cost a launch; per-row bulk copies
// through shared memory were slower but at the classifier.
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

// 16 bytes of a weight stream, read once: not kept in L1, where x stays
__device__ __forceinline__ uint4 ldg_stream(const void* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
  return r;
}

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
  // the GEMV's fetch: lane t of a quad takes elements 16 (t % 2) .. + 15 of
  // block 2 p + t / 2 of a row (the 16 bytes at 64 p + 16 t)
  __device__ static __forceinline__ uint4 pair_bytes(const uint8_t* row, int p, int t) {
    return ldg_stream(row + 64 * p + 16 * t);
  }
  // those sixteen values as value + 8 in the low nibble of each byte, four a word
  __device__ static __forceinline__ void pair_nibbles(uint4 b, int, uint32_t (&u)[4]) {
    u[0] = (b.x & 0x0F0F0F0Fu) ^ 0x08080808u;
    u[1] = (b.y & 0x0F0F0F0Fu) ^ 0x08080808u;
    u[2] = (b.z & 0x0F0F0F0Fu) ^ 0x08080808u;
    u[3] = (b.w & 0x0F0F0F0Fu) ^ 0x08080808u;
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
  // Int8Values::pair_bytes from packed blocks: the whole 16-byte block 2 p + t / 2 ...
  __device__ static __forceinline__ uint4 pair_bytes(const uint8_t* row, int p, int t) {
    return ldg_stream(row + 32 * p + 16 * (t >> 1));  // lanes 2j and 2j + 1: the same bytes
  }
  // ... whose low nibbles are elements 0 .. 15 and high nibbles 16 .. 31
  __device__ static __forceinline__ void pair_nibbles(uint4 b, int t, uint32_t (&u)[4]) {
    const int sh = 4 * (t & 1);
    u[0] = (b.x >> sh) & 0x0F0F0F0Fu;
    u[1] = (b.y >> sh) & 0x0F0F0F0Fu;
    u[2] = (b.z >> sh) & 0x0F0F0F0Fu;
    u[3] = (b.w >> sh) & 0x0F0F0F0Fu;
  }
};

constexpr int GEMV_WARPS = 4;  // warps per block
constexpr int GEMV_COLS = 2;   // output columns per warp

// f32 x (m <= 8) on CUDA cores: no tensor-core type holds f32 exactly
template <typename W, int M>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
gemv_kernel(const float* __restrict__ x, const uint8_t* __restrict__ q,
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
        for (int i = 0; i < 32; ++i) w[c][i] *= sc;
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) w[c][i] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < M; ++r) {
      float xv[4][8];
      const float* xp = x + (size_t)r * k + b * 32;
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

// ---- the bf16 GEMV (m <= 8) on mma.sync (see the note at the top) ----

constexpr int MV_UNROLL = 4;  // 64-value block pairs a warp loads before their mmas

// Two weights of the GEMV in bf16 with no conversion: bytes 2 h, 2 h + 1 of
// u (values + 8 in [0, 15]) under the bf16 bits of 128 (0x43uu is 128 + u
// exactly), minus 136, give the values; the f16 scale enters as bf16 hi +
// lo (`split_scale`), so v * lo is exact and fma(v, hi, v * lo) rounds
// v * scale once, to nearest even: the bits of the f32 product rounded to
// bf16 (`pack_bf16`), for four bf16x2 operations a pair.
__device__ __forceinline__ uint32_t weight_pair(uint32_t u, int h, __nv_bfloat162 hi,
                                                __nv_bfloat162 lo) {
  const uint32_t b = __byte_perm(u, 0x43u, h ? 0x4342 : 0x4140);
  const __nv_bfloat162 v =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&b), __float2bfloat162_rn(136.f));
  const __nv_bfloat162 w = __hfma2(v, hi, __hmul2(v, lo));
  return *reinterpret_cast<const uint32_t*>(&w);
}
// an f16 scale as bf16 hi (its f32 bits cut to 16) + lo (the exact rest:
// at most 3 significant bits of the 11), each in both halves
__device__ __forceinline__ void split_scale(__half d, __nv_bfloat162& hi, __nv_bfloat162& lo) {
  const float f = __half2float(d);
  const uint32_t h = __float_as_uint(f) & 0xFFFF0000u;
  const uint32_t l = __float_as_uint(f - __uint_as_float(h)) & 0xFFFF0000u;
  const uint32_t hh = h | (h >> 16), ll = l | (l >> 16);
  hi = *reinterpret_cast<const __nv_bfloat162*>(&hh);
  lo = *reinterpret_cast<const __nv_bfloat162*>(&ll);
}

// out^T[16 weight rows, 8 x rows] of one 64-value block pair: lane (g, t)
// holds the 16 values of weight rows g (wa) and g + 8 (wb) that W's pair
// fetch gives it, with their scales da, db, and x row g's 16 values at the
// same k (xv, zero past m). A k16 step s takes values 4 s .. 4 s + 3 of
// each: the mma's k 2t, 2t + 1, 2t + 8, 2t + 9 stand for these four on both
// sides, so the sum runs over every k of the pair once.
template <typename W>
__device__ __forceinline__ void gemv_pair(uint4 wa, uint4 wb, __half da, __half db,
                                          const uint4 (&xv)[2], int t, float (&acc)[4]) {
  uint32_t ua[4], ub[4];
  W::pair_nibbles(wa, t, ua);
  W::pair_nibbles(wb, t, ub);
  __nv_bfloat162 ha, la, hb, lb;
  split_scale(da, ha, la);
  split_scale(db, hb, lb);
  const uint32_t xw[8] = {xv[0].x, xv[0].y, xv[0].z, xv[0].w, xv[1].x, xv[1].y, xv[1].z, xv[1].w};
#pragma unroll
  for (int st = 0; st < 4; ++st) {
    const uint32_t a[4] = {weight_pair(ua[st], 0, ha, la), weight_pair(ub[st], 0, hb, lb),
                           weight_pair(ua[st], 1, ha, la), weight_pair(ub[st], 1, hb, lb)};
    mma_bf16(acc, a, xw[2 * st], xw[2 * st + 1]);
  }
}

// out [m, n] f32 = x [m <= 8, k] bf16 . W^T: block blockIdx.x takes weight
// rows 16 blockIdx.x .. (mma's M; x rows are its N = 8), its KS warps split
// the block pairs of k in KS contiguous runs, and warp 0 adds their sums in
// warp order. A value of out depends on its own x row and weight row only.
template <typename W, int KS>
__global__ void __launch_bounds__(KS * 32)
gemv_mma_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
                const __half* __restrict__ d, float* __restrict__ out, int m, int n, int k) {
  __shared__ float4 red[KS][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * 16;
  const int nb = k / 32, np = (nb + 1) / 2;  // blocks, block pairs
  const int p0 = warp * np / KS, p1 = (warp + 1) * np / KS;
  const size_t row_bytes = (size_t)k / W::ROW_DIV;
  // rows past n read row n - 1 (their sums are never stored)
  const int ra = min(r0 + g, n - 1), rb = min(r0 + g + 8, n - 1);
  const uint8_t* qa = q + ra * row_bytes;
  const uint8_t* qb = q + rb * row_bytes;
  const __half* da = d + (size_t)ra * nb;
  const __half* db = d + (size_t)rb * nb;
  const bool has_x = g < m;
  const __nv_bfloat16* xr = x + (size_t)(has_x ? g : 0) * k + 16 * t;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};

  for (int p = p0; p < p1; p += MV_UNROLL) {
    uint4 wa[MV_UNROLL], wb[MV_UNROLL], xv[MV_UNROLL][2];
    __half sa[MV_UNROLL], sb[MV_UNROLL];
#pragma unroll
    for (int u = 0; u < MV_UNROLL; ++u) {
      const int pp = p + u, b = 2 * pp + (t >> 1);
      const bool ok = pp < p1 && b < nb;  // an odd nb: the last pair's second block is zero
      const uint4 z = make_uint4(0, 0, 0, 0);
      wa[u] = ok ? W::pair_bytes(qa, pp, t) : z;
      wb[u] = ok ? W::pair_bytes(qb, pp, t) : z;
      sa[u] = ok ? __ldg(da + b) : __ushort_as_half(0);  // a zero scale: a zero weight
      sb[u] = ok ? __ldg(db + b) : __ushort_as_half(0);
      const uint4* xp = reinterpret_cast<const uint4*>(xr + 64 * pp);
      xv[u][0] = ok && has_x ? __ldg(xp) : z;
      xv[u][1] = ok && has_x ? __ldg(xp + 1) : z;
    }
#pragma unroll
    for (int u = 0; u < MV_UNROLL; ++u) gemv_pair<W>(wa[u], wb[u], sa[u], sb[u], xv[u], t, acc);
  }
  red[warp][lane] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  __syncthreads();
  if (warp == 0) {
    float v[4] = {acc[0], acc[1], acc[2], acc[3]};
#pragma unroll
    for (int w = 1; w < KS; ++w) {
      const float4 o = red[w][lane];
      v[0] += o.x;
      v[1] += o.y;
      v[2] += o.z;
      v[3] += o.w;
    }
    // v[i]: weight row r0 + g + 8 (i / 2), x row 2 t + i % 2
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + g + 8 * (i >> 1), xrow = 2 * t + (i & 1);
      if (row < n && xrow < m) out[(size_t)xrow * n + row] = v[i];
    }
  }
}

// Warps a block (k split KS ways): 4, or more while the grid holds fewer
// than 48 warps an SM (w1 / w3 at n = 14336 take 8; wq / wo and the narrow
// wk / wv at n = 1024, qwen3-30b-a3b's n = 512, take 16)
constexpr int MV_MIN_WARPS = 132 * 48;
template <typename W>
void launch_gemv(const __nv_bfloat16* x, const uint8_t* q, const __half* d, float* out, int m,
                 int n, int k, cudaStream_t s) {
  const int tiles = (n + 15) / 16;
  int ks = 4;
  while (ks < 16 && tiles * ks < MV_MIN_WARPS) ks *= 2;
  switch (ks) {
    case 4: gemv_mma_kernel<W, 4><<<tiles, 4 * 32, 0, s>>>(x, q, d, out, m, n, k); break;
    case 8: gemv_mma_kernel<W, 8><<<tiles, 8 * 32, 0, s>>>(x, q, d, out, m, n, k); break;
    default: gemv_mma_kernel<W, 16><<<tiles, 16 * 32, 0, s>>>(x, q, d, out, m, n, k); break;
  }
}
template <typename W>
void launch_gemv(const float* x, const uint8_t* q, const __half* d, float* out, int m, int n,
                 int k, cudaStream_t s) {
  const dim3 grid((n + GEMV_WARPS * GEMV_COLS - 1) / (GEMV_WARPS * GEMV_COLS));
  const dim3 block(GEMV_WARPS * 32);
  switch (m) {
    case 1: gemv_kernel<W, 1><<<grid, block, 0, s>>>(x, q, d, out, n, k); break;
    case 2: gemv_kernel<W, 2><<<grid, block, 0, s>>>(x, q, d, out, n, k); break;
    case 3: gemv_kernel<W, 3><<<grid, block, 0, s>>>(x, q, d, out, n, k); break;
    case 4: gemv_kernel<W, 4><<<grid, block, 0, s>>>(x, q, d, out, n, k); break;
    case 5: gemv_kernel<W, 5><<<grid, block, 0, s>>>(x, q, d, out, n, k); break;
    case 6: gemv_kernel<W, 6><<<grid, block, 0, s>>>(x, q, d, out, n, k); break;
    case 7: gemv_kernel<W, 7><<<grid, block, 0, s>>>(x, q, d, out, n, k); break;
    default: gemv_kernel<W, 8><<<grid, block, 0, s>>>(x, q, d, out, n, k); break;
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
    launch_gemv<W>(x, q, d, out, m, n, k, s);
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
