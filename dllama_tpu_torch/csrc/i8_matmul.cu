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
// The GEMV path (m <= 8) gives each warp two output columns and each lane
// 16-byte loads, four __dp4a a load; a group of G inputs is G / 16 lanes
// (for G <= 512; more groups a pass below 512, a loop above), reduced in
// int32 by shuffles, so a warp reads 512 contiguous bytes a column a step.
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

#include "wgmma.cuh"

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
    CUtensorMap mx, mq;
    if (!map_rows(&mx, xq, m, k, TM) || !map_rows(&mq, q, n, k, TN))
      return static_cast<int>(cudaErrorInvalidValue);
    cudaFuncSetAttribute(i8_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
    const dim3 grid((m + TM - 1) / TM, (n + TN - 1) / TN);
    i8_wgmma_kernel<<<grid, TC_THREADS, TC_SMEM, st>>>(mx, mq, xs, ws, o, m, n, k, group);
  }
  return static_cast<int>(cudaGetLastError());
}
