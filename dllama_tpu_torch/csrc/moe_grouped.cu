// Grouped routed SwiGLU experts for prefill on Hopper (sm_90a).
//
// Replaces the TPU kernels dllama_tpu/ops/moe_kernel.py moe_grouped_experts
// (_grouped_kernel) and moe_grouped_experts_q40 (_grouped_kernel_q40). The
// n * k (token, choice) assignments arrive sorted by expert into runs of
// RUN = 64 rows (ops/moe.py grouped_schedule, torch ops outside the kernel
// as JAX's _grouped_schedule is jnp outside pallas_call): each expert's
// segment starts on a run boundary, so a run belongs to one expert, its
// real rows come first, and each row carries its token (-1 for padding)
// and routing weight. Two grids behind one C entry:
//   1. up:   hidden[rows, F] = round(silu(Xt W1[e]^T) * (Xt W3[e]^T)), x
//            rows gathered by token;
//   2. down: out[rows, D] = w_row * (hidden W2[e]^T).
// The combine back to tokens (out[inv].view(n, k, D).sum(1)) is torch
// outside the kernel, as JAX's .at[t].add is. Roundings as in ops/moe.py:
// W rounded to x's type, f32 products and sums, the hidden rounded to x's
// type before the down projection, the routing weight applied in f32.
// The grid is sized from the shapes alone (ceil(A / RUN) + min(E, A) runs
// for A = n * k); a block past the real run count, read from a device int,
// returns at once, so the host never reads the schedule back (the two-tier
// decode, `--moe-decode-dedup`, sizes the grid by its cap of ceil(A / RUN) +
// cap runs and sets the device count to 0 on a step whose lanes share too
// few experts: every block returns, ops/moe.py `moe_decode_tiers`). No atomics:
// every output element is written by one block, so launches repeat their
// bits.
//
// Bound on an H100: at a 512-row chunk of Qwen3-30B-A3B (E 128, D 2048,
// F 768, k 8) the 4,096 assignments touch all 128 experts, 641.7 MB of
// Q40 weights (1.21 GB dense bf16) for 38.7 GFLOP: about 60 operations a
// byte, under the ~295 where the tensor cores would be the limit, so the
// work is bound by bytes, 0.1934 ms (dense 0.3625) over 3.35 TB/s, and
// the tensor cores are needed only so that the operations (0.58 ms in f32
// FMA) stop being the limit.
//
// Design, bf16 x (`grouped_up_mma_kernel`, `grouped_down_mma_kernel`): a
// block owns one run (up to 64 rows of one expert) and ROWS = 128 weight
// rows, so each selected expert's bytes are read from device memory once
// a layer (an expert with more than 64 rows takes several runs, side by
// side in the grid, which read it again through L2). The products run on
// mma.sync m16n8k16 with the weight rows as A and the run's rows as the N
// side: a warp holds two 16-row slabs of A and walks the run's 8-row
// column tiles up to its real rows only (the count is a template
// parameter), so padding costs no products. A Q40 weight enters A as the
// exact f32 product rounded once to bf16 with no int-to-float conversion
// (q40::weight_pair, the Q40 GEMV's fragments), each fragment built once a
// block and used for every row of the run. In the up projection the W1
// and W3 rows of the same 8 hidden units share a slab (rows 0..7 W1, 8..15
// W3, as in moe_active.cu), so one lane holds h1 and h3 of a unit and
// stores round(silu(h1) h3) once, in bf16. Weight rows, x rows and the Q40
// scales stream through a cp.async ring: each weight row's 128-byte line
// of a stage (Q40 128 values, dense 64), x rows gathered by token 16 bytes
// a copy (the down projection's hidden rows are contiguous in run order),
// two aligned 16-byte chunks of each Q40 row's scales; as many stages as
// keep two blocks on an SM (3 for Q40, 4 for dense). Each thread's copies
// are fixed rows and chunks, their addresses worked out once a block.
// Fragments read the ring in the Q40 GEMV's k order (lane t's values
// 64 p + 16 t .. + 15 of a pair on both sides), on swizzled chunks free of
// bank conflicts. Each stage's products are summed from zero on the
// tensor cores and added to the running f32 sums (see `mainloop`).
// f32 x keeps the CUDA-core kernels (no tensor-core type holds f32
// exactly): a block per (32-row half of a run, 64 columns), a shared-memory
// tiled product in f32 FMA, the hidden in f32.
//
// What holds it (PERF.md): not the bytes. With no weight bytes read
// at all the Q40 launches take nearly as long, so it is the work a warp
// does a stage (dequantizing, issuing copies, B fragments, mmas) with 8 warps
// an SM to hide its latencies; and, around the launches, the wrapper's
// torch schedule and combine.

#include "moe_experts.cuh"

using namespace dllama;

namespace {

constexpr int RUN = 64;  // rows of a run: ops/moe.py GROUP_ROWS

// ---- bf16 x on mma.sync (see the note at the top) ----

constexpr int WARPS = 4;
constexpr int SLABS = 2;                  // 16-row A slabs a warp
constexpr int ROWS = WARPS * SLABS * 16;  // weight rows a block
constexpr int THREADS = WARPS * 32;
constexpr int NJ = RUN / 8;               // 8-row column tiles of a run
constexpr int SMEM_BUDGET = 113 * 1024;   // a block's ring: two blocks an SM

// One stage of the ring: the block's weight rows (a 128-byte line each),
// the run's x rows (bf16, 2 BK bytes each, chunk c of row r at c ^ (r & 1))
// and the Q40 scales' slots.
template <typename W>
struct Ring {
  static constexpr int BK = W::STAGE_K;
  static constexpr int PAIRS = BK / 64;      // 64-value fragment pairs a stage
  static constexpr int W_ROW = 128;
  static constexpr int W_BYTES = ROWS * W_ROW;
  static constexpr int X_BYTES = RUN * BK * 2;
  static constexpr int STAGE = W_BYTES + X_BYTES + ROWS * W::STAGE_SCALE_BYTES;
  static constexpr int STAGES = SMEM_BUDGET / STAGE < 4 ? SMEM_BUDGET / STAGE : 4;
  static constexpr int BYTES = STAGES * STAGE;
  static_assert(STAGES >= 2, "a ring of at least two stages");
  static_assert(BK / W::CHUNK_VALS == 8, "a weight row's stage is eight 16-byte chunks");
};

// A rows of the up projection: shared row sr of slab sr / 16 is W1's row of
// hidden unit u0 + 8 (sr / 16) + sr % 8 for sr % 16 < 8, else W3's. Shared
// rows sr0 + 16 m (sr0 < 16) are one tensor's rows r0 + 8 m.
template <typename W>
struct UpRows {
  W w1, w3;
  int e, u0;
  static constexpr int STEP = 8;
  __device__ __forceinline__ const W& at(int sr, int& r) const {
    r = u0 + 8 * (sr >> 4) + (sr & 7);
    return (sr & 8) ? w3 : w1;
  }
};
// A rows of the down projection: W2's rows d0 ..; shared rows sr0 + 16 m
// are rows d0 + sr0 + 16 m.
template <typename W>
struct DownRows {
  W w2;
  int e, d0;
  static constexpr int STEP = 16;
  __device__ __forceinline__ const W& at(int sr, int& r) const {
    r = d0 + sr;
    return w2;
  }
};
// B rows: x gathered by the run's tokens (real rows only) ...
struct TokenRows {
  const __nv_bfloat16* x;
  const int* toks;  // shared memory
  int n_d;
  __device__ __forceinline__ const __nv_bfloat16* row(int r) const {
    return x + (size_t)toks[r] * n_d;
  }
};
// ... or the run's hidden rows, contiguous
struct RunRows {
  const __nv_bfloat16* h;
  int n_f;
  __device__ __forceinline__ const __nv_bfloat16* row(int r) const { return h + (size_t)r * n_f; }
};

// acc[s][j] = A (this warp's slab s of the block's rows, `a`) . B (the
// run's rows 8 j .. 8 j + 7, `b`) over k = 0 .. n_k - 1, for j < NV8 =
// ceil(nv / 8): B rows past nv are zeros, and tiles past them are never
// computed (NV8 is a template parameter, picked by `products`).
// Each stage's products are summed on the tensor cores from a zero
// accumulator and added to acc in f32, in k order (bits that repeat, the
// same for every NV8): mma.sync aligns the running sum's addends to its
// largest and cuts the bits below, so a sum chained through all of k strays
// further from the f32 sum than the bf16 rounding of the hidden that
// follows can bear (A3B at N = 512 on an H100: 6.8e-4 against the plain
// version, over its 5e-4 limit). Each thread copies fixed rows and chunks
// at every stage, so its copy addresses are worked out once.
template <typename W, int NV8, typename A, typename B>
__device__ __forceinline__ void mainloop(const A& a, const B& b, int n_k, int nv, uint8_t* smem,
                                         float (&acc)[SLABS][NJ][4]) {
  using R = Ring<W>;
  constexpr int BK = R::BK, S = R::STAGES, XC = BK / 8, SB = W::STAGE_SCALE_BYTES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int nst = (n_k + BK - 1) / BK;

  // weight chunks: chunk c of shared rows sr0 + 16 m, m < ROWS / 16
  constexpr int WM = ROWS * 8 / THREADS;
  static_assert(THREADS / 8 == 16, "sixteen shared rows a round of copies");
  const int c = tid & 7, sr0 = tid >> 3;
  int r0;
  const W& wc = a.at(sr0, r0);
  const int m_rows = r0 < wc.rows ? (wc.rows - r0 + A::STEP - 1) / A::STEP : 0;  // real m
  const uint8_t* wsrc = wc.row_bytes(a.e, r0 < wc.rows ? r0 : 0) + 16 * c;
  const size_t wstep = wc.row_stride() * A::STEP;
  const uint32_t wdst = smem_addr(smem) + sr0 * R::W_ROW + 16 * (c ^ (W::SWIZZLE * (sr0 & 1)));
  // scale chunks (Q40): the slot of shared row tid
  const uint8_t *sfirst = nullptr, *send = nullptr;
  if constexpr (SB > 0) {
    static_assert(THREADS == ROWS, "a thread a row's scales");
    int r;
    const W& w = a.at(tid, r);
    sfirst = w.scales_of(a.e, r < w.rows ? r : 0, send);
    if (r >= w.rows) send = sfirst;  // zeros
  }

  auto copy = [&](int kt) {
    uint8_t* ws = smem + (kt % S) * R::STAGE;
    uint8_t* xs = ws + R::W_BYTES;
    const bool k_ok = kt * BK + W::CHUNK_VALS * c < n_k;
#pragma unroll
    for (int m = 0; m < WM; ++m) {
      const bool ok = m < m_rows && k_ok;
      cp_async16(wdst + (kt % S) * R::STAGE + m * 16 * R::W_ROW,
                 ok ? wsrc + m * wstep + kt * R::W_ROW : wsrc, ok);
    }
    for (int i = tid; i < 8 * NV8 * XC; i += THREADS) {
      const int r = i / XC, cx = i % XC, v0 = kt * BK + 8 * cx;
      const bool ok = r < nv && v0 < n_k;
      const __nv_bfloat16* src = ok ? b.row(r) + v0 : b.row(0);
      cp_async16(smem_addr(xs + r * BK * 2 + 16 * (cx ^ (r & 1))), src, ok);
    }
    if constexpr (SB > 0) W::stage_scale_chunks(xs + R::X_BYTES + tid * SB, sfirst, send, kt);
  };
  // the scales' first byte of this lane's fragment rows (Q40)
  const uint8_t* frag_scales[SLABS][2] = {};
  if constexpr (SB > 0) {
#pragma unroll
    for (int s = 0; s < SLABS; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int r;
        const W& w = a.at(16 * (SLABS * warp + s) + g + 8 * h, r);
        const uint8_t* end;
        frag_scales[s][h] = w.scales_of(a.e, r < w.rows ? r : 0, end);
      }
  }

#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < nst) copy(st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nst; ++kt) {
    cp_async_wait<S - 2>();
    __syncthreads();  // stage kt is in; every thread is done with stage kt - 1
    if (kt + S - 1 < nst) copy(kt + S - 1);
    cp_async_commit();

    const uint8_t* ws = smem + (kt % S) * R::STAGE;
    const uint8_t* xs = ws + R::W_BYTES;
    const uint8_t* ss = xs + R::X_BYTES;
    uint32_t af[R::PAIRS][SLABS][2][8];  // pair p, rows g and g + 8 of each slab
#pragma unroll
    for (int p = 0; p < R::PAIRS; ++p)
#pragma unroll
      for (int s = 0; s < SLABS; ++s)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int sr = 16 * (SLABS * warp + s) + g + 8 * h;
          const __half* sc = nullptr;
          if constexpr (SB > 0) sc = W::stage_scales(ss + sr * SB, frag_scales[s][h], kt);
          W::stage_pairs(ws + sr * R::W_ROW, sr, sc, p, t, af[p][s][h]);
        }
#pragma unroll
    for (int j = 0; j < NV8; ++j) {
      const int r = 8 * j + g;
      uint32_t bw[R::PAIRS][8];
      float part[SLABS][4] = {};
#pragma unroll
      for (int p = 0; p < R::PAIRS; ++p) stage_row_pairs(xs + r * BK * 2, r, p, t, bw[p]);
#pragma unroll
      for (int p = 0; p < R::PAIRS; ++p)
#pragma unroll
        for (int st = 0; st < 4; ++st)
#pragma unroll
          for (int s = 0; s < SLABS; ++s) {
            const uint32_t f[4] = {af[p][s][0][2 * st], af[p][s][1][2 * st],
                                   af[p][s][0][2 * st + 1], af[p][s][1][2 * st + 1]};
            mma_bf16(part[s], f, bw[p][2 * st], bw[p][2 * st + 1]);
          }
#pragma unroll
      for (int s = 0; s < SLABS; ++s)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[s][j][i] += part[s][i];
    }
  }
  cp_async_wait<0>();
}

// `mainloop` for the run's nv real rows
template <typename W, typename A, typename B>
__device__ __forceinline__ void products(const A& a, const B& b, int n_k, int nv, uint8_t* smem,
                                         float (&acc)[SLABS][NJ][4]) {
  static_assert(NJ == 8, "one case a column tile");
  switch ((nv + 7) / 8) {
    case 1: mainloop<W, 1>(a, b, n_k, nv, smem, acc); break;
    case 2: mainloop<W, 2>(a, b, n_k, nv, smem, acc); break;
    case 3: mainloop<W, 3>(a, b, n_k, nv, smem, acc); break;
    case 4: mainloop<W, 4>(a, b, n_k, nv, smem, acc); break;
    case 5: mainloop<W, 5>(a, b, n_k, nv, smem, acc); break;
    case 6: mainloop<W, 6>(a, b, n_k, nv, smem, acc); break;
    case 7: mainloop<W, 7>(a, b, n_k, nv, smem, acc); break;
    default: mainloop<W, 8>(a, b, n_k, nv, smem, acc); break;
  }
}

// The run's tokens into toks; returns its real rows (a prefix of the run).
__device__ __forceinline__ int run_rows(const int* __restrict__ row_token, int tile, int* toks) {
  const int tid = threadIdx.x;
  const int tok = tid < RUN ? __ldg(row_token + tile * RUN + tid) : -1;
  if (tid < RUN) toks[tid] = tok;
  return __syncthreads_count(tok >= 0);
}

// up: block (run, blockIdx.y) takes hidden units u0 = 64 blockIdx.y .. of
// its run; lane (g, t) of slab s ends with h1 (acc[0], [1]) and h3 (acc[2],
// [3]) of unit u0 + 8 (2 warp + s) + g at rows 8 j + 2 t, + 1.
template <typename W>
__global__ void __launch_bounds__(THREADS)
grouped_up_mma_kernel(const __nv_bfloat16* __restrict__ x, W w1, W w3,
                      const int* __restrict__ row_token, const int* __restrict__ tile_expert,
                      const int* __restrict__ n_tiles, __nv_bfloat16* __restrict__ hidden,
                      int n_d, int n_f) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int toks[RUN];
  const int tile = blockIdx.x;
  if (tile >= __ldg(n_tiles)) return;
  const int nv = run_rows(row_token, tile, toks);
  const int e = __ldg(tile_expert + tile), u0 = blockIdx.y * (ROWS / 2);
  float acc[SLABS][NJ][4] = {};
  products<W>(UpRows<W>{w1, w3, e, u0}, TokenRows{x, toks, n_d}, n_d, nv, smem, acc);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s = 0; s < SLABS; ++s) {
    const int u = u0 + 8 * (SLABS * warp + s) + g;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 8 * j + 2 * t + i;
        if (u < n_f && r < nv)
          hidden[((size_t)tile * RUN + r) * n_f + u] =
              __float2bfloat16(silu_mul(acc[s][j][i], acc[s][j][2 + i]));
      }
  }
}

// down: block (run, blockIdx.y) takes outputs d0 = 128 blockIdx.y .. of its
// run; lane (g, t) of slab s ends with outputs d0 + 16 (2 warp + s) + g
// (acc[0], [1]) and + 8 (acc[2], [3]) at rows 8 j + 2 t, + 1.
template <typename W>
__global__ void __launch_bounds__(THREADS)
grouped_down_mma_kernel(const __nv_bfloat16* __restrict__ hidden, W w2,
                        const int* __restrict__ row_token, const float* __restrict__ row_weight,
                        const int* __restrict__ tile_expert, const int* __restrict__ n_tiles,
                        float* __restrict__ out, int n_d, int n_f) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int toks[RUN];
  const int tile = blockIdx.x;
  if (tile >= __ldg(n_tiles)) return;
  const int nv = run_rows(row_token, tile, toks);
  const int e = __ldg(tile_expert + tile), d0 = blockIdx.y * ROWS;
  float acc[SLABS][NJ][4] = {};
  products<W>(DownRows<W>{w2, e, d0}, RunRows{hidden + (size_t)tile * RUN * n_f, n_f}, n_f, nv,
              smem, acc);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 8 * j + 2 * t + i;
      if (r >= nv) continue;
      const size_t row = (size_t)tile * RUN + r;
      const float wr = __ldg(row_weight + row);
#pragma unroll
      for (int s = 0; s < SLABS; ++s)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int d = d0 + 16 * (SLABS * warp + s) + g + 8 * h;
          if (d < n_d) out[row * n_d + d] = __fmul_rn(acc[s][j][2 * h + i], wr);
        }
    }
}

// ---- f32 x on CUDA cores: a block per (32-row half of a run, 64 columns) ----

constexpr int HR = 32;            // rows a block: half a run
constexpr int HN = 64;            // output columns a block
constexpr int HK = 32;            // depth a step
constexpr int F32_THREADS = 256;  // 16 x 16 threads, 2 rows x 4 columns each

// One depth step's B tile (HN weight rows x HK) into Bs[k][col]: thread
// reads 8 consecutive depth values of weight row c0 + tid / 4.
template <typename W>
__device__ __forceinline__ void load_b(const W& w, int e, int c0, int n_rows, int k0,
                                       float (&Bs)[HK][HN + 4], int tid) {
  const int col = tid / 4, kk = (tid % 4) * 8;
  float v[8];
  if (c0 + col < n_rows) {
    w.template get8<float>(e, c0 + col, k0 + kk, v);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) Bs[kk + j][col] = v[j];
}

__device__ __forceinline__ void fma_tile(const float (&As)[HK][HR + 4],
                                         const float (&Bs)[HK][HN + 4], int kk, int ty, int tx,
                                         float (&acc)[2][4]) {
  const float2 a = *reinterpret_cast<const float2*>(&As[kk][ty * 2]);
  const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
  const float av[2] = {a.x, a.y};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

// Half h = blockIdx.x of the schedule's rows 32 h ..: nothing to do past the
// real runs or where the half holds only padding (its first row's token is
// -1: a run's real rows come first).
__device__ __forceinline__ bool half_idle(const int* row_token, const int* n_tiles) {
  const int h = blockIdx.x;
  return h / (RUN / HR) >= __ldg(n_tiles) || __ldg(row_token + h * HR) < 0;
}

template <typename W>
__global__ void __launch_bounds__(F32_THREADS)
grouped_up_kernel(const float* __restrict__ x, W w1, W w3, const int* __restrict__ row_token,
                  const int* __restrict__ tile_expert, const int* __restrict__ n_tiles,
                  float* __restrict__ hidden, int n_d, int n_f) {
  if (half_idle(row_token, n_tiles)) return;
  const int half = blockIdx.x;
  __shared__ __align__(16) float As[HK][HR + 4];
  __shared__ __align__(16) float B1[HK][HN + 4];
  __shared__ __align__(16) float B3[HK][HN + 4];
  const int e = tile_expert[half / (RUN / HR)], f0 = blockIdx.y * HN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // this thread loads 4 consecutive depth values of row a_row
  const int a_row = tid / 8, a_k = (tid % 8) * 4;
  const int tok = row_token[half * HR + a_row];
  const float* xr = x + (size_t)(tok < 0 ? 0 : tok) * n_d + a_k;
  float acc1[2][4] = {}, acc3[2][4] = {};
  for (int k0 = 0; k0 < n_d; k0 += HK) {
#pragma unroll
    for (int j = 0; j < 4; ++j) As[a_k + j][a_row] = tok < 0 ? 0.f : xr[k0 + j];
    load_b(w1, e, f0, n_f, k0, B1, tid);
    load_b(w3, e, f0, n_f, k0, B3, tid);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < HK; ++kk) {
      fma_tile(As, B1, kk, ty, tx, acc1);
      fma_tile(As, B3, kk, ty, tx, acc3);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t row = (size_t)half * HR + ty * 2 + i;
    if (row_token[row] < 0) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + tx * 4 + j;
      if (f < n_f) hidden[row * n_f + f] = silu_mul(acc1[i][j], acc3[i][j]);
    }
  }
}

template <typename W>
__global__ void __launch_bounds__(F32_THREADS)
grouped_down_kernel(const float* __restrict__ hidden, W w2, const int* __restrict__ row_token,
                    const float* __restrict__ row_weight, const int* __restrict__ tile_expert,
                    const int* __restrict__ n_tiles, float* __restrict__ out, int n_d, int n_f) {
  if (half_idle(row_token, n_tiles)) return;
  const int half = blockIdx.x;
  __shared__ __align__(16) float As[HK][HR + 4];
  __shared__ __align__(16) float Bs[HK][HN + 4];
  const int e = tile_expert[half / (RUN / HR)], d0 = blockIdx.y * HN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int a_row = tid / 8, a_k = (tid % 8) * 4;
  // padding rows read zeros, not the hidden scratch (never stored there)
  const bool real = row_token[half * HR + a_row] >= 0;
  const float* hrow = hidden + ((size_t)half * HR + a_row) * n_f + a_k;
  float acc[2][4] = {};
  for (int k0 = 0; k0 < n_f; k0 += HK) {
    const float4 h = real ? *reinterpret_cast<const float4*>(hrow + k0) : make_float4(0, 0, 0, 0);
    As[a_k][a_row] = h.x;
    As[a_k + 1][a_row] = h.y;
    As[a_k + 2][a_row] = h.z;
    As[a_k + 3][a_row] = h.w;
    load_b(w2, e, d0, n_d, k0, Bs, tid);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < HK; ++kk) fma_tile(As, Bs, kk, ty, tx, acc);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t row = (size_t)half * HR + ty * 2 + i;
    if (row_token[row] < 0) continue;
    const float w = row_weight[row];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + tx * 4 + j;
      if (d < n_d) out[row * n_d + d] = acc[i][j] * w;
    }
  }
}

// bf16 x: the tensor-core kernels, a bf16 hidden
template <typename W>
int launch(const __nv_bfloat16* x, W w1, W w3, W w2, const int* row_token,
           const float* row_weight, const int* tile_expert, const int* n_tiles, void* hidden,
           float* out, int max_tiles, int n_d, int n_f, cudaStream_t s) {
  constexpr int smem = Ring<W>::BYTES;
  auto* h = static_cast<__nv_bfloat16*>(hidden);
  // the kernels' shared-memory limit, set once a device (a host call that
  // a prefill chunk would otherwise make twice a MoE layer)
  static SmemLimit up_limit, down_limit;
  if (up_limit.raise(grouped_up_mma_kernel<W>, smem) != cudaSuccess ||
      down_limit.raise(grouped_down_mma_kernel<W>, smem) != cudaSuccess)
    return static_cast<int>(cudaErrorInvalidValue);
  grouped_up_mma_kernel<W><<<dim3(max_tiles, (n_f + ROWS / 2 - 1) / (ROWS / 2)), THREADS, smem,
                             s>>>(x, w1, w3, row_token, tile_expert, n_tiles, h, n_d, n_f);
  grouped_down_mma_kernel<W><<<dim3(max_tiles, (n_d + ROWS - 1) / ROWS), THREADS, smem, s>>>(
      h, w2, row_token, row_weight, tile_expert, n_tiles, out, n_d, n_f);
  return static_cast<int>(cudaGetLastError());
}

// f32 x: the CUDA-core kernels, an f32 hidden
template <typename W>
int launch(const float* x, W w1, W w3, W w2, const int* row_token, const float* row_weight,
           const int* tile_expert, const int* n_tiles, void* hidden, float* out, int max_tiles,
           int n_d, int n_f, cudaStream_t s) {
  auto* h = static_cast<float*>(hidden);
  const int halves = max_tiles * (RUN / HR);
  grouped_up_kernel<W><<<dim3(halves, (n_f + HN - 1) / HN), F32_THREADS, 0, s>>>(
      x, w1, w3, row_token, tile_expert, n_tiles, h, n_d, n_f);
  grouped_down_kernel<W><<<dim3(halves, (n_d + HN - 1) / HN), F32_THREADS, 0, s>>>(
      h, w2, row_token, row_weight, tile_expert, n_tiles, out, n_d, n_f);
  return static_cast<int>(cudaGetLastError());
}

template <typename X>
int run(const void* x, const void* w1, const void* w1d, const void* w3, const void* w3d,
        const void* w2, const void* w2d, const int* row_token, const float* row_weight,
        const int* tile_expert, const int* n_tiles, void* hidden, float* out, int max_tiles,
        int n_d, int n_f, int q40, cudaStream_t s) {
  return with_experts<X>(q40, w1, w1d, w3, w3d, w2, w2d, n_d, n_f, [&](auto e1, auto e3, auto e2) {
    return launch(static_cast<const X*>(x), e1, e3, e2, row_token, row_weight, tile_expert,
                  n_tiles, hidden, out, max_tiles, n_d, n_f, s);
  });
}

}  // namespace

// x [n, D] (bf16 when x_bf16 else f32); experts as in moe_active.cu; the
// schedule of ops/moe.py grouped_schedule: row_token int32 [max_tiles *
// RUN], row_weight f32 [max_tiles * RUN], tile_expert int32 [max_tiles],
// n_tiles int32 [1] on the device; hidden scratch [max_tiles * RUN, F] in
// x's type; out f32 [max_tiles * RUN, D], rows in schedule order (padding
// rows of both never stored). Returns cudaGetLastError().
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
  float* o = static_cast<float*>(out);
  if (x_bf16)
    return run<__nv_bfloat16>(x, w1, w1d, w3, w3d, w2, w2d, rt, rw, te, nt, hidden, o, max_tiles,
                              n_d, n_f, q40, s);
  return run<float>(x, w1, w1d, w3, w3d, w2, w2d, rt, rw, te, nt, hidden, o, max_tiles, n_d, n_f,
                    q40, s);
}
