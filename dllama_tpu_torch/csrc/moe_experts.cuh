// Stacked expert weights for the MoE kernels (moe_active.cu, moe_grouped.cu).
//
// An expert tensor is [E, rows, cols] in the .m file's own row order, cols a
// multiple of 32: Q40 as int8 values in [-8, 7] plus one f16 scale per 32
// columns ([E, rows, cols / 32]), or dense in the activation type. get8
// returns eight consecutive weights of one row as float, formed exactly in
// f32 and rounded to the activation type X (the q40_matmul rule: bfloat16
// runs round where the TPU kernels round, float32 runs round nowhere).
// The bf16 mma.sync path (moe_active.cu) loads both kinds straight into
// registers: a chunk of a row is 4 LANE_VALS values, `fetch` takes lane
// t's LANE_VALS of them (runs of 8 at `col`, in loads of 16 bytes), and
// `pairs` gives them as bf16 pairs in k order (Q40 with the Q40 GEMV's
// rounding, q40_gemm.cuh `gemv_mma_kernel`). A warp takes one chunk at a
// time; each kind's sizes and loads measured fastest of those tried on an
// H100 (PERF.md).
#pragma once

#include "q40_gemm.cuh"

namespace dllama {

// SwiGLU of one hidden unit, in the JAX kernels' order of operations.
__device__ __forceinline__ float silu_mul(float h1, float h3) {
  return (h1 / (1.f + expf(-h1))) * h3;
}

struct Q40Experts {
  const int8_t* q;
  const __half* d;
  int rows, cols;

  // weights (e, r, c .. c + 7); c a multiple of 8
  template <typename X>
  __device__ __forceinline__ void get8(int e, int r, int c, float (&v)[8]) const {
    const size_t row = (size_t)e * rows + r;
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(q + row * cols + c));
    const int8_t* b = reinterpret_cast<const int8_t*>(&u);
    const float s = __half2float(d[row * (cols / 32) + c / 32]);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = round_to((float)b[i] * s, static_cast<const X*>(nullptr));
  }

  // lane t takes a block of 32, with its one scale, in loads that bypass L1
  static constexpr int LANE_VALS = 32;
  struct Frag {
    uint4 v[LANE_VALS / 16];
    __half d;
  };
  // the value where lane t's h-th run of 8 of chunk c starts
  __device__ static __forceinline__ int col(int c, int t, int h) {
    return 4 * LANE_VALS * c + LANE_VALS * t + 8 * h;
  }
  // lane t's bytes of row (e, r) in chunk c and their block's scale; zero
  // past cols
  __device__ __forceinline__ Frag fetch(int e, int r, int c, int t) const {
    const size_t row = (size_t)e * rows + r;
    const int v0 = col(c, t, 0);
    Frag f;
    f.d = v0 < cols ? __ldg(d + row * (cols / 32) + v0 / 32) : __ushort_as_half(0);
#pragma unroll
    for (int h = 0; h < LANE_VALS / 16; ++h)
      f.v[h] = v0 < cols ? q40::ldg_stream(q + row * cols + v0 + 16 * h) : make_uint4(0, 0, 0, 0);
    return f;
  }
  // those values as LANE_VALS / 2 bf16 pairs in k order, each the f32
  // product rounded once to bf16 with no conversion (q40::weight_pair)
  __device__ __forceinline__ void pairs(const Frag& f, uint32_t (&w)[LANE_VALS / 2]) const {
    __nv_bfloat162 hi, lo;
    q40::split_scale(f.d, hi, lo);
#pragma unroll
    for (int h = 0; h < LANE_VALS / 16; ++h) {
      uint32_t u[4];
      q40::Int8Values::pair_nibbles(f.v[h], 0, u);
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        w[8 * h + 2 * st] = q40::weight_pair(u[st], 0, hi, lo);
        w[8 * h + 2 * st + 1] = q40::weight_pair(u[st], 1, hi, lo);
      }
    }
  }
};

template <typename T>
struct DenseExperts {
  const T* w;
  int rows, cols;

  template <typename X>
  __device__ __forceinline__ void get8(int e, int r, int c, float (&v)[8]) const {
    dllama::load8(w + ((size_t)e * rows + r) * cols + c, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = round_to(v[i], static_cast<const X*>(nullptr));
  }

  // the mma path's, for T bf16 (x's type: nothing to round): lane t's
  // values of row (e, r) in chunk c, zero past cols, through L1, and the
  // same as LANE_VALS / 2 bf16 pairs in k order
  static constexpr int LANE_VALS = 16;
  struct Frag {
    uint4 v[LANE_VALS / 8];  // 8 bf16 a load
  };
  // the value where lane t's h-th run of 8 of chunk c starts: a quad's h-th
  // loads read 64 contiguous bytes
  __device__ static __forceinline__ int col(int c, int t, int h) {
    return 4 * LANE_VALS * c + 32 * h + 8 * t;
  }
  __device__ __forceinline__ Frag fetch(int e, int r, int c, int t) const {
    const T* row = w + ((size_t)e * rows + r) * cols;
    Frag f;
#pragma unroll
    for (int h = 0; h < LANE_VALS / 8; ++h) {
      const int v0 = col(c, t, h);
      f.v[h] = v0 < cols ? __ldg(reinterpret_cast<const uint4*>(row + v0))
                         : make_uint4(0, 0, 0, 0);
    }
    return f;
  }
  __device__ __forceinline__ void pairs(const Frag& f, uint32_t (&u)[LANE_VALS / 2]) const {
#pragma unroll
    for (int h = 0; h < LANE_VALS / 8; ++h) {
      u[4 * h] = f.v[h].x;
      u[4 * h + 1] = f.v[h].y;
      u[4 * h + 2] = f.v[h].z;
      u[4 * h + 3] = f.v[h].w;
    }
  }
};

// launch(w1, w3, w2) with the experts as Q40Experts when q40, else as
// DenseExperts<X>; w1/w3 are [E, F, D] and w2 [E, D, F] (scales w*d unused
// for dense experts).
template <typename X, typename L>
int with_experts(int q40, const void* w1, const void* w1d, const void* w3, const void* w3d,
                 const void* w2, const void* w2d, int n_d, int n_f, L launch) {
  if (q40) {
    const auto q = [](const void* v, const void* s, int rows, int cols) {
      return Q40Experts{static_cast<const int8_t*>(v), static_cast<const __half*>(s), rows, cols};
    };
    return launch(q(w1, w1d, n_f, n_d), q(w3, w3d, n_f, n_d), q(w2, w2d, n_d, n_f));
  }
  const auto d = [](const void* v, int rows, int cols) {
    return DenseExperts<X>{static_cast<const X*>(v), rows, cols};
  };
  return launch(d(w1, n_f, n_d), d(w3, n_f, n_d), d(w2, n_d, n_f));
}

}  // namespace dllama
