// Stacked expert weights for the MoE kernels (moe_active.cu, moe_grouped.cu).
//
// An expert tensor is [E, rows, cols] in the .m file's own row order, cols a
// multiple of 32: Q40 as int8 values in [-8, 7] plus one f16 scale per 32
// columns ([E, rows, cols / 32]), or dense in the activation type. get8
// returns eight consecutive weights of one row as float, formed exactly in
// f32 and rounded to the activation type X (the q40_matmul rule: bfloat16
// runs round where the TPU kernels round, float32 runs round nowhere).
#pragma once

#include "common.cuh"

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
