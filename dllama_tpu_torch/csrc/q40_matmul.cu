// Q40 weight-only matrix product from int8 values (weight_format q40).
//
// Replaces the TPU kernel dllama_tpu/ops/quant_matmul.py qmatmul_2d
// (_qmm_kernel). The kernels, their bound and their design are in
// q40_gemm.cuh, shared with q40i4_matmul.cu; this file picks the weight
// fetch: q int8 [n, k] in [-8, 7], two 16-byte loads a 32-value block.

#include "q40_gemm.cuh"

// x [m, k] (bf16 when x_bf16 else f32), q int8 [n, k], d f16 [n, k/32],
// out f32 [m, n]; all contiguous, k a multiple of 32. Returns cudaGetLastError().
extern "C" int q40_matmul(const void* x, const void* q, const void* d, void* out, int m, int n,
                          int k, int x_bf16, void* stream) {
  return dllama::q40::run<dllama::q40::Int8Values>(x, q, d, out, m, n, k, x_bf16, stream);
}
