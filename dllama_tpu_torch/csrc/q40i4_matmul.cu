// Q40 weight-only matrix product from packed nibbles (weight_format q40i4).
//
// Replaces the TPU kernel dllama_tpu/ops/quant_matmul.py qmatmul_i4_2d
// (_qmm_i4_kernel). The kernels, their bound and their design are in
// q40_gemm.cuh, shared with q40_matmul.cu; this file picks the weight
// fetch: qp uint8 [n, k / 2], one 16-byte load a 32-value block, unpacked
// in registers by shift and mask. Half the bytes of the int8 layout for the
// same values, rounded and summed in the same order, so on the unpacked
// twin the two kernels give the same bits.

#include "q40_gemm.cuh"

// x [m, k] (bf16 when x_bf16 else f32), qp uint8 [n, k/2], d f16 [n, k/32],
// out f32 [m, n]; all contiguous, k a multiple of 32. Returns cudaGetLastError().
extern "C" int q40i4_matmul(const void* x, const void* qp, const void* d, void* out, int m,
                            int n, int k, int x_bf16, void* stream) {
  return dllama::q40::run<dllama::q40::PackedNibbles>(x, qp, d, out, m, n, k, x_bf16, stream);
}
