// Fused HDC fragment encoding against a dense base, float32, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/hdc_encode.py::_encode_kernel
// (reached through hdc_encode / ops.hdc_encode). Same function:
//
//   out[n, d] = nonlin(sum_k x[n, k] * B[k, d], b[d])
//
// with nonlin cos(p + b) * sin(p) (RFF), sign(p) or p, and no
// normalization inside (ops.hdc_encode normalizes the rows first).
//
// What bounds it on the H100: operations. At the training path's shape
// (N ~ 400-800 fragments, K = 96*96 = 9216, D = 5000) the product is
// 2*N*K*D ~ 37-74 GFLOP against ~185 MB of base, so float32 at 67 TFLOP/s
// on the CUDA cores sets the bound. The TPU kernel tiles (bn, bd, bk) with
// the K axis as a sequential grid dimension carrying an fp32 VMEM
// accumulator; here the K loop runs inside one block with the accumulator
// in registers (encode_common.cuh), which is the same fixed-order sum
// without a grid axis that Hopper blocks could not share.

#include <cuda_runtime.h>

#include "encode_common.cuh"

extern "C" {

// out (N, D) = nonlin(x (N, K) @ B (K, D), b (D,)); all float32, row-major
// and contiguous. Returns cudaGetLastError().
int hdc_encode_f32(const float* x, const float* B, const float* bias,
                   float* out, int N, int K, int D, int nonlinearity,
                   cudaStream_t stream) {
  return encode_common::launch_encode(x, encode_common::DenseBase{B, D},
                                      bias, out, N, K, D, nonlinearity,
                                      stream);
}

}  // extern "C"
