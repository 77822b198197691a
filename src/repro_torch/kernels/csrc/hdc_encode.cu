// Fused HDC fragment encoding against a dense base, for Hopper, on the
// TF32 tensor cores in 3xTF32 (float32 accuracy).
//
// Replaces the TPU kernel src/repro/kernels/hdc_encode.py::_encode_kernel
// (reached through hdc_encode / ops.hdc_encode). Same function:
//
//   out[n, d] = nonlin(sum_k x[n, k] * B[k, d], b[d])
//
// with nonlin cos(p + b) * sin(p) (RFF), sign(p) or p, and no
// normalization inside (ops.hdc_encode normalizes the rows first).
//
// What bounds it on the H100: operations, 3 * 2*N*K*D (three TF32
// products per multiply-add) over the 495 TFLOP/s TF32 tensor-core peak:
// 0.215 ms at the held-out encode, 384 x 9216 x 5000; its ~198 MB of
// x, base and output take 0.059 ms at 3.35 TB/s. The mainloop
// (encode_common.cuh) stages 32-deep base tiles with 16-byte cp.async
// copies (D = 5000 rows are 16-byte aligned) in a 4-stage ring; at that
// shape it takes 128 x 128 output tiles, 120 blocks, one per SM, 91% of
// 132 SMs (128 x 160 tiles would leave 36 SMs idle).
// The TPU kernel tiles (bn, bd, bk) with the K axis as a sequential grid
// dimension carrying an fp32 VMEM accumulator; here the K loop runs inside
// one block with the accumulators in registers, the same fixed-order sum
// without a grid axis that Hopper blocks could not share.

#include <cuda_runtime.h>

#include "encode_common.cuh"

extern "C" {

// out (N, D) = nonlin(x (N, K) @ B (K, D), b (D,)); all float32, row-major
// and contiguous. Returns cudaGetLastError().
int hdc_encode_f32(const float* x, const float* B, const float* bias,
                   float* out, int N, int K, int D, int nonlinearity,
                   cudaStream_t stream) {
  const encode_common::DenseBase base{
      B, K, D, D % 4 == 0 && encode_common::aligned16(B)};
  return encode_common::launch_encode(x, base, bias, out, N, K, D,
                                      nonlinearity, stream);
}

// The tile width an (N, D) encode takes, its blocks, resident blocks per
// SM and shared memory per block. Returns the occupancy query's error.
int hdc_encode_occupancy(int N, int D, int* tile_n, int* blocks,
                         int* per_sm, int* smem_bytes) {
  return encode_common::encode_occupancy<encode_common::DenseBase>(
      N, D, tile_n, blocks, per_sm, smem_bytes);
}

}  // extern "C"
