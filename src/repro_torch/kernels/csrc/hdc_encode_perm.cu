// Fused HDC fragment encoding against the permutation base, for Hopper,
// on the TF32 tensor cores in 3xTF32 (float32 accuracy).
//
// Replaces the TPU kernel src/repro/kernels/hdc_encode_perm.py::_kernel
// (reached through hdc_encode_perm). Same function as
// hdc_encode(x, flat_perm_base(B0, w), b):
//
//   out[n, d] = nonlin(sum_{r, j} x[n, r*w + j] * B0[r, (d + j) % D], b[d])
//
// What bounds it on the H100: operations, 3 * 2*N*K*D over the 495
// TFLOP/s TF32 tensor-core peak: 0.286 ms at the training encode,
// 512 x 9216 x 5000. The bytes are cut by w: the kernel reads the (h, D)
// generators (1.9 MB at h = 96, D = 5000), never the (h*w, D) expanded
// base (184 MB). The TPU kernel keeps the circularly padded generators
// resident in VMEM and builds each (bk, bd) base tile with a loop of row
// slices before its matmul; here each K step stages, per generator row it
// touches, one window B0[r, (d0 + jlo + c) % D] in shared memory, and the
// shared mainloop (encode_common.cuh) reads base row r*w + j as that
// window shifted by j (the Hankel view). 128 x 160 output tiles make 128
// blocks at the training shape, one per SM, 97% of 132 SMs in one wave;
// the windows cut the generator reads from L2 to ~(160 + 32) floats per
// 32-deep K step per block.
// The mainloop, its product order and its epilogue are hdc_encode.cu's,
// so the two agree bitwise on flat_perm_base(B0, w). Unlike the TPU
// wrapper, any D and any h*w are taken: edges are bounds-checked, not
// asserted away, and a K step may straddle generator rows.

#include <cuda_runtime.h>

#include "encode_common.cuh"

extern "C" {

// out (N, D) = nonlin(x (N, h*w) @ B, b (D,)) with B[r*w + j, d] =
// B0[r, (d + j) % D]; all float32, row-major and contiguous. Returns
// cudaGetLastError().
int hdc_encode_perm_f32(const float* x, const float* B0, const float* bias,
                        float* out, int N, int h, int w, int D,
                        int nonlinearity, cudaStream_t stream) {
  return encode_common::launch_encode(x,
                                      encode_common::PermBase{B0, h * w, D, w},
                                      bias, out, N, h * w, D, nonlinearity,
                                      stream);
}

// As hdc_encode_occupancy, for this kernel.
int hdc_encode_perm_occupancy(int N, int D, int* tile_n, int* blocks,
                              int* per_sm, int* smem_bytes) {
  return encode_common::encode_occupancy<encode_common::PermBase>(
      N, D, tile_n, blocks, per_sm, smem_bytes);
}

}  // extern "C"
