// Fused HDC fragment encoding against the permutation base, float32, for
// Hopper.
//
// Replaces the TPU kernel src/repro/kernels/hdc_encode_perm.py::_kernel
// (reached through hdc_encode_perm). Same function as
// hdc_encode(x, flat_perm_base(B0, w), b):
//
//   out[n, d] = nonlin(sum_{r, j} x[n, r*w + j] * B0[r, (d + j) % D], b[d])
//
// What bounds it on the H100: operations, as for hdc_encode.cu (2*N*K*D
// float32 multiply-adds), but with the base's bytes cut by w: the kernel
// reads the (h, D) generators (1.9 MB at h=96, D=5000), never the
// (h*w, D) expanded base (184 MB). The TPU kernel keeps the circularly
// padded generators resident in VMEM and builds each (bk, bd) base tile
// with a loop of row slices before its matmul; here each 8 x 128 base
// tile is gathered into shared memory straight from the generators, which
// stay in L2, by the same mainloop as hdc_encode.cu (encode_common.cuh).
// Unlike the TPU wrapper, any D and any h*w are taken: edges are
// bounds-checked, not asserted away.

#include <cuda_runtime.h>

#include "encode_common.cuh"

extern "C" {

// out (N, D) = nonlin(x (N, h*w) @ B, b (D,)) with B[r*w + j, d] =
// B0[r, (d + j) % D]; all float32, row-major and contiguous. Returns
// cudaGetLastError().
int hdc_encode_perm_f32(const float* x, const float* B0, const float* bias,
                        float* out, int N, int h, int w, int D,
                        int nonlinearity, cudaStream_t stream) {
  return encode_common::launch_encode(x, encode_common::PermBase{B0, D, w},
                                      bias, out, N, h * w, D, nonlinearity,
                                      stream);
}

}  // extern "C"
