// The float32 GEMM mainloop and fused epilogue shared by the two fragment
// encoders (hdc_encode.cu, hdc_encode_perm.cu):
//
//   out[n, d] = nonlin(sum_k x[n, k] * B[k, d], b[d])
//
// The encoders differ only in where B[k, d] comes from: a dense (K, D)
// base, or the permutation base generated from its (h, D) generator rows.
// A loader functor hands the mainloop one base element at a time.
//
// Tiling: one block of 256 threads computes a 128 x 128 output tile. K is
// walked in steps of 8: the block stages an 8-deep slice of x (transposed,
// rows padded to 132 floats so the staging stores hit 32 distinct banks)
// and of B in shared memory, and each thread multiply-adds an 8 x 8
// register block (rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns the
// same with tx, so each quarter warp reads 128 contiguous bytes). The
// accumulators stay in registers across the whole K loop and every output
// sums k = 0, 1, ..., K-1 in that order: no split-K, no atomics, so a
// result is bitwise the same from run to run. Edges are bounds-checked and
// zero-filled, so N, K and D are arbitrary (D = 5000 is no multiple of
// 128). Float32 on the CUDA cores: no TF32, no tensor cores.
#pragma once

#include <cuda_runtime.h>

#include "score_common.cuh"

namespace encode_common {

constexpr int kBM = 128;       // output rows per block
constexpr int kBN = 128;       // output columns per block
constexpr int kBK = 8;         // K depth per shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int kApad = kBM + 4;

// B[k, d] of a dense row-major (K, D) base.
struct DenseBase {
  const float* __restrict__ B;
  int D;
  __device__ __forceinline__ float operator()(int k, int d) const {
    return B[(size_t)k * D + d];
  }
};

// B[k, d] of the permutation base: row k = r*w + j of the flattened
// fragment pairs with roll(B0[r], -j), whose element d is B0[r, (d+j) % D]
// (SHIFT == -1). The expanded (h*w, D) base never exists in memory; the
// generators (1.9 MB at h=96, D=5000) stay in L2.
struct PermBase {
  const float* __restrict__ B0;
  int D;
  int w;
  __device__ __forceinline__ float operator()(int k, int d) const {
    const int r = k / w;
    const int j = k - r * w;
    return B0[(size_t)r * D + (d + j) % D];
  }
};

template <class Base>
__global__ void __launch_bounds__(kThreads)
    encode_kernel(const float* __restrict__ x,     // (N, K)
                  Base base,                        // B[k, d], (K, D)
                  const float* __restrict__ bias,  // (D,)
                  float* __restrict__ out,         // (N, D)
                  int N, int K, int D, int nonlinearity) {
  __shared__ __align__(16) float As[kBK][kApad];
  __shared__ __align__(16) float Bs[kBK][kBN];
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int n0 = blockIdx.y * kBM, d0 = blockIdx.x * kBN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < kBM * kBK / kThreads; ++i) {
      const int e = t + i * kThreads;
      const int m = e / kBK, ka = e % kBK;  // x: 128 rows x 8 deep
      const int n = n0 + m, k = k0 + ka;
      As[ka][m] = (n < N && k < K) ? x[(size_t)n * K + k] : 0.f;
      const int kb = e / kBN, c = e % kBN;  // B: 8 deep x 128 columns
      const int kk = k0 + kb, d = d0 + c;
      Bs[kb][c] = (kk < K && d < D) ? base(kk, d) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // fused epilogue: the precise cosf/sinf (no --use_fast_math), see
  // score_common.cuh
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int n = n0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = d0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (d < D)
        out[(size_t)n * D + d] = score_common::apply_nonlinearity(
            acc[i][j], bias[d], nonlinearity);
    }
  }
}

template <class Base>
int launch_encode(const float* x, Base base, const float* bias, float* out,
                  int N, int K, int D, int nonlinearity,
                  cudaStream_t stream) {
  dim3 grid((D + kBN - 1) / kBN, (N + kBM - 1) / kBM);
  encode_kernel<Base><<<grid, kThreads, 0, stream>>>(x, base, bias, out, N,
                                                     K, D, nonlinearity);
  return (int)cudaGetLastError();
}

}  // namespace encode_common
