// Fused cosine-similarity classifier, float32, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/similarity.py::_sim_kernel
// (reached through similarity / ops.similarity). Same function:
//
//   out[n, k] = dot(q[n], c[k]) / (max(sqrt(q[n].q[n]), eps) *
//                                  max(sqrt(c[k].c[k]), eps))
//
// for queries (N, D) against C class hypervectors (C, D). One launch takes
// up to kMaxClasses classes and writes their columns of an output whose
// rows are ldo floats apart; the wrapper launches once per block of
// kMaxClasses classes. Each class's dot and sum of squares are summed on
// their own, so a class's bits do not depend on the block it sits in.
//
// What bounds it on the H100: bytes. Each query element is read once and
// used in C + 1 multiply-adds, far below the card's ~20 float32 operations
// per byte of device memory. The TPU kernel walks D tiles as a sequential
// grid axis, carrying dots and sums of squares in VMEM; here one warp owns
// a query row and walks its D with float4 loads (when D % 4 == 0 and both
// rows are 16-byte aligned), accumulating q.c_k for every class and q.q
// in registers, then reduces with a fixed shuffle tree. The class sums of
// squares are computed once per launch by a first small kernel (one block
// per class, shuffle tree then warps left to right). Every sum has one
// fixed order: the result is bitwise the same from run to run.

#include <cuda_runtime.h>

#include "score_common.cuh"

namespace {

constexpr int kMaxClasses = 8;
constexpr int kRowsPerBlock = 4;  // one warp per query row
constexpr int kSumThreads = 256;

using score_common::warp_sum;

__global__ void __launch_bounds__(kSumThreads)
    class_sumsq(const float* __restrict__ c, float* __restrict__ cc, int D) {
  __shared__ float red[kSumThreads / 32];
  const float* row = c + (size_t)blockIdx.x * D;
  float s = 0.f;
  for (int i = threadIdx.x; i < D; i += kSumThreads) s = fmaf(row[i], row[i], s);
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = red[0];
    for (int i = 1; i < kSumThreads / 32; ++i) total = total + red[i];
    cc[blockIdx.x] = total;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    sim_rows(const float* __restrict__ q,   // (N, D)
             const float* __restrict__ c,   // (C, D)
             const float* __restrict__ cc,  // (C,) class sums of squares
             float* __restrict__ out,       // (N, ldo), columns 0 .. C-1
             int N, int D, int C, int ldo, float eps) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (n >= N) return;  // n is the same in every lane of a warp
  const float* row = q + (size_t)n * D;
  float dots[kMaxClasses];
#pragma unroll
  for (int k = 0; k < kMaxClasses; ++k) dots[k] = 0.f;
  float qq = 0.f;
  if (kVec) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
    for (int i = lane; i < D / 4; i += 32) {
      const float4 v = row4[i];
      qq = fmaf(v.x, v.x, qq);
      qq = fmaf(v.y, v.y, qq);
      qq = fmaf(v.z, v.z, qq);
      qq = fmaf(v.w, v.w, qq);
#pragma unroll
      for (int k = 0; k < kMaxClasses; ++k) {
        if (k < C) {
          const float4 u = reinterpret_cast<const float4*>(c + (size_t)k * D)[i];
          dots[k] = fmaf(v.x, u.x, dots[k]);
          dots[k] = fmaf(v.y, u.y, dots[k]);
          dots[k] = fmaf(v.z, u.z, dots[k]);
          dots[k] = fmaf(v.w, u.w, dots[k]);
        }
      }
    }
  } else {
    for (int i = lane; i < D; i += 32) {
      const float v = row[i];
      qq = fmaf(v, v, qq);
#pragma unroll
      for (int k = 0; k < kMaxClasses; ++k)
        if (k < C) dots[k] = fmaf(v, c[(size_t)k * D + i], dots[k]);
    }
  }
  qq = warp_sum(qq);
#pragma unroll
  for (int k = 0; k < kMaxClasses; ++k) dots[k] = warp_sum(dots[k]);
  if (lane == 0) {
    const float qn = fmaxf(sqrtf(qq), eps);
#pragma unroll
    for (int k = 0; k < kMaxClasses; ++k)
      if (k < C) out[(size_t)n * ldo + k] = dots[k] / (qn * fmaxf(sqrtf(cc[k]), eps));
  }
}

}  // namespace

extern "C" {

int similarity_max_classes() { return kMaxClasses; }

// Cosine scores of q (N, D) against c (C, D), C <= kMaxClasses, into
// columns 0 .. C-1 of out, whose rows are ldo >= C floats apart; cc is
// scratch of C floats. vec != 0 takes float4 loads: D % 4 == 0 and q, c
// 16-byte aligned. Returns cudaGetLastError().
int similarity_f32(const float* q, const float* c, float* cc, float* out,
                   int N, int D, int C, int ldo, int vec, float eps,
                   cudaStream_t stream) {
  if (C < 1 || C > kMaxClasses || ldo < C) return (int)cudaErrorInvalidValue;
  class_sumsq<<<C, kSumThreads, 0, stream>>>(c, cc, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  if (vec)
    sim_rows<true><<<blocks, kRowsPerBlock * 32, 0, stream>>>(q, c, cc, out,
                                                              N, D, C, ldo,
                                                              eps);
  else
    sim_rows<false><<<blocks, kRowsPerBlock * 32, 0, stream>>>(q, c, cc, out,
                                                               N, D, C, ldo,
                                                               eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
