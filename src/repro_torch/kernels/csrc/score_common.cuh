// Pieces shared by the float and integer fragment-scoring kernels (and the
// encoders and the similarity kernel): the nonlinearity, a warp sum, and
// the fixed-order fold of the per-column-tile classifier partials followed
// by the cosine epilogue.
//
// Built without --use_fast_math: cosf/sinf/sqrtf and '/' stay IEEE-accurate.
// The RFF argument s_n + b reaches past 2*pi, where the __cosf/__sinf
// intrinsics lose the digits a 5e-5 score tolerance needs.
#pragma once

#include <cuda_runtime.h>

namespace score_common {

enum Nonlinearity { kRff = 0, kLinear = 1, kSign = 2 };

__device__ __forceinline__ float apply_nonlinearity(float s, float b,
                                                    int kind) {
  if (kind == kRff) return cosf(s + b) * sinf(s);
  if (kind == kLinear) return s;
  return (s > 0.f) ? 1.f : ((s < 0.f) ? -1.f : s);  // sign (keeps +-0, NaN)
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// partials: (n_chunks, M, 3) per-column-tile sums of phi*cpos, phi*cneg
// and phi^2, M = N*my*mx. One thread per output: fold the chunks left to right (no
// atomics: the same floats in the same order on every run), then
// score = dpos / (|q| |cpos|) - dneg / (|q| |cneg|) with the stream's
// class norms (frame n belongs to stream n / frames_per_stream).
__global__ void fold_epilogue(const float* __restrict__ partials,
                              const float* __restrict__ cpos_norm,
                              const float* __restrict__ cneg_norm,
                              float* __restrict__ out, int n_chunks, int M,
                              int per_frame, int frames_per_stream) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= M) return;
  float dp = partials[3 * o], dn = partials[3 * o + 1],
        qq = partials[3 * o + 2];
  for (int c = 1; c < n_chunks; ++c) {
    const float* p = partials + 3 * ((size_t)c * M + o);
    dp = dp + p[0];
    dn = dn + p[1];
    qq = qq + p[2];
  }
  const int s = (o / per_frame) / frames_per_stream;
  const float qn = fmaxf(sqrtf(qq), 1e-9f);
  out[o] = dp / (qn * fmaxf(cpos_norm[s], 1e-9f)) -
           dn / (qn * fmaxf(cneg_norm[s], 1e-9f));
}

}  // namespace score_common
