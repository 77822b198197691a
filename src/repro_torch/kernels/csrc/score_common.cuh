// Pieces shared by the float and integer fragment-scoring kernels:
// the nonlinearity, a deterministic block sum, and the fixed-order fold of
// the per-chunk classifier partials followed by the cosine epilogue.
//
// Built without --use_fast_math: cosf/sinf/sqrtf and '/' stay IEEE-accurate.
// The RFF argument s_n + b reaches past 2*pi, where the __cosf/__sinf
// intrinsics lose the digits a 5e-5 score tolerance needs.
#pragma once

#include <cuda_runtime.h>

namespace score_common {

// one thread per hypervector column; a multiple of 32
constexpr int kColChunk = 256;
constexpr int kWarps = kColChunk / 32;

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

// Sum a, b, c over the block in a fixed association order (shuffle tree in
// each warp, then warps left to right). The totals land in thread 0.
__device__ __forceinline__ void block_sum3(float& a, float& b, float& c,
                                           float* red) {
  a = warp_sum(a);
  b = warp_sum(b);
  c = warp_sum(c);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();  // thread 0 may still read red from the previous call
  if (lane == 0) {
    red[wid] = a;
    red[kWarps + wid] = b;
    red[2 * kWarps + wid] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = red[0];
    b = red[kWarps];
    c = red[2 * kWarps];
    for (int i = 1; i < kWarps; ++i) {
      a = a + red[i];
      b = b + red[kWarps + i];
      c = c + red[2 * kWarps + i];
    }
  }
}

// partials: (n_chunks, M, 3) per-chunk sums of phi*cpos, phi*cneg, phi^2,
// M = N*my*mx. One thread per output: fold the chunks left to right (no
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

// Dynamic shared memory of one scoring block: a frame row (W) and a slab
// segment (kColChunk + W - 1), both widened to 4 bytes, the prefix snapshot
// and window accumulator per column (2 * mx * kColChunk), and the block
// sum's warp totals (3 * kWarps). The Python bound checks mirror this.
inline size_t score_smem_bytes(int W, int mx) {
  return 4 * ((size_t)W + (kColChunk + W - 1) + 2 * (size_t)mx * kColChunk +
              3 * kWarps);
}

}  // namespace score_common
