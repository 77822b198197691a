// Low-precision integer HyperSense frame scoring for Hopper: raw ADC codes
// in, float score maps out.
//
// Replaces the TPU kernel
// src/repro/kernels/sliding_scores_int.py::_score_kernel_int (reached
// through fragment_scores_batch_int). Same function: for frame n, fragment
// row ky and hypervector column j, the exact int32 window sum
//
//   acc[kx] = sum_r sum_{i in [kx*s, kx*s + w)} codes[ky*s + r, i] * slab_q[r, i + j]
//
// (int8 or +-1 slab values, 8/4-bit or wider codes), then the float
// epilogue acc / norm, the nonlinearity and the classifier partials, a
// fold in fixed order and the cosine epilogue.
//
// What bounds it on the H100: operations, h*W integer multiply-adds per
// (frame, row band, column). This version runs them as int32 multiply-adds
// on the CUDA cores, not on the int8 tensor cores.
//
// Design. The TPU kernel builds the windows from an int32 MXU matmul
// codes^T @ slabs, log2(W) roll-and-select passes (_roll_diagonals) and a
// window-mask matmul, per 128-column chunk: all of that exists for the
// TPU's vector unit. Integer sums are exact in any order, so this kernel
// takes the float kernel's simplest right shape: one block per (column
// chunk, row band, frame), one thread per column carrying a running
// prefix; window sums are prefix differences in wrapping 32-bit unsigned
// arithmetic, exact whenever the window sum itself fits in int32 (the
// int_datapath_bounds contract). The result equals
// sliding_scores_int._int_window_acc bit for bit; acc_out, when not null,
// receives it for that check. Packed int4 codes are unpacked on the way
// into shared memory, low nibble first.

#include <cuda_runtime.h>
#include <stdint.h>

#include "score_common.cuh"

using namespace score_common;

namespace {

enum CodesLayout { kU8 = 0, kPackedNibbles = 1, kI32 = 2 };

__device__ __forceinline__ int load_code(const void* codes, size_t row_off,
                                         int i, int layout) {
  if (layout == kU8) return ((const uint8_t*)codes)[row_off + i];
  if (layout == kPackedNibbles) {
    const int byte = ((const uint8_t*)codes)[row_off + (i >> 1)];
    return (byte >> ((i & 1) * 4)) & 0xF;
  }
  return ((const int32_t*)codes)[row_off + i];
}

__global__ void __launch_bounds__(kColChunk)
    score_int(const void* __restrict__ codes,     // (N, H, Wc)
              const int8_t* __restrict__ slabs,   // (n_dt, h, td + W - 1)
              const float* __restrict__ bias,     // (n_dt, mx, td)
              const int8_t* __restrict__ cpos,    // (S * n_dt, mx, td)
              const int8_t* __restrict__ cneg,    // (S * n_dt, mx, td)
              const float* __restrict__ norms,    // (N, my, mx), scale folded in
              float* __restrict__ partials,       // (n_chunks, N*my*mx, 3)
              int32_t* __restrict__ acc_out,      // (N, my, n_dt, mx, td) or null
              int N, int H, int W, int Wc, int h, int w, int stride, int my,
              int mx, int td, int n_dt, int chunks_per_tile,
              int frames_per_stream, int nonlinearity, int layout) {
  extern __shared__ float smem[];
  const int cw = kColChunk;
  int* xrow = (int*)smem;                      // W
  int* seg = xrow + W;                         // cw + W - 1
  unsigned* lo = (unsigned*)(seg + cw + W - 1);  // mx * cw
  unsigned* acc = lo + mx * cw;                // mx * cw
  float* red = (float*)(acc + mx * cw);        // 3 * kWarps

  const int chunk = blockIdx.x, ky = blockIdx.y, n = blockIdx.z;
  const int dt = chunk / chunks_per_tile;
  const int j0 = (chunk % chunks_per_tile) * cw;
  const int t = threadIdx.x;
  const int j = j0 + t;
  const int slab_len = td + W - 1;
  const int seg_len = min(cw, td - j0) + W - 1;
  const int last = (mx - 1) * stride + w;

  for (int k = 0; k < mx; ++k) acc[k * cw + t] = 0u;

  const int8_t* tile = slabs + (size_t)dt * h * slab_len;
  for (int r = 0; r < h; ++r) {
    __syncthreads();
    const size_t row_off = ((size_t)n * H + ky * stride + r) * Wc;
    for (int i = t; i < last; i += cw) xrow[i] = load_code(codes, row_off, i, layout);
    const int8_t* srow = tile + (size_t)r * slab_len + j0;
    for (int i = t; i < seg_len; i += cw) seg[i] = srow[i];
    __syncthreads();

    unsigned P = 0u;
    int nl = 0, nh = 0, p = 0;
    for (;;) {
      while (nl < mx && nl * stride == p) lo[nl++ * cw + t] = P;
      while (nh < mx && nh * stride + w == p) {
        acc[nh * cw + t] += P - lo[nh * cw + t];
        ++nh;
      }
      if (nh == mx) break;
      int next = nh * stride + w;
      if (nl < mx) next = min(next, nl * stride);
      for (int i = p; i < next; ++i) P += (unsigned)(xrow[i] * seg[i + t]);
      p = next;
    }
  }

  const bool live = j < td;
  const int stream = n / frames_per_stream;
  const size_t btile = (size_t)dt * mx * td;
  const size_t ctile = ((size_t)stream * n_dt + dt) * mx * td;
  const int M = N * my * mx;
  for (int kx = 0; kx < mx; ++kx) {
    float dp = 0.f, dn = 0.f, qq = 0.f;
    if (live) {
      const int a = (int)acc[kx * cw + t];
      if (acc_out != nullptr)
        acc_out[((((size_t)n * my + ky) * n_dt + dt) * mx + kx) * td + j] = a;
      const float phi = apply_nonlinearity(
          (float)a / norms[((size_t)n * my + ky) * mx + kx],
          bias[btile + (size_t)kx * td + j], nonlinearity);
      dp = phi * (float)cpos[ctile + (size_t)kx * td + j];
      dn = phi * (float)cneg[ctile + (size_t)kx * td + j];
      qq = phi * phi;
    }
    block_sum3(dp, dn, qq, red);
    if (t == 0) {
      float* o = partials + 3 * ((size_t)chunk * M + ((size_t)n * my + ky) * mx + kx);
      o[0] = dp;
      o[1] = dn;
      o[2] = qq;
    }
  }
}

}  // namespace

extern "C" {

size_t sliding_scores_int_smem_bytes(int W, int mx) {
  return score_smem_bytes(W, mx);
}

// Scores (N, my, mx) from integer codes in one call. layout: 0 = uint8
// codes (N, H, W), 1 = packed nibbles (N, H, W/2), 2 = int32 (N, H, W).
// Returns cudaGetLastError().
int sliding_scores_int(const void* codes, const int8_t* slabs,
                       const float* bias, const int8_t* cpos,
                       const int8_t* cneg, const float* norms,
                       const float* cpos_norm, const float* cneg_norm,
                       float* partials, float* out, int32_t* acc_out, int N,
                       int H, int W, int h, int w, int stride, int td,
                       int n_dt, int frames_per_stream, int nonlinearity,
                       int layout, cudaStream_t stream) {
  const int my = (H - h) / stride + 1;
  const int mx = (W - w) / stride + 1;
  const int Wc = layout == kPackedNibbles ? W / 2 : W;
  const int chunks_per_tile = (td + kColChunk - 1) / kColChunk;
  const int n_chunks = n_dt * chunks_per_tile;
  const size_t smem = score_smem_bytes(W, mx);
  cudaError_t err = cudaFuncSetAttribute(
      score_int, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_chunks, my, N);
  score_int<<<grid, kColChunk, smem, stream>>>(
      codes, slabs, bias, cpos, cneg, norms, partials, acc_out, N, H, W, Wc,
      h, w, stride, my, mx, td, n_dt, chunks_per_tile, frames_per_stream,
      nonlinearity, layout);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int M = N * my * mx;
  fold_epilogue<<<(M + 255) / 256, 256, 0, stream>>>(
      partials, cpos_norm, cneg_norm, out, n_chunks, M, my * mx,
      frames_per_stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
