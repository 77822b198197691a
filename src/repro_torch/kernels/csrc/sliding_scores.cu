// Fused computation-reuse HyperSense frame scoring, float32, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/sliding_scores.py::_score_kernel
// (reached through fragment_scores_batch). Same function: for frame n,
// fragment row ky and hypervector column j,
//
//   P[i]      = sum_{i' < i} frame[ky*s + r, i'] * slab[r, i' + j]  (prefix)
//   acc[kx]  += P[kx*s + w] - P[kx*s]           for each of the h rows r
//   phi       = nonlin(acc[kx] / max(norm, 1e-8), bias[kx, j])
//
// then the partial sums of phi*cpos, phi*cneg and phi^2 over columns, a
// fold in fixed order and the cosine epilogue.
//
// What bounds it on the H100: operations. Each (frame, row band, column)
// costs h*W multiply-adds in float32 (19.7 GFLOP per 32-frame chunk at the
// paper's 128x128 frames, h=w=96, stride 8, D=5000) against ~4 MB of
// inputs. This first version runs them on the CUDA cores (67 TFLOP/s
// float32 peak), not on tensor cores.
//
// Design. The TPU kernel keeps a (W+1, TD) float prefix scratch per grid
// step; at D=5000 (one 5000-wide tile) that is 2.58 MB, beyond the 227 KB
// a block may have. Here D is cut into column chunks of kColChunk: one
// block per (column chunk, row band ky, frame n), one thread per column,
// carrying its running prefix P in a register. The block stages one frame
// row and the slab segment it needs in shared memory per base row, and
// keeps, per column, only the prefix snapshots at window starts and the
// window accumulators (2 * mx values). Each block writes its chunk's
// classifier partials; a second small kernel folds the chunks left to
// right (no atomics: bitwise the same from run to run) and applies the
// cosine epilogue.

#include <cuda_runtime.h>

#include "score_common.cuh"

using namespace score_common;

namespace {

__global__ void __launch_bounds__(kColChunk)
    score_f32(const float* __restrict__ frames,  // (N, H, W)
              const float* __restrict__ slabs,   // (n_dt, h, td + W - 1)
              const float* __restrict__ bias,    // (n_dt, mx, td)
              const float* __restrict__ cpos,    // (S * n_dt, mx, td)
              const float* __restrict__ cneg,    // (S * n_dt, mx, td)
              const float* __restrict__ norms,   // (N, my, mx)
              float* __restrict__ partials,      // (n_chunks, N*my*mx, 3)
              int N, int H, int W, int h, int w, int stride, int my, int mx,
              int td, int n_dt, int chunks_per_tile, int frames_per_stream,
              int nonlinearity) {
  extern __shared__ float smem[];
  const int cw = kColChunk;
  float* xrow = smem;               // W
  float* seg = xrow + W;            // cw + W - 1
  float* lo = seg + cw + W - 1;     // mx * cw  prefix at window starts
  float* acc = lo + mx * cw;        // mx * cw  window sums
  float* red = acc + mx * cw;       // 3 * kWarps

  const int chunk = blockIdx.x, ky = blockIdx.y, n = blockIdx.z;
  const int dt = chunk / chunks_per_tile;
  const int j0 = (chunk % chunks_per_tile) * cw;
  const int t = threadIdx.x;
  const int j = j0 + t;
  const int slab_len = td + W - 1;
  const int seg_len = min(cw, td - j0) + W - 1;
  const int last = (mx - 1) * stride + w;  // no prefix is read past this

  for (int k = 0; k < mx; ++k) acc[k * cw + t] = 0.f;

  const float* frame = frames + (size_t)n * H * W;
  const float* tile = slabs + (size_t)dt * h * slab_len;
  for (int r = 0; r < h; ++r) {
    __syncthreads();  // every thread is done with the previous row
    const float* row = frame + (size_t)(ky * stride + r) * W;
    for (int i = t; i < last; i += cw) xrow[i] = row[i];
    const float* srow = tile + (size_t)r * slab_len + j0;
    for (int i = t; i < seg_len; i += cw) seg[i] = srow[i];
    __syncthreads();

    // Walk the prefix once, stopping at each window start (snapshot) and
    // end (acc += P_end - P_start). Control flow is the same in every
    // thread of the block.
    float P = 0.f;
    int nl = 0, nh = 0, p = 0;
    for (;;) {
      while (nl < mx && nl * stride == p) lo[nl++ * cw + t] = P;
      while (nh < mx && nh * stride + w == p) {
        acc[nh * cw + t] = acc[nh * cw + t] + P - lo[nh * cw + t];
        ++nh;
      }
      if (nh == mx) break;
      int next = nh * stride + w;
      if (nl < mx) next = min(next, nl * stride);
      for (int i = p; i < next; ++i) P = fmaf(xrow[i], seg[i + t], P);
      p = next;
    }
  }

  // normalization, nonlinearity and this chunk's classifier partials
  const bool live = j < td;
  const int stream = n / frames_per_stream;
  const size_t btile = (size_t)dt * mx * td;
  const size_t ctile = ((size_t)stream * n_dt + dt) * mx * td;
  const int M = N * my * mx;
  for (int kx = 0; kx < mx; ++kx) {
    float dp = 0.f, dn = 0.f, qq = 0.f;
    if (live) {
      const float nrm = fmaxf(norms[((size_t)n * my + ky) * mx + kx], 1e-8f);
      const float phi = apply_nonlinearity(acc[kx * cw + t] / nrm,
                                           bias[btile + (size_t)kx * td + j],
                                           nonlinearity);
      dp = phi * cpos[ctile + (size_t)kx * td + j];
      dn = phi * cneg[ctile + (size_t)kx * td + j];
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

size_t sliding_scores_f32_smem_bytes(int W, int mx) {
  return score_smem_bytes(W, mx);
}

// Scores (N, my, mx) for N frames in one call; partials is scratch of
// n_dt * ceil(td / kColChunk) * N*my*mx * 3 floats. Returns cudaGetLastError().
int sliding_scores_f32(const float* frames, const float* slabs,
                       const float* bias, const float* cpos, const float* cneg,
                       const float* norms, const float* cpos_norm,
                       const float* cneg_norm, float* partials, float* out,
                       int N, int H, int W, int h, int w, int stride, int td,
                       int n_dt, int frames_per_stream, int nonlinearity,
                       cudaStream_t stream) {
  const int my = (H - h) / stride + 1;
  const int mx = (W - w) / stride + 1;
  const int chunks_per_tile = (td + kColChunk - 1) / kColChunk;
  const int n_chunks = n_dt * chunks_per_tile;
  const size_t smem = score_smem_bytes(W, mx);
  cudaError_t err = cudaFuncSetAttribute(
      score_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_chunks, my, N);
  score_f32<<<grid, kColChunk, smem, stream>>>(
      frames, slabs, bias, cpos, cneg, norms, partials, N, H, W, h, w, stride,
      my, mx, td, n_dt, chunks_per_tile, frames_per_stream, nonlinearity);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int M = N * my * mx;
  fold_epilogue<<<(M + 255) / 256, 256, 0, stream>>>(
      partials, cpos_norm, cneg_norm, out, n_chunks, M, my * mx,
      frames_per_stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
