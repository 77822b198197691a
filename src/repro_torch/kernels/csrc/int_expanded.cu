// The expanded-slab integer scorer for Hopper: the int scorer's retired
// layout, kept as a yardstick for the live kernel (sliding_scores_int.cu).
//
// Replaces the TPU kernel benchmarks/int_datapath.py::_expanded_kernel
// (called at :160 by _expanded_scores). Same function: for frame n, row band
// ky, D-tile dt and hypervector column j,
//
//   G[i, j]   = sum_{r<h} codes[n, ky*s + r, i] * E[dt, r*W + i, j]
//   acc[kx,j] = sum_{i in [kx*s, kx*s + w)} G[i, j]
//
// with E = expand_slabs(geom, W), the (n_dt, h*W, td) int8 operand whose row
// (r, i) is slabs_q[dt, r, i : i + td], pre-shifted for every frame column
// i; then acc / norm (the slab scale folded into the norm), RFF with the
// bias tile, the classifier partials, their fold in a fixed order and the
// cosine epilogue. The operand lives in device memory and grows linearly in
// W (h*W*td bytes a D-tile; 61.4 MB at the paper's 128-wide frames, 96-row
// windows and D = 5000, and 16*4096*D bytes at the deployment geometry of
// 16x16 windows over 4096-wide frames), which is what the race against the
// live kernel, whose block does not grow with W, measures. Do not turn this
// kernel into the live kernel's reuse form or an im2col GEMM.
//
// Bound on the H100: bytes. Read once, the operand takes 0.018 ms at
// 3.35 TB/s at the paper's 32-frame chunk, against 0.010 ms for its
// 2*N*my*W*td*(h + mx) int8 operations at 1,979 TOPS. This kernel, like the
// TPU grid it replaces, reads the operand again for every (frame, row
// band): 32 * 5 * 61.4 MB = 9.8 GB a chunk, ~3 ms from device memory. That
// is the yardstick's nature; it is kept simple, not tuned.
//
// Design. One block of 128 threads per (column tile of 128 columns of one
// D-tile, row band ky, frame n); thread t owns column j = j0 + t. The
// block walks the frame columns i that its windows cover in steps of
// kChunkI; per step it stages the h code rows of the band for those
// columns in shared memory, kChunkR rows at a time (shared memory depends
// on neither W nor h), and each thread accumulates G[i, j] in int32
// registers from one byte of the operand per (r, i): 128 consecutive bytes
// across the block. The window indicator is a running sum over i: the sum
// at each window's first column is kept in a ring of ceil(w/s) slots (the
// windows open at once), and a window's total is the running sum at its
// last column minus that start. Integer adds wrap modulo 2^32 and wrapping
// addition is associative, so the window sums are the true int32 sums
// wherever those fit (the int_datapath_bounds contract), bitwise equal to
// sliding_scores_int's int_window_acc in any order. acc_out, when not null,
// receives them in the live kernel's (N, my, n_dt, mx, td) layout.
//
// Epilogue, at each window's close (block-uniform): phi = RFF(acc / norm,
// bias) per column, then the live kernel's 128-column partial in its order
// (each of 4 quad lanes sums its 8 columns 32*wn + 8*ni + 2q + e in order,
// the quad combines in the butterfly, the 4 warps left to right), written
// to partials (n_col_tiles, M, 3); fold_epilogue folds the column tiles
// left to right. No atomics: a window's score has one order on every run,
// at every batch position. cosf/sinf stay IEEE (score_common.cuh).
//
// Three launches per call: window_norms, score_expanded, fold_epilogue.

#include <cuda_runtime.h>
#include <stdint.h>

#include "score_common.cuh"

using namespace score_common;

namespace {

// the codes' layouts (numbered as in sliding_scores_int.cu; no packed
// nibbles: the reference's twin takes none)
enum CodesLayout { kU8 = 0, kI32 = 2, kU16 = 3 };

constexpr int kThreads = 128;  // one hypervector column each
constexpr int kBN = kThreads;  // the column tile (the live kernel's kBN)
constexpr int kWarps = kThreads / 32;
constexpr int kChunkI = 32;    // frame columns a step
constexpr int kChunkR = 32;    // code rows staged at once
// static shared memory: staged codes, a step's G, phi, the warps' partials
constexpr int kStaticSmem =
    4 * (kChunkR * kChunkI + kChunkI * kBN + kBN + kWarps * 3);
constexpr int kSmemLimit = 232448;  // dynamic + static, after the opt-in

__device__ __forceinline__ unsigned load_code(const void* codes, size_t off,
                                              int layout) {
  if (layout == kU8) return ((const uint8_t*)codes)[off];
  if (layout == kU16) return ((const uint16_t*)codes)[off];
  return (unsigned)((const int32_t*)codes)[off];
}

struct Geometry {
  int N, H, W, h, w, stride, my, mx, layout;
};

// norms[m] = max(sqrt(sum of the window's squared codes), 1e-8) / scale,
// one block per window: the exact int32 sum (wrapping) and the same float
// steps as sliding_scores_int.cu's window_norms and the plain version.
__global__ void __launch_bounds__(256)
    window_norms(const void* __restrict__ codes, const Geometry gm,
                 const float* __restrict__ scale, float* __restrict__ norms) {
  __shared__ unsigned red[8];
  const int m = blockIdx.x;
  const int n = m / (gm.my * gm.mx), rem = m - n * gm.my * gm.mx;
  const int ky = rem / gm.mx, kx = rem - ky * gm.mx;
  const size_t base = ((size_t)n * gm.H + (size_t)ky * gm.stride) * gm.W +
                      (size_t)kx * gm.stride;
  unsigned sum = 0;
  for (int e = threadIdx.x; e < gm.h * gm.w; e += blockDim.x) {
    const int r = e / gm.w;
    const unsigned c =
        load_code(codes, base + (size_t)r * gm.W + (e - r * gm.w), gm.layout);
    sum += c * c;
  }
  for (int o = 16; o > 0; o >>= 1)
    sum += __shfl_down_sync(0xffffffffu, sum, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < (int)(blockDim.x >> 5); ++i) sum += red[i];
    const float nm = sqrtf((float)(int)sum);
    norms[m] = (nm < 1e-8f ? 1e-8f : nm) / scale[0];  // keeps a NaN
  }
}

struct Args {
  const void* codes;       // (N, H, W) in gm.layout
  const int8_t* operand;   // (n_dt, h*W, td): expand_slabs
  const float* bias;       // (n_dt, mx, td)
  const int8_t* cpos;      // (n_dt, mx, td)
  const int8_t* cneg;      // (n_dt, mx, td)
  const float* norms;      // (N, my, mx), slab scale folded in
  float* partials;         // (n_col_tiles, M, 3)
  int32_t* acc_out;        // (N, my, n_dt, mx, td) or null
  Geometry gm;
  int td, n_dt, tiles_per_dt, open;  // open: ring slots, ceil(w / stride)
};

__global__ void __launch_bounds__(kThreads) score_expanded(const Args p) {
  extern __shared__ unsigned ring[];  // (open, kBN) running sums
  __shared__ unsigned codes_s[kChunkR][kChunkI];
  __shared__ unsigned g_s[kChunkI][kBN];
  __shared__ float phi_s[kBN];
  __shared__ float red[kWarps][3];

  const Geometry gm = p.gm;
  const int t = threadIdx.x, lane = t & 31, wn = t >> 5, q = lane & 3;
  const int ct = blockIdx.x, dt = ct / p.tiles_per_dt;
  const int j0 = (ct - dt * p.tiles_per_dt) * kBN, j = j0 + t;
  const bool col_in = j < p.td;
  const int ky = blockIdx.y, n = blockIdx.z;
  const int M = gm.N * gm.my * gm.mx;
  const int last = (gm.mx - 1) * gm.stride + gm.w;  // columns the windows use
  // this thread's column of the operand; row (r, i) is td bytes further on
  const int8_t* col = p.operand + (size_t)dt * gm.h * gm.W * p.td +
                      (col_in ? j : 0);
  const size_t band = ((size_t)n * gm.H + (size_t)ky * gm.stride) * gm.W;
  unsigned run = 0;  // sum of G[., j] over the columns walked so far

  for (int i0 = 0; i0 < last; i0 += kChunkI) {
    const int ni = min(kChunkI, last - i0);
    unsigned g[kChunkI];
#pragma unroll
    for (int c = 0; c < kChunkI; ++c) g[c] = 0;
    for (int r0 = 0; r0 < gm.h; r0 += kChunkR) {
      const int nr = min(kChunkR, gm.h - r0);
      __syncthreads();  // the previous rows are consumed
      for (int e = t; e < kChunkR * kChunkI; e += kThreads) {
        const int rr = e / kChunkI, c = e - rr * kChunkI;
        codes_s[rr][c] =
            rr < nr && c < ni
                ? load_code(p.codes, band + (size_t)(r0 + rr) * gm.W + i0 + c,
                            gm.layout)
                : 0u;
      }
      __syncthreads();
      for (int rr = 0; rr < nr; ++rr) {
        const int8_t* src = col + ((size_t)(r0 + rr) * gm.W + i0) * p.td;
#pragma unroll
        for (int c = 0; c < kChunkI; ++c)
          if (c < ni)
            g[c] += codes_s[rr][c] * (unsigned)(int)src[(size_t)c * p.td];
      }
    }
#pragma unroll
    for (int c = 0; c < kChunkI; ++c) g_s[c][t] = g[c];  // own column only

    // window events at each column, in order (block-uniform)
    for (int c = 0; c < ni; ++c) {
      const int i = i0 + c;
      if (i % gm.stride == 0 && i / gm.stride < gm.mx)  // a window opens
        ring[(i / gm.stride % p.open) * kBN + t] = run;
      run += g_s[c][t];
      const int first = i - gm.w + 1;  // the window that closes at i
      if (first < 0 || first % gm.stride != 0) continue;
      const int kx = first / gm.stride;
      const int a = (int)(run - ring[(kx % p.open) * kBN + t]);
      const size_t m = ((size_t)n * gm.my + ky) * gm.mx + kx;
      const size_t row = ((size_t)dt * gm.mx + kx) * p.td;
      if (col_in && p.acc_out != nullptr)
        p.acc_out[((((size_t)n * gm.my + ky) * p.n_dt + dt) * gm.mx + kx) *
                      p.td +
                  j] = a;
      phi_s[t] = col_in ? apply_nonlinearity((float)a / p.norms[m],
                                             p.bias[row + j], kRff)
                        : 0.f;
      __syncthreads();
      // the live kernel's partial of this window over the column tile
      float dp = 0.f, dn = 0.f, qq = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cc = 32 * wn + 8 * nt + 2 * q + e;
          if (j0 + cc < p.td) {
            const float phi = phi_s[cc];
            dp += phi * (float)p.cpos[row + j0 + cc];
            dn += phi * (float)p.cneg[row + j0 + cc];
            qq += phi * phi;
          }
        }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        dp += __shfl_xor_sync(0xffffffffu, dp, o);
        dn += __shfl_xor_sync(0xffffffffu, dn, o);
        qq += __shfl_xor_sync(0xffffffffu, qq, o);
      }
      if (lane == 0) {
        red[wn][0] = dp;
        red[wn][1] = dn;
        red[wn][2] = qq;
      }
      __syncthreads();
      if (t == 0) {
        dp = red[0][0];
        dn = red[0][1];
        qq = red[0][2];
        for (int k = 1; k < kWarps; ++k) {
          dp = dp + red[k][0];
          dn = dn + red[k][1];
          qq = qq + red[k][2];
        }
        float* out = p.partials + 3 * ((size_t)ct * M + m);
        out[0] = dp;
        out[1] = dn;
        out[2] = qq;
      }
    }
  }
}

}  // namespace

extern "C" {

// The column tile: the partition of td into partials.
int int_expanded_col_tile() { return kBN; }

// Shared memory of one score_expanded block for windows w wide at this
// stride: the static part and the ring of ceil(w / stride) running sums.
size_t int_expanded_smem_bytes(int w, int stride) {
  return kStaticSmem + (size_t)4 * kBN * ((w + stride - 1) / stride);
}

// Scores (N, my, mx) from integer codes and the expanded operand in one
// call. layout: 0 = uint8, 2 = int32, 3 = uint16 codes (N, H, W).
// slab_scale: the geometry's scalar scale, on the device. Scratch from the
// caller: norms, N*my*mx floats; partials, n_dt * ceil(td / 128) * N*my*mx
// * 3 floats. acc_out: null, or (N, my, n_dt, mx, td) int32 for the window
// sums. Single-model class tiles, RFF. Three launches: window_norms,
// score_expanded, fold_epilogue. Returns the first launch error
// (cudaErrorInvalidValue for a layout it does not take or a block past the
// card's shared memory).
int int_expanded(const void* codes, const int8_t* operand, const float* bias,
                 const int8_t* cpos, const int8_t* cneg,
                 const float* slab_scale, float* norms,
                 const float* cpos_norm, const float* cneg_norm,
                 float* partials, float* out, int32_t* acc_out, int N, int H,
                 int W, int h, int w, int stride, int td, int n_dt,
                 int layout, cudaStream_t stream) {
  if (layout != kU8 && layout != kI32 && layout != kU16)
    return (int)cudaErrorInvalidValue;
  const size_t smem = int_expanded_smem_bytes(w, stride);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  Geometry gm;
  gm.N = N;
  gm.H = H;
  gm.W = W;
  gm.h = h;
  gm.w = w;
  gm.stride = stride;
  gm.my = (H - h) / stride + 1;
  gm.mx = (W - w) / stride + 1;
  gm.layout = layout;
  const int M = N * gm.my * gm.mx;
  window_norms<<<M, 256, 0, stream>>>(codes, gm, slab_scale, norms);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.codes = codes;
  a.operand = operand;
  a.bias = bias;
  a.cpos = cpos;
  a.cneg = cneg;
  a.norms = norms;
  a.partials = partials;
  a.acc_out = acc_out;
  a.gm = gm;
  a.td = td;
  a.n_dt = n_dt;
  a.tiles_per_dt = (td + kBN - 1) / kBN;
  a.open = (w + stride - 1) / stride;
  const int ring = (int)(smem - kStaticSmem);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(score_expanded,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ring);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_ct = n_dt * a.tiles_per_dt;
  score_expanded<<<dim3(n_ct, gm.my, N), kThreads, ring, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fold_epilogue<<<(M + 255) / 256, 256, 0, stream>>>(
      partials, cpos_norm, cneg_norm, out, n_ct, M, gm.my * gm.mx, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
