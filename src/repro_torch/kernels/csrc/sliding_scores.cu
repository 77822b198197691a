// Fused computation-reuse HyperSense frame scoring, float32, for Hopper, on
// the TF32 tensor cores in 3xTF32.
//
// Replaces the TPU kernel src/repro/kernels/sliding_scores.py::_score_kernel
// (reached through fragment_scores_batch). Same function: for frame n, row
// band ky, window column kx, D-tile dt and hypervector column j < td,
//
//   acc[(n, ky), kx, j] = sum_{r<h} sum_{u = kx*s}^{kx*s+w-1}
//                             frame[n, ky*s + r, u] * slab[dt, r, u + j]
//   phi = nonlin(acc / max(norm[n, ky, kx], 1e-8), bias[dt, kx, j])
//
// then the partial sums of phi*cpos, phi*cneg and phi^2 over columns (class
// tiles of stream n / frames_per_stream), a fold in fixed order and the
// cosine epilogue (score_common.cuh::fold_epilogue).
//
// The paper's reuse as GEMMs. With g = gcd(s, w), the frame columns
// u < last = (mx-1)*s + w fall into blocks q of g columns, and window kx
// covers the blocks kx*s/g .. kx*s/g + w/g - 1. Rows are (n, ky), R = N*my
// of them; block q's depth is (r, c), r < h, c < g:
//
//   A_q[(n, ky), (r, c)] = frame[n, ky*s + r, q*g + c]   read from the frames
//   B_q[(r, c), j]       = slab[dt, r, q*g + c + j]      a Hankel view
//
// and acc[kx] = P[kx*s/g + w/g] - P[kx*s/g], where P[q] is the running sum
// of A_q' @ B_q' over q' < q: the prefix form of the TPU kernel. Each pixel
// meets each base row once per row band (h*last multiply-adds per row and
// column, against h*w per window for one GEMM per kx): 2*160*96*128*5000
// = 19.7 GFLOP at the paper's 32-frame chunk (128x128 frames, 96x96
// windows, stride 8, D = 5000), 3 x that in TF32 products.
//
// What bounds it on the H100: operations. 3xTF32 (encode_common.cuh) makes
// 3 * 19.7 GFLOP of TF32 products over the 495 TFLOP/s dense peak: 0.119
// ms, against ~4 MB of inputs (1.2 us at 3.35 TB/s). Three TF32 products
// per multiply-add (big*small, small*big, big*big of each operand split
// into big = tf32(v), small = tf32(v - big)) keep float32 accuracy; each
// 32-deep K step sums into a fresh partial joined to the float32 running
// sum by one IEEE add (the tensor cores' own accumulate is not
// round-to-nearest).
//
// Tiling: 256 threads, 8 warps, 2 along M x 4 along N; a block owns 64 rows
// (n, ky), a fixed 128-column tile and kKX = 5 consecutive windows. It walks
// the windows' blocks q once, in 32-deep K steps (each block's depth h*g
// zero-padded to a multiple of 32, so windows close on step boundaries),
// through a ring of kStages shared-memory stages filled with cp.async: A
// rows padded to 36 floats (conflict-free fragment loads); B as one Hankel
// window per base row of the step, copied in 16-byte chunks from its
// 16-byte-aligned start into a slot of its own (row (r, c) of B_q is the
// window read from its shift + c on, so a k8 inside one base row reads 11
// consecutive words per warp: conflict-free); a zero row for the padded
// depth. Each warp splits the operands it loads into TF32 pairs as it
// multiplies. At a block boundary where window kx opens, the block keeps
// P in shared memory (each thread its own 32 values, kKX - 1 slots: the
// first window opens at P = 0); where kx closes, it takes P - P[open] and
// runs the epilogue at once: each thread sums its 8 columns of a row in
// order, the 4 threads of a row combine in a fixed butterfly, the 4 warps
// along N left to right through shared memory, into the column tile's
// partials (n_col_tiles, N*my*mx, 3). The state is kKX - 1 window starts
// and the ring, whatever W, mx or td: 214,400 B of dynamic shared memory,
// one block per SM. At the paper's chunk: 3 row tiles x 40 column tiles x
// 1 window group = 120 blocks, one wave on 132 SMs. A first launch computes
// the window norms (one block per window, a fixed-order sum of squares); a
// last one folds the column tiles' partials.
//
// Two entries, split at the tile fold: sliding_scores_f32_partials runs
// the first two launches over the D-tiles it is given and
// sliding_scores_f32_fold the last over a (n_ct, M, 3) buffer. A call
// runs both back to back; a D split over ranks runs each rank's
// contiguous D-tiles through the first, gathers the partials in tile
// order and folds all of them with the second: the same partials, folded
// in the same order.
//
// Determinism: no atomics, no split-K; every output's sum order is a
// function of (W, w, s, td, kKX) alone, never of N, the batch position or
// the SM count, so a frame scores the same bits alone, in any chunk, or as
// stream n / C of a fleet. cosf/sinf stay IEEE (no --use_fast_math).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "encode_common.cuh"
#include "score_common.cuh"

using namespace score_common;
using encode_common::cp_async4;
using encode_common::cp_async_commit;
using encode_common::cp_async_wait;
using encode_common::mma_tf32;
using encode_common::split_tf32;

namespace {

// Copy 16 bytes to shared memory, of which the first `valid` floats come
// from src and the rest are zero-filled (valid = 0: src must still be a
// valid address).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   encode_common::smem_addr(dst)),
               "l"(src), "r"(4 * valid)
               : "memory");
}

constexpr int kThreads = 256;
constexpr int kWarpsN = 4;              // 2 warps along M
constexpr int kBN = 128;                // the column tile (fixed)
constexpr int kNT = kBN / kWarpsN / 8;  // n8 tiles per warp (4)
constexpr int kMT = 2;                  // m16 tiles per warp
constexpr int kBM = 2 * 16 * kMT;       // the row tile (64)
constexpr int kBK = 32;                 // K depth per stage
constexpr int kStages = 3;              // cp.async ring depth
constexpr int kKX = 5;                  // windows per block
constexpr int kAStride = kBK + 4;       // 36 = 4 (mod 32)
constexpr int kAFloats = kBM * kAStride;
// B: one slot per base row a step touches (at most kBK of them, when
// g = 1), each holding the row's Hankel window copied in 16-byte chunks
// from its 16-byte-aligned start: slot(g) = kBN + min(g, kBK) + 2 rounded
// up to 4 floats (a shift of up to 3, then up to min(g, kBK) - 1 + kBN
// floats read). rows(g) * slot(g) is largest at g = 1: 32 * 132. A zero
// row after the slots stands in for the padded depth.
constexpr int kBSlots = kBK * 132;
constexpr int kZeroRow = kBSlots;
constexpr int kBFloats = kZeroRow + kBN;
constexpr int kStageFloats = kAFloats + kBFloats + kBK;  // + row offsets
constexpr int kFrag = kMT * kNT * 4;  // accumulators per thread (32)
constexpr int kSnapFloats = (kKX - 1) * kFrag * kThreads;
constexpr int kRedFloats = kWarpsN * kBM * 3;
constexpr int kSmemBytes =
    4 * (kStages * kStageFloats + kSnapFloats + kRedFloats);
static_assert(kSmemBytes <= 232448, "over the H100's shared memory");
static_assert(kStageFloats % 4 == 0 && kAFloats % 4 == 0,
              "stages 16-byte aligned");

struct Geometry {
  int N, H, W, h, w, stride, my, mx;
  int g;      // gcd(stride, w): frame columns per block q
  int nkb;    // K steps per block: h * g rounded up to kBK, over kBK
  int dr, dc;  // a K step advances (r, c) by kBK = dr * g + dc
  int rows;   // base rows a step touches at most
  int slot;   // floats per base row's window in a B stage
};

struct Args {
  const float* frames;  // (N, H, W)
  const float* slabs;   // (n_dt, h, td + W - 1)
  const float* bias;    // (n_dt, mx, td)
  const float* cpos;    // (S * n_dt, mx, td)
  const float* cneg;    // (S * n_dt, mx, td)
  const float* norms;   // (N, my, mx)
  float* partials;      // (n_col_tiles, N*my*mx, 3)
  Geometry gm;
  int td, n_dt, tiles_per_dt, frames_per_stream, nonlinearity;
};

// The A copies of one thread: vec (g % 4 == 0, W % 4 == 0, frames 16-byte
// aligned) takes 16-byte chunks, 2 rows a thread at k = 4 * (t & 7);
// otherwise 4-byte copies, 8 rows a thread at k = t & 31. (r, c) is the
// thread's depth index k = r * g + c within the block (r >= h: padding).
constexpr int kARowsVec = kBM * kBK / 4 / kThreads;  // 2
constexpr int kARowsScalar = kBM * kBK / kThreads;   // 8

__device__ __forceinline__ int a_depth(bool vec, int t) {
  return vec ? 4 * (t & 7) : (t & 31);
}

__device__ __forceinline__ int a_row(bool vec, int i, int t) {
  return vec ? i * (kThreads / 8) + (t >> 3) : i * (kThreads / 32) + (t >> 5);
}

template <bool kVec>
__device__ __forceinline__ void load_a(float* As, const float* frames,
                                       const Geometry& gm,
                                       const long long (&row_off)[8], int q,
                                       int r, int c, int t) {
  constexpr int kRows = kVec ? kARowsVec : kARowsScalar;
  const int kk = a_depth(kVec, t);
  const bool in_depth = r < gm.h;
  const long long col = (long long)r * gm.W + q * gm.g + c;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const bool ok = in_depth && row_off[i] >= 0;
    const float* src = ok ? frames + row_off[i] + col : frames;
    float* dst = As + a_row(kVec, i, t) * kAStride + kk;
    if (kVec)
      cp_async16(dst, src, ok ? 4 : 0);
    else
      cp_async4(dst, src, ok);
  }
}

// The first slab element of base row r's window in a step that starts at
// (r0, c0) of block q: slab[dt, r, q*g + clo + j0], clo = c0 on the step's
// first row and 0 after it.
__device__ __forceinline__ long long window_start(const Geometry& gm,
                                                  long long row0, int L,
                                                  int r, int r0, int c0,
                                                  int q, int j0) {
  return row0 + (long long)r * L + q * gm.g + (r == r0 ? c0 : 0) + j0;
}

// B_q rows of one step (its first depth index (r0, c0)) for the column tile
// at j0: slot i holds base row r0 + i's window from its 16-byte-aligned
// start, so row (r, c) of the tile reads slot i from shift + c - clo on.
// Chunks past the slab array's end are zero-filled; elements past a slab
// row's end feed only columns j >= td, which no output reads. Task u of a
// thread copies chunk bx[u] of slot bi[u] (bi[u] < 0: none).
constexpr int kBTasks = (kBSlots / 4 + kThreads - 1) / kThreads;  // 5

__device__ __forceinline__ void load_b(float* Bs, const Geometry& gm,
                                       const float* slabs, long long total,
                                       long long row0, int L,
                                       const int (&bi)[kBTasks],
                                       const int (&bx)[kBTasks], int q,
                                       int r0, int c0, int j0) {
#pragma unroll
  for (int u = 0; u < kBTasks; ++u) {
    const int r = r0 + bi[u];
    if (bi[u] < 0 || r >= gm.h) continue;
    const long long start = window_start(gm, row0, L, r, r0, c0, q, j0);
    const long long at = (start & ~3LL) + 4 * bx[u];
    const int n = (int)max(0LL, min(4LL, total - at));
    cp_async16(Bs + bi[u] * gm.slot + 4 * bx[u], n > 0 ? slabs + at : slabs,
               n);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1) score_f32(const Args p) {
  extern __shared__ __align__(16) float smem[];  // kSmemBytes
  float* snap = smem + kStages * kStageFloats;   // (kKX-1, kFrag, kThreads)
  float* red = snap + kSnapFloats;               // (kWarpsN, kBM, 3)

  const Geometry gm = p.gm;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int gq = lane >> 2, qq = lane & 3;  // mma fragment row / column
  const int warp_n = warp % kWarpsN;
  const int wm = (warp / kWarpsN) * 16 * kMT, wn = warp_n * 8 * kNT;
  const int ct = blockIdx.x, dt = ct / p.tiles_per_dt;
  const int j0 = (ct - dt * p.tiles_per_dt) * kBN;
  const int r0 = blockIdx.y * kBM;
  const int kx0 = blockIdx.z * kKX;
  const int nwin = min(kKX, gm.mx - kx0);
  const int R = gm.N * gm.my, M = R * gm.mx;
  const int s_g = gm.stride / gm.g, w_g = gm.w / gm.g;
  const int qa = kx0 * s_g;                          // window kx0 opens
  const int qb = (kx0 + nwin - 1) * s_g + w_g;       // the last one closes
  const int steps = (qb - qa) * gm.nkb;
  const int L = p.td + gm.W - 1;  // slab row length

  // this thread's A rows: the frame offset of row band (n, ky), or -1
  long long row_off[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int rr = r0 + a_row(kVec, i, t);
    row_off[i] = -1;
    if (rr < R && (kVec ? i < kARowsVec : i < kARowsScalar)) {
      const int n = rr / gm.my, ky = rr - n * gm.my;
      row_off[i] = ((long long)n * gm.H + (long long)ky * gm.stride) * gm.W;
    }
  }
  // this thread's B copies (slot, chunk), fixed for the whole walk
  int bi[kBTasks], bx[kBTasks];
#pragma unroll
  for (int u = 0; u < kBTasks; ++u) {
    const int task = u * kThreads + t, cpr = gm.slot / 4;
    bi[u] = task < gm.rows * cpr ? task / cpr : -1;
    bx[u] = task - max(bi[u], 0) * cpr;
  }
  const long long row0 = (long long)dt * gm.h * L;  // slab row (dt, 0)
  const long long total = (long long)p.n_dt * gm.h * L;

  for (int s = 0; s < kStages; ++s) {
    float* Bs = smem + s * kStageFloats + kAFloats;
    for (int c = t; c < kBN; c += kThreads) Bs[kZeroRow + c] = 0.f;
  }

  // The loader's cursor: the step (ld_q, ld_kb) it loads, the depth index
  // (r, c) of its first k (b_*), of this thread's A column (a_*) and of
  // its row offset k0 + t (o_*, threads t < kBK); each advances by
  // kBK = dr * g + dc per step and starts over at a new block q.
  const int a_k = a_depth(kVec, t), o_k = min(t, kBK - 1);
  int ld_q = qa, ld_kb = 0;
  int b_r = 0, b_c = 0, a_r = 0, a_c = 0, o_r = 0, o_c = 0;
  const auto advance = [&](int& r, int& c) {
    r += gm.dr;
    c += gm.dc;
    if (c >= gm.g) {
      c -= gm.g;
      ++r;
    }
  };
  const auto load = [&](int st) {
    float* base = smem + st * kStageFloats;
    float* Bs = base + kAFloats;
    if (ld_kb == 0) {
      b_r = b_c = 0;
      a_r = a_k / gm.g;
      a_c = a_k - a_r * gm.g;
      o_r = o_k / gm.g;
      o_c = o_k - o_r * gm.g;
    }
    load_a<kVec>(base, p.frames, gm, row_off, ld_q, a_r, a_c, t);
    load_b(Bs, gm, p.slabs, total, row0, L, bi, bx, ld_q, b_r, b_c, j0);
    if (t < kBK) {
      int off = kZeroRow;
      if (o_r < gm.h) {
        const int i = o_r - b_r, clo = i == 0 ? b_c : 0;
        const long long start =
            window_start(gm, row0, L, o_r, b_r, b_c, ld_q, j0);
        off = i * gm.slot + (int)(start & 3) + o_c - clo;
      }
      ((int*)(Bs + kBFloats))[t] = off;
    }
    if (++ld_kb == gm.nkb) {
      ld_kb = 0;
      ++ld_q;
    } else {
      advance(b_r, b_c);
      advance(a_r, a_c);
      advance(o_r, o_c);
    }
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // Iteration s loads step s + kStages - 1 (one cp.async group each, empty
  // past the last step) and multiplies step s; s < 0 only fills the ring.
  int q = qa, kb = 0;  // the step multiplied
  for (int s = 1 - kStages; s < steps; ++s) {
    if (s >= 0) {
      cp_async_wait<kStages - 2>();  // step s has landed (this thread's part)
      __syncthreads();               // ... everyone's; step s-1 is consumed
    }
    if (s + kStages - 1 < steps) load((s + kStages - 1) % kStages);
    cp_async_commit();
    if (s < 0) continue;

    const float* A = smem + (s % kStages) * kStageFloats;
    const float* B = A + kAFloats;
    const int* of = (const int*)(B + kBFloats);
    // this step's partial on the tensor cores, per k8 big*small,
    // small*big, big*big (encode_common.cuh)
    float part[kMT][kNT][4];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t ab[kMT][4], as[kMT][4], bb[kNT][2], bs[kNT][2];
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = wm + mi * 16 + gq + (i & 1) * 8;
          const int c = kk + qq + (i >> 1) * 4;
          split_tf32(A[m * kAStride + c], ab[mi][i], as[mi][i]);
        }
      const int o0 = of[kk + qq], o1 = of[kk + qq + 4];
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) {
        const int c = wn + ni * 8 + gq;
        split_tf32(B[o0 + c], bb[ni][0], bs[ni][0]);
        split_tf32(B[o1 + c], bb[ni][1], bs[ni][1]);
      }
      const float zero[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni) {
          if (kk == 0)
            mma_tf32(part[mi][ni], ab[mi], bs[ni], zero);
          else
            mma_tf32(part[mi][ni], ab[mi], bs[ni], part[mi][ni]);
        }
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni)
          mma_tf32(part[mi][ni], as[mi], bb[ni], part[mi][ni]);
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni)
          mma_tf32(part[mi][ni], ab[mi], bb[ni], part[mi][ni]);
    }
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[mi][ni][e];

    if (++kb < gm.nkb) continue;
    // a block boundary: P = acc is the running sum up to block q + 1
    kb = 0;
    ++q;
    for (int i = 0; i < nwin; ++i) {
      const int start = (kx0 + i) * s_g;
      if (i > 0 && start == q) {  // window kx0 + i opens: keep P
        float* sn = snap + (size_t)(i - 1) * kFrag * kThreads + t;
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
          for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sn[((mi * kNT + ni) * 4 + e) * kThreads] = acc[mi][ni][e];
      }
      if (start + w_g != q) continue;
      // window kx closes: acc[kx] = P - P[open]; its epilogue. Accumulator
      // e holds row gq + 8*(e/2), column 2*qq + e%2 of its 16 x 8 tile.
      const int kx = kx0 + i;
      const float* sn = snap + (size_t)max(i - 1, 0) * kFrag * kThreads + t;
      __syncthreads();  // red is free: the previous close has read it
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = wm + mi * 16 + gq + 8 * half, rr = r0 + row;
          float dp = 0.f, dn = 0.f, sq = 0.f;
          if (rr < R) {
            const int n = rr / gm.my;
            const float nm = fmaxf(p.norms[(size_t)rr * gm.mx + kx], 1e-8f);
            const int stream = n / p.frames_per_stream;
            const size_t brow = ((size_t)dt * gm.mx + kx) * p.td;
            const size_t crow =
                (((size_t)stream * p.n_dt + dt) * gm.mx + kx) * p.td;
#pragma unroll
            for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int j = j0 + wn + ni * 8 + 2 * qq + e;
                const int ai = 2 * half + e;
                float v = acc[mi][ni][ai];
                if (i > 0) v = v - sn[((mi * kNT + ni) * 4 + ai) * kThreads];
                if (j < p.td) {
                  const float phi = apply_nonlinearity(
                      v / nm, p.bias[brow + j], p.nonlinearity);
                  dp += phi * p.cpos[crow + j];
                  dn += phi * p.cneg[crow + j];
                  sq += phi * phi;
                }
              }
          }
#pragma unroll
          for (int o = 1; o < 4; o <<= 1) {
            dp += __shfl_xor_sync(0xffffffffu, dp, o);
            dn += __shfl_xor_sync(0xffffffffu, dn, o);
            sq += __shfl_xor_sync(0xffffffffu, sq, o);
          }
          if (qq == 0) {
            float* o = red + 3 * (warp_n * kBM + row);
            o[0] = dp;
            o[1] = dn;
            o[2] = sq;
          }
        }
      __syncthreads();
      for (int row = t; row < kBM; row += kThreads) {
        const int rr = r0 + row;
        if (rr >= R) continue;
        float dp = red[3 * row], dn = red[3 * row + 1], sq = red[3 * row + 2];
        for (int k = 1; k < kWarpsN; ++k) {
          const float* o = red + 3 * (k * kBM + row);
          dp = dp + o[0];
          dn = dn + o[1];
          sq = sq + o[2];
        }
        float* out =
            p.partials + 3 * ((size_t)ct * M + (size_t)rr * gm.mx + kx);
        out[0] = dp;
        out[1] = dn;
        out[2] = sq;
      }
    }
  }
  cp_async_wait<0>();  // only empty groups remain; leave none behind
}

// norms[m] = sqrt(max(sum of the window's squared pixels, 1e-16)), one
// block per window m = (n, ky, kx): each thread sums its pixels in order,
// then a shuffle tree and the warps left to right (a fixed order).
__global__ void __launch_bounds__(256)
    window_norms(const float* __restrict__ frames, const Geometry gm,
                 float* __restrict__ norms) {
  __shared__ float red[8];
  const int m = blockIdx.x;
  const int n = m / (gm.my * gm.mx), rem = m - n * gm.my * gm.mx;
  const int ky = rem / gm.mx, kx = rem - ky * gm.mx;
  const float* win = frames +
                     ((size_t)n * gm.H + (size_t)ky * gm.stride) * gm.W +
                     (size_t)kx * gm.stride;
  float sum = 0.f;
  for (int e = threadIdx.x; e < gm.h * gm.w; e += blockDim.x) {
    const int r = e / gm.w;
    const float x = win[(size_t)r * gm.W + (e - r * gm.w)];
    sum = fmaf(x, x, sum);
  }
  sum = warp_sum(sum);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < (int)(blockDim.x >> 5); ++i) sum = sum + red[i];
    norms[m] = sqrtf(fmaxf(sum, 1e-16f));
  }
}

int gcd(int a, int b) {
  while (b != 0) {
    const int r = a % b;
    a = b;
    b = r;
  }
  return a;
}

dim3 grid_of(int R, int mx, int n_ct) {
  return dim3(n_ct, (R + kBM - 1) / kBM, (mx + kKX - 1) / kKX);
}

// Let score_f32<kVec> take kSmemBytes (> 48 KB) of dynamic shared memory
// on this device; looked up once per device (the first kMaxDevices).
template <bool kVec>
cudaError_t allow_smem() {
  constexpr int kMaxDevices = encode_common::kMaxDevices;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(score_f32<kVec>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (dev < kMaxDevices) done[dev] = err == cudaSuccess;
  return err;
}

}  // namespace

extern "C" {

// The column tile: the partition of td into partials.
int sliding_scores_f32_col_tile() { return kBN; }

// Consecutive windows per block.
int sliding_scores_f32_windows() { return kKX; }

// Dynamic shared memory of one score_f32 block.
size_t sliding_scores_f32_smem_bytes() { return kSmemBytes; }

// For a launch over R = N*my rows, mx window columns and n_ct column
// tiles: the row tile, blocks, resident blocks per SM and shared memory
// per block, for the wave arithmetic in PERF.md. Returns the first error.
int sliding_scores_f32_occupancy(int R, int mx, int n_ct, int* tile_m,
                                 int* blocks, int* per_sm, int* smem_bytes) {
  cudaError_t err = allow_smem<true>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, score_f32<true>, kThreads, kSmemBytes);
  const dim3 grid = grid_of(R, mx, n_ct);
  *tile_m = kBM;
  *blocks = (int)(grid.x * grid.y * grid.z);
  *smem_bytes = kSmemBytes;
  return (int)err;
}

// The partials of N frames: the window norms, then the scoring kernel,
// which writes the n_dt * ceil(td / 128) column tiles' partials
// (n_ct, N*my*mx, 3) of the n_dt D-tiles it is given (the tiles of one
// rank of a split D: slabs, bias and class tiles cut to them). Scratch
// from the caller: norms, N*my*mx floats. Returns the first launch error.
int sliding_scores_f32_partials(const float* frames, const float* slabs,
                                const float* bias, const float* cpos,
                                const float* cneg, float* norms,
                                float* partials, int N, int H, int W, int h,
                                int w, int stride, int td, int n_dt,
                                int frames_per_stream, int nonlinearity,
                                cudaStream_t stream) {
  Args a;
  Geometry& gm = a.gm;
  gm.N = N;
  gm.H = H;
  gm.W = W;
  gm.h = h;
  gm.w = w;
  gm.stride = stride;
  gm.my = (H - h) / stride + 1;
  gm.mx = (W - w) / stride + 1;
  gm.g = gcd(stride, w);
  gm.nkb = (h * gm.g + kBK - 1) / kBK;
  gm.dr = kBK / gm.g;
  gm.dc = kBK % gm.g;
  gm.rows = (kBK - 2 + gm.g) / gm.g + 1;
  gm.slot = (kBN + std::min(gm.g, kBK) + 2 + 3) / 4 * 4;
  a.frames = frames;
  a.slabs = slabs;
  a.bias = bias;
  a.cpos = cpos;
  a.cneg = cneg;
  a.norms = norms;
  a.partials = partials;
  a.td = td;
  a.n_dt = n_dt;
  a.tiles_per_dt = (td + kBN - 1) / kBN;
  a.frames_per_stream = frames_per_stream;
  a.nonlinearity = nonlinearity;
  if (gm.rows * gm.slot > kBSlots || !encode_common::aligned16(slabs))
    return (int)cudaErrorInvalidValue;
  const bool vec = gm.g % 4 == 0 && W % 4 == 0 &&
                   encode_common::aligned16(frames);
  const dim3 grid = grid_of(N * gm.my, gm.mx, n_dt * a.tiles_per_dt);
  cudaError_t err = vec ? allow_smem<true>() : allow_smem<false>();
  if (err != cudaSuccess) return (int)err;
  window_norms<<<N * gm.my * gm.mx, 256, 0, stream>>>(frames, gm, norms);
  if (vec)
    score_f32<true><<<grid, kThreads, kSmemBytes, stream>>>(a);
  else
    score_f32<false><<<grid, kThreads, kSmemBytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// Scores (M = N*my*mx outputs) from the partials of all n_ct column tiles
// (n_ct, M, 3) in global tile order: fold_epilogue, one launch, with the
// class norms of stream (m / per_frame) / frames_per_stream. Returns its
// launch error.
int sliding_scores_f32_fold(const float* partials, const float* cpos_norm,
                            const float* cneg_norm, float* out, int n_ct,
                            int M, int per_frame, int frames_per_stream,
                            cudaStream_t stream) {
  fold_epilogue<<<(M + 255) / 256, 256, 0, stream>>>(
      partials, cpos_norm, cneg_norm, out, n_ct, M, per_frame,
      frames_per_stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
