// The 3xTF32 tensor-core GEMM mainloop and fused epilogue shared by the two
// fragment encoders (hdc_encode.cu, hdc_encode_perm.cu):
//
//   out[n, d] = nonlin(sum_k x[n, k] * B[k, d], b[d])
//
// The encoders differ only in where B[k, d] comes from: a dense (K, D)
// base, or the permutation base generated from its (h, D) generator rows.
// A base functor stages one K step of B into shared memory and names the
// shared-memory row that holds B[k0 + kk, d0 : d0 + kBN].
//
// What bounds it on the H100: operations. Three TF32 products per
// multiply-add (below) make 3 * 2*N*K*D operations over the 495 TFLOP/s
// dense TF32 tensor-core peak: 0.286 ms at 512 x 9216 x 5000, 0.215 ms at
// 384 x 9216 x 5000, against 0.704 / 0.528 ms for plain float32 on the
// CUDA cores (67 TFLOP/s). The bytes (x, the base, the output) take a
// fifth of that at 3.35 TB/s.
//
// Why 3xTF32: the port holds hypervectors to 1e-4 of the plain float32
// version. One TF32 product keeps 10 mantissa bits and misses that by ~10x
// at K = 9216; splitting each operand v into big = tf32(v) and
// small = tf32(v - big) and summing big*small + small*big + big*big
// (small*small dropped) is as accurate as float32. Each k8 step issues the
// three products in that order, for every output, in both encoders. The
// tensor cores' own accumulate is not round-to-nearest, so the running sum
// never passes through them: each 32-deep K step sums into a fresh
// partial, which joins the float32 accumulator with one IEEE add.
//
// Tiling: one block of 256 threads (8 warps, 2 x 4) computes a 128 x 160
// output tile (each warp 64 x 40: 4 x 5 mma.sync m16n8k8 tiles, whose
// accumulators and partials take 160 registers), or 128 x 128 where that
// tile lets the grid finish in less time on the card's SMs (narrow_tile).
// K is walked in steps of 32 through a ring of 4 shared-memory stages
// filled with cp.async (16-byte copies where rows are 16-byte aligned,
// 4-byte copies otherwise), so three steps are in flight while one is
// multiplied: 156.5 KB (140.5 KB) of dynamic shared memory, one block per
// SM. x rows are padded to 36 floats and base rows to kBN + 8, so every
// fragment load hits 32 distinct banks. At D = 5000 on 132 SMs the
// training encode (N = 512) runs 128 blocks of 128 x 160 in one wave (97%
// of the SMs), the held-out encode (N = 384) 120 blocks of 128 x 128 (91%)
// instead of 96 wide ones (73%).
//
// The whole K loop runs inside one block in the order k = 0, 1, ..., K-1:
// no split-K, no atomics, so a result is bitwise the same from run to run,
// and the two encoders, which feed the same values to the same products in
// the same order, agree bitwise (the tile width changes no output's sum).
// Edges are zero-filled (the cp.async src-size operand) and bounds-checked,
// so N, K and D are arbitrary.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "score_common.cuh"

namespace encode_common {

constexpr int kBM = 128;       // output rows per block
constexpr int kBK = 32;        // K depth per shared-memory stage
constexpr int kStages = 4;     // cp.async ring depth
constexpr int kThreads = 256;  // 8 warps: 2 along M x 4 along N
constexpr int kWarpsN = 4;
constexpr int kWarpM = kBM / (kThreads / 32 / kWarpsN);  // 64
constexpr int kMT = kWarpM / 16;   // m16 tiles per warp
constexpr int kAStride = kBK + 4;  // 36 = 4 (mod 32): conflict-free A loads
constexpr int kAFloats = kBM * kAStride;

// The block's column extent: kNT n8 tiles per warp, kBN = 32 * kNT columns
// (160 or 128). Base rows are padded to kBN + 8 = 8 (mod 32) floats, so B
// fragment loads are conflict-free too.
template <int kNT_>
struct Tile {
  static constexpr int kNT = kNT_;
  static constexpr int kBN = kWarpsN * 8 * kNT;
  static constexpr int kBStride = kBN + 8;
  static constexpr int kBFloats = kBK * kBStride;
  // A permutation stage holds at most kBK * kBN floats of windows
  // (PermBase); a zero row after them stands in for k >= K.
  static constexpr int kZeroRow = kBK * kBN;
  static constexpr int kSmemBytes =
      kStages * ((kAFloats + kBFloats) * (int)sizeof(float) +
                 kBK * (int)sizeof(int));
  static_assert(kZeroRow + kBN <= kBFloats, "zero row outside the stage");
  static_assert(kBStride % 32 == 8, "B fragment loads would conflict");
};
using Wide = Tile<5>;    // 128 x 160
using Narrow = Tile<4>;  // 128 x 128

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Copy 16 (4) bytes to shared memory, or zeros when !valid (src-size 0;
// src must still be a valid address).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// TF32 rounding of float32 bits, nearest with ties away from zero: the
// bits cvt.rna.tf32.f32 gives for finite v, as two full-rate integer ops.
__device__ __forceinline__ uint32_t tf32_rna(uint32_t u) {
  return (u + 0x1000u) & 0xffffe000u;
}

// v = big + small, big = tf32(v), small = tf32(v - big) (the subtraction is
// exact).
__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(__float_as_uint(v));
  small = tf32_rna(__float_as_uint(v - __uint_as_float(big)));
}

// d (16 x 8) = a (16 x 8, row) * b (8 x 8, col) + c in TF32 with float32
// sums. Not volatile: ptxas may interleave independent products.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2],
                                         const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// The x tile: rows n0 .. n0+kBM, columns k0 .. k0+kBK, zero past N and K.
// vec: K % 4 == 0 and x 16-byte aligned, so a 4-float chunk is all in or
// all out.
__device__ __forceinline__ void load_x(float* As, const float* __restrict__ x,
                                       int N, int K, int n0, int k0, bool vec,
                                       int t) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < kBM * kBK / 4 / kThreads; ++i) {
      const int e = t + i * kThreads;
      const int m = e / (kBK / 4), c = 4 * (e % (kBK / 4));
      const int n = n0 + m, k = k0 + c;
      const bool ok = n < N && k < K;
      cp_async16(As + m * kAStride + c, ok ? x + (size_t)n * K + k : x, ok);
    }
  } else {
    for (int e = t; e < kBM * kBK; e += kThreads) {
      const int m = e / kBK, c = e % kBK;
      const int n = n0 + m, k = k0 + c;
      const bool ok = n < N && k < K;
      cp_async4(As + m * kAStride + c, ok ? x + (size_t)n * K + k : x, ok);
    }
  }
}

// B[k, d] of a dense row-major (K, D) base: the stage is the (kBK, kBN)
// tile itself, row kk at kk * kBStride, zero past K and D. vec: D % 4 == 0
// and B 16-byte aligned (D = 5000 rows are 20,000 B).
struct DenseBase {
  const float* __restrict__ B;
  int K, D;
  bool vec;

  template <class T>
  __device__ __forceinline__ void init(float*, int) const {}

  template <class T>
  __device__ __forceinline__ void load(float* Bs, int*, int k0, int d0,
                                       int t) const {
    constexpr int kBN = T::kBN, kBStride = T::kBStride;
    if (vec) {
      for (int e = t; e < kBK * kBN / 4; e += kThreads) {
        const int kk = e / (kBN / 4), c = 4 * (e % (kBN / 4));
        const int k = k0 + kk, d = d0 + c;
        const bool ok = k < K && d < D;
        cp_async16(Bs + kk * kBStride + c, ok ? B + (size_t)k * D + d : B,
                   ok);
      }
    } else {
      for (int e = t; e < kBK * kBN; e += kThreads) {
        const int kk = e / kBN, c = e % kBN;
        const int k = k0 + kk, d = d0 + c;
        const bool ok = k < K && d < D;
        cp_async4(Bs + kk * kBStride + c, ok ? B + (size_t)k * D + d : B, ok);
      }
    }
  }

  template <class T>
  __device__ __forceinline__ int row(const int*, int kk) const {
    return kk * T::kBStride;
  }
};

// B[k, d] of the permutation base: row k = r*w + j of the flattened
// fragment pairs with roll(B0[r], -j), whose element d is B0[r, (d+j) % D]
// (SHIFT == -1). The expanded (h*w, D) base never exists. For each
// generator row r that a K step touches, with j running over [jlo, jhi)
// inside the step, the stage holds the window
//
//   Wr[c] = B0[r, (d0 + jlo + c) % D],  c < kBN + (jhi - jlo) - 1,
//
// and row k of the tile is Wr + (j - jlo): the Hankel view, one shared
// window per generator row instead of a gathered row per k, so the
// mainloop reads it through a per-k offset with no '/' or '%'. A step may
// straddle generator rows (w not a multiple of kBK; w = 96 never does);
// the windows of one step take at most kBK * kBN floats. Per block the
// generators are read as ~(kBN + kBK) floats per K step from L2.
struct PermBase {
  const float* __restrict__ B0;
  int K, D, w;

  template <class T>
  __device__ __forceinline__ void init(float* Bs, int t) const {
    for (int c = t; c < T::kBN; c += kThreads) Bs[T::kZeroRow + c] = 0.f;
  }

  template <class T>
  __device__ __forceinline__ void load(float* Bs, int* offs, int k0, int d0,
                                       int t) const {
    constexpr int kBN = T::kBN;
    const int kend = min(k0 + kBK, K);
    const int r0 = k0 / w, j0 = k0 - r0 * w;
    const int len0 = kBN + min(w, kend - r0 * w) - j0 - 1;  // r0's window
    if (t < kBK) {
      const int k = k0 + t;
      int off = T::kZeroRow;
      if (k < K) {
        const int r = k / w, j = k - r * w;
        // rows between r0 and r are whole: kBN + w - 1 floats each
        off = (r == r0) ? j - j0 : len0 + (r - r0 - 1) * (kBN + w - 1) + j;
      }
      offs[t] = off;
    }
    int at = 0;
    for (int r = r0, jlo = j0; r * w < kend; ++r, jlo = 0) {
      const int len = kBN + min(w, kend - r * w) - jlo - 1;
      const float* g = B0 + (size_t)r * D;
      const int start = d0 + jlo;
      for (int c = t; c < len; c += kThreads)
        cp_async4(Bs + at + c, g + (start + c) % D, true);
      at += len;
    }
  }

  template <class T>
  __device__ __forceinline__ int row(const int* offs, int kk) const {
    return offs[kk];
  }
};

template <class Base, class T>
__global__ void __launch_bounds__(kThreads, 1)
    encode_kernel(const float* __restrict__ x,     // (N, K)
                  Base base,                        // B[k, d], (K, D)
                  const float* __restrict__ bias,  // (D,)
                  float* __restrict__ out,         // (N, D)
                  int N, int K, int D, int nonlinearity, int x_vec) {
  constexpr int kNT = T::kNT, kBN = T::kBN, kBFloats = T::kBFloats;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                      // kStages x (kBM, kAStride)
  float* Bs = As + kStages * kAFloats;   // kStages x (kBK, kBStride)
  int* offs = reinterpret_cast<int*>(Bs + kStages * kBFloats);  // x kBK
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, q = lane & 3;  // mma fragment row / column
  const int wm = (warp / kWarpsN) * kWarpM, wn = (warp % kWarpsN) * 8 * kNT;
  const int n0 = blockIdx.y * kBM, d0 = blockIdx.x * kBN;
  const int nk = (K + kBK - 1) / kBK;

  for (int s = 0; s < kStages; ++s)
    base.template init<T>(Bs + s * kBFloats, t);

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0.f;

  // prologue: steps 0 .. kStages-2 in flight (one group each, empty past K)
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) {
      load_x(As + s * kAFloats, x, N, K, n0, s * kBK, x_vec, t);
      base.template load<T>(Bs + s * kBFloats, offs + s * kBK, s * kBK, d0,
                            t);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // step kt has landed (this thread's part)
    __syncthreads();               // ... everyone's; step kt-1 is consumed
    const int pre = kt + kStages - 1;
    if (pre < nk) {
      const int s = pre % kStages;
      load_x(As + s * kAFloats, x, N, K, n0, pre * kBK, x_vec, t);
      base.template load<T>(Bs + s * kBFloats, offs + s * kBK, pre * kBK, d0,
                            t);
    }
    cp_async_commit();

    const int s = kt % kStages;
    const float* A = As + s * kAFloats;
    const float* B = Bs + s * kBFloats;
    const int* of = offs + s * kBK;
    // This step's partial on the tensor cores, per k8 big*small,
    // small*big, big*big. Fed the running sum over all of K instead, their
    // accumulate's rounding error is biased and grows with K, past the
    // 1e-4 hypervector tolerance at K = 9216 on the H100.
    float part[kMT][kNT][4];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t ab[kMT][4], as[kMT][4], bb[kNT][2], bs[kNT][2];
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = wm + mi * 16 + g + (i & 1) * 8;
          const int c = kk + q + (i >> 1) * 4;
          split_tf32(A[m * kAStride + c], ab[mi][i], as[mi][i]);
        }
      const int r0 = base.template row<T>(of, kk + q);
      const int r1 = base.template row<T>(of, kk + q + 4);
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) {
        const int c = wn + ni * 8 + g;
        split_tf32(B[r0 + c], bb[ni][0], bs[ni][0]);
        split_tf32(B[r1 + c], bb[ni][1], bs[ni][1]);
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
        for (int i = 0; i < 4; ++i) acc[mi][ni][i] += part[mi][ni][i];
  }
  cp_async_wait<0>();  // only empty groups remain; leave none behind

  // fused epilogue: the precise cosf/sinf (no --use_fast_math), see
  // score_common.cuh. Accumulator i holds row g + 8*(i/2), column
  // 2*q + i%2 of its 16 x 8 tile.
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n0 + wm + mi * 16 + g + (i >> 1) * 8;
        const int d = d0 + wn + ni * 8 + 2 * q + (i & 1);
        if (n < N && d < D)
          out[(size_t)n * D + d] = score_common::apply_nonlinearity(
              acc[mi][ni][i], bias[d], nonlinearity);
      }
}

inline bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

inline int grid_blocks(int N, int D, int bn) {
  return ((D + bn - 1) / bn) * ((N + kBM - 1) / kBM);
}

// Per-device facts a launch needs, looked up once per device (the first
// kMaxDevices of them) and kept: each launch pays the host's time before
// the kernel starts.
constexpr int kMaxDevices = 64;

inline int sm_count(int dev) {
  static int known[kMaxDevices] = {};
  if (dev < kMaxDevices && known[dev] > 0) return known[dev];
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (sms <= 0) return 1;
  if (dev < kMaxDevices) known[dev] = sms;
  return sms;
}

// Let encode_kernel<Base, T> take T::kSmemBytes (> 48 KB) of dynamic
// shared memory on this device.
template <class Base, class T>
cudaError_t allow_smem(int dev) {
  static bool done[kMaxDevices] = {};
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      encode_kernel<Base, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmemBytes);
  if (dev < kMaxDevices) done[dev] = err == cudaSuccess;
  return err;
}

// The tile width for an (N, D) encode: the one whose waves of one block
// per SM take the least time (waves x columns per block; a tie goes to
// the wide tile). 512 x 5000 on 132 SMs: 128 wide blocks, one wave;
// 384 x 5000: 120 narrow blocks, one wave, instead of 96 wide ones.
inline bool narrow_tile(int N, int D, int dev) {
  const int sms = sm_count(dev);
  const auto waves = [&](int bn) {
    return (grid_blocks(N, D, bn) + sms - 1) / sms;
  };
  return waves(Narrow::kBN) * Narrow::kBN < waves(Wide::kBN) * Wide::kBN;
}

template <class Base, class T>
int launch_tile(const float* x, Base base, const float* bias, float* out,
                int N, int K, int D, int nonlinearity, int dev,
                cudaStream_t stream) {
  const cudaError_t err = allow_smem<Base, T>(dev);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((D + T::kBN - 1) / T::kBN, (N + kBM - 1) / kBM);
  encode_kernel<Base, T><<<grid, kThreads, T::kSmemBytes, stream>>>(
      x, base, bias, out, N, K, D, nonlinearity,
      K % 4 == 0 && aligned16(x));
  return (int)cudaGetLastError();
}

template <class Base>
int launch_encode(const float* x, Base base, const float* bias, float* out,
                  int N, int K, int D, int nonlinearity,
                  cudaStream_t stream) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return narrow_tile(N, D, dev)
             ? launch_tile<Base, Narrow>(x, base, bias, out, N, K, D,
                                         nonlinearity, dev, stream)
             : launch_tile<Base, Wide>(x, base, bias, out, N, K, D,
                                       nonlinearity, dev, stream);
}

// For an (N, D) encode: the tile width chosen, blocks, resident blocks
// per SM and dynamic shared memory per block, for the wave arithmetic in
// PERF.md.
template <class Base>
int encode_occupancy(int N, int D, int* tile_n, int* blocks, int* per_sm,
                     int* smem_bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  const bool narrow = err == cudaSuccess && narrow_tile(N, D, dev);
  if (err == cudaSuccess)
    err = narrow ? allow_smem<Base, Narrow>(dev) : allow_smem<Base, Wide>(dev);
  const int smem = narrow ? Narrow::kSmemBytes : Wide::kSmemBytes;
  const auto kernel =
      narrow ? encode_kernel<Base, Narrow> : encode_kernel<Base, Wide>;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                        kThreads, smem);
  *tile_n = narrow ? Narrow::kBN : Wide::kBN;
  *blocks = grid_blocks(N, D, *tile_n);
  *smem_bytes = smem;
  return (int)err;
}

}  // namespace encode_common
