// Low-precision integer HyperSense frame scoring for Hopper, on the int8
// tensor cores: raw ADC codes in, float score maps out.
//
// Replaces the TPU kernel
// src/repro/kernels/sliding_scores_int.py::_score_kernel_int (reached
// through fragment_scores_batch_int). Same function: for frame n, fragment
// row ky and column kx, D-tile dt and hypervector column j, the exact int32
// window sum
//
//   acc[(n, ky, kx), j] = sum_{r<h} sum_{i<w} codes[n, ky*s + r, kx*s + i]
//                                           * slabs_q[dt, r, kx*s + i + j]
//
// (int8 or +-1 slab values; 8-bit, packed 4-bit or wider codes; the slabs
// are in the unrolled orientation, so a window reads them from its own
// first pixel on), then the float epilogue acc / norm, the nonlinearity and
// the classifier partials, a fold in fixed order and the cosine epilogue.
//
// The sum as one GEMM per D-tile and fragment column kx: rows (n, ky),
// R = N*my of them; columns j < td; depth k = (r, i) with i running over w
// rounded up to a multiple of 4 (w4; i >= w reads code 0), K = h*w4:
//
//   A[(n, ky), k] = codes[n, ky*s + r, kx*s + i]   u8, one byte per code
//   B[k, j]       = slabs_q[dt, r, kx*s + i + j]   s8, a Hankel view
//
// run with mma.sync m16n8k32 s32.u8.s8.s32 into int32 registers. Integer
// adds wrap modulo 2^32 and wrapping addition is associative, so the tensor
// cores' accumulate gives the same bits in any order: the true sum wherever
// it fits in int32 (the int_datapath_bounds contract), bitwise equal to
// sliding_scores_int._int_window_acc. acc_out, when not null, receives it
// in the (N, my, n_dt, mx, td) layout for that check. This form does h*w
// multiply-adds per window, not the h*W per row band of the paper's reuse
// (the reuse bound stays the kernel's bound_ms; bound_tc_ms is this GEMM's
// own): 2*800*9216*5000 operations at the paper's 32-frame chunk, 0.037 ms
// at the int8 tensor cores' 1,979 TOPS.
//
// Codes wider than 8 bits (uint16, int32) run Horner over their bytes with
// one accumulator: the K loop over the highest byte of every code, then the
// accumulator shifted left by 8 (wrapping) and the next byte's products
// added into the same registers, down to byte 0. Exact modulo 2^32.
//
// Four launches per call (two entries, below):
// 1. window_norms: each window's exact int32 sum of squared codes, then
//    max(sqrt, 1e-8) / slab_scale, the plain version's float steps.
// 2. im2col: A as a dense u8 matrix per byte pass and kx, (passes, mx, R,
//    Kp) with Kp = K rounded up to 32, zero past w and K. It takes the
//    codes' layout (bytes, packed nibbles low nibble first, the bytes of
//    uint16 or int32 codes), any stride and any width, so the main loop
//    sees one aligned operand: 7.4 MB at the paper's chunk, L2-resident.
// 3. score_int, the GEMM with the fused scoring epilogue;
// 4. fold_epilogue.
// sliding_scores_int_partials makes the first three over the D-tiles it is
// given and sliding_scores_int_fold the fourth over a (n_ct, M, 3) buffer.
// A call runs both back to back; a D split over ranks runs each rank's
// contiguous D-tiles through the first, gathers the partials in tile
// order and folds all of them with the second: the same partials, folded
// in the same order.
//
// Operands of score_int. A step covers kBK = 32*kSub of k (kSub m16n8k32
// products per warp tile): kBK/4 groups of 4 consecutive k, each inside
// one base row (w4 is a multiple of 4), so each group is one B register
// per column: the 4 slab bytes at slabs_q[dt, r, kx*s + j0 + i + c ...].
// A step may straddle base rows (w4 not a multiple of kBK); each group
// finds its own row. Per step and group the block stages the
// column tile's slab window from its 16-byte-aligned start (ten 16-byte
// copies, zero past the slabs' end) and its byte shift (0..15); a B
// register is read as a Hankel view: two aligned shared loads joined with
// __funnelshift_r at the byte offset. A rows (kBK bytes a step) are read
// back with ldmatrix from rows padded by 16 bytes (conflict-free).
//
// Pipeline: a ring of kStages stages of dynamic shared memory filled with
// 16-byte cp.async copies, kStages - 1 steps in
// flight while one is multiplied; K advances by counters, with no division
// in the loop. The whole K loop runs inside one block.
//
// Tiles: 256 threads, 8 warps, 2 along M x 4 along N; a block computes
// kBM = 64 rows (n, ky) of one kx by 128 columns. The column tile is
// fixed: which columns share a partial, and in what order they are summed,
// is a function of td alone, never of N, M or the SM count, so a frame's
// scores are bitwise the same at any batch position, in any chunking, in a
// fleet or alone. A row's epilogue: each thread sums its 8 columns in
// order, the 4 threads of a row combine in a fixed butterfly, the 4 warps
// along N left to right through shared memory; partials (n_col_tiles, M, 3)
// are folded left to right by fold_epilogue. cosf/sinf stay IEEE
// (score_common.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "score_common.cuh"

using namespace score_common;

namespace {

enum CodesLayout { kU8 = 0, kPackedNibbles = 1, kI32 = 2, kU16 = 3 };

constexpr int kThreads = 256;
constexpr int kWarpsN = 4;              // 2 warps along M
constexpr int kBN = 128;                // the column tile (fixed)
constexpr int kNT = kBN / kWarpsN / 8;  // n8 tiles per warp
constexpr int kSub = 2;                 // m16n8k32 products per step
constexpr int kBK = 32 * kSub;          // k per step
constexpr int kGroups = kBK / 4;        // 4-k groups per step
constexpr int kAStride = kBK + 16;      // bytes per staged A row
constexpr int kWinChunks = 10;  // 16-byte copies over a group's window
constexpr int kWinWords = 4 * kWinChunks;
constexpr int kStages = 4;              // cp.async ring depth
constexpr int kMT = 2;                  // m16 tiles per warp
constexpr int kBM = 2 * 16 * kMT;       // the row tile
constexpr int kABytes = kBM * kAStride;
// words per group window: = 8 (mod 32), so the 4 groups a warp reads at
// once fall in distinct banks. A window from its 16-byte-aligned start:
// shift (< 16) + 128 columns + 3 bytes.
constexpr int kGroupWords = kWinWords;
constexpr int kBWords = kGroups * kGroupWords;
constexpr int kBTasks = kGroups * kWinChunks;  // 16-byte copies
constexpr int kBPerThread = (kBTasks + kThreads - 1) / kThreads;
static_assert(kGroupWords % 32 == 8, "B reads would conflict");
static_assert(4 * kWinWords >= 15 + kBN + 4, "window too short");
constexpr int kAPerThread = kBM * kBK / 16 / kThreads;
constexpr int kStageBytes = kABytes + 4 * kBWords + 4 * kGroups;
constexpr int kSmemBytes = kStages * kStageBytes;
static_assert(kWarpsN * kBM * 3 * 4 <= kSmemBytes, "no room to reduce");
static_assert(kAPerThread * kThreads * 16 == kBM * kBK, "A copies");
static_assert(kStageBytes % 16 == 0, "stages 16-byte aligned");
static_assert(kSmemBytes <= 48 * 1024, "needs no opt-in to launch");

__device__ __forceinline__ int load_code(const void* codes, size_t off,
                                         int layout) {
  if (layout == kU8) return ((const uint8_t*)codes)[off];
  if (layout == kPackedNibbles) {
    const int byte = ((const uint8_t*)codes)[off >> 1];
    return (byte >> ((off & 1) * 4)) & 0xF;
  }
  if (layout == kU16) return ((const uint16_t*)codes)[off];
  return ((const int32_t*)codes)[off];
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Copy 16 bytes to shared memory; only the first n of them are read, the
// rest are zero-filled (n = 0: src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4],
                                            const uint8_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d (16 x 8, s32) += a (16 x 32, u8, row) * b (32 x 8, s8, col), wrapping.
__device__ __forceinline__ void mma_u8s8(int (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct Geometry {
  int N, H, W, h, w, stride, my, mx;
  int w4, Kp, passes, layout;
};

// norms[m] = max(sqrt(sum of the window's squared codes), 1e-8) / scale,
// one block per window: the exact int32 sum (wrapping, as the summed-area
// table of the plain version wraps) and the same float steps, so the same
// bits as sliding_scores_int._scaled_norms.
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
    const unsigned c = (unsigned)load_code(
        codes, base + (size_t)r * gm.W + (e - r * gm.w), gm.layout);
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

// acol[pass, kx, (n, ky), k]: byte (passes - 1 - pass) of the code A reads,
// 0 past w and K. One block per row (pass, kx, n, ky), a 4-byte group per
// thread and loop.
__global__ void __launch_bounds__(256)
    im2col(const void* __restrict__ codes, const Geometry gm,
           uint32_t* __restrict__ acol) {
  const int R = gm.N * gm.my, K4 = gm.h * gm.w4;
  const int row = blockIdx.x, rr = row % R, kx = (row / R) % gm.mx;
  const int byte = gm.passes - 1 - row / (R * gm.mx);
  const int n = rr / gm.my, ky = rr - n * gm.my;
  const size_t base = ((size_t)n * gm.H + (size_t)ky * gm.stride) * gm.W +
                      (size_t)kx * gm.stride;
  uint32_t* out = acol + (size_t)row * (gm.Kp / 4);
  for (int kw = threadIdx.x; kw < gm.Kp / 4; kw += blockDim.x) {
    const int k = 4 * kw;
    uint32_t v = 0;
    if (k < K4) {
      const int r = k / gm.w4, i = k - r * gm.w4;
      const size_t off = base + (size_t)r * gm.W + i;
      for (int e = 0; e < min(4, gm.w - i); ++e)
        v |= (((uint32_t)load_code(codes, off + e, gm.layout) >> (8 * byte)) &
              0xFFu) << (8 * e);
    }
    out[kw] = v;
  }
}

struct Args {
  const uint8_t* acol;   // (passes, mx, R, Kp) from im2col
  const int8_t* slabs;   // (n_dt, h, td + W - 1), 16-byte aligned
  const float* bias;     // (n_dt, mx, td)
  const int8_t* cpos;    // (S * n_dt, mx, td)
  const int8_t* cneg;    // (S * n_dt, mx, td)
  const float* norms;    // (N, my, mx), slab scale folded in
  float* partials;       // (n_col_tiles, M, 3)
  int32_t* acc_out;      // (N, my, n_dt, mx, td) or null
  Geometry gm;
  int td, n_dt, tiles_per_dt, frames_per_stream, nonlinearity;
};

__global__ void __launch_bounds__(kThreads) score_int(const Args p) {
  extern __shared__ __align__(16) uint8_t smem[];  // kSmemBytes

  const Geometry gm = p.gm;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int warp_n = warp % kWarpsN;
  const int wm = (warp / kWarpsN) * 16 * kMT, wn = warp_n * 8 * kNT;
  const int ct = blockIdx.x, dt = ct / p.tiles_per_dt;
  const int j0 = (ct - dt * p.tiles_per_dt) * kBN;
  const int r0 = blockIdx.y * kBM, kx = blockIdx.z;
  const int R = gm.N * gm.my, M = R * gm.mx;
  const int w4 = gm.w4, nk = gm.Kp / kBK, steps = gm.passes * nk;
  const int L = p.td + gm.W - 1;
  const long long slab_bytes = (long long)p.n_dt * gm.h * L;
  // the slab byte of B[(r, i) = (0, 0), j0] for this block's windows,
  // which start at pixel kx*s
  const long long b_base =
      (long long)dt * gm.h * L + (long long)kx * gm.stride + j0;

  // A: thread t copies 16-byte chunk v*kThreads + t of each step (chunk
  // c: row c / (kBK/16), part c % (kBK/16)); rows past R are zero-filled
  int a_dst[kAPerThread];
  bool a_in[kAPerThread];
  const uint8_t* a_src[kAPerThread];
#pragma unroll
  for (int v = 0; v < kAPerThread; ++v) {
    const int c = v * kThreads + t, row = c / (kBK / 16);
    const int part = c - row * (kBK / 16);
    a_in[v] = r0 + row < R;
    a_dst[v] = row * kAStride + 16 * part;
    a_src[v] = p.acol +
               ((size_t)kx * R + (a_in[v] ? r0 + row : 0)) * gm.Kp +
               16 * part;
  }
  const size_t a_pass = (size_t)gm.mx * R * gm.Kp;  // one byte plane
  // B: task u of this thread copies chunk b_x of group b_gi's window; its
  // cursor (br, bi) is the group's base row and position at the step loaded
  int b_gi[kBPerThread], b_x[kBPerThread], br[kBPerThread],
      bi[kBPerThread];
#pragma unroll
  for (int u = 0; u < kBPerThread; ++u) {
    const int task = min(u * kThreads + t, kBTasks - 1);
    b_gi[u] = task / kWinChunks;
    b_x[u] = task - b_gi[u] * kWinChunks;
  }
  int sr = 0, si = 0;  // group t's cursor, for its byte shift
  int ld_kt = 0, ld_pass = 0;  // the step being loaded

  // issue step (ld_pass, ld_kt)'s copies into stage st and advance
  const auto load = [&](int st) {
    uint8_t* base = smem + st * kStageBytes;
    uint32_t* Bs = (uint32_t*)(base + kABytes);
    if (ld_kt == 0) {  // a byte pass starts over at k = 0
#pragma unroll
      for (int u = 0; u < kBPerThread; ++u) {
        br[u] = 4 * b_gi[u] / w4;
        bi[u] = 4 * b_gi[u] - br[u] * w4;
      }
      sr = 4 * (t & (kGroups - 1)) / w4;
      si = 4 * (t & (kGroups - 1)) - sr * w4;
    }
#pragma unroll
    for (int v = 0; v < kAPerThread; ++v)
      cp_async16(base + a_dst[v],
                 a_src[v] + ld_pass * a_pass + (size_t)ld_kt * kBK,
                 a_in[v] ? 16 : 0);
#pragma unroll
    for (int u = 0; u < kBPerThread; ++u) {
      if (u * kThreads + t >= kBTasks) continue;
      int n = 0;
      long long off = 0;
      if (br[u] < gm.h) {
        const long long src = b_base + (long long)br[u] * L + bi[u];
        off = (src & ~15LL) + 16LL * b_x[u];
        n = (int)max(0LL, min(16LL, slab_bytes - off));
      }
      cp_async16(Bs + b_gi[u] * kGroupWords + 4 * b_x[u],
                 n > 0 ? p.slabs + off : p.slabs, n);
    }
    if (t < kGroups)
      ((int*)(Bs + kBWords))[t] =
          sr < gm.h ? (int)((b_base + (long long)sr * L + si) & 15) : 0;
    if (++ld_kt == nk) {
      ld_kt = 0;
      ++ld_pass;
    } else {
#pragma unroll
      for (int u = 0; u < kBPerThread; ++u) {
        bi[u] += kBK;
        while (bi[u] >= w4) {
          bi[u] -= w4;
          ++br[u];
        }
      }
      si += kBK;
      while (si >= w4) {
        si -= w4;
        ++sr;
      }
    }
  };

  int acc[kMT][kNT][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  // Iteration s loads step s + kStages - 1 (one cp.async group each, empty
  // past the last step) and multiplies step s; s < 0 only fills the ring.
  // load has this one call site, so its state stays in registers.
  int kt = 0;  // the step multiplied, within its byte pass
  for (int s = 1 - kStages; s < steps; ++s) {
    if (s >= 0) {
      cp_async_wait<kStages - 2>();  // step s has landed (this thread's part)
      __syncthreads();               // ... everyone's; step s-1 is consumed
    }
    if (s + kStages - 1 < steps) load((s + kStages - 1) % kStages);
    cp_async_commit();
    if (s < 0) continue;

    const uint8_t* base = smem + (s % kStages) * kStageBytes;
    const uint32_t* Bs = (const uint32_t*)(base + kABytes);
    const int* shs = (const int*)(Bs + kBWords);

    if (kt == nk) {  // Horner: the next (lower) byte of the codes
      kt = 0;
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[mi][ni][e] = (int)((unsigned)acc[mi][ni][e] << 8);
    }
    ++kt;
#pragma unroll
    for (int sub = 0; sub < kSub; ++sub) {
      uint32_t af[kMT][4], bf[kNT][2];
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
        ldmatrix_x4(af[mi], base + (wm + mi * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * kAStride +
                                32 * sub + (lane >> 4) * 16);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // column c = wn + 8 ni + g is byte o = sh + c of the window; the
        // byte offset within a word is the same for every ni
        const int gi = 8 * sub + q + 4 * half;
        const int o = shs[gi] + wn + g, sh8 = 8 * (o & 3);
        const uint32_t* row = Bs + gi * kGroupWords + (o >> 2);
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni)
          bf[ni][half] = __funnelshift_r(row[2 * ni], row[2 * ni + 1], sh8);
      }
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni) mma_u8s8(acc[mi][ni], af[mi], bf[ni]);
    }
  }
  cp_async_wait<0>();  // only empty groups remain; leave none behind
  __syncthreads();     // the stages are consumed: the reduction reuses them

  // epilogue. Accumulator e holds row g + 8*(e/2), column 2q + e%2 of its
  // 16 x 8 tile.
  float* red = (float*)smem;  // (kWarpsN, kBM, 3)
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = wm + mi * 16 + g + 8 * half, rr = r0 + row;
      float dp = 0.f, dn = 0.f, qq = 0.f;
      if (rr < R) {
        const int n = rr / gm.my, ky = rr - n * gm.my;
        const float nm = p.norms[(size_t)rr * gm.mx + kx];
        const int stream = n / p.frames_per_stream;
        const size_t brow = ((size_t)dt * gm.mx + kx) * p.td;
        const size_t crow =
            (((size_t)stream * p.n_dt + dt) * gm.mx + kx) * p.td;
        int32_t* arow =
            p.acc_out == nullptr
                ? nullptr
                : p.acc_out +
                      ((((size_t)n * gm.my + ky) * p.n_dt + dt) * gm.mx + kx) *
                          p.td;
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = j0 + wn + ni * 8 + 2 * q + e;
            if (j < p.td) {
              const int a = acc[mi][ni][2 * half + e];
              if (arow != nullptr) arow[j] = a;
              const float phi = apply_nonlinearity(
                  (float)a / nm, p.bias[brow + j], p.nonlinearity);
              dp += phi * (float)p.cpos[crow + j];
              dn += phi * (float)p.cneg[crow + j];
              qq += phi * phi;
            }
          }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        dp += __shfl_xor_sync(0xffffffffu, dp, o);
        dn += __shfl_xor_sync(0xffffffffu, dn, o);
        qq += __shfl_xor_sync(0xffffffffu, qq, o);
      }
      if (q == 0) {
        float* o = red + 3 * (warp_n * kBM + row);
        o[0] = dp;
        o[1] = dn;
        o[2] = qq;
      }
    }
  __syncthreads();
  for (int row = t; row < kBM; row += kThreads) {
    const int rr = r0 + row;
    if (rr >= R) continue;
    const size_t m = (size_t)rr * gm.mx + kx;
    float dp = red[3 * row], dn = red[3 * row + 1], qq = red[3 * row + 2];
    for (int k = 1; k < kWarpsN; ++k) {
      const float* o = red + 3 * (k * kBM + row);
      dp = dp + o[0];
      dn = dn + o[1];
      qq = qq + o[2];
    }
    float* out = p.partials + 3 * ((size_t)ct * M + m);
    out[0] = dp;
    out[1] = dn;
    out[2] = qq;
  }
}

dim3 grid_of(int R, int mx, int n_ct) {
  return dim3(n_ct, (R + kBM - 1) / kBM, mx);
}

int passes(int layout) {
  return layout == kU16 ? 2 : (layout == kI32 ? 4 : 1);
}

}  // namespace

extern "C" {

// The column tile: the partition of td into partials.
int sliding_scores_int_col_tile() { return kBN; }

// Dynamic shared memory of one score_int block.
size_t sliding_scores_int_smem_bytes() { return kSmemBytes; }

// For a launch over R = N*my rows, mx fragment columns and n_ct column
// tiles: the row tile, blocks, resident blocks per SM and shared memory
// per block, for the wave arithmetic in PERF.md. Returns the occupancy
// query's error.
int sliding_scores_int_occupancy(int R, int mx, int n_ct, int* tile_m,
                                 int* blocks, int* per_sm, int* smem_bytes) {
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, score_int, kThreads, kSmemBytes);
  const dim3 grid = grid_of(R, mx, n_ct);
  *tile_m = kBM;
  *blocks = (int)(grid.x * grid.y * grid.z);
  *smem_bytes = kSmemBytes;
  return (int)err;
}

// The partials of N frames from integer codes: the window norms, im2col
// and the scoring kernel, which writes the n_dt * ceil(td / 128) column
// tiles' partials (n_ct, N*my*mx, 3) of the n_dt D-tiles it is given (the
// tiles of one rank of a split D). layout: 0 = uint8 codes (N, H, W),
// 1 = packed nibbles (N, H, W/2), 2 = int32 (N, H, W), 3 = uint16
// (N, H, W). slab_scale: the geometry's scalar scale, on the device.
// Scratch from the caller: norms, N*my*mx floats; acol, passes * mx *
// N*my * Kp bytes (passes: 1, 1, 4, 2 by layout; Kp = h * w4 rounded up
// to kBK, w4 = w rounded up to 4), 16-byte aligned. The slabs must be
// 16-byte aligned. acc_out, if not null, takes the int32 window sums
// (N, my, n_dt, mx, td). Returns the first launch error.
int sliding_scores_int_partials(const void* codes, const int8_t* slabs,
                                const float* bias, const int8_t* cpos,
                                const int8_t* cneg, const float* slab_scale,
                                float* norms, uint8_t* acol, float* partials,
                                int32_t* acc_out, int N, int H, int W, int h,
                                int w, int stride, int td, int n_dt,
                                int frames_per_stream, int nonlinearity,
                                int layout, cudaStream_t stream) {
  if ((uintptr_t)slabs % 16 != 0 || (uintptr_t)acol % 16 != 0 ||
      layout < kU8 || layout > kU16)
    return (int)cudaErrorInvalidValue;
  Geometry gm;
  gm.N = N;
  gm.H = H;
  gm.W = W;
  gm.h = h;
  gm.w = w;
  gm.stride = stride;
  gm.my = (H - h) / stride + 1;
  gm.mx = (W - w) / stride + 1;
  gm.w4 = (w + 3) & ~3;
  gm.Kp = (h * gm.w4 + kBK - 1) / kBK * kBK;
  gm.passes = passes(layout);
  gm.layout = layout;
  const int M = N * gm.my * gm.mx;
  window_norms<<<M, 256, 0, stream>>>(codes, gm, slab_scale, norms);
  im2col<<<gm.passes * M, 256, 0, stream>>>(codes, gm, (uint32_t*)acol);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.acol = acol;
  a.slabs = slabs;
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
  a.frames_per_stream = frames_per_stream;
  a.nonlinearity = nonlinearity;
  score_int<<<grid_of(N * gm.my, gm.mx, n_dt * a.tiles_per_dt), kThreads,
              kSmemBytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// Scores (M = N*my*mx outputs) from the partials of all n_ct column tiles
// (n_ct, M, 3) in global tile order: fold_epilogue, one launch, with the
// class norms of stream (m / per_frame) / frames_per_stream. Returns its
// launch error.
int sliding_scores_int_fold(const float* partials, const float* cpos_norm,
                            const float* cneg_norm, float* out, int n_ct,
                            int M, int per_frame, int frames_per_stream,
                            cudaStream_t stream) {
  fold_epilogue<<<(M + 255) / 256, 256, 0, stream>>>(
      partials, cpos_norm, cneg_norm, out, n_ct, M, per_frame,
      frames_per_stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
