// The expanded-slab integer scorer for Hopper, on the int8 tensor cores:
// the int scorer's retired layout, kept as a yardstick for the live kernel
// (sliding_scores_int.cu).
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
// cosine epilogue.
//
// Why the layout is kept. The operand lives in device memory and grows
// linearly in W (h*W*td bytes a D-tile: 61.4 MB at the paper's 128-wide
// frames, 96-row windows and D = 5000; 16*4096*D bytes at the deployment
// geometry of 16x16 windows over 4096-wide frames), where the live kernel
// reads the compact slabs through a Hankel view and its block does not grow
// with W. That difference is what the race in chip_smoke.py's int-datapath
// phase measures, so this kernel reads E as it lies, (r, i) row by row, and
// never the compact slabs: no Hankel view, no im2col scratch, no library
// product.
//
// The design: one GEMM per D-tile, the window indicator as a difference of
// prefix sums. Rows m = (n, ky), M = N*my; columns j < td; depth k = (r, i)
// for r < h and i over the columns the windows use:
//
//   A[m, (r, i)] = codes[n, ky*s + r, i]   u8, the code bytes as they lie
//   B[(r, i), j] = E[dt, r*W + i, j]       s8, the expanded operand
//
// K is walked in column blocks [c0, c1) whose edges are the consecutive
// points of {kx*s} and {kx*s + w} (every 8 columns at the paper's point, with
// one 64-column block between 32 and 96); inside a block, (r, i) runs r-major
// in groups of 4 consecutive i (i past c1 reads code 0), 16 groups a step of
// 64 k. With P_c the prefix sum over the columns before c, window kx is
// P_{kx*s + w} - P_{kx*s}: at a window's opening point the thread stores its
// int32 accumulators in a ring of min(mx, ceil(w/s)) slots of shared memory
// (5 at the paper's point, 2 at the reference's shape); at its closing point
// it subtracts the slot and stores the window's sums to acc, (N, my, n_dt,
// mx, td) int32, the live kernel's acc_out layout (a close before an open at
// the same point, so the slot is free). Each thread reads back only its own
// slots. Integer adds wrap modulo 2^32 and wrapping addition is associative,
// so the window sums are the true int32 sums wherever those fit (the
// int_datapath_bounds contract), bitwise equal to sliding_scores_int's
// int_window_acc in any order.
//
// The product: mma.sync m16n8k32 s32.u8.s8.s32 into int32 registers. Codes
// wider than 8 bits (uint16, int32) run Horner over their bytes: each column
// block is walked once per byte, highest first, into one block accumulator
// that is shifted left by 8 (wrapping) between the passes and then added to
// the prefix. Exact modulo 2^32.
//
// Operands. B: per step the 64 operand rows of the step's groups, 128 bytes
// of one column tile each, are staged with cp.async (16-, 8- or 4-byte
// copies as the rows' alignment allows, td % 16; byte loads for an odd td;
// a warp copies 4 whole rows an instruction) in a ring of kStages stages,
// their 16-byte chunks swizzled by row. A B
// register wants 4 consecutive k of one column, and E holds 4 consecutive
// columns of one k in a word, so a thread loads one word from each of 4
// rows and transposes the 4x4 bytes with __byte_perm: its 4 words become
// the registers of its 4 n8 tiles, whose column g is physical column
// wn + 4g + ni. A: read straight from the codes, one 4-byte group per
// thread and A row. For uint8 codes at a 4-byte-aligned address with W, s
// and w multiples of 4 (every group whole and aligned) the group is one
// 4-byte cp.async into the same stage as B; else (wider codes, groups cut
// at a block's end, an unaligned view) it is loaded byte by byte into
// registers, held across a step's products and stored to the stage after
// them. The copy is the faster route where it applies: chip_smoke.py times
// both on one capture (PERF.md section 6). Read back with ldmatrix.
//
// Tiles: 256 threads, 8 warps, 2 along M x 4 along N, the live kernel's
// kBM = 64 rows (n, ky) by kBN = 128 columns; a geometry whose ring does not
// fit 227 KB at 64 rows takes 32 (the ring, not the tile, sets the shared
// memory: 5 slots of 32 KB at the paper's point beside 5 stages, 225 KB in
// all). The M tiles of one column tile sit side by side in the grid, so
// they run together and E comes from device memory about once a chunk; the
// other reads hit L2.
//
// Epilogue, its own launch over the stored sums (so the cosf/sinf tail of a
// window does not hold the GEMM block's 8 warps), in the live kernel's order
// exactly: per window and 128-column tile, thread (g, q) of warp wn takes
// columns wn + 8ni + 2q + e of row g, phi = RFF(acc / norm, bias) per column,
// each thread sums its 8 columns in order, the quad combines in a butterfly,
// the 4 warps left to right, written to partials (n_col_tiles, M, 3);
// fold_epilogue folds the column tiles left to right. Which columns share a
// partial depends on td alone, and no atomics: a window's score has one order
// on every run, at every batch position, the live kernel's. cosf/sinf stay
// IEEE (score_common.cuh).
//
// Bound on the H100: bytes. Read once, the operand takes 0.018 ms at
// 3.35 TB/s at the paper's 32-frame chunk, against 0.010 ms for its
// 2*N*my*W*h*D = 1.97e10 int8 operations at 1,979 TOPS. Each of the 3 M
// tiles reads it (184 MB, mostly from L2), and the window sums make 16 MB
// to store and read again. One block of 8 warps fits an SM (the ring takes
// 160 KB). Measured on an NVIDIA H100 80GB HBM3 at 700 W by chip_smoke.py
// (PERF.md section 6): 0.245 ms of device time a chunk (score_expanded
// 0.202, expanded_epilogue 0.023), 7.6% of the bytes bound.
//
// Four launches per call: window_norms, score_expanded, expanded_epilogue,
// fold_epilogue.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "score_common.cuh"

using namespace score_common;

namespace {

// the codes' layouts (numbered as in sliding_scores_int.cu; no packed
// nibbles: the reference's twin takes none)
enum CodesLayout { kU8 = 0, kI32 = 2, kU16 = 3 };

constexpr int kThreads = 256;
constexpr int kWarpsN = 4;              // 2 warps along M
constexpr int kBN = 128;                // the column tile (the live kernel's)
constexpr int kNT = kBN / kWarpsN / 8;  // n8 tiles per warp
constexpr int kSub = 2;                 // m16n8k32 products per step
constexpr int kBK = 32 * kSub;          // k per step
constexpr int kGroups = kBK / 4;        // 4-k groups per step
constexpr int kAStride = kBK + 16;      // bytes per staged A row
constexpr int kBBytes = kBK * kBN;      // a stage's operand rows
constexpr int kStages = 5;              // cp.async ring depth
constexpr int kSmemLimit = 232448;      // after the opt-in
static_assert(kThreads % kGroups == 0, "one A group a thread a step");
static_assert(2 * kThreads * 16 == kBBytes, "two B copies a thread");

// The block of 32*MT rows: MT m16 tiles per warp.
template <int MT>
struct Tile {
  static constexpr int kBM = 32 * MT;
  static constexpr int kABytes = kBM * kAStride;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kAcc = MT * kNT * 4;  // int32 accumulators a thread
  static constexpr int kSlotBytes = kAcc * kThreads * 4;
  static constexpr int kARows = kBM * kGroups / kThreads;  // A loads a step
  static constexpr size_t smem(int slots) {
    return (size_t)kStages * kStageBytes + (size_t)slots * kSlotBytes;
  }
  static_assert(kStageBytes % 16 == 0, "stages 16-byte aligned");
};

__device__ __forceinline__ unsigned load_code(const void* codes, size_t off,
                                              int layout) {
  if (layout == kU8) return ((const uint8_t*)codes)[off];
  if (layout == kU16) return ((const uint16_t*)codes)[off];
  return (unsigned)((const int32_t*)codes)[off];
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Copy size bytes to shared memory; only the first n are read, the rest
// are zero-filled (n = 0: src must still be a valid address).
template <int kSize>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int n) {
  if constexpr (kSize == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(kSize), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// 16 bytes of an operand row to shared memory, n of them valid (the rest
// zero), in copies of vec bytes (16, 8 or 4: the rows' alignment; else
// byte loads stored at once). base: a valid address for an empty copy.
__device__ __forceinline__ void copy16(uint8_t* dst, const int8_t* src,
                                       int n, int vec, const int8_t* base) {
  if (vec == 16) {
    cp_async<16>(dst, n > 0 ? src : base, n);
  } else if (vec == 8) {
#pragma unroll
    for (int c = 0; c < 16; c += 8)
      cp_async<8>(dst + c, n > c ? src + c : base, max(0, min(8, n - c)));
  } else if (vec == 4) {
#pragma unroll
    for (int c = 0; c < 16; c += 4)
      cp_async<4>(dst + c, n > c ? src + c : base, max(0, min(4, n - c)));
  } else {
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    for (int b = 0; b < n; ++b)
      v[b >> 2] |= (uint32_t)(uint8_t)src[b] << (8 * (b & 3));
    *(uint4*)dst = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// byte `byte` of the 4 codes at off.. (n of them inside the block, the rest
// 0), packed low byte first
__device__ __forceinline__ uint32_t load_group(const void* codes,
                                               long long off, int n,
                                               int layout, int byte) {
  uint32_t v = 0;
  for (int e = 0; e < min(4, n); ++e)
    v |= ((load_code(codes, off + e, layout) >> (8 * byte)) & 0xFFu)
         << (8 * e);
  return v;
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
  int N, H, W, h, w, stride, my, mx, layout, passes;
};

// The window points in order: {kx*s} and {kx*s + w} for kx < mx, merged.
struct Walk {
  int mx, s, w, ko, kc;  // the next window to open, to close
  __host__ __device__ int next() const {
    const int o = ko < mx ? ko * s : INT_MAX;
    const int c = kc < mx ? kc * s + w : INT_MAX;
    return o < c ? o : c;
  }
  // step past point p: the window that closes there and the one that
  // opens there (-1: none)
  __host__ __device__ void pass(int p, int& closes, int& opens) {
    closes = kc < mx && kc * s + w == p ? kc++ : -1;
    opens = ko < mx && ko * s == p ? ko++ : -1;
  }
};

// K steps a byte pass takes over a column block wb wide
__host__ __device__ inline int block_steps(int h, int wb) {
  return (h * ((wb + 3) >> 2) + kGroups - 1) / kGroups;
}

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
  const void* codes;      // (N, H, W) in gm.layout
  const int8_t* operand;  // (n_dt, h*W, td): expand_slabs
  int32_t* acc;           // (N, my, n_dt, mx, td): the window sums
  Geometry gm;
  int td, n_dt, tiles_per_dt;
  int slots;   // the ring: min(mx, ceil(w / stride))
  int steps;   // K steps of the whole walk, every byte pass
  int a_vec;   // 1: uint8 codes copied a 4-byte group at a time
  int b_vec;   // bytes per operand copy: 16, 8, 4, or 1 (byte loads)
  int acc_vec;  // 1: acc rows take 16-byte stores
};

// A group's place in a column block's walk: base row r, group ii of the
// row, gpr groups a row; a step moves it on by kGroups groups (dq rows and
// dr groups).
struct Cursor {
  int r, ii;
  __device__ void start(int g, int gpr) {
    r = g / gpr;
    ii = g - r * gpr;
  }
  __device__ void advance(int dq, int dr, int gpr) {
    r += dq;
    ii += dr;
    if (ii >= gpr) {
      ii -= gpr;
      ++r;
    }
  }
};

template <int MT>
__global__ void __launch_bounds__(kThreads, 1) score_expanded(const Args p) {
  using Tl = Tile<MT>;
  constexpr int kBM = Tl::kBM, kAcc = Tl::kAcc;
  extern __shared__ __align__(16) uint8_t smem[];
  unsigned* ring = (unsigned*)(smem + kStages * Tl::kStageBytes);
  // ring: (slots, kAcc, kThreads), each thread's own column of it

  const Geometry gm = p.gm;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int warp_n = warp % kWarpsN;
  const int wm = (warp / kWarpsN) * 16 * MT, wn = warp_n * 8 * kNT;
  const int r0 = blockIdx.x * kBM;  // the M tiles of a column tile adjacent
  const int ct = blockIdx.y, dt = ct / p.tiles_per_dt;
  const int j0 = (ct - dt * p.tiles_per_dt) * kBN;
  const int R = gm.N * gm.my;
  // column j0 of operand row 0 of this D-tile
  const int8_t* E = p.operand + (size_t)dt * gm.h * gm.W * p.td + j0;

  // Loads. Each step, thread t copies the 4 codes of group gi = t % 16 for
  // A rows t/16 + 16u, and 16-byte chunk bx = t % 8 of operand rows
  // kr = t/8 and kr + 32 (groups t/32 and t/32 + 8; a warp copies 4 whole
  // rows an instruction), the chunks swizzled by 2 (group % 4).
  const int gi = t & (kGroups - 1);
  long long a_base[Tl::kARows];  // code offset of the row's band; -1 past R
#pragma unroll
  for (int u = 0; u < Tl::kARows; ++u) {
    const int m = r0 + (t >> 4) + 16 * u;
    const int n = m / gm.my, ky = m - n * gm.my;
    a_base[u] = m < R ? ((long long)n * gm.H + (long long)ky * gm.stride) *
                            gm.W
                      : -1;
  }
  const int a_dst = (t >> 4) * kAStride + 4 * gi;
  const int bx = t & 7, be = (t >> 3) & 3;  // chunk, row within its group
  const int bn = max(0, min(16, p.td - j0 - 16 * bx));
  const int b_dst = (t >> 3) * kBN + 16 * (bx ^ (2 * (warp & 3)));

  // the loader's walk: block [lc0, lc1), groups per base row, steps per
  // pass; the step and byte pass; the groups of this thread's A words and
  // of its two B rows, and their advance per step (lq rows, lrem groups)
  Walk lw{gm.mx, gm.stride, gm.w, 0, 0};
  int cl, op;  // the window that closes and opens at a point
  lw.pass(0, cl, op);
  int lc0 = 0, lc1 = lw.next();
  int lgpr = (lc1 + 3) >> 2, lsteps = block_steps(gm.h, lc1);
  int lst = 0, lpass = 0;
  int lq = kGroups / lgpr, lrem = kGroups - lq * lgpr;
  Cursor ca, cb[2];
  ca.start(gi, lgpr);
  cb[0].start(warp, lgpr);
  cb[1].start(warp + 8, lgpr);
  uint32_t a_regs[Tl::kARows];

  // issue the copies of the next step into stage st (A's too for word
  // groups; else load its A words into a_regs), and advance
  const auto load = [&](int st) {
    uint8_t* As = smem + st * Tl::kStageBytes;
    uint8_t* Bs = As + Tl::kABytes;
    const int byte = gm.passes - 1 - lpass;
    const int i0 = lc0 + 4 * ca.ii;
    const int nv = ca.r < gm.h ? lc1 - i0 : 0;  // codes of the group inside
    const long long row = (long long)ca.r * gm.W + i0;
#pragma unroll
    for (int u = 0; u < Tl::kARows; ++u) {
      const bool in = a_base[u] >= 0 && nv > 0;
      if (p.a_vec)
        cp_async<4>(As + a_dst + 16 * u * kAStride,
                    (const uint8_t*)p.codes + (in ? a_base[u] + row : 0),
                    in ? 4 : 0);
      else
        a_regs[u] = in ? load_group(p.codes, a_base[u] + row, nv,
                                    gm.layout, byte)
                       : 0u;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = lc0 + 4 * cb[u].ii + be;
      const bool in = cb[u].r < gm.h && i < lc1;
      copy16(Bs + b_dst + 32 * u * kBN,
             E + ((long long)cb[u].r * gm.W + i) * p.td + 16 * bx,
             in ? bn : 0, p.b_vec, p.operand);
    }
    if (++lst < lsteps) {
      ca.advance(lq, lrem, lgpr);
      cb[0].advance(lq, lrem, lgpr);
      cb[1].advance(lq, lrem, lgpr);
      return;
    }
    lst = 0;
    if (++lpass == gm.passes) {  // the next column block
      lpass = 0;
      int lcl, lop;
      lw.pass(lc1, lcl, lop);
      lc0 = lc1;
      lc1 = lw.next();
      if (lc1 == INT_MAX) return;  // the walk is done
      lgpr = (lc1 - lc0 + 3) >> 2;
      lsteps = block_steps(gm.h, lc1 - lc0);
      lq = kGroups / lgpr;
      lrem = kGroups - lq * lgpr;
    }
    ca.start(gi, lgpr);
    cb[0].start(warp, lgpr);
    cb[1].start(warp + 8, lgpr);
  };

  // the prefix P, the block accumulator T (Horner over byte passes)
  unsigned pre[kAcc];
  int acc[MT][kNT][4];
#pragma unroll
  for (int v = 0; v < kAcc; ++v) pre[v] = 0u;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  // the compute side's walk: window 0 opens at 0 on a zero prefix
  Walk cw{gm.mx, gm.stride, gm.w, 0, 0};
  cw.pass(0, cl, op);
#pragma unroll
  for (int v = 0; v < kAcc; ++v) ring[v * kThreads + t] = 0u;
  int cc1 = cw.next();
  int csteps = block_steps(gm.h, cc1), cst = 0, cpass = 0;

  // a window closes: its sums P - slot, stored. Accumulator e of n8 tile
  // ni holds row g + 8 (e / 2), physical column wn + 8q + 4 (e % 2) + ni,
  // so a thread's 8 sums of a row are 8 consecutive columns.
  const auto close = [&](int kx) {
    const unsigned* slot = ring + (size_t)(kx % p.slots) * kAcc * kThreads;
    const int jq = j0 + wn + 8 * q;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rr = r0 + wm + mi * 16 + g + 8 * half;
        if (rr >= R) continue;
        int own[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int v = (mi * kNT + (c & 3)) * 4 + 2 * half + (c >> 2);
          own[c] = (int)(pre[v] - slot[v * kThreads + t]);
        }
        const int n = rr / gm.my, ky = rr - n * gm.my;
        int32_t* arow =
            p.acc +
            ((((size_t)n * gm.my + ky) * p.n_dt + dt) * gm.mx + kx) * p.td;
        if (p.acc_vec && jq + 8 <= p.td) {
          *(int4*)(arow + jq) = make_int4(own[0], own[1], own[2], own[3]);
          *(int4*)(arow + jq + 4) = make_int4(own[4], own[5], own[6], own[7]);
        } else {
#pragma unroll
          for (int c = 0; c < 8; ++c)
            if (jq + c < p.td) arow[jq + c] = own[c];
        }
      }
  };

  // Iteration s loads step s + kStages - 1 (one cp.async group each, empty
  // past the last step; its A words stored after step s's products) and
  // multiplies step s; s < 0 only fills the ring of stages.
  for (int s = 1 - kStages; s < p.steps; ++s) {
    if (s >= 0) {
      cp_async_wait<kStages - 2>();  // step s has landed (this thread's part)
      __syncthreads();               // ... everyone's; step s-1 is consumed
    }
    const int ld = s + kStages - 1, ld_st = ld % kStages;
    if (ld < p.steps) load(ld_st);
    cp_async_commit();

    if (s >= 0) {
      const uint8_t* base = smem + (s % kStages) * Tl::kStageBytes;
      const uint8_t* Bs = base + Tl::kABytes;
      if (cst == 0 && cpass > 0) {  // Horner: the next (lower) byte
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[mi][ni][e] = (int)((unsigned)acc[mi][ni][e] << 8);
      }
#pragma unroll
      for (int sub = 0; sub < kSub; ++sub) {
        uint32_t af[MT][4], bf[kNT][2];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
          ldmatrix_x4(af[mi], base + (wm + mi * 16 + (lane & 7) +
                                      ((lane >> 3) & 1) * 8) * kAStride +
                                  32 * sub + (lane >> 4) * 16);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          // rows 32 sub + 16 half + 4q + (0..3): group 8 sub + 4 half + q,
          // swizzle 2q; the word of columns wn + 4g .. wn + 4g + 3
          const uint8_t* rp =
              Bs + (32 * sub + 16 * half + 4 * q) * kBN +
              16 * (((wn >> 4) + (g >> 2)) ^ (2 * q)) + 4 * (g & 3);
          const uint32_t w0 = *(const uint32_t*)rp;
          const uint32_t w1 = *(const uint32_t*)(rp + kBN);
          const uint32_t w2 = *(const uint32_t*)(rp + 2 * kBN);
          const uint32_t w3 = *(const uint32_t*)(rp + 3 * kBN);
          // 4x4 byte transpose: register ni holds column wn + 4g + ni,
          // k = 4q .. 4q + 3 low byte first
          const uint32_t t0 = __byte_perm(w0, w1, 0x5140);
          const uint32_t t1 = __byte_perm(w0, w1, 0x7362);
          const uint32_t t2 = __byte_perm(w2, w3, 0x5140);
          const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
          bf[0][half] = __byte_perm(t0, t2, 0x5410);
          bf[1][half] = __byte_perm(t0, t2, 0x7632);
          bf[2][half] = __byte_perm(t1, t3, 0x5410);
          bf[3][half] = __byte_perm(t1, t3, 0x7632);
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int ni = 0; ni < kNT; ++ni)
            mma_u8s8(acc[mi][ni], af[mi], bf[ni]);
      }
      if (++cst == csteps) {
        cst = 0;
        if (++cpass == gm.passes) {  // the column block is done
          cpass = 0;
#pragma unroll
          for (int mi = 0; mi < MT; ++mi)
#pragma unroll
            for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                pre[(mi * kNT + ni) * 4 + e] += (unsigned)acc[mi][ni][e];
                acc[mi][ni][e] = 0;
              }
          const int c0 = cc1;
          cw.pass(c0, cl, op);
          if (cl >= 0) close(cl);
          if (op >= 0) {
            unsigned* slot = ring + (size_t)(op % p.slots) * kAcc * kThreads;
#pragma unroll
            for (int v = 0; v < kAcc; ++v) slot[v * kThreads + t] = pre[v];
          }
          cc1 = cw.next();
          if (cc1 != INT_MAX) csteps = block_steps(gm.h, cc1 - c0);
        }
      }
    }
    if (!p.a_vec && ld < p.steps) {  // loaded A words, after the products
      uint8_t* As = smem + ld_st * Tl::kStageBytes;
#pragma unroll
      for (int u = 0; u < Tl::kARows; ++u)
        *(uint32_t*)(As + a_dst + 16 * u * kAStride) = a_regs[u];
    }
  }
  cp_async_wait<0>();  // only empty groups remain; leave none behind
}

constexpr int kEpiRows = 32;  // windows an epilogue block scores

// The live kernel's scoring epilogue over the window sums, in its order:
// per window m = (n, ky, kx) and column tile, thread (g, q) of warp wn
// takes columns wn + 8ni + 2q + e, ni < 4, e < 2, of row g: phi =
// RFF(acc / norm, bias), its 8 columns summed in order, the quad combined
// in the butterfly, the 4 warps left to right; partials (n_col_tiles, M, 3).
// Blocks of 4 warps: kEpiRows windows of one column tile, 8 a pass.
__global__ void __launch_bounds__(kWarpsN * 32)
    expanded_epilogue(const int32_t* __restrict__ acc,
                      const float* __restrict__ norms,
                      const float* __restrict__ bias,
                      const int8_t* __restrict__ cpos,
                      const int8_t* __restrict__ cneg,
                      float* __restrict__ partials, const Geometry gm,
                      int td, int n_dt, int tiles_per_dt) {
  __shared__ float red[kWarpsN][8][3];
  const int t = threadIdx.x, lane = t & 31, wn = (t >> 5) * 8 * kNT;
  const int g = lane >> 2, q = lane & 3;
  const int ct = blockIdx.y, dt = ct / tiles_per_dt;
  const int j0 = (ct - dt * tiles_per_dt) * kBN;
  const int M = gm.N * gm.my * gm.mx;
  const int m_end = min(M, ((int)blockIdx.x + 1) * kEpiRows);
  for (int m0 = (int)blockIdx.x * kEpiRows; m0 < m_end; m0 += 8) {
    const int m = m0 + g;
    float dp = 0.f, dn = 0.f, qq = 0.f;
    if (m < M) {
      const int nky = m / gm.mx, kx = m - nky * gm.mx;
      const int32_t* arow = acc + (((size_t)nky * n_dt + dt) * gm.mx + kx) * td;
      const size_t brow = ((size_t)dt * gm.mx + kx) * td;
      const float nm = norms[m];
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + wn + ni * 8 + 2 * q + e;
          if (j < td) {
            const float phi =
                apply_nonlinearity((float)arow[j] / nm, bias[brow + j], kRff);
            dp += phi * (float)cpos[brow + j];
            dn += phi * (float)cneg[brow + j];
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
      red[t >> 5][g][0] = dp;
      red[t >> 5][g][1] = dn;
      red[t >> 5][g][2] = qq;
    }
    __syncthreads();
    if (t < 8 && m0 + t < M) {
      dp = red[0][t][0];
      dn = red[0][t][1];
      qq = red[0][t][2];
      for (int k = 1; k < kWarpsN; ++k) {
        dp = dp + red[k][t][0];
        dn = dn + red[k][t][1];
        qq = qq + red[k][t][2];
      }
      float* out = partials + 3 * ((size_t)ct * M + m0 + t);
      out[0] = dp;
      out[1] = dn;
      out[2] = qq;
    }
    __syncthreads();  // red is free for the next pass
  }
}

// The launch's plan: the row tile's MT (2: 64 rows, 1: 32; 0: no tile's
// ring fits), the ring's slots, the K steps of the walk and the grid.
struct Plan {
  int mt, slots, steps, m_tiles, n_ct;
  size_t smem;
};

Plan plan_of(const Geometry& gm, int td, int n_dt) {
  Plan pl;
  const int open = (gm.w + gm.stride - 1) / gm.stride;
  pl.slots = gm.mx < open ? gm.mx : open;
  pl.mt = Tile<2>::smem(pl.slots) <= kSmemLimit
              ? 2
              : (Tile<1>::smem(pl.slots) <= kSmemLimit ? 1 : 0);
  pl.smem = pl.mt == 2 ? Tile<2>::smem(pl.slots) : Tile<1>::smem(pl.slots);
  const int bm = pl.mt == 2 ? Tile<2>::kBM : Tile<1>::kBM;
  pl.m_tiles = (gm.N * gm.my + bm - 1) / bm;
  pl.n_ct = n_dt * ((td + kBN - 1) / kBN);
  Walk wk{gm.mx, gm.stride, gm.w, 0, 0};
  int cl, op;
  wk.pass(0, cl, op);
  pl.steps = 0;
  for (int c0 = 0, c1 = wk.next(); c1 != INT_MAX; c0 = c1, c1 = wk.next()) {
    wk.pass(c1, cl, op);
    pl.steps += gm.passes * block_steps(gm.h, c1 - c0);
  }
  return pl;
}

Geometry geometry_of(int N, int H, int W, int h, int w, int stride,
                     int layout) {
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
  gm.passes = layout == kU16 ? 2 : (layout == kI32 ? 4 : 1);
  return gm;
}

// Allow score_expanded<MT> the card's whole shared memory (once a process:
// the port runs on one card).
template <int MT>
cudaError_t allow_smem() {
  static cudaError_t err = cudaFuncSetAttribute(
      score_expanded<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemLimit);
  return err;
}

template <int MT>
cudaError_t launch(const Args& a, const Plan& pl, cudaStream_t stream) {
  const cudaError_t err = allow_smem<MT>();
  if (err != cudaSuccess) return err;
  score_expanded<MT><<<dim3(pl.m_tiles, pl.n_ct), kThreads, pl.smem,
                       stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The column tile: the partition of td into partials.
int int_expanded_col_tile() { return kBN; }

// The launch int_expanded makes at this geometry (plan_of): the row tile,
// the ring's slots, blocks, resident blocks per SM, shared memory per block
// and the K steps of the walk. Returns cudaErrorInvalidValue where no
// tile's ring fits the card's shared memory, else the occupancy query's
// error.
int int_expanded_occupancy(int N, int H, int W, int h, int w, int stride,
                           int td, int n_dt, int layout, int* tile_m,
                           int* slots, int* blocks, int* per_sm,
                           int* smem_bytes, int* steps) {
  const Geometry gm = geometry_of(N, H, W, h, w, stride, layout);
  const Plan pl = plan_of(gm, td, n_dt);
  if (pl.mt == 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err = pl.mt == 2 ? allow_smem<2>() : allow_smem<1>();
  if (err != cudaSuccess) return (int)err;
  const cudaError_t occ =
      pl.mt == 2 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       per_sm, score_expanded<2>, kThreads, pl.smem)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       per_sm, score_expanded<1>, kThreads, pl.smem);
  *tile_m = 32 * pl.mt;
  *slots = pl.slots;
  *blocks = pl.m_tiles * pl.n_ct;
  *smem_bytes = (int)pl.smem;
  *steps = pl.steps;
  return (int)occ;
}

// Scores (N, my, mx) from integer codes and the expanded operand in one
// call. layout: 0 = uint8, 2 = int32, 3 = uint16 codes (N, H, W).
// slab_scale: the geometry's scalar scale, on the device. Scratch from the
// caller: norms, N*my*mx floats; partials, n_dt * ceil(td / 128) * N*my*mx
// * 3 floats; acc, (N, my, n_dt, mx, td) int32, which receives the window
// sums. Single-model class tiles, RFF. Four launches: window_norms,
// score_expanded, expanded_epilogue, fold_epilogue. Returns the first
// launch error (cudaErrorInvalidValue for a layout it does not take or a
// ring past the card's shared memory).
int int_expanded(const void* codes, const int8_t* operand, const float* bias,
                 const int8_t* cpos, const int8_t* cneg,
                 const float* slab_scale, float* norms,
                 const float* cpos_norm, const float* cneg_norm,
                 float* partials, float* out, int32_t* acc, int N, int H,
                 int W, int h, int w, int stride, int td, int n_dt,
                 int layout, cudaStream_t stream) {
  if (layout != kU8 && layout != kI32 && layout != kU16)
    return (int)cudaErrorInvalidValue;
  const Geometry gm = geometry_of(N, H, W, h, w, stride, layout);
  const Plan pl = plan_of(gm, td, n_dt);
  if (pl.mt == 0) return (int)cudaErrorInvalidValue;
  const int M = N * gm.my * gm.mx;
  window_norms<<<M, 256, 0, stream>>>(codes, gm, slab_scale, norms);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.codes = codes;
  a.operand = operand;
  a.acc = acc;
  a.gm = gm;
  a.td = td;
  a.n_dt = n_dt;
  a.tiles_per_dt = (td + kBN - 1) / kBN;
  a.slots = pl.slots;
  a.steps = pl.steps;
  a.a_vec = layout == kU8 && W % 4 == 0 && stride % 4 == 0 && w % 4 == 0 &&
            (uintptr_t)codes % 4 == 0;
  int vec = 16;
  while (vec > 1 && (td % vec != 0 || (uintptr_t)operand % vec != 0))
    vec >>= 1;
  a.b_vec = vec >= 4 ? vec : 1;
  a.acc_vec = td % 4 == 0 && (uintptr_t)acc % 16 == 0;
  err = pl.mt == 2 ? launch<2>(a, pl, stream) : launch<1>(a, pl, stream);
  if (err != cudaSuccess) return (int)err;
  expanded_epilogue<<<dim3((M + kEpiRows - 1) / kEpiRows, pl.n_ct),
                      kWarpsN * 32, 0, stream>>>(
      acc, norms, bias, cpos, cneg, partials, gm, td, n_dt, a.tiles_per_dt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fold_epilogue<<<(M + 255) / 256, 256, 0, stream>>>(
      partials, cpos_norm, cneg_norm, out, pl.n_ct, M, gm.my * gm.mx, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
