// Fused cosine-similarity classifier, float32, for Hopper: one cluster
// launch at any class count.
//
// Replaces the TPU kernel src/repro/kernels/similarity.py::_sim_kernel
// (reached through similarity / ops.similarity). Same function:
//
//   out[n, k] = dot(q[n], c[k]) / (max(sqrt(q[n].q[n]), eps) *
//                                  max(sqrt(c[k].c[k]), eps))
//
// for queries (N, D) against C class hypervectors (C, D).
//
// What bounds it on the H100: bytes. Each query element is read once and
// used in C + 1 multiply-adds: 2 (C + 1) operations per 4 bytes, under the
// card's ~20 float32 operations per byte of device memory for any C below
// ~40, so the CUDA cores and not the tensor cores do the arithmetic. The
// work is to keep enough query bytes in flight to stream at HBM rate.
//
// The design. The TPU kernel walks D as a sequential grid axis, carrying
// dots and sums of squares in VMEM. Here D is split across a thread-block
// cluster of kRanks blocks, and each cluster walks tiles of kRows query
// rows:
//
// - The chunk plan depends on D alone (similarity_chunk): rank r owns
//   elements [r * chunk, min(D, (r + 1) * chunk)), chunk =
//   roundup(ceil(D / kRanks), 128); ranks past D own nothing. A rank's
//   chunk is staged in tiles of at most kTile floats.
// - A block's work is a sequence of steps: per row tile (row tiles
//   cluster, cluster + clusters, ...), per group of kClassBlock classes,
//   per D tile of its chunk. Each step stages the tile of its kRows rows
//   and of its classes in the block's one buffer in shared memory: one
//   cp.async.bulk (TMA 1-D) copy per row on an mbarrier where the rows
//   are 16-byte aligned (D % 4 == 0 and 16-byte base pointers), issued by
//   thread 0 as soon as the buffer is free; plain loads otherwise. The
//   class tile is staged once when every step uses the same one (one
//   class group, one D tile). Both paths stage the same floats, and the
//   arithmetic reads only shared memory, so a misaligned view gives the
//   aligned copy's bits.
// - Warp w owns row w of a tile: lane l sums the float4 slots v = l (mod
//   32) of the rank's chunk in order, the four elements of a slot in
//   order, with fmaf, for q.q and each class of the group; warp w also
//   sums class w's squares the same way. Then a fixed shuffle tree
//   (score_common::warp_sum) per sum, into the block's partials.
// - Every kFoldGroups groups one cluster.sync(); then rank r reads row
//   r's partial dots and q.q and the partial c.c of each of those groups
//   from ranks 0 .. kRanks-1 (distributed shared memory), adds them left
//   to right in rank order and writes row r's scores. Partials are
//   double-buffered by batch, so the next batch's cluster.sync() orders
//   the reads before they are overwritten; a last cluster.sync() keeps
//   every rank alive until all have read.
//
// The grid holds as many clusters as fit on the card at once
// (cudaOccupancyMaxActiveClusters), each walking its row tiles. The
// bytes in flight come from many small blocks on each SM (30 KB of
// shared memory each at the paper's D = 5000 and C = 2), each with one
// step's copies outstanding; deeper rings of buffers per block, with
// fewer blocks, ran slower on the H100.
//
// No atomics: every sum has one order, set by D alone. A row's scores are
// the same bits at any batch position and call size, a class's column the
// same bits whichever classes share the call, and every run the same bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "score_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRanks = 8;       // blocks per cluster, splitting D
constexpr int kRows = 8;        // query rows per tile: one warp each
constexpr int kClassBlock = 8;  // classes per step
constexpr int kThreads = 32 * kRows;
constexpr int kAlign = 128;     // chunk granule: 32 lanes x float4
constexpr int kTile = 1024;     // most floats of a row staged per step
constexpr int kFoldGroups = 8;  // groups folded per cluster.sync()
static_assert(kRows <= kRanks, "rank r folds row r of a tile");
static_assert(kClassBlock <= kRows, "warp w sums class w's squares");
static_assert(kTile % kAlign == 0, "a tile keeps every lane's slots");
static_assert(kFoldGroups * kClassBlock <= kThreads, "one fold thread each");

using score_common::warp_sum;

__host__ __device__ inline int chunk_of(int D) {
  const int per = (D + kRanks - 1) / kRanks;
  return (per + kAlign - 1) / kAlign * kAlign;
}

__host__ __device__ inline int tile_of(int D) {
  const int chunk = chunk_of(D);
  return chunk < kTile ? chunk : kTile;
}

// class rows the buffer holds: a call with fewer classes leaves room for
// more blocks per SM
__host__ __device__ inline int class_rows(int C) {
  return C < kClassBlock ? C : kClassBlock;
}

struct Partials {  // one group's sums of one rank
  float dot[kRows][kClassBlock];
  float qq[kRows];
  float cc[kClassBlock];
};

// the buffer, two batches of partials (one being folded, one being
// written) and the buffer's mbarrier
__host__ __device__ inline size_t smem_bytes(int D, int C) {
  return (size_t)(kRows + class_rows(C)) * tile_of(D) * sizeof(float) +
         2 * kFoldGroups * sizeof(Partials) + sizeof(uint64_t);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One TMA 1-D bulk copy, global -> this block's shared memory; src, dst
// and bytes are multiples of 16.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// acc += x . y over the slot's first min(rest, 4) elements, in order,
// with fmaf (rest >= 1: the tile's floats left from this slot on).
__device__ __forceinline__ float fma4(float4 x, float4 y, int rest,
                                      float acc) {
  acc = fmaf(x.x, y.x, acc);
  if (rest > 1) acc = fmaf(x.y, y.y, acc);
  if (rest > 2) acc = fmaf(x.z, y.z, acc);
  if (rest > 3) acc = fmaf(x.w, y.w, acc);
  return acc;
}

// A block's walk: step i is D tile i % n_tiles of group g = i / n_tiles,
// and group g is class group g % n_kb of row tile
// cluster + (g / n_kb) * clusters.
struct Walk {
  int N, D, C, lo, len, tile, n_tiles, n_kb, cluster, clusters;

  __device__ int n0(int g) const {
    return (cluster + (g / n_kb) * clusters) * kRows;
  }
  __device__ int rows(int g) const { return min(kRows, N - n0(g)); }
  __device__ int c0(int g) const { return (g % n_kb) * kClassBlock; }
  __device__ int classes(int g) const {
    return min(kClassBlock, C - c0(g));
  }
  __device__ int off(int t) const { return lo + t * tile; }
  __device__ int tlen(int t) const { return min(tile, len - t * tile); }
};

// Stage step i's rows, and its classes if load_c, into the buffer: rows
// at sq, classes at sc. The bulk path is thread 0's alone; the plain
// path every thread's.
template <bool kBulk>
__device__ __forceinline__ void stage(const Walk& w, const float* q,
                                      const float* c, int i, float* sq,
                                      float* sc, bool load_c, uint64_t* bar) {
  const int g = i / w.n_tiles, t = i % w.n_tiles;
  const int n0 = w.n0(g), rows = w.rows(g), c0 = w.c0(g);
  const int classes = load_c ? w.classes(g) : 0;
  const int off = w.off(t), tlen = w.tlen(t);
  if (kBulk) {
    const uint32_t bytes = tlen * sizeof(float);
    mbar_expect(bar, bytes * (rows + classes));
    for (int r = 0; r < rows; ++r)
      bulk_copy(sq + r * w.tile, q + (size_t)(n0 + r) * w.D + off, bytes,
                bar);
    for (int k = 0; k < classes; ++k)
      bulk_copy(sc + k * w.tile, c + (size_t)(c0 + k) * w.D + off, bytes,
                bar);
  } else {
    for (int j = threadIdx.x; j < rows * tlen; j += kThreads) {
      const int r = j / tlen, e = j % tlen;
      sq[r * w.tile + e] = q[(size_t)(n0 + r) * w.D + off + e];
    }
    for (int j = threadIdx.x; j < classes * tlen; j += kThreads) {
      const int k = j / tlen, e = j % tlen;
      sc[k * w.tile + e] = c[(size_t)(c0 + k) * w.D + off + e];
    }
  }
}

template <bool kBulk>
__global__ void __launch_bounds__(kThreads)
    sim_cluster(const float* __restrict__ q,  // (N, D)
                const float* __restrict__ c,  // (C, D)
                float* __restrict__ out,      // (N, C)
                int N, int D, int C, float eps) {
  extern __shared__ __align__(128) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  Walk w;
  w.N = N;
  w.D = D;
  w.C = C;
  const int chunk = chunk_of(D);
  w.tile = tile_of(D);
  w.lo = rank * chunk;
  w.len = max(0, min(chunk, D - w.lo));  // this rank's floats
  w.n_tiles = w.len > 0 ? (w.len + w.tile - 1) / w.tile : 0;
  w.n_kb = (C + kClassBlock - 1) / kClassBlock;
  w.cluster = blockIdx.x / kRanks;
  w.clusters = gridDim.x / kRanks;
  const int row_tiles = (N + kRows - 1) / kRows;
  const int n_groups =  // the same on every rank of the cluster
      (row_tiles - w.cluster + w.clusters - 1) / w.clusters * w.n_kb;
  const int n_steps = n_groups * w.n_tiles;
  // every step uses the same class tile: stage it once
  const bool same_c = w.n_kb == 1 && w.n_tiles == 1;

  float* sq = smem;                      // (kRows, tile)
  float* sc = smem + kRows * w.tile;     // (class_rows(C), tile)
  Partials* part = reinterpret_cast<Partials*>(sc + class_rows(C) * w.tile);
  uint64_t* full = reinterpret_cast<uint64_t*>(part + 2 * kFoldGroups);
  if (kBulk && threadIdx.x == 0) {
    mbar_init(full);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (kBulk && threadIdx.x == 0 && n_steps > 0)
    stage<true>(w, q, c, 0, sq, sc, true, full);

  int i = 0;  // step
  for (int g = 0; g < n_groups; ++g) {
    const int p = g % kFoldGroups, rows = w.rows(g), classes = w.classes(g);
    // the last group of a batch: every rank's sums of the batch are
    // folded after one cluster.sync()
    const bool batch_end = p + 1 == kFoldGroups || g + 1 == n_groups;
    float dots[kClassBlock];
#pragma unroll
    for (int k = 0; k < kClassBlock; ++k) dots[k] = 0.f;
    float qq = 0.f, cc = 0.f;
    for (int t = 0; t < w.n_tiles; ++t, ++i) {
      if (kBulk) {
        mbar_wait(full, i & 1);
      } else {
        stage<false>(w, q, c, i, sq, sc, !same_c || i == 0, nullptr);
        __syncthreads();
      }
      // lane l: the tile's float4 slots v = l, l + 32, ... in order (a
      // tile is a multiple of 128 floats, so these are the slots = l
      // (mod 32) of the rank's chunk whatever the tiling)
      const int tlen = w.tlen(t), t4 = w.tile / 4;
      const float4* row = reinterpret_cast<const float4*>(sq + warp * w.tile);
      const float4* cls = reinterpret_cast<const float4*>(sc);
      if (warp < rows)
        for (int v = lane; 4 * v < tlen; v += 32) {
          const float4 x = row[v];
          const int rest = tlen - 4 * v;
          qq = fma4(x, x, rest, qq);
#pragma unroll
          for (int k = 0; k < kClassBlock; ++k)
            if (k < classes) dots[k] = fma4(x, cls[k * t4 + v], rest, dots[k]);
        }
      if (warp < classes)
        for (int v = lane; 4 * v < tlen; v += 32) {
          const float4 y = cls[warp * t4 + v];
          cc = fma4(y, y, tlen - 4 * v, cc);
        }
      if (!batch_end || t + 1 < w.n_tiles) {
        __syncthreads();  // every warp is done with the buffer
        if (kBulk && threadIdx.x == 0 && i + 1 < n_steps)
          stage<true>(w, q, c, i + 1, sq, sc, !same_c, full);
      }
    }
    Partials* batch = part + (g / kFoldGroups & 1) * kFoldGroups;
#pragma unroll
    for (int k = 0; k < kClassBlock; ++k) dots[k] = warp_sum(dots[k]);
    qq = warp_sum(qq);
    cc = warp_sum(cc);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kClassBlock; ++k) batch[p].dot[warp][k] = dots[k];
      batch[p].qq[warp] = qq;
      batch[p].cc[warp] = cc;
    }
    if (!batch_end) continue;
    cluster.sync();  // every rank's sums of the batch are written
    if (kBulk && threadIdx.x == 0 && i < n_steps)  // the buffer is free
      stage<true>(w, q, c, i, sq, sc, !same_c, full);
    // rank r folds row r of each group of the batch: thread
    // j = b * kClassBlock + k scores class c0 + k of group g0 + b
    const int g0 = g - p, b = threadIdx.x / kClassBlock,
              k = threadIdx.x % kClassBlock;
    if (rank < kRows && b <= p && k < w.classes(g0 + b)) {
      float d[kRanks], x[kRanks], y[kRanks];
#pragma unroll
      for (int r = 0; r < kRanks; ++r) {
        const Partials* pr = cluster.map_shared_rank(batch + b, r);
        d[r] = pr->dot[rank][k];
        x[r] = pr->qq[rank];
        y[r] = pr->cc[k];
      }
      float dot = d[0], qqs = x[0], ccs = y[0];
#pragma unroll
      for (int r = 1; r < kRanks; ++r) {
        dot = dot + d[r];
        qqs = qqs + x[r];
        ccs = ccs + y[r];
      }
      if (rank < w.rows(g0 + b))
        out[(size_t)(w.n0(g0 + b) + rank) * C + w.c0(g0 + b) + k] =
            dot / (fmaxf(sqrtf(qqs), eps) * fmaxf(sqrtf(ccs), eps));
    }
    // the next batch writes the other half of `part`; the one after
    // writes this half only after every rank has passed the next batch's
    // cluster.sync(), so after every rank's fold of this one
  }
  cluster.sync();  // keep every rank's shared memory until all have read
}

template <bool kBulk>
cudaError_t launch(const float* q, const float* c, float* out, int N, int D,
                   int C, float eps, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, C);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kRanks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the clusters that fit on the card at once, for this shared memory
  static size_t opted_in = 48 * 1024, fits_for = 0;
  static int fits = 0;
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        sim_cluster<kBulk>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  if (smem != fits_for) {
    cfg.gridDim = dim3(kRanks);
    const cudaError_t err =
        cudaOccupancyMaxActiveClusters(&fits, sim_cluster<kBulk>, &cfg);
    if (err != cudaSuccess) return err;
    if (fits < 1) return cudaErrorInvalidConfiguration;
    fits_for = smem;
  }
  const int row_tiles = (N + kRows - 1) / kRows;
  cfg.gridDim = dim3((unsigned)(kRanks * min(row_tiles, fits)));
  return cudaLaunchKernelEx(&cfg, sim_cluster<kBulk>, q, c, out, N, D, C,
                            eps);
}

}  // namespace

extern "C" {

// Floats of D each rank of the cluster owns: the chunk plan, set by D alone.
int similarity_chunk(int D) { return chunk_of(D); }

// Cosine scores of q (N, D) against c (C, D) into out (N, C), all
// contiguous, in one cluster launch at any N >= 1, D >= 0 and C >= 1.
// bulk != 0 stages with cp.async.bulk: D % 4 == 0 and q, c 16-byte
// aligned. Returns the launch's error, else cudaGetLastError().
int similarity_f32(const float* q, const float* c, float* out, int N, int D,
                   int C, int bulk, float eps, cudaStream_t stream) {
  if (N < 1 || D < 0 || C < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t err = bulk ? launch<true>(q, c, out, N, D, C, eps, stream)
                               : launch<false>(q, c, out, N, D, C, eps, stream);
  const cudaError_t last = cudaGetLastError();  // also clears a failed launch
  return (int)(err != cudaSuccess ? err : last);
}

}  // extern "C"
