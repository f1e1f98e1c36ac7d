// K3 on Hopper: degree-bucketed ELL SpMM with its output assembly,
// out[i, :] = sum_d w[p, d] * x[nbr[p, d], :] for p = inv_perm[i].
//
// Replaces the TPU kernel `spmm_rowdma_pallas` and its wrapper
// `spmm_rowdma_bucketed` (linkpred_tpu/ops/pallas_kernels.py), which compute
// the function of `linkpred_tpu/ops/spmm.py:spmm_bucketed`. The Pallas kernel
// runs one launch per bucket, copies every neighbour row HBM -> VMEM by its own
// DMA descriptor (double-buffered two deep), and merges the buckets by row
// `.set`s outside the kernel. Here one launch covers every output row: the
// bucket of a row is found from a small descriptor table, and the zero rows
// of degree-0 nodes and the inverse-permutation gather of the reference's
// assembly are written by the same kernel.
//
// Layout (built once on the host, `ops/spmm.BucketedEll.operands`): the
// buckets' ELL rows concatenated in bucket order, flattened into nbr [S] int32
// and w [S] float32; per bucket its (rows, width), passed by value; inv_perm
// [N] int32 gives each output row its concat row, and the concat row count
// (or anything outside [0, rows)) means an all-zero output row.
//
// Types: x [NX, F] float32 or bfloat16, out [N, F] of the same type. Each
// weight is rounded to x's type before the product (the reference casts the
// weights to x.dtype), products are summed in f32, and the sum is rounded to
// out's type once. A slot whose weight is 0 (ELL padding: index 0, weight 0)
// or whose index lies outside [0, NX) contributes nothing. The order of the
// sums is fixed, so a result is the same bit for bit from run to run: slot
// order in the warp-per-row and wide kernels; in the slot kernel, lane g of a
// row's group adds its slots g, g + G, g + 2G, ... in that order, and the G
// lanes' sums are then added by a butterfly (lanes 1, 2, ..., G / 2 apart);
// in the packed kernel, slot group s of a row's P adds the slots s, s + P,
// s + 2P, ... in that order, and the P groups' sums are then added by a
// butterfly (groups 1, 2, ..., P / 2 apart). Which of these a shape takes,
// and so the order, depends on F, x's type and alignment and the row count.
//
// What bounds it on an H100 (80 GB HBM3, 3.35 TB/s; the bound counts each row
// of x that a live slot names once, the live slots' index and weight, inv_perm
// and the output, over that rate). 2 flops per gathered element: tensor cores
// have nothing to multiply, and the design is about memory.
//   - The TwoWL sweep, 32 trials: 7,112 output rows, 110,526 slots in 6
//     buckets of widths 4-114, x [7112, 1024] f32 (rows of 4 KB). 44 MB must
//     move: 0.013 ms. The ~82,000 live slots re-read x's 29 MB eleven times
//     over, from L2 where it fits.
//   - One trial: x [7112, 32] f32 (rows of 128 B): 2 MB, 0.0006 ms, which is
//     the time of an empty launch; launch and gather latency are what is left.
//   - The GCN slice: 235,000 rows, 1,406,216 slots in 10 buckets of widths
//     2-64, x [235000, 64 or 128] bf16 (rows of 128 or 256 B): 69 / 127 MB,
//     0.021 / 0.038 ms; the row gathers are 180 / 360 MB, part of them from L2.
//   - The 2-WL stack at 50k nodes: x [703916, 32] bf16 (rows of 64 B),
//     703,916 output rows, 4,871,231 slots forward (buckets of widths 4, 8
//     and 15) and 4,805,782 transposed (widths 4-26): 100 / 122 MB, 0.030 /
//     0.036 ms; a row is ~7 slots, so what is left above that is the chain
//     of dependent reads a row costs (order, inv_perm, slots, x).
//   - The 2-WL degree pass at 50k nodes: x [703916, 1] f32, 703,916 output
//     rows, 4,871,231 slots in buckets of widths 4, 8 and 15: 36.7 MB, nearly
//     all of it the slots' index and weight, 0.011 ms. On fb-pages-food,
//     x [7112, 1]: 7,112 rows of up to 114 slots, well under an empty launch.
//
// Design: four kernels, chosen in `launch` from the shape and alignment of x
// and the count of output rows.
//   - Rows narrower than 16 bytes (`spmm_bucketed_slots_kernel`): a group of
//     G lanes per output row, one lane per slot: lane g takes the row's slots
//     g, g + G, ..., kSlotsUnroll of them at once, each lane issuing their
//     index and weight reads and then their feature reads, predicated and
//     without a branch between them, before its multiply-adds; the group's
//     sums meet in a butterfly of __shfl_xor_sync. A warp holds 32 / G rows,
//     so a row of 4 slots no longer costs a warp with one lane at work and
//     its slots no longer wait on each other. G is 2 when the output rows
//     outnumber the warps the card holds at once (the card is filled many
//     times over, and short groups hold more rows a warp), else the least
//     power of two whose kSlotsUnroll rounds cover the widest bucket (the
//     call lasts as long as its widest row).
//   - Rows of 1-16 whole 16-byte groups on 16-byte boundaries (16-256 bytes:
//     F = 4-64 f32, 8-128 bf16; `spmm_bucketed_packed_kernel`): R rows a
//     warp, 32 / R lanes a row and G lanes a slot, G the row's groups rounded
//     up to a power of two, so P = 32 / (R G) slots of a row are gathered at
//     once and each lane has up to kPackedUnroll of them in flight; a row's
//     slot groups meet in a butterfly of __shfl_xor_sync, with no shared
//     memory and no barrier. A row of ~7 slots is a chain of four dependent
//     reads whatever its width, so what the card needs is many rows in
//     flight: R is the most, up to 32 / G, that still fills the card twice
//     over with warps (8 at the 50k-node shape, 4 and 2 at the GCN's F = 64
//     and 128), and 1 when the rows are too few to fill it, where the
//     widest row decides and P slot groups share it (see kPackedWaves).
//   - Wider rows of whole 16-byte groups (`spmm_bucketed_wide_kernel`): one
//     warp per (output row, tile of 32 lanes x 16 bytes), so the feature
//     axis is spread over the grid:
//     a slot of a tile is one coalesced read of up to 512 bytes and a row of
//     width 114 costs its warp 114 reads, whatever F. kUnroll reads are issued
//     before their multiply-adds, each predicated on its slot (no branch
//     between them, and a pad that points at a NaN row is never read); the
//     sums keep slot order. A chunk of 32 slots ends at its last live slot.
//     The caller may pass `order`, the output rows by falling concat row, so
//     the widest bucket's rows start first and the narrow ones fill the tail.
//   - Any other shape (`spmm_bucketed_kernel`: rows not of whole 16-byte
//     groups, or off the 16-byte grid): one warp per output row, lanes
//     across F, two neighbouring features per lane (float2 / __nv_bfloat162)
//     when F is even and the bases are aligned; padding is skipped by a
//     warp-uniform branch.
// The last three read a chunk of a row's slots per coalesced load of nbr and
// w and broadcast each with __shfl_sync. The bucket search is a scan over <= 64
// entries of a table in kernel parameter (constant) memory (all lanes that
// are still scanning read the same entry). No shared memory, no atomics:
// each output element is written once.
//
// Tried on the same card and dropped: staging the neighbour rows of a (row,
// 4 KB tile) through a shared-memory ring filled by `cp.async.bulk` against an
// mbarrier (the counterpart of the Pallas kernel's row DMAs). At [7112, 1024]
// f32 it took 0.049-0.053 ms with 4 stages and 0.059 ms with 8, against
// 0.045 ms for the direct gather above, and 0.051-0.060 against 0.028 ms in
// bf16: the direct gather already keeps kUnroll x 512 bytes in flight per warp
// with many warps per SM, and pays no barrier round trip per stage.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "feature_io.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;  // narrow path: a warp per row
constexpr int kWideWarps = 4;      // wide path: a warp per (row, tile)
constexpr int kUnroll = 4;         // wide path: row reads in flight per lane
constexpr int kMaxBuckets = 64;  // MAX_BUCKETS of ops/hopper_kernels.py
// Rows narrower than 16 bytes take the slot kernel (F <= 3 in f32, <= 7 in
// bf16), with kSlotsUnroll slots a lane in flight at once. Its group is
// kSlotsMinGroup lanes when there are more output rows than the card holds
// warps at once, else the least power of two, up to 32 lanes, whose
// kSlotsUnroll rounds cover the widest bucket. Device ms per call at F = 1
// f32 on an NVIDIA H100 80GB HBM3 at 700 W, each group forced and timed in
// turns by kernel_turns.py (the warp-per-row kernel in brackets):
//   703,916 rows of widths 4 / 8 / 15 (50k nodes): G = 1 0.0368, 2 0.0361,
//     4 0.0430, 8 0.0713 (0.2407); the transposed operands, widths 4-26:
//     G = 2 0.0416, 4 0.0460 (0.2214);
//   235,000 rows of widths 2-64 (the GCN layout): G = 1 0.0200, 2 0.0132,
//     4 0.0187, 8 0.0289 (0.0647);
//   7,112 rows of widths 4-114 (fb-pages-food): G = 2 0.0059, 4 0.0038,
//     8 0.0031, 16 0.0030, 32 0.0045 (0.0148).
// 16 slots a lane in flight gained at most 1 % (50k nodes: G = 1 0.0358),
// 4 lost 3-18 %. At F = 2-3 f32 and F = 1-7 bf16 the same rule runs 2.6-6.3x
// faster than the warp-per-row kernel on all three layouts; the group it
// picks is the fastest or within 1 % of it, except at F = 2-7 bf16, where
// G = 1 (50k nodes) or G / 2 (fb-pages-food) takes up to 25 % less time.
constexpr int64_t kSlotsMaxRowBytes = 15;
// Rows of whole 16-byte groups up to kPackedMaxRowBytes take the packed
// kernel: G = the row's groups rounded up to a power of two lanes a slot,
// kPackedUnroll row reads a lane in flight, and R rows a warp, the most (up
// to 32 / G and kPackedMaxRows) that leave kPackedWaves warps' worth of rows
// for each warp the card holds at once. Device ms per call on an NVIDIA
// H100 80GB HBM3 at 700 W, each kernel forced and timed in turns by
// kernel_turns.py (the rule's pick in brackets; wide / warp per row after
// the slash):
//   703,916 rows of widths 4 / 8 / 15 (50k nodes), bf16 F = 32 (G = 4):
//     R = 1 0.2897, 2 0.1670, 4 0.1074, [8 0.0790] / 0.3980 / 0.3015; the
//     transposed operands (widths 4-26): [8 0.1052] / 0.4037 / 0.3133;
//     F = 64 (G = 8): 1 0.3150, 2 0.2077, [4 0.1534] / 0.4276 / 0.3251;
//     F = 128 (G = 16): 1 0.4180, [2 0.2998] / 0.4943 / 0.5666;
//     F = 8 (G = 1): 8 0.0715, [16 0.0612], 32 0.0850 / 0.3479 / 0.2585;
//   235,000 rows of widths 2-64 (the GCN layout), bf16 F = 64: 1 0.0995,
//     2 0.0682, [4 0.0518] / 0.1277 / 0.0948; F = 128: 1 0.1268,
//     [2 0.0903] / 0.1410 / 0.1616; F = 32: 4 0.0372, [8 0.0293];
//   58,750 rows (a rank's rows of the GCN over four ranks), bf16 F = 64:
//     halo 1 0.0226, [2 0.0138], 4 0.0217 / 0.0280 / 0.0197; node-sharded
//     1 0.0343, [2 0.0277], 4 0.0287 / 0.0553 / 0.0431; F = 128: halo
//     1 0.0343, [2 0.0268] / 0.0368; node-sharded [2 0.0466] / 0.0680;
//   7,112 rows of widths 4-114 (fb-pages-food): f32 F = 32 [1 0.0060],
//     2 0.0091 / 0.0138 / 0.0247; bf16 F = 128 [1 0.0091] / 0.0226; F = 4
//     f32 [1 0.0043], 2 0.0038 / 0.0132.
// The rule's pick is the fastest R at 30 of 35 such shapes, within 3.3 % at
// two more, and leaves 14-22 % at three that no path runs (16-byte rows, and
// bf16 F = 8 at 7,112 rows); it beats the wide and the warp-per-row kernels
// 1.38-4.87x at all 35. Eight reads in flight a lane instead of four took up
// to 68 % more time at the picks (four picks gained at most 7 %): they cost
// 64-76 registers a thread against 32-56.
constexpr int64_t kPackedMaxRowBytes = 256;
constexpr int kPackedUnroll = 4;
constexpr int kPackedMaxRows = 16;
constexpr int64_t kPackedWaves = 2;
constexpr int kSlotsUnroll = 8;
constexpr int kSlotsMinGroup = 2;
constexpr unsigned kFullMask = 0xffffffffu;

struct Buckets {
  int count;
  int row_end[kMaxBuckets];      // exclusive end of bucket b among concat rows
  int width[kMaxBuckets];
  int64_t slot0[kMaxBuckets];    // first slot of bucket b in nbr / w
};

// The slots of concat row p: its bucket's width and its first slot. Width 0
// (the zero row, or p outside the layout) leaves the sums at 0. A scan over
// <= 64 entries of the table in kernel parameter (constant) memory, which
// reads one entry for all lanes still scanning.
struct RowSlots {
  int width;
  int64_t slot;
};

__device__ __forceinline__ RowSlots find_row(const Buckets& buckets, int p) {
  RowSlots r{0, 0};
  if (p >= 0) {
    int start = 0;
    for (int b = 0; b < buckets.count; ++b) {
      if (p < buckets.row_end[b]) {
        r.width = buckets.width[b];
        r.slot = buckets.slot0[b] + static_cast<int64_t>(p - start) * r.width;
        break;
      }
      start = buckets.row_end[b];
    }
  }
  return r;
}

// 32 of a row's slots, one per lane, by one coalesced read of nbr and of w:
// the weight rounded to the feature type, and 0 for a slot past the row's
// end or with an index outside [0, nx) (whose index becomes 0, a safe row).
template <typename T>
__device__ __forceinline__ void load_slots(const int32_t* nrow,
                                           const float* wrow, int d, int width,
                                           int nx, int& j, float& wv) {
  j = 0;
  wv = 0.0f;
  if (d < width) {
    j = nrow[d];
    wv = FeatureIo<T>::round(wrow[d]);
    if (j < 0 || j >= nx) {
      j = 0;
      wv = 0.0f;
    }
  }
}

// Narrow rows: one warp per output row, lanes across F, kVec neighbouring
// features per lane.
template <typename T, int kVec>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
spmm_bucketed_kernel(const T* __restrict__ x,
                     const int32_t* __restrict__ inv_perm,
                     const int32_t* __restrict__ order,
                     const int32_t* __restrict__ nbr,
                     const float* __restrict__ w, T* __restrict__ out, int n,
                     int nx, int f, const Buckets buckets) {
  const int rank = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (rank >= n) return;  // warp-uniform: whole warps leave together
  const int row = order != nullptr ? order[rank] : rank;

  const RowSlots rs = find_row(buckets, inv_perm[row]);
  const int width = rs.width;
  const int32_t* nrow = nbr + rs.slot;
  const float* wrow = w + rs.slot;
  T* orow = out + static_cast<int64_t>(row) * f;

  for (int f0 = 0; f0 < f; f0 += kWarp * kVec) {
    const int col = f0 + lane * kVec;
    const bool active = col < f;  // kVec == 2 implies F even: col + 1 < F too
    float acc0 = 0.0f, acc1 = 0.0f;
    for (int d0 = 0; d0 < width; d0 += kWarp) {
      int j;
      float wv;
      load_slots<T>(nrow, wrow, d0 + lane, width, nx, j, wv);
      const int n_slots = min(kWarp, width - d0);
      for (int k = 0; k < n_slots; ++k) {
        const int jk = __shfl_sync(kFullMask, j, k);
        const float wk = __shfl_sync(kFullMask, wv, k);
        if (wk != 0.0f && active) {
          const T* xr = x + static_cast<int64_t>(jk) * f + col;
          if (kVec == 2) {
            const float2 v = FeatureIo<T>::load2(xr);
            acc0 = fmaf(wk, v.x, acc0);
            acc1 = fmaf(wk, v.y, acc1);
          } else {
            acc0 = fmaf(wk, FeatureIo<T>::load(xr), acc0);
          }
        }
      }
    }
    if (active) {
      if (kVec == 2) {
        FeatureIo<T>::store2(orow + col, acc0, acc1);
      } else {
        FeatureIo<T>::store(orow + col, acc0);
      }
    }
  }
}

// Rows narrower than 16 bytes (F <= kMaxF): kGroup lanes per output row,
// the row's slots spread over them, lane g of the group taking slots g,
// g + kGroup, ... . Each lane issues kSlotsUnroll slots' index and weight
// reads, then their feature reads, all predicated and without a branch
// between them, before its multiply-adds; the group's partial sums then
// meet in a butterfly of __shfl_xor_sync (lanes 1, 2, ..., kGroup / 2
// apart), after which every lane of the group holds the same sums, and lane
// g writes the features c with c % kGroup == g. Lanes past the last output
// row take no slots and stay for the shuffles.
template <typename T, int kGroup, int kMaxF>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
spmm_bucketed_slots_kernel(const T* __restrict__ x,
                           const int32_t* __restrict__ inv_perm,
                           const int32_t* __restrict__ order,
                           const int32_t* __restrict__ nbr,
                           const float* __restrict__ w, T* __restrict__ out,
                           int n, int nx, int f, const Buckets buckets) {
  constexpr int kStep = kGroup * kSlotsUnroll;
  const int lane = threadIdx.x % kWarp;
  const int g = lane % kGroup;
  const int64_t rank =
      (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp)
          * (kWarp / kGroup) + lane / kGroup;
  int row = 0;
  RowSlots rs{0, 0};
  if (rank < n) {
    row = order != nullptr ? order[rank] : static_cast<int>(rank);
    rs = find_row(buckets, inv_perm[row]);
  }
  const int32_t* nrow = nbr + rs.slot;
  const float* wrow = w + rs.slot;

  float acc[kMaxF];
#pragma unroll
  for (int c = 0; c < kMaxF; ++c) acc[c] = 0.0f;
  for (int d0 = 0; d0 < rs.width; d0 += kStep) {
    int j[kSlotsUnroll];
    float wv[kSlotsUnroll];
#pragma unroll
    for (int u = 0; u < kSlotsUnroll; ++u) {
      const int d = d0 + u * kGroup + g;
      const bool in_row = d < rs.width;
      j[u] = static_cast<int>(load32_if(nrow + d, in_row));
      wv[u] = FeatureIo<T>::round(
          __uint_as_float(load32_if(wrow + d, in_row)));
      // an index outside [0, nx) contributes nothing (j = 0, a safe row)
      const bool inside = j[u] >= 0 && j[u] < nx;
      wv[u] = inside ? wv[u] : 0.0f;
      j[u] = inside ? j[u] : 0;
    }
    float v[kSlotsUnroll][kMaxF];
#pragma unroll
    for (int u = 0; u < kSlotsUnroll; ++u) {
      const T* xr = x + static_cast<int64_t>(j[u]) * f;
#pragma unroll
      for (int c = 0; c < kMaxF; ++c) {
        v[u][c] = load_feature_if(xr + c, wv[u] != 0.0f && c < f);
      }
    }
#pragma unroll
    for (int u = 0; u < kSlotsUnroll; ++u) {
#pragma unroll
      for (int c = 0; c < kMaxF; ++c) acc[c] = fmaf(wv[u], v[u][c], acc[c]);
    }
  }
#pragma unroll
  for (int off = kGroup / 2; off > 0; off /= 2) {
#pragma unroll
    for (int c = 0; c < kMaxF; ++c) {
      acc[c] += __shfl_xor_sync(kFullMask, acc[c], off);
    }
  }
  if (rank < n) {
    T* orow = out + static_cast<int64_t>(row) * f;
#pragma unroll
    for (int c = 0; c < kMaxF; ++c) {
      if (c % kGroup == g && c < f) FeatureIo<T>::store(orow + c, acc[c]);
    }
  }
}

// Wide rows: one warp per (output row, tile of 32 lanes x 16 bytes). The
// warp walks its row's slots once; each slot is one coalesced 512-byte read
// of x, and kUnroll of them are issued, predicated and without a branch,
// before their multiply-adds, which keep slot order.
template <typename T>
__global__ void __launch_bounds__(kWarp * kWideWarps)
spmm_bucketed_wide_kernel(const T* __restrict__ x,
                          const int32_t* __restrict__ inv_perm,
                          const int32_t* __restrict__ order,
                          const int32_t* __restrict__ nbr,
                          const float* __restrict__ w, T* __restrict__ out,
                          int n, int nx, int f, int tiles,
                          const Buckets buckets) {
  constexpr int kPer = FeatureIo<T>::kWide;
  const int64_t g =
      static_cast<int64_t>(blockIdx.x) * kWideWarps + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t rank = g / tiles;
  if (rank >= n) return;  // warp-uniform: whole warps leave together
  const int tile = static_cast<int>(g - rank * tiles);
  const int row = order != nullptr ? order[rank] : static_cast<int>(rank);

  const RowSlots rs = find_row(buckets, inv_perm[row]);
  const int width = rs.width;
  const int32_t* nrow = nbr + rs.slot;
  const float* wrow = w + rs.slot;
  // rows are whole 16-byte groups, so a lane's kPer columns are all inside
  // the row or all outside it
  const int col = (tile * kWarp + lane) * kPer;
  const bool active = col < f;
  const T* xcol = x + (active ? col : 0);

  float acc[kPer];
#pragma unroll
  for (int c = 0; c < kPer; ++c) acc[c] = 0.0f;

  for (int d0 = 0; d0 < width; d0 += kWarp) {
    int j;
    float wv;
    load_slots<T>(nrow, wrow, d0 + lane, width, nx, j, wv);
    // stop after the chunk's last slot that contributes (ELL pads trail)
    const int n_slots = kWarp - __clz(__ballot_sync(kFullMask, wv != 0.0f));
    for (int k0 = 0; k0 < n_slots; k0 += kUnroll) {
      uint4 r[kUnroll];
      float wk[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        // k0 + u < 32: kUnroll divides 32; lanes past n_slots hold weight 0
        const int jk = __shfl_sync(kFullMask, j, k0 + u);
        wk[u] = __shfl_sync(kFullMask, wv, k0 + u);
        r[u] = load16_if(xcol + static_cast<int64_t>(jk) * f,
                         wk[u] != 0.0f && active);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float v[kPer];
        FeatureIo<T>::unpack(r[u], v);
#pragma unroll
        for (int c = 0; c < kPer; ++c) acc[c] = fmaf(wk[u], v[c], acc[c]);
      }
    }
  }
  if (active) {
    uint4* dst =
        reinterpret_cast<uint4*>(out + static_cast<int64_t>(row) * f + col);
    *dst = FeatureIo<T>::pack(acc);
  }
}

// Packed slots: kRows output rows a warp, kLanes = 32 / kRows lanes a row,
// kGroup of them a slot (the row's 16-byte groups rounded up to a power of
// two), so P = kLanes / kGroup slots of a row are gathered at once. A row's
// slots come in chunks of kChunk: lane l reads the indices and weights of
// slots l, l + kLanes, ... of the chunk (kIdx of them, each a coalesced read
// over the row's lanes, predicated and without a branch between them).
// Lane (s, c) = (l / kGroup, l % kGroup) then reads the column group c of
// the chunk's slots s, s + P, s + 2P, ..., kPackedUnroll of them issued,
// predicated and without a branch, before their multiply-adds, each slot's
// index and weight taken from the lane that read it by __shfl_sync. The
// slot groups' partial sums meet in a butterfly of __shfl_xor_sync (lanes
// kGroup, 2 kGroup, ..., kLanes / 2 apart), and the lanes of slot group 0
// write the row, 16 bytes a lane. The rows of a warp walk their chunks
// together (the shuffles need every lane), as far as the warp's widest row
// and, in a chunk, its last live slot.
template <typename T, int kGroup, int kRows>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
spmm_bucketed_packed_kernel(const T* __restrict__ x,
                            const int32_t* __restrict__ inv_perm,
                            const int32_t* __restrict__ order,
                            const int32_t* __restrict__ nbr,
                            const float* __restrict__ w, T* __restrict__ out,
                            int n, int nx, int f, const Buckets buckets) {
  constexpr int kPer = FeatureIo<T>::kWide;
  constexpr int kLanes = kWarp / kRows;
  constexpr int kSlotsAtOnce = kLanes / kGroup;
  constexpr int kStep = kSlotsAtOnce * kPackedUnroll;  // slots a round
  constexpr int kIdx = kStep > kLanes ? kStep / kLanes : 1;
  constexpr int kChunk = kLanes * kIdx;  // a multiple of kStep
  static_assert(kGroup <= kLanes && kChunk % kStep == 0, "packed shape");
  // a row's lanes in a ballot, shifted down to bit 0
  constexpr unsigned kRowBits =
      kRows == 1 ? kFullMask : (1u << (kLanes % kWarp)) - 1u;
  const int lane = threadIdx.x % kWarp;
  const int l = lane % kLanes;
  const int s = l / kGroup;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp)
      * kRows;
  if (first >= n) return;  // warp-uniform: whole warps leave together
  const int64_t rank = first + lane / kLanes;
  int row = 0;
  RowSlots rs{0, 0};
  if (rank < n) {
    row = order != nullptr ? order[rank] : static_cast<int>(rank);
    rs = find_row(buckets, inv_perm[row]);
  }
  const int32_t* nrow = nbr + rs.slot;
  const float* wrow = w + rs.slot;
  // rows are whole 16-byte groups, so a lane's kPer columns are all inside
  // the row or all outside it
  const int col = (l % kGroup) * kPer;
  const bool active = col < f;
  const T* xcol = x + (active ? col : 0);
  int width = rs.width;
#pragma unroll
  for (int off = kLanes; off < kWarp; off *= 2) {
    width = max(width, __shfl_xor_sync(kFullMask, width, off));
  }

  float acc[kPer];
#pragma unroll
  for (int c = 0; c < kPer; ++c) acc[c] = 0.0f;
  for (int d0 = 0; d0 < width; d0 += kChunk) {
    int j[kIdx];
    float wv[kIdx];
#pragma unroll
    for (int i = 0; i < kIdx; ++i) {
      // an index outside [0, nx) contributes nothing (j = 0, a safe row)
      const int d = d0 + i * kLanes + l;
      const bool in_row = d < rs.width;
      j[i] = static_cast<int>(load32_if(nrow + d, in_row));
      wv[i] = FeatureIo<T>::round(
          __uint_as_float(load32_if(wrow + d, in_row)));
      const bool inside = j[i] >= 0 && j[i] < nx;
      wv[i] = inside ? wv[i] : 0.0f;
      j[i] = inside ? j[i] : 0;
    }
    // stop after the chunk's last slot that contributes in any of the
    // warp's rows (ELL pads trail)
    int n_slots = 0;
#pragma unroll
    for (int i = 0; i < kIdx; ++i) {
      const unsigned live = __ballot_sync(kFullMask, wv[i] != 0.0f);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const unsigned bits = (live >> (r * kLanes)) & kRowBits;
        if (bits != 0u) {
          n_slots = max(n_slots, i * kLanes + kWarp - __clz(bits));
        }
      }
    }
#pragma unroll
    for (int k0 = 0; k0 < kChunk; k0 += kStep) {
      if (k0 >= n_slots) break;  // warp-uniform
      uint4 v[kPackedUnroll];
      float wk[kPackedUnroll];
#pragma unroll
      for (int u = 0; u < kPackedUnroll; ++u) {
        // slot k0 + u P + s of the chunk: base is a multiple of P, so the
        // P slots from base lie in one register of the row's lanes
        const int base = k0 + u * kSlotsAtOnce;
        const int jk = __shfl_sync(kFullMask, j[base / kLanes],
                                   base % kLanes + s, kLanes);
        wk[u] = __shfl_sync(kFullMask, wv[base / kLanes], base % kLanes + s,
                            kLanes);
        v[u] = load16_if(xcol + static_cast<int64_t>(jk) * f,
                         wk[u] != 0.0f && active);
      }
#pragma unroll
      for (int u = 0; u < kPackedUnroll; ++u) {
        float e[kPer];
        FeatureIo<T>::unpack(v[u], e);
#pragma unroll
        for (int c = 0; c < kPer; ++c) acc[c] = fmaf(wk[u], e[c], acc[c]);
      }
    }
  }
#pragma unroll
  for (int off = kGroup; off < kLanes; off *= 2) {
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      acc[c] += __shfl_xor_sync(kFullMask, acc[c], off);
    }
  }
  if (s == 0 && active && rank < n) {
    uint4* dst =
        reinterpret_cast<uint4*>(out + static_cast<int64_t>(row) * f + col);
    *dst = FeatureIo<T>::pack(acc);
  }
}

// The slot kernel at kGroup lanes a row. F = 1, the degree pass, has an
// instance of its own, which holds fewer registers than one for up to
// kSlotsMaxRowBytes' worth of features.
template <typename T, int kGroup>
void launch_slots_group(const T* x, const int32_t* inv_perm,
                        const int32_t* order, const int32_t* nbr,
                        const float* w, T* out, int64_t n, int nx, int f,
                        const Buckets& buckets, cudaStream_t stream) {
  constexpr int kRowsPerBlock = kWarp / kGroup * kWarpsPerBlock;
  constexpr int kMaxF = static_cast<int>(kSlotsMaxRowBytes / sizeof(T));
  const unsigned blocks =
      static_cast<unsigned>((n + kRowsPerBlock - 1) / kRowsPerBlock);
  const int ni = static_cast<int>(n);
  if (f == 1) {
    spmm_bucketed_slots_kernel<T, kGroup, 1>
        <<<blocks, kWarp * kWarpsPerBlock, 0, stream>>>(
            x, inv_perm, order, nbr, w, out, ni, nx, f, buckets);
  } else {
    spmm_bucketed_slots_kernel<T, kGroup, kMaxF>
        <<<blocks, kWarp * kWarpsPerBlock, 0, stream>>>(
            x, inv_perm, order, nbr, w, out, ni, nx, f, buckets);
  }
}

// Rows narrower than 16 bytes: the slot kernel, its group sized from the
// widest bucket that holds rows (see kSlotsUnroll).
template <typename T>
int launch_slots(const T* x, const int32_t* inv_perm, const int32_t* order,
                 const int32_t* nbr, const float* w, T* out, int64_t n,
                 int nx, int f, const Buckets& buckets,
                 cudaStream_t stream) {
  int widest = 0;
  for (int b = 0; b < buckets.count; ++b) {
    const int rows = buckets.row_end[b] - (b > 0 ? buckets.row_end[b - 1] : 0);
    if (rows > 0 && buckets.width[b] > widest) widest = buckets.width[b];
  }
  int group = kSlotsMinGroup;
  if (n <= resident_warps()) {
    while (group < kWarp && group * kSlotsUnroll < widest) group *= 2;
  }
  switch (group) {
    case 2:
      launch_slots_group<T, 2>(x, inv_perm, order, nbr, w, out, n, nx, f,
                               buckets, stream);
      break;
    case 4:
      launch_slots_group<T, 4>(x, inv_perm, order, nbr, w, out, n, nx, f,
                               buckets, stream);
      break;
    case 8:
      launch_slots_group<T, 8>(x, inv_perm, order, nbr, w, out, n, nx, f,
                               buckets, stream);
      break;
    case 16:
      launch_slots_group<T, 16>(x, inv_perm, order, nbr, w, out, n, nx, f,
                                buckets, stream);
      break;
    default:
      launch_slots_group<T, 32>(x, inv_perm, order, nbr, w, out, n, nx, f,
                                buckets, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

// The packed kernel at kGroup lanes a slot and kRows rows a warp.
template <typename T, int kGroup, int kRows>
void launch_packed_rows(const T* x, const int32_t* inv_perm,
                        const int32_t* order, const int32_t* nbr,
                        const float* w, T* out, int64_t n, int nx, int f,
                        const Buckets& buckets, cudaStream_t stream) {
  constexpr int kRowsPerBlock = kRows * kWarpsPerBlock;
  const unsigned blocks =
      static_cast<unsigned>((n + kRowsPerBlock - 1) / kRowsPerBlock);
  spmm_bucketed_packed_kernel<T, kGroup, kRows>
      <<<blocks, kWarp * kWarpsPerBlock, 0, stream>>>(
          x, inv_perm, order, nbr, w, out, static_cast<int>(n), nx, f,
          buckets);
}

// The packed kernel at kGroup lanes a slot and the most rows a warp, up to
// kRows, that `rows` allows.
template <typename T, int kGroup, int kRows>
void launch_packed_upto(int rows, const T* x, const int32_t* inv_perm,
                        const int32_t* order, const int32_t* nbr,
                        const float* w, T* out, int64_t n, int nx, int f,
                        const Buckets& buckets, cudaStream_t stream) {
  if constexpr (kRows > 1) {
    if (rows < kRows) {
      launch_packed_upto<T, kGroup, kRows / 2>(rows, x, inv_perm, order, nbr,
                                               w, out, n, nx, f, buckets,
                                               stream);
      return;
    }
  }
  launch_packed_rows<T, kGroup, kRows>(x, inv_perm, order, nbr, w, out, n,
                                       nx, f, buckets, stream);
}

// Rows of 1-16 whole 16-byte groups: the packed kernel, its group and its
// rows a warp chosen as kPackedMaxRowBytes says.
template <typename T>
int launch_packed(const T* x, const int32_t* inv_perm, const int32_t* order,
                  const int32_t* nbr, const float* w, T* out, int64_t n,
                  int nx, int f, const Buckets& buckets,
                  cudaStream_t stream) {
  const int64_t groups = f * static_cast<int64_t>(sizeof(T)) / 16;
  int group = 1;
  while (group < groups) group *= 2;
  int rows = 1;
  while (group * rows < kWarp && rows < kPackedMaxRows &&
         n >= kPackedWaves * 2 * rows * resident_warps()) {
    rows *= 2;
  }
  switch (group) {
    case 1:
      launch_packed_upto<T, 1, 16>(rows, x, inv_perm, order, nbr, w, out, n,
                                   nx, f, buckets, stream);
      break;
    case 2:
      launch_packed_upto<T, 2, 16>(rows, x, inv_perm, order, nbr, w, out, n,
                                   nx, f, buckets, stream);
      break;
    case 4:
      launch_packed_upto<T, 4, 8>(rows, x, inv_perm, order, nbr, w, out, n,
                                  nx, f, buckets, stream);
      break;
    case 8:
      launch_packed_upto<T, 8, 4>(rows, x, inv_perm, order, nbr, w, out, n,
                                  nx, f, buckets, stream);
      break;
    default:
      launch_packed_upto<T, 16, 2>(rows, x, inv_perm, order, nbr, w, out, n,
                                   nx, f, buckets, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const int32_t* inv_perm, const int32_t* order,
           const int32_t* nbr, const float* w, void* out, int64_t n,
           int64_t nx, int64_t f, const Buckets& buckets,
           cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const int ni = static_cast<int>(n), nxi = static_cast<int>(nx),
            fi = static_cast<int>(f);
  // Dispatch by shape (see kSlotsMaxRowBytes and kPackedMaxRowBytes). Rows
  // narrower than 16 bytes take the slot kernel; rows of whole 16-byte groups
  // on 16-byte boundaries the packed kernel up to kPackedMaxRowBytes and the
  // wide kernel above; every other shape the warp-per-row kernel, in pairs
  // where it can.
  const int64_t row_bytes = f * static_cast<int64_t>(sizeof(T));
  if (row_bytes <= kSlotsMaxRowBytes) {
    return launch_slots<T>(xt, inv_perm, order, nbr, w, ot, n, nxi, fi,
                           buckets, stream);
  }
  if (wide_aligned(f, sizeof(T), 16, {x, out})) {
    if (row_bytes <= kPackedMaxRowBytes) {
      return launch_packed<T>(xt, inv_perm, order, nbr, w, ot, n, nxi, fi,
                              buckets, stream);
    }
    constexpr int kTile = kWarp * FeatureIo<T>::kWide;
    const int64_t tiles = (f + kTile - 1) / kTile;
    const int64_t blocks = (n * tiles + kWideWarps - 1) / kWideWarps;
    if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
    spmm_bucketed_wide_kernel<T>
        <<<static_cast<unsigned>(blocks), kWarp * kWideWarps, 0, stream>>>(
            xt, inv_perm, order, nbr, w, ot, ni, nxi, fi,
            static_cast<int>(tiles), buckets);
    return static_cast<int>(cudaGetLastError());
  }
  const unsigned blocks =
      static_cast<unsigned>((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (pairs_aligned(f, sizeof(T), {x, out})) {
    spmm_bucketed_kernel<T, 2><<<blocks, kWarp * kWarpsPerBlock, 0, stream>>>(
        xt, inv_perm, order, nbr, w, ot, ni, nxi, fi, buckets);
  } else {
    spmm_bucketed_kernel<T, 1><<<blocks, kWarp * kWarpsPerBlock, 0, stream>>>(
        xt, inv_perm, order, nbr, w, ot, ni, nxi, fi, buckets);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches K3 on `stream` (a cudaStream_t, PyTorch's current stream).
// dtype: 0 float32, 1 bfloat16 (x and out). `shapes` holds n_buckets pairs
// (rows, width) in the order of the concatenated slots. `order` [N] int32
// lists the output rows in the order they are launched (widest bucket
// first), or is null for row order. Returns cudaGetLastError() after the
// launch: 0 when it was accepted. Does not synchronise and allocates
// nothing; the caller owns every buffer.
int spmm_bucketed(int dtype, const void* x, const int32_t* inv_perm,
                  const int32_t* order, const int32_t* nbr, const float* w,
                  void* out, int64_t n, int64_t nx, int64_t f,
                  int64_t n_buckets, const int64_t* shapes, void* stream) {
  if (n_buckets < 0 || n_buckets > kMaxBuckets) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Buckets buckets{};
  buckets.count = static_cast<int>(n_buckets);
  int64_t rows = 0, slots = 0;
  for (int b = 0; b < buckets.count; ++b) {
    buckets.slot0[b] = slots;
    rows += shapes[2 * b];
    slots += shapes[2 * b] * shapes[2 * b + 1];
    buckets.row_end[b] = static_cast<int>(rows);
    buckets.width[b] = static_cast<int>(shapes[2 * b + 1]);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, inv_perm, order, nbr, w, out, n, nx, f, buckets,
                           s);
    case 1:
      return launch<__nv_bfloat16>(x, inv_perm, order, nbr, w, out, n, nx, f,
                                   buckets, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* spmm_bucketed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
