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
// weights to x.dtype), products are summed in f32 in slot order, and the sum
// is rounded to out's type once. A slot whose weight is 0 (ELL padding: index
// 0, weight 0) or whose index lies outside [0, NX) contributes nothing.
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
//
// Design: two kernels, chosen in `launch` from the shape and alignment of x
// and the count of output rows.
//   - Wide rows (`spmm_bucketed_wide_kernel`): one warp per (output row, tile
//     of 32 lanes x 16 bytes), so the feature axis is spread over the grid:
//     a slot of a tile is one coalesced read of up to 512 bytes and a row of
//     width 114 costs its warp 114 reads, whatever F. kUnroll reads are issued
//     before their multiply-adds, each predicated on its slot (no branch
//     between them, and a pad that points at a NaN row is never read); the
//     sums keep slot order. A chunk of 32 slots ends at its last live slot.
//     The caller may pass `order`, the output rows by falling concat row, so
//     the widest bucket's rows start first and the narrow ones fill the tail.
//   - Narrow rows (`spmm_bucketed_kernel`): one warp per output row, lanes
//     across F, two neighbouring features per lane (float2 / __nv_bfloat162)
//     when F is even and the bases are aligned; padding is skipped by a
//     warp-uniform branch.
// Both read 32 of a row's slots per coalesced load of nbr and w and broadcast
// each with __shfl_sync. The bucket search is a scan over <= 64 entries of a
// table in kernel parameter (constant) memory, uniform across the warp. No
// shared memory, no atomics: each output element is written once.
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
// Which rows take the wide kernel. Device ms per call on an NVIDIA H100 80GB
// HBM3 at 700 W, narrow / wide (builds with each threshold, timed in turns):
//   rows of 256 B: the GCN slice at F = 128 bf16, 0.149-0.162 / 0.131-0.143;
//     the TwoWL train split at F = 64 f32, 0.024 / 0.014;
//   rows of 128 B: the GCN slice at F = 64 bf16, 0.095 / 0.128 (235,000 rows
//     of 6 slots on average keep the card full, and the wide kernel has 8 of
//     32 lanes at work); the TwoWL train split at F = 32 f32, 0.024 / 0.014
//     (7,112 rows are all on the card at once, so the call lasts as long as
//     its row of 114 slots, and the wide kernel has kUnroll of that row's
//     reads in flight).
// So: rows of kWideMinRowBytes or more always; rows down to
// kWideMinRowBytesFewRows when there are no more output rows than the card
// holds warps at once.
constexpr int64_t kWideMinRowBytes = 256;
constexpr int64_t kWideMinRowBytesFewRows = 128;
constexpr unsigned kFullMask = 0xffffffffu;

struct Buckets {
  int count;
  int row_end[kMaxBuckets];      // exclusive end of bucket b among concat rows
  int width[kMaxBuckets];
  int64_t slot0[kMaxBuckets];    // first slot of bucket b in nbr / w
};

// The slots of concat row p: its bucket's width and its first slot. Width 0
// (the zero row, or p outside the layout) leaves the sums at 0. A scan over
// <= 64 entries of the table in kernel parameter (constant) memory, uniform
// across the warp.
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

// The warps the current device holds at once (132 SMs x 64 on an H100), read
// once; 0 if the device cannot be asked.
int64_t resident_warps() {
  static const int64_t warps = [] {
    int device = 0, sms = 0, threads = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&threads,
                               cudaDevAttrMaxThreadsPerMultiProcessor,
                               device) != cudaSuccess) {
      return int64_t{0};
    }
    return static_cast<int64_t>(sms) * (threads / kWarp);
  }();
  return warps;
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
  // Dispatch by shape (see kWideMinRowBytes). Rows of whole 16-byte groups
  // on 16-byte boundaries that are wide enough take the wide kernel; every
  // other shape the warp-per-row kernel, in pairs where it can.
  const int64_t wide_min = n <= resident_warps() ? kWideMinRowBytesFewRows
                                                 : kWideMinRowBytes;
  if (wide_aligned(f, sizeof(T), wide_min, {x, out})) {
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
