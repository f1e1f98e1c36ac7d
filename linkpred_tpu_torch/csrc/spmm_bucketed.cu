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
// What bounds it on an H100: at the GCN slice's shape (235,000 rows, 1.41M
// slots in 10 buckets of widths 2-64, F = 64 or 128 bf16) each call reads
// 1.41M neighbour rows of 128-256 bytes (180-360 MB of row reads; x itself is
// 30-60 MB, so the 50 MB L2 holds part of it) plus 11 MB of nbr/w, and writes
// 30-60 MB. It is bound by the latency and bandwidth of these row gathers,
// not by arithmetic (2 flops per gathered element).
//
// Design: one warp per output row, lanes across F, two neighbouring features
// per lane (float2 / __nv_bfloat162) when F is even and the bases are
// aligned, so a 64-feature stripe of a row is one coalesced 256-byte (f32) or
// 128-byte (bf16) read. The warp reads 32 of its row's slots per coalesced
// load of nbr and w and broadcasts each with __shfl_sync; padding is skipped
// by a warp-uniform branch. The bucket search is a scan over <= 64 entries of
// a table in kernel parameter (constant) memory, uniform across the warp. No
// shared memory, no atomics: each output element is written once.
// Staging rows through shared memory (cp.async, TMA) is left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "feature_io.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr int kMaxBuckets = 64;  // MAX_BUCKETS of ops/hopper_kernels.py
constexpr unsigned kFullMask = 0xffffffffu;

struct Buckets {
  int count;
  int row_end[kMaxBuckets];      // exclusive end of bucket b among concat rows
  int width[kMaxBuckets];
  int64_t slot0[kMaxBuckets];    // first slot of bucket b in nbr / w
};

template <typename T, int kVec>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
spmm_bucketed_kernel(const T* __restrict__ x,
                     const int32_t* __restrict__ inv_perm,
                     const int32_t* __restrict__ nbr,
                     const float* __restrict__ w, T* __restrict__ out, int n,
                     int nx, int f, const Buckets buckets) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= n) return;  // warp-uniform: whole warps leave together

  // the row's bucket; width 0 (the zero row, or p outside the layout)
  // leaves the sums at 0
  const int p = inv_perm[row];
  int width = 0;
  int64_t slot = 0;
  if (p >= 0) {
    int start = 0;
    for (int b = 0; b < buckets.count; ++b) {
      if (p < buckets.row_end[b]) {
        width = buckets.width[b];
        slot = buckets.slot0[b] + static_cast<int64_t>(p - start) * width;
        break;
      }
      start = buckets.row_end[b];
    }
  }
  const int32_t* nrow = nbr + slot;
  const float* wrow = w + slot;
  T* orow = out + static_cast<int64_t>(row) * f;

  for (int f0 = 0; f0 < f; f0 += kWarp * kVec) {
    const int col = f0 + lane * kVec;
    const bool active = col < f;  // kVec == 2 implies F even: col + 1 < F too
    float acc0 = 0.0f, acc1 = 0.0f;
    for (int d0 = 0; d0 < width; d0 += kWarp) {
      // one coalesced read of 32 slots; out-of-range indices get weight 0
      int j = 0;
      float wv = 0.0f;
      if (d0 + lane < width) {
        j = nrow[d0 + lane];
        wv = FeatureIo<T>::round(wrow[d0 + lane]);
        if (j < 0 || j >= nx) wv = 0.0f;
      }
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

template <typename T>
int launch(const void* x, const int32_t* inv_perm, const int32_t* nbr,
           const float* w, void* out, int64_t n, int64_t nx, int64_t f,
           const Buckets& buckets, cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (pairs_aligned(f, sizeof(T), {x, out})) {
    spmm_bucketed_kernel<T, 2><<<blocks, kWarp * kWarpsPerBlock, 0, stream>>>(
        xt, inv_perm, nbr, w, ot, static_cast<int>(n), static_cast<int>(nx),
        static_cast<int>(f), buckets);
  } else {
    spmm_bucketed_kernel<T, 1><<<blocks, kWarp * kWarpsPerBlock, 0, stream>>>(
        xt, inv_perm, nbr, w, ot, static_cast<int>(n), static_cast<int>(nx),
        static_cast<int>(f), buckets);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches K3 on `stream` (a cudaStream_t, PyTorch's current stream).
// dtype: 0 float32, 1 bfloat16 (x and out). `shapes` holds n_buckets pairs
// (rows, width) in the order of the concatenated slots. Returns
// cudaGetLastError() after the launch: 0 when it was accepted. Does not
// synchronise and allocates nothing; the caller owns every buffer.
int spmm_bucketed(int dtype, const void* x, const int32_t* inv_perm,
                  const int32_t* nbr, const float* w, void* out, int64_t n,
                  int64_t nx, int64_t f, int64_t n_buckets,
                  const int64_t* shapes, void* stream) {
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
      return launch<float>(x, inv_perm, nbr, w, out, n, nx, f, buckets, s);
    case 1:
      return launch<__nv_bfloat16>(x, inv_perm, nbr, w, out, n, nx, f,
                                   buckets, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* spmm_bucketed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
