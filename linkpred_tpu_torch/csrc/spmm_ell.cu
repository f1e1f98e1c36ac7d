// K1 on Hopper: ELL SpMM, out[i, :] = sum_d w[i, d] * x[nbr[i, d], :].
//
// Replaces the TPU kernel `spmm_ell_pallas` (linkpred_tpu/ops/pallas_kernels.py,
// body `_spmm_kernel`). That kernel expands each block of neighbour lists into
// a one-hot [rows, NX] matrix in VMEM and multiplies it with x on the MXU, a
// form chosen for the TPU's systolic array. Here the same function is a direct
// gather-reduce: a row costs its valid slots, not NX.
//
// Operands: nbr [M, D] int32, w [M, D] float32, x [NX, F] float32 with any row
// count, out [M, F] float32 (written in full). All row-major and contiguous.
// A slot whose weight is 0 or whose index lies outside [0, NX) contributes
// nothing. Sums are taken in f32 in a fixed order (slot order; in the wide
// kernel, slot order within each warp's share of the slots, then the shares
// in warp order), so a result does not change from run to run.
//
// What bounds it on an H100 (80 GB HBM3, 3.35 TB/s; the bound counts each row
// of x that a live slot names once, the live slots' index and weight and the
// output, over that rate). 2 flops per gathered element, so the design is
// about memory and, at these sizes, about latency and how much of the card is
// at work: M = 620 output rows (the nodes of fb-pages-food) of up to 114-120
// slots, few of them live.
//   - One trial: x [3556, 24] f32 (rows of 96 B, 341 KB): 0.4 MB must move,
//     0.0001 ms, below the 0.0007 ms of an empty launch.
//   - The sweep, 32 trials: x [3556, 768] f32 (rows of 3 KB, 10.9 MB):
//     12.9 MB, 0.0038 ms. Everything sits in the 50 MB L2 after first touch.
//
// Design: two kernels, chosen in `spmm_ell_f32` from the shape and alignment
// of x.
//   - Rows of whole 16-byte groups (`spmm_ell_wide_kernel`): one block per
//     (output row, tile of 128 columns), so 620 rows at F = 768 are 3,720
//     blocks, not 620 warps. The block's kSplit warps share the row's slots
//     in chunks of 32; a slot of a tile is one coalesced read of up to 512
//     bytes, kUnroll of them issued before their multiply-adds, each
//     predicated on its slot (no branch between them, and a slot that points
//     at a NaN row with weight 0 is never read). A chunk ends at its last
//     live slot. The warps' partial sums meet in shared memory and are added
//     in warp order.
//   - Any other shape (`spmm_ell_kernel`): one warp per output row, lanes
//     across F in steps of 32; padding is skipped by a warp-uniform branch.
// Both read 32 of a row's slots per coalesced load of nbr and w and broadcast
// each with __shfl_sync. No atomics: each output element is written once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "feature_io.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;   // narrow path: a warp per row
constexpr int kSplit = 4;           // wide path: warps that share a row's slots
constexpr int kUnroll = 8;          // wide path: row reads in flight per lane
constexpr int kTile = kWarp * 4;    // f32 columns of a tile: 32 lanes x 16 bytes
constexpr unsigned kFullMask = 0xffffffffu;
// Rows of at least this many bytes take the wide kernel. Device ms per call on
// an NVIDIA H100 80GB HBM3 at 700 W, M = 620, narrow / wide: F = 16 (64 B)
// 0.0104 / 0.0062, F = 24 (96 B) 0.0104 / 0.0062, F = 64 (256 B) 0.0190 /
// 0.0062: the split of a row's slots over a block's warps pays at any width.
constexpr int64_t kWideMinRowBytes = 64;

// 32 of a row's slots, one per lane, by one coalesced read of nbr and of w:
// weight 0 for a slot past the row's end or with an index outside [0, nx)
// (whose index becomes 0, a safe row).
__device__ __forceinline__ void load_slots(const int32_t* nrow,
                                           const float* wrow, int d, int width,
                                           int nx, int& j, float& wv) {
  j = 0;
  wv = 0.0f;
  if (d < width) {
    j = nrow[d];
    wv = wrow[d];
    if (j < 0 || j >= nx) {
      j = 0;
      wv = 0.0f;
    }
  }
}

// Narrow rows: one warp per output row, lanes across F in steps of 32.
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
spmm_ell_kernel(const int32_t* __restrict__ nbr, const float* __restrict__ w,
                const float* __restrict__ x, float* __restrict__ out,
                int m, int d, int nx, int f) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= m) return;  // warp-uniform: whole warps leave together
  const int32_t* nrow = nbr + static_cast<int64_t>(row) * d;
  const float* wrow = w + static_cast<int64_t>(row) * d;
  float* orow = out + static_cast<int64_t>(row) * f;

  for (int f0 = 0; f0 < f; f0 += kWarp) {
    const int col = f0 + lane;
    const bool active = col < f;
    float acc = 0.0f;
    for (int d0 = 0; d0 < d; d0 += kWarp) {
      int j;
      float wv;
      load_slots(nrow, wrow, d0 + lane, d, nx, j, wv);
      const int n_slots = min(kWarp, d - d0);
      for (int k = 0; k < n_slots; ++k) {
        const int jk = __shfl_sync(kFullMask, j, k);
        const float wk = __shfl_sync(kFullMask, wv, k);
        if (wk != 0.0f && active) {
          acc = fmaf(wk, __ldg(x + static_cast<int64_t>(jk) * f + col), acc);
        }
      }
    }
    if (active) orow[col] = acc;
  }
}

// Wide rows: one block per (output row, tile of 128 columns). Its kSplit
// warps share the row's slots in chunks of 32 (warp s takes chunks s,
// s + kSplit, ...); each slot is one coalesced 512-byte read of x, kUnroll of
// them issued, predicated and without a branch, before their multiply-adds.
// The warps' partial sums meet in shared memory and are added in warp order,
// one column per thread, so a result does not change from run to run.
__global__ void __launch_bounds__(kWarp * kSplit)
spmm_ell_wide_kernel(const int32_t* __restrict__ nbr,
                     const float* __restrict__ w, const float* __restrict__ x,
                     float* __restrict__ out, int d, int nx, int f,
                     int tiles) {
  __shared__ __align__(16) float part[kSplit][kTile];
  const int row = blockIdx.x / tiles;
  const int tile = blockIdx.x - row * tiles;
  const int split = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int32_t* nrow = nbr + static_cast<int64_t>(row) * d;
  const float* wrow = w + static_cast<int64_t>(row) * d;
  // rows are whole 16-byte groups, so a lane's 4 columns are all inside the
  // row or all outside it
  const int col = tile * kTile + lane * 4;
  const bool active = col < f;
  const float* xcol = x + (active ? col : 0);

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int d0 = split * kWarp; d0 < d; d0 += kSplit * kWarp) {
    int j;
    float wv;
    load_slots(nrow, wrow, d0 + lane, d, nx, j, wv);
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
        float v[4];
        FeatureIo<float>::unpack(r[u], v);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] = fmaf(wk[u], v[c], acc[c]);
      }
    }
  }
  *reinterpret_cast<float4*>(&part[split][lane * 4]) =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
  __syncthreads();
  // kSplit * 32 threads over 128 columns: each thread adds the partial sums
  // of its columns in warp order
  for (int c = threadIdx.x; c < kTile; c += kWarp * kSplit) {
    float sum = part[0][c];
#pragma unroll
    for (int s = 1; s < kSplit; ++s) sum += part[s][c];
    if (tile * kTile + c < f) {
      out[static_cast<int64_t>(row) * f + tile * kTile + c] = sum;
    }
  }
}

}  // namespace

extern "C" {

// Launches K1 on `stream` (a cudaStream_t, PyTorch's current stream). Returns
// cudaGetLastError() after the launch: 0 when the launch was accepted. Does not
// synchronise and allocates nothing; the caller owns every buffer.
int spmm_ell_f32(const int32_t* nbr, const float* w, const float* x,
                 float* out, int64_t m, int64_t d, int64_t nx, int64_t f,
                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Dispatch by shape. Rows of whole 16-byte groups on 16-byte boundaries,
  // kWideMinRowBytes or more, take the wide kernel; every other shape the
  // warp-per-row kernel.
  if (wide_aligned(f, sizeof(float), kWideMinRowBytes, {x, out})) {
    const int64_t tiles = (f + kTile - 1) / kTile;
    if (m * tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
    spmm_ell_wide_kernel<<<static_cast<unsigned>(m * tiles), kWarp * kSplit, 0,
                           s>>>(nbr, w, x, out, static_cast<int>(d),
                                static_cast<int>(nx), static_cast<int>(f),
                                static_cast<int>(tiles));
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t blocks = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
  spmm_ell_kernel<<<static_cast<unsigned>(blocks), kWarp * kWarpsPerBlock, 0,
                    s>>>(nbr, w, x, out, static_cast<int>(m),
                         static_cast<int>(d), static_cast<int>(nx),
                         static_cast<int>(f));
  return static_cast<int>(cudaGetLastError());
}

const char* spmm_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
