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
// nothing. Sums are taken in f32 in a fixed order, so a result is the same
// bit for bit from run to run: slot order in the warp-per-row kernel; in the
// wide kernel, slot order within each warp's share of the slots, then the
// shares in warp order; in the packed kernel, slot group s of P = 32 / G adds
// the slots s, s + P, s + 2P, ... of each chunk of 32 in that order, and the
// P groups' sums are then added by a butterfly (groups 1, 2, ..., P / 2
// apart).
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
//   - TwoWL at 50k nodes: nbr/w [50000, 32], x [351958, 24 or 16] f32 (rows
//     of 96 or 64 B, each read once): 41.4 / 28.5 MB, 0.0124 / 0.0085 ms.
//
// Design: three kernels, chosen in `spmm_ell_f32` from the shape and
// alignment of x, the slot count D and the row count M.
//   - Rows of 1-32 whole 16-byte groups where the wide kernel's split of the
//     slots does not pay (`spmm_ell_packed_kernel`; see kPackedAnySlots): one
//     warp per output row, G lanes per slot, G the row's 16-byte groups
//     rounded up to a power of two, so P = 32 / G slots are gathered at once
//     (4 at F = 24, 8 at F = 16) and each lane has up to 8 of its slots' reads
//     in flight; the slot groups' sums meet by __shfl_xor_sync, with no shared
//     memory and no barrier. At D = 32 the wide kernel ran 50,000 blocks of
//     which three warps in four found no chunk, and 6 or 4 of the fourth
//     warp's 32 lanes held a 16-byte group.
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
// All three read 32 of a row's slots per coalesced load of nbr and w and
// broadcast each with __shfl_sync. No atomics: each output element is written
// once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "feature_io.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;   // narrow and packed: a warp per row
constexpr int kSplit = 4;           // wide path: warps that share a row's slots
constexpr int kUnroll = 8;          // wide path: row reads in flight per lane
constexpr int kTile = kWarp * 4;    // f32 columns of a tile: 32 lanes x 16 bytes
constexpr unsigned kFullMask = 0xffffffffu;
// Rows of at least this many bytes that the packed kernel does not take take
// the wide kernel. Device ms per call on an NVIDIA H100 80GB HBM3 at 700 W,
// before the packed kernel existed, M = 620, narrow / wide: F = 16 (64 B)
// 0.0104 / 0.0062, F = 24 (96 B) 0.0104 / 0.0062, F = 64 (256 B) 0.0190 /
// 0.0062: the split of a row's slots over a block's warps pays at any width.
constexpr int64_t kWideMinRowBytes = 64;
// Which rows of whole 16-byte groups take the packed kernel (rows of 1-32
// groups: F = 4-128 f32). Device ms per call on an NVIDIA H100 80GB HBM3 at
// 700 W, wide / packed, each kernel forced and timed in turns by
// kernel_turns.py:
//   D = 32, M = 50,000 (the 50k-node run): F = 16 0.0829 / 0.0147, F = 24
//     0.0997 / 0.0249, F = 64 0.1086 / 0.0419, F = 128 0.1241 / 0.0769: the
//     wide kernel's other three warps find no chunk;
//   D = 114, M = 620 (fb-pages-food): F = 4 0.0047 / 0.0032, F = 16 0.0062 /
//     0.0050, F = 24 0.0064 / 0.0065, F = 32 0.0063 / 0.0065, F = 64 0.0062 /
//     0.0078, F = 128 0.0065 / 0.0134; the same slots tiled to M = 2,480:
//     F = 24 0.0078 / 0.0067, F = 64 0.0078 / 0.0084; to M = 9,920: F = 64
//     0.0149 / 0.0116, F = 128 0.0154 / 0.0176; to M = 49,600: F = 128
//     0.0673 / 0.0478;
//   D = 128, M = 50,000: F = 64 0.1153 / 0.0726, F = 128 0.1303 / 0.1738.
// So: packed when D <= kPackedAnySlots (one chunk), or when a row has at
// most kPackedAnyRowGroups groups (8 or more slots gathered at once), or
// when there are more rows than the card holds warps and at most
// kPackedManyRowGroups groups; else the wide kernel. The rule leaves some
// of packed's gains (M = 2,480 at F = 24-32; F = 128 at M = 49,600) where
// the neighbouring shapes lose with it.
constexpr int64_t kPackedAnySlots = 32;
constexpr int64_t kPackedAnyRowGroups = 4;
constexpr int64_t kPackedManyRowGroups = 16;

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

// Packed slots: one warp per output row, kGroup lanes per slot (the row's
// 16-byte groups rounded up to a power of two), so kWarp / kGroup slots are
// gathered at once. Lane (s, c) = (lane / kGroup, lane % kGroup) reads the
// column group c of the slots s, s + kWarp / kGroup, ... of each chunk of 32,
// kPackedUnroll of them issued, predicated and without a branch, before
// their multiply-adds; the slot groups' partial sums then meet in a
// butterfly of __shfl_xor_sync (lanes kGroup, 2 kGroup, ..., 16 apart), and
// the lanes of slot group 0 write the row. No shared memory, no barrier.
template <int kGroup>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
spmm_ell_packed_kernel(const int32_t* __restrict__ nbr,
                       const float* __restrict__ w,
                       const float* __restrict__ x, float* __restrict__ out,
                       int m, int d, int nx, int f) {
  constexpr int kSlotsAtOnce = kWarp / kGroup;
  constexpr int kPackedUnroll = kGroup < 8 ? kGroup : 8;
  constexpr int kStep = kSlotsAtOnce * kPackedUnroll;  // divides 32
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= m) return;  // warp-uniform: whole warps leave together
  const int s = lane / kGroup;
  const int col = (lane % kGroup) * 4;
  const bool active = col < f;
  const int32_t* nrow = nbr + static_cast<int64_t>(row) * d;
  const float* wrow = w + static_cast<int64_t>(row) * d;
  const float* xcol = x + (active ? col : 0);

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int d0 = 0; d0 < d; d0 += kWarp) {
    int j;
    float wv;
    load_slots(nrow, wrow, d0 + lane, d, nx, j, wv);
    // stop after the chunk's last slot that contributes (ELL pads trail)
    const int n_slots = kWarp - __clz(__ballot_sync(kFullMask, wv != 0.0f));
    for (int k0 = 0; k0 < n_slots; k0 += kStep) {
      uint4 r[kPackedUnroll];
      float wk[kPackedUnroll];
#pragma unroll
      for (int u = 0; u < kPackedUnroll; ++u) {
        // k < 32: k0 is a multiple of kStep; lanes past n_slots hold weight 0
        const int k = k0 + u * kSlotsAtOnce + s;
        const int jk = __shfl_sync(kFullMask, j, k);
        wk[u] = __shfl_sync(kFullMask, wv, k);
        r[u] = load16_if(xcol + static_cast<int64_t>(jk) * f,
                         wk[u] != 0.0f && active);
      }
#pragma unroll
      for (int u = 0; u < kPackedUnroll; ++u) {
        float v[4];
        FeatureIo<float>::unpack(r[u], v);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] = fmaf(wk[u], v[c], acc[c]);
      }
    }
  }
#pragma unroll
  for (int off = kGroup; off < kWarp; off *= 2) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[c] += __shfl_xor_sync(kFullMask, acc[c], off);
    }
  }
  if (s == 0 && active) {
    *reinterpret_cast<float4*>(out + static_cast<int64_t>(row) * f + col) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

template <int kGroup>
void launch_packed(const int32_t* nbr, const float* w, const float* x,
                   float* out, int64_t m, int64_t d, int64_t nx, int64_t f,
                   cudaStream_t stream) {
  const int64_t blocks = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
  spmm_ell_packed_kernel<kGroup>
      <<<static_cast<unsigned>(blocks), kWarp * kWarpsPerBlock, 0, stream>>>(
          nbr, w, x, out, static_cast<int>(m), static_cast<int>(d),
          static_cast<int>(nx), static_cast<int>(f));
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
  // Dispatch by shape (see kPackedAnySlots and kWideMinRowBytes). Rows of
  // whole 16-byte groups on 16-byte boundaries take the packed kernel or the
  // wide one; every other shape the warp-per-row kernel.
  const int64_t groups = f / 4;
  const bool many_rows = m > resident_warps();
  const bool packed =
      groups <= kWarp &&
      (d <= kPackedAnySlots || groups <= kPackedAnyRowGroups ||
       (many_rows && groups <= kPackedManyRowGroups));
  if (packed && wide_aligned(f, sizeof(float), 16, {x, out})) {
    if (groups <= 1) {
      launch_packed<1>(nbr, w, x, out, m, d, nx, f, s);
    } else if (groups <= 2) {
      launch_packed<2>(nbr, w, x, out, m, d, nx, f, s);
    } else if (groups <= 4) {
      launch_packed<4>(nbr, w, x, out, m, d, nx, f, s);
    } else if (groups <= 8) {
      launch_packed<8>(nbr, w, x, out, m, d, nx, f, s);
    } else if (groups <= 16) {
      launch_packed<16>(nbr, w, x, out, m, d, nx, f, s);
    } else {
      launch_packed<32>(nbr, w, x, out, m, d, nx, f, s);
    }
    return static_cast<int>(cudaGetLastError());
  }
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
