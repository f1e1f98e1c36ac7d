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
// apart); in the split kernel, each warp's chunks as in the packed kernel,
// then the warps' sums in warp order.
//
// What bounds it on an H100 (80 GB HBM3, 3.35 TB/s; the bound counts each row
// of x that a live slot names once, the live slots' index and weight and the
// output, over that rate). 2 flops per gathered element, so the design is
// about memory and, at these sizes, about latency and how much of the card is
// at work: M = 620 output rows (the nodes of fb-pages-food) of up to 114-120
// slots, few of them live: one node has 134 edges, which leaves a train row
// of 114 live slots; 11 more have 33-59, the other 608 at most 32 (mean 6.8).
// That hub row sets the time of the whole launch: it is the longest chain of
// dependent reads (its indices, then its rows, round after round).
//   - One trial: x [3556, 24] f32 (rows of 96 B, 341 KB): 0.4 MB must move,
//     0.0001 ms, below the 0.0007 ms of an empty launch.
//   - The sweep, 32 trials: x [3556, 768] f32 (rows of 3 KB, 10.9 MB):
//     12.9 MB, 0.0038 ms. Everything sits in the 50 MB L2 after first touch.
//   - TwoWL at 50k nodes: nbr/w [50000, 32], x [351958, 24 or 16] f32 (rows
//     of 96 or 64 B, each read once): 41.4 / 28.5 MB, 0.0124 / 0.0085 ms.
//
// Design: four kernels, chosen in `spmm_ell_f32` from the shape and
// alignment of x, the slot count D and the row count M.
//   - Slot matrices of more than 32 columns over few rows, rows of whole
//     16-byte groups (`spmm_ell_split_kernel`; see kSplitWaves): one block
//     per (output row, tile of 4G columns), G lanes per slot as in the packed
//     kernel, and up to 8 warps that each take a chunk of the row's slots (32
//     at G <= 8, 8 at G = 32), so the hub row's 114 slots are read by 4-8
//     warps, each with one read of its chunk's indices and one round of row
//     reads, instead of four warps with up to four rounds each (the wide
//     kernel). The warps' sums meet in shared memory, added in warp order.
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
// All four read up to 32 of a row's slots per coalesced load of nbr and w and
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

// Which slot matrices take the split kernel, and at how many warps a row:
// W = the chunks of kStep slots a row has (D / kStep, rounded up to a power
// of two), at most 8, then halved down to 4 while the warps launched (rows x
// tiles x W) pass kSplitWaves times the warps the card holds at once; the
// split kernel when D > kPackedAnySlots and the warps stay within that.
// Device ms per call on an NVIDIA H100 80GB HBM3 at 700 W, each kernel
// forced and timed in turns by kernel_turns.py (split at W = 2 / 4 / 8 / 16,
// the rule's pick in brackets; wide / packed after the slash):
//   fb-pages-food, [620, 114] (one row of 114 live slots, 11 of 33-59, the
//     rest <= 32): F = 4 0.00250 / [0.00219] / 0.00229 / 0.00354, wide
//     0.00474 / packed 0.00318; F = 16 0.00291 / [0.00227] / 0.00329 /
//     0.00477, 0.00622 / 0.00499; F = 24 0.00419 / [0.00284] / 0.00259 /
//     0.00466, 0.00634 / 0.00632; F = 32 0.00399 / [0.00282] / 0.00263 /
//     0.00464, 0.00627 / 0.00646; F = 64 0.00817 / 0.00425 / [0.00292] /
//     0.00490, 0.00630; F = 128 0.01066 / 0.00636 / [0.00415] / 0.00459,
//     0.00644; F = 192 0.01133 / 0.00676 / [0.00527] / 0.00671, 0.00669;
//     F = 256 0.01121 / 0.00677 / [0.00530] / 0.00678, 0.00674; F = 512
//     0.01144 / [0.00699] / 0.00782 / 0.01113, 0.00804; F = 768 0.01193 /
//     [0.00840] / 0.01044 / 0.01549, 0.00915;
//   the same slots tiled to 2,480 rows: F = 16 0.00394 / [0.00423] /
//     0.00730, packed 0.00516; F = 24 0.00461 / [0.00452] / 0.00553, packed
//     0.00665; F = 192 0.01493 / 0.01186 / 0.01297, [wide 0.01028]; F = 512
//     0.02000 / 0.01832, [wide 0.01552]; to 9,920 rows: packed (F = 16, 24)
//     or wide (F = 192, 512) 1.3-3.1x faster than any W.
// The rule's pick is the fastest kernel at 15 of these 18 shapes and within
// 9 % at the other three (W = 8 at F = 24 and 32 on [620, 114], W = 2 at
// F = 16 on 2,480 rows; W = 8 at F = 16 on [620, 114] would lose 45 %).
constexpr int64_t kSplitWaves = 2;
constexpr int64_t kSplitMaxWarps = 8;

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

// Few rows with a long tail: a block of kWarps warps per (output row, tile of
// 4 kGroup columns), kGroup lanes a slot as in the packed kernel. The row's
// slots fall into chunks of kStep = (32 / kGroup) x kPackedUnroll (32 at
// kGroup <= 8, 16 at 16, 8 at 32); warp v takes chunks v, v + kWarps, ...,
// and the launch gives a row as many warps as it has chunks (up to 16), so
// each warp reads its chunk's indices once and issues all of its row reads
// in one round. A warp with no live slot in its chunk reads no row. Each
// warp's slot groups meet in a butterfly as in the packed kernel; the warps'
// partial sums meet in shared memory and are added in warp order, one column
// a thread. No atomics.
template <int kGroup, int kWarps>
__global__ void __launch_bounds__(kWarp * kWarps)
spmm_ell_split_kernel(const int32_t* __restrict__ nbr,
                      const float* __restrict__ w,
                      const float* __restrict__ x, float* __restrict__ out,
                      int d, int nx, int f, int tiles) {
  constexpr int kSlotsAtOnce = kWarp / kGroup;
  constexpr int kPackedUnroll = kGroup < 8 ? kGroup : 8;
  constexpr int kStep = kSlotsAtOnce * kPackedUnroll;  // divides 32
  constexpr int kCols = 4 * kGroup;
  __shared__ __align__(16) float part[kWarps][kCols];
  const int row = blockIdx.x / tiles;
  const int tile = blockIdx.x - row * tiles;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int s = lane / kGroup;
  const int col = tile * kCols + (lane % kGroup) * 4;
  const bool active = col < f;
  const int32_t* nrow = nbr + static_cast<int64_t>(row) * d;
  const float* wrow = w + static_cast<int64_t>(row) * d;
  const float* xcol = x + (active ? col : 0);

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int d0 = warp * kStep; d0 < d; d0 += kWarps * kStep) {
    int j = 0;
    float wv = 0.0f;
    if (lane < kStep) load_slots(nrow, wrow, d0 + lane, d, nx, j, wv);
    if (__ballot_sync(kFullMask, wv != 0.0f) == 0u) continue;  // warp-uniform
    uint4 r[kPackedUnroll];
    float wk[kPackedUnroll];
#pragma unroll
    for (int u = 0; u < kPackedUnroll; ++u) {
      const int k = u * kSlotsAtOnce + s;  // < kStep
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
#pragma unroll
  for (int off = kGroup; off < kWarp; off *= 2) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[c] += __shfl_xor_sync(kFullMask, acc[c], off);
    }
  }
  if (s == 0) {
    *reinterpret_cast<float4*>(&part[warp][(lane % kGroup) * 4]) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < kCols; c += kWarp * kWarps) {
    float sum = part[0][c];
#pragma unroll
    for (int v = 1; v < kWarps; ++v) sum += part[v][c];
    if (tile * kCols + c < f) {
      out[static_cast<int64_t>(row) * f + tile * kCols + c] = sum;
    }
  }
}

template <int kGroup, int kWarps>
void launch_split_warps(const int32_t* nbr, const float* w, const float* x,
                        float* out, int64_t m, int64_t d, int64_t nx,
                        int64_t f, cudaStream_t stream) {
  const int64_t tiles = (f + 4 * kGroup - 1) / (4 * kGroup);
  spmm_ell_split_kernel<kGroup, kWarps>
      <<<static_cast<unsigned>(m * tiles), kWarp * kWarps, 0, stream>>>(
          nbr, w, x, out, static_cast<int>(d), static_cast<int>(nx),
          static_cast<int>(f), static_cast<int>(tiles));
}

// The split kernel's warps a row (see kSplitWaves): as many as a row has
// chunks of the group's kStep slots, rounded up to a power of two, at most
// kSplitMaxWarps, halved down to 4 while rows x tiles x warps passes
// kSplitWaves times the card's resident warps. 0 when the split kernel does
// not take [m, d] slots over f features (whole 16-byte groups).
inline int split_warps(int64_t m, int64_t d, int64_t f) {
  if (d <= kPackedAnySlots || f % 4 != 0) return 0;
  int64_t group = 1;
  while (group < 32 && group * 4 < f) group *= 2;
  const int64_t step = kWarp / group * (group < 8 ? group : 8);
  const int64_t tiles = (f + 4 * group - 1) / (4 * group);
  const int64_t budget = kSplitWaves * resident_warps();
  int64_t warps = 2;
  while (warps < kSplitMaxWarps && warps * step < d) warps *= 2;
  while (warps > 4 && m * tiles * warps > budget) warps /= 2;
  return m * tiles * warps <= budget ? static_cast<int>(warps) : 0;
}

template <int kGroup>
void launch_split(int warps, const int32_t* nbr, const float* w,
                  const float* x, float* out, int64_t m, int64_t d,
                  int64_t nx, int64_t f, cudaStream_t stream) {
  if (warps <= 2) {
    launch_split_warps<kGroup, 2>(nbr, w, x, out, m, d, nx, f, stream);
  } else if (warps <= 4) {
    launch_split_warps<kGroup, 4>(nbr, w, x, out, m, d, nx, f, stream);
  } else {
    launch_split_warps<kGroup, 8>(nbr, w, x, out, m, d, nx, f, stream);
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
  // Dispatch by shape (see kPackedAnySlots and kWideMinRowBytes). Rows of
  // whole 16-byte groups on 16-byte boundaries take the packed kernel or the
  // wide one; every other shape the warp-per-row kernel.
  const int64_t groups = f / 4;
  const bool many_rows = m > resident_warps();
  const bool packed =
      groups <= kWarp &&
      (d <= kPackedAnySlots || groups <= kPackedAnyRowGroups ||
       (many_rows && groups <= kPackedManyRowGroups));
  const int warps = split_warps(m, d, f);
  if (warps > 0 && wide_aligned(f, sizeof(float), 16, {x, out})) {
    if (groups <= 1) {
      launch_split<1>(warps, nbr, w, x, out, m, d, nx, f, s);
    } else if (groups <= 2) {
      launch_split<2>(warps, nbr, w, x, out, m, d, nx, f, s);
    } else if (groups <= 4) {
      launch_split<4>(warps, nbr, w, x, out, m, d, nx, f, s);
    } else if (groups <= 8) {
      launch_split<8>(warps, nbr, w, x, out, m, d, nx, f, s);
    } else if (groups <= 16) {
      launch_split<16>(warps, nbr, w, x, out, m, d, nx, f, s);
    } else {
      launch_split<32>(warps, nbr, w, x, out, m, d, nx, f, s);
    }
    return static_cast<int>(cudaGetLastError());
  }
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
