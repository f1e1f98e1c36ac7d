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
// nothing. Sums are taken in f32, in slot order, so a result does not change
// from run to run.
//
// What bounds it on an H100: on the TwoWL slice (fb-pages-food) x is at most
// 3765 x 24 f32 (361 KB) and nbr/w at most 620 x 120 (595 KB together), so
// after the first touch everything sits in the 50 MB L2 and HBM bandwidth is
// not the limit. The arithmetic is a few hundred thousand multiply-adds. What
// is left is launch latency and, inside a warp, the dependent chain of
// gathers: for each slot, one index broadcast and one row read of x.
//
// Design: one warp per output row; lanes run across F in steps of 32, so one
// row of x is one coalesced read of up to 128 bytes. The warp reads its row of
// nbr and w 32 slots at a time, one coalesced load each, and broadcasts slot
// k with __shfl_sync. ELL padding carries weight 0 and is skipped by a
// warp-uniform branch, so a row with 6 valid slots of D = 120 issues 6 row
// reads. No shared memory, no atomics: each output element is written once.
// wgmma, TMA and tuning are left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;

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
      // one coalesced read of 32 slots; out-of-range indices get weight 0
      int j = 0;
      float wv = 0.0f;
      if (d0 + lane < d) {
        j = nrow[d0 + lane];
        wv = wrow[d0 + lane];
        if (j < 0 || j >= nx) wv = 0.0f;
      }
      const int n_slots = min(kWarp, d - d0);
      for (int k = 0; k < n_slots; ++k) {
        const int jk = __shfl_sync(0xffffffffu, j, k);
        const float wk = __shfl_sync(0xffffffffu, wv, k);
        if (wk != 0.0f && active) {
          acc = fmaf(wk, __ldg(x + static_cast<int64_t>(jk) * f + col), acc);
        }
      }
    }
    if (active) orow[col] = acc;
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
  const int64_t blocks = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
  spmm_ell_kernel<<<static_cast<unsigned>(blocks), kWarp * kWarpsPerBlock, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      nbr, w, x, out, static_cast<int>(m), static_cast<int>(d),
      static_cast<int>(nx), static_cast<int>(f));
  return static_cast<int>(cudaGetLastError());
}

const char* spmm_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
