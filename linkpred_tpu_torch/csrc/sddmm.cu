// K2 on Hopper: SDDMM, out[e] = sum_f x[src[e], f] * y[dst[e], f].
//
// Replaces the TPU kernel `sddmm_pallas` (linkpred_tpu/ops/pallas_kernels.py,
// body `_sddmm_kernel`). That kernel expands each block of 256 edge endpoints
// into two one-hot [256, N] matrices in VMEM, gathers the endpoint rows with
// two MXU products against the whole of x and y, and reduces their
// elementwise product: a form for the TPU's systolic array whose cost grows
// with N. Here the same function is a direct gather and reduction: an edge
// costs its two rows.
//
// Operands: src, dst [E] int32; x [NX, F] and y [NY, F], both float32 or both
// bfloat16, row-major and contiguous; out [E] float32 (written in full), as
// the TPU kernel returns f32. Products are summed in f32 (each lane in
// feature order, then a butterfly across the warp), so a result does not
// change from run to run. An edge with an index outside its table scores 0,
// as a one-hot row of zeros gives in the TPU kernel.
//
// What bounds it on an H100: in the GCN slice's training step E = 16,384
// edges (8,192 positive, 8,192 negative) over F = 128 bf16 features, so a
// call reads 2 x 16,384 rows of 256 bytes (8.4 MB, from a 60 MB table) and
// writes 64 KB; at test time E = 51,200. The arithmetic (2 flops per element
// read) is negligible: it is bound by the row reads and, at this size, by
// launch latency.
//
// Design: one warp per edge; lanes across F, two features per lane (float2 /
// __nv_bfloat162) when F is even and the bases are aligned, so a row is read
// in coalesced 256-byte (f32) or 128-byte (bf16) stripes; then a shuffle
// reduction, and lane 0 writes. No shared memory, no atomics. Several edges
// per warp for small F, and the endpoint rows staged through shared memory,
// are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "feature_io.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFullMask = 0xffffffffu;

template <typename T, int kVec>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
sddmm_kernel(const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
             const T* __restrict__ x, const T* __restrict__ y,
             float* __restrict__ out, int e, int nx, int ny, int f) {
  const int edge = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (edge >= e) return;  // warp-uniform: whole warps leave together
  const int s = src[edge];
  const int d = dst[edge];
  float acc = 0.0f;
  if (s >= 0 && s < nx && d >= 0 && d < ny) {  // warp-uniform
    const T* xr = x + static_cast<int64_t>(s) * f;
    const T* yr = y + static_cast<int64_t>(d) * f;
    for (int col = lane * kVec; col < f; col += kWarp * kVec) {
      if (kVec == 2) {
        const float2 a = FeatureIo<T>::load2(xr + col);
        const float2 b = FeatureIo<T>::load2(yr + col);
        acc = fmaf(a.x, b.x, acc);
        acc = fmaf(a.y, b.y, acc);
      } else {
        acc = fmaf(FeatureIo<T>::load(xr + col), FeatureIo<T>::load(yr + col),
                   acc);
      }
    }
  }
  for (int offset = kWarp / 2; offset > 0; offset /= 2) {
    acc += __shfl_xor_sync(kFullMask, acc, offset);
  }
  if (lane == 0) out[edge] = acc;
}

template <typename T>
int launch(const int32_t* src, const int32_t* dst, const void* x,
           const void* y, float* out, int64_t e, int64_t nx, int64_t ny,
           int64_t f, cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((e + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  if (pairs_aligned(f, sizeof(T), {x, y})) {
    sddmm_kernel<T, 2><<<blocks, kWarp * kWarpsPerBlock, 0, stream>>>(
        src, dst, xt, yt, out, static_cast<int>(e), static_cast<int>(nx),
        static_cast<int>(ny), static_cast<int>(f));
  } else {
    sddmm_kernel<T, 1><<<blocks, kWarp * kWarpsPerBlock, 0, stream>>>(
        src, dst, xt, yt, out, static_cast<int>(e), static_cast<int>(nx),
        static_cast<int>(ny), static_cast<int>(f));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches K2 on `stream` (a cudaStream_t, PyTorch's current stream).
// dtype: 0 float32, 1 bfloat16 (x and y). Returns cudaGetLastError() after
// the launch: 0 when it was accepted. Does not synchronise and allocates
// nothing; the caller owns every buffer.
int sddmm(int dtype, const int32_t* src, const int32_t* dst, const void* x,
          const void* y, float* out, int64_t e, int64_t nx, int64_t ny,
          int64_t f, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(src, dst, x, y, out, e, nx, ny, f, s);
    case 1:
      return launch<__nv_bfloat16>(src, dst, x, y, out, e, nx, ny, f, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* sddmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
