// Row gather on Hopper: out[r, :] = x[i[r], :], or, with a second operand,
// out[r, :] = x[i[r], :] * y[j[r], :] (without j: y[r, :]).
//
// Replaces no TPU kernel. The JAX package leaves its row gathers (`x[idx]`,
// `jnp.take`) to XLA, and the port first left them to PyTorch's indexing.
// That kernel (`vectorized_gather_kernel`) takes one block per gathered row,
// its threads across the row's 16-byte pieces and the block rounded up to a
// warp: a row of 64 bytes keeps 4 of 32 lanes busy, and each of the
// millions of blocks an epoch waits on two dependent reads (its index, then
// its row) with nothing else in flight. In TwoWL at 50k nodes its time grew
// with the rows (about 4.4 million an epoch), not with the bytes. This kernel
// was added to move the same rows at the rate of the card's memory, and to
// fold in the one product that always follows two of them, the edge Hadamard
// product x[src] * x[dst] (`ops/sddmm.edge_hadamard`) and its gradient's
// g * x[dst].
//
// Operands: x [NX, F] and y [NY, F], both float32 or both bfloat16, i and j
// int64, out [R, F] of x's type (written in full), all row-major and
// contiguous. An index equal to the table's row count reads a zero row (the
// sentinel of a padded slot); any other index outside [0, rows) stops the
// kernel with a trap, which the next synchronise reports, as PyTorch's own
// index kernels report theirs. The product is taken in the operands' type,
// one multiply per element (bf16 through f32, rounded to nearest even once),
// as PyTorch's `x[i] * y[j]` takes it, so the result is the plain one bit for
// bit. No sums, no atomics: each output element is written once.
//
// What bounds it on an H100 (80 GB HBM3, 3.35 TB/s): bytes, with no arithmetic
// to speak of. The bound counts the output and the indices once and each row
// of the tables that an index names once. TwoWL at 50k nodes gathers from
// tables of 1.6-4.8 MB, which stay in the 50 MB L2, so the bound is nearly all
// output and indices: per epoch about 4.4 million rows of 32, 64 or 96 bytes,
// ~0.32 GB written and ~35 MB of indices, ~0.1 ms.
//
// Design: the output is cut into chunks of 16 bytes (4 f32 or 8 bf16), or of
// 4 bytes, or of one element, the widest that the row's byte width and every
// base address allow, so the chunk follows the row width and no knob sets it.
// Consecutive threads take consecutive chunks, so a warp writes 512
// contiguous bytes and reads 8 rows of 64 bytes (or 16 of 32) at once,
// whatever the row width. Each thread takes kUnroll chunks kThreads apart,
// reads their indices, then their rows (and y's), each read predicated
// rather than branched over, so a thread keeps kUnroll pairs of dependent
// reads in flight; a grid-stride loop covers any length.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <initializer_list>

#include "feature_io.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

// what the second operand is: none, y's own rows (j absent), or rows of y
// named by j
enum Mode { kGather = 0, kTimesRows = 1, kTimesGathered = 2 };

template <int kBytes>
struct Chunk;
template <>
struct Chunk<16> {
  using type = uint4;
  static __device__ __forceinline__ uint4 load_if(const uint4* p, bool pred) {
    return load16_if(p, pred);
  }
};
template <>
struct Chunk<4> {
  using type = uint32_t;
  static __device__ __forceinline__ uint32_t load_if(const uint32_t* p,
                                                     bool pred) {
    return load32_if(p, pred);
  }
};
template <>
struct Chunk<2> {
  using type = unsigned short;
  static __device__ __forceinline__ unsigned short load_if(
      const unsigned short* p, bool pred) {
    return static_cast<unsigned short>(load16bit_if(p, pred));
  }
};

__device__ __forceinline__ float times(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ __nv_bfloat16 times(__nv_bfloat16 a,
                                               __nv_bfloat16 b) {
  return __float2bfloat16_rn(
      __fmul_rn(__bfloat162float(a), __bfloat162float(b)));
}

// the elementwise product of two chunks of T
template <typename T, int kBytes>
__device__ __forceinline__ typename Chunk<kBytes>::type times_chunk(
    typename Chunk<kBytes>::type a, typename Chunk<kBytes>::type b) {
  constexpr int n = kBytes / static_cast<int>(sizeof(T));
  static_assert(n >= 1, "a chunk holds at least one element");
  T va[n], vb[n];
  memcpy(va, &a, kBytes);
  memcpy(vb, &b, kBytes);
#pragma unroll
  for (int e = 0; e < n; ++e) va[e] = times(va[e], vb[e]);
  memcpy(&a, va, kBytes);
  return a;
}

// chunks are counted in 32 bits: the wrapper refuses outputs of 2^31
// elements or more
template <typename T, int kBytes, int kMode>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const typename Chunk<kBytes>::type* __restrict__ x,
                       const int64_t* __restrict__ idx,
                       const typename Chunk<kBytes>::type* __restrict__ y,
                       const int64_t* __restrict__ j,
                       typename Chunk<kBytes>::type* __restrict__ out,
                       uint32_t total, uint32_t row_chunks, int64_t nx,
                       int64_t ny) {
  using C = Chunk<kBytes>;
  using V = typename C::type;
  const uint32_t stride = gridDim.x * kThreads * kUnroll;
  for (uint32_t base = blockIdx.x * kThreads * kUnroll + threadIdx.x;
       base < total; base += stride) {
    bool live[kUnroll];
    uint32_t r[kUnroll], k[kUnroll];
    int64_t xi[kUnroll], yi[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t c = base + static_cast<uint32_t>(u) * kThreads;
      live[u] = c < total;
      r[u] = live[u] ? c / row_chunks : 0;
      k[u] = live[u] ? c - r[u] * row_chunks : 0;
      xi[u] = live[u] ? __ldg(idx + r[u]) : 0;
      yi[u] = kMode == kTimesGathered && live[u]
                  ? __ldg(j + r[u])
                  : static_cast<int64_t>(r[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // outside [0, rows] (a negative index wraps to above it): stop
      const bool bad_x =
          static_cast<uint64_t>(xi[u]) > static_cast<uint64_t>(nx);
      const bool bad_y =
          kMode == kTimesGathered &&
          static_cast<uint64_t>(yi[u]) > static_cast<uint64_t>(ny);
      if (live[u] && (bad_x || bad_y)) __trap();
    }
    V a[kUnroll], b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      a[u] = C::load_if(x + xi[u] * static_cast<int64_t>(row_chunks) + k[u],
                        live[u] && xi[u] != nx);
      if constexpr (kMode != kGather) {
        b[u] = C::load_if(y + yi[u] * static_cast<int64_t>(row_chunks) + k[u],
                          live[u] && yi[u] != ny);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if constexpr (kMode != kGather) {
        a[u] = times_chunk<T, kBytes>(a[u], b[u]);
      }
      if (live[u]) out[base + static_cast<uint32_t>(u) * kThreads] = a[u];
    }
  }
}

template <typename T, int kBytes, int kMode>
void launch(const void* x, const int64_t* idx, const void* y,
            const int64_t* j, void* out, int64_t rows, int64_t nx, int64_t ny,
            int64_t f, cudaStream_t s) {
  using V = typename Chunk<kBytes>::type;
  const int64_t row_chunks = f * static_cast<int64_t>(sizeof(T)) / kBytes;
  const int64_t total = rows * row_chunks;
  const int64_t per_block = int64_t{kThreads} * kUnroll;
  const int64_t blocks =
      std::min<int64_t>((total + per_block - 1) / per_block, INT32_MAX);
  const auto* xv = static_cast<const V*>(x);
  const auto* yv = static_cast<const V*>(y);
  auto* ov = static_cast<V*>(out);
  gather_rows_kernel<T, kBytes, kMode>
      <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
          xv, idx, yv, j, ov, static_cast<uint32_t>(total),
          static_cast<uint32_t>(row_chunks), nx, ny);
}

template <typename T, int kBytes>
void launch_mode(int mode, const void* x, const int64_t* idx, const void* y,
                 const int64_t* j, void* out, int64_t rows, int64_t nx,
                 int64_t ny, int64_t f, cudaStream_t s) {
  if (mode == kGather) {
    launch<T, kBytes, kGather>(x, idx, y, j, out, rows, nx, ny, f, s);
  } else if (mode == kTimesRows) {
    launch<T, kBytes, kTimesRows>(x, idx, y, j, out, rows, nx, ny, f, s);
  } else {
    launch<T, kBytes, kTimesGathered>(x, idx, y, j, out, rows, nx, ny, f, s);
  }
}

// True when rows of `row_bytes` bytes at every pointer given (nulls left
// out) can be moved in chunks of `chunk` bytes.
bool chunks_fit(int64_t row_bytes, int64_t chunk,
                std::initializer_list<const void*> ptrs) {
  if (row_bytes % chunk != 0) return false;
  for (const void* p : ptrs) {
    if (p != nullptr && reinterpret_cast<uintptr_t>(p) % chunk != 0) {
      return false;
    }
  }
  return true;
}

template <typename T>
void launch_type(int mode, const void* x, const int64_t* idx, const void* y,
                 const int64_t* j, void* out, int64_t rows, int64_t nx,
                 int64_t ny, int64_t f, cudaStream_t s) {
  const int64_t row_bytes = f * static_cast<int64_t>(sizeof(T));
  if (chunks_fit(row_bytes, 16, {x, y, out})) {
    launch_mode<T, 16>(mode, x, idx, y, j, out, rows, nx, ny, f, s);
  } else if (chunks_fit(row_bytes, 4, {x, y, out})) {
    launch_mode<T, 4>(mode, x, idx, y, j, out, rows, nx, ny, f, s);
  } else {
    launch_mode<T, sizeof(T)>(mode, x, idx, y, j, out, rows, nx, ny, f, s);
  }
}

}  // namespace

extern "C" {

// Launches the row gather on `stream` (a cudaStream_t, PyTorch's current
// stream): `dtype` 0 for float32, 1 for bfloat16; `y` null for a plain
// gather, `j` null for y's own rows (then NY = rows). Returns
// cudaGetLastError() after the launch: 0 when the launch was accepted. Does
// not synchronise and allocates nothing; the caller owns every buffer and
// launches nothing for rows == 0 or f == 0.
int gather_rows(int dtype, const void* x, const int64_t* idx, const void* y,
                const int64_t* j, void* out, int64_t rows, int64_t nx,
                int64_t ny, int64_t f, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mode = y == nullptr ? kGather
                   : j == nullptr ? kTimesRows
                                  : kTimesGathered;
  if (dtype == 0) {
    launch_type<float>(mode, x, idx, y, j, out, rows, nx, ny, f, s);
  } else {
    launch_type<__nv_bfloat16>(mode, x, idx, y, j, out, rows, nx, ny, f, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* gather_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
