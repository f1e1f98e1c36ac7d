// Loads and stores of feature rows for kernels templated on the feature type
// (float or __nv_bfloat16). Values are read into f32 registers and written
// back rounded to nearest-even, as PyTorch's and JAX's casts round. The pair
// forms move two neighbouring features as one float2 / __nv_bfloat162 access
// and need an even feature count and an 8-byte (f32) or 4-byte (bf16)
// aligned base, which `pairs_aligned` checks on the host. The 16-byte forms
// move kWide neighbouring features (4 f32 or 8 bf16) as one uint4 access and
// need rows of a multiple of 16 bytes on a 16-byte aligned base
// (`wide_aligned`). `load_feature_if` reads one feature under a predicate,
// for the kernels that give each lane a slot of a row narrower than 16
// bytes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

template <typename T>
struct FeatureIo;

template <>
struct FeatureIo<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
  // a weight as the feature type holds it: f32 keeps it as it is
  static __device__ __forceinline__ float round(float v) { return v; }
  static constexpr int kWide = 4;  // features in 16 bytes
  static __device__ __forceinline__ void unpack(const uint4& r,
                                                float (&v)[kWide]) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[kWide]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

template <>
struct FeatureIo<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float a,
                                                float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static constexpr int kWide = 8;  // features in 16 bytes
  // a bf16 is the upper half of the f32 of the same value: the lower
  // feature of a 32-bit word shifts up, the upper one is masked
  static __device__ __forceinline__ void unpack(const uint4& r,
                                                float (&v)[kWide]) {
    const uint32_t words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(words[i] << 16);
      v[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[kWide]) {
    uint32_t words[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      words[i] = *reinterpret_cast<const uint32_t*>(&pair);
    }
    return make_uint4(words[0], words[1], words[2], words[3]);
  }
};

// 16 bytes from `p` (16-byte aligned) through the read-only path when `pred`
// holds, else zeros without touching memory. The predicate rides on the load
// itself, so a run of these has no branch between them and the loads of
// several slots are in flight together.
__device__ __forceinline__ uint4 load16_if(const void* p, bool pred) {
  uint4 r;
  asm("{\n\t"
      ".reg .pred q;\n\t"
      "setp.ne.s32 q, %5, 0;\n\t"
      "mov.u32 %0, 0;\n\t"
      "mov.u32 %1, 0;\n\t"
      "mov.u32 %2, 0;\n\t"
      "mov.u32 %3, 0;\n\t"
      "@q ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n\t"
      "}"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p), "r"(static_cast<int>(pred)));
  return r;
}

// 4 bytes from `p` through the read-only path when `pred` holds, else 0
// without touching memory; a run of these, like load16_if, has no branch
// between them.
__device__ __forceinline__ uint32_t load32_if(const void* p, bool pred) {
  uint32_t r;
  asm("{\n\t"
      ".reg .pred q;\n\t"
      "setp.ne.s32 q, %2, 0;\n\t"
      "mov.u32 %0, 0;\n\t"
      "@q ld.global.nc.u32 %0, [%1];\n\t"
      "}"
      : "=r"(r)
      : "l"(p), "r"(static_cast<int>(pred)));
  return r;
}

// The same for 2 bytes, returned in the low half.
__device__ __forceinline__ uint32_t load16bit_if(const void* p, bool pred) {
  unsigned short r;
  asm("{\n\t"
      ".reg .pred q;\n\t"
      "setp.ne.s32 q, %2, 0;\n\t"
      "mov.u16 %0, 0;\n\t"
      "@q ld.global.nc.u16 %0, [%1];\n\t"
      "}"
      : "=h"(r)
      : "l"(p), "r"(static_cast<int>(pred)));
  return r;
}

// One feature as f32 when `pred` holds, else 0, by a predicated load.
__device__ __forceinline__ float load_feature_if(const float* p, bool pred) {
  return __uint_as_float(load32_if(p, pred));
}
__device__ __forceinline__ float load_feature_if(const __nv_bfloat16* p,
                                                 bool pred) {
  return __uint_as_float(load16bit_if(p, pred) << 16);
}

// True when rows of `f` features of `elem_bytes` each, starting at every
// pointer given, can be read and written as pairs.
inline bool pairs_aligned(int64_t f, int64_t elem_bytes,
                          std::initializer_list<const void*> ptrs) {
  if (f % 2 != 0) return false;
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % (2 * elem_bytes) != 0) return false;
  }
  return true;
}

// True when rows of `f` features of `elem_bytes` each, starting at every
// pointer given, are whole 16-byte groups on 16-byte boundaries and hold at
// least `min_row_bytes`: the wide-row kernels' condition.
inline bool wide_aligned(int64_t f, int64_t elem_bytes, int64_t min_row_bytes,
                         std::initializer_list<const void*> ptrs) {
  const int64_t row_bytes = f * elem_bytes;
  if (row_bytes < min_row_bytes || row_bytes % 16 != 0) return false;
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  }
  return true;
}

// The warps the current device holds at once (132 SMs x 64 on an H100), read
// once; 0 if the device cannot be asked.
inline int64_t resident_warps() {
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
    return static_cast<int64_t>(sms) * (threads / 32);
  }();
  return warps;
}
