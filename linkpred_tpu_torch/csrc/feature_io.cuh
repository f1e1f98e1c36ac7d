// Loads and stores of feature rows for kernels templated on the feature type
// (float or __nv_bfloat16). Values are read into f32 registers and written
// back rounded to nearest-even, as PyTorch's and JAX's casts round. The pair
// forms move two neighbouring features as one float2 / __nv_bfloat162 access
// and need an even feature count and an 8-byte (f32) or 4-byte (bf16)
// aligned base, which `pairs_aligned` checks on the host.

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
};

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
