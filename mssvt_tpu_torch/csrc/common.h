// Shared helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MSSVT_API extern "C" __attribute__((visibility("default")))

constexpr int PACK5_ZERO = (16 << 10) | (16 << 5) | 16;

// Storage/compute element types. Values are loaded to float, arithmetic is
// float, and round() re-rounds to the compute type where the reference
// rounds (every bf16 elementwise op of the JAX kernels rounds its result).
template <typename T> struct Elem;
template <> struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};
template <> struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

static inline int launch_status() { return (int)cudaGetLastError(); }
