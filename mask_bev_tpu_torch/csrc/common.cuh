// Shared helpers of the port's CUDA kernels (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define MB_EXPORT extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// round an f32 value to the storage type T and back (identity for f32)
template <typename T> __device__ __forceinline__ float rd(float v) {
  return to_f(from_f<T>(v));
}
__device__ __forceinline__ float rd_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// exact erf GELU, as the reference XLA path computes it
__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752440f));
}

static inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Return codes of the exported functions: 0 or a cudaError_t from the
// launch; MB_BAD_ARGS when the arguments fail the function's own checks;
// MB_ATTR_FAILED + e when cudaFuncSetAttribute refused with error e.
#define MB_BAD_ARGS 100000
#define MB_ATTR_FAILED 200000
