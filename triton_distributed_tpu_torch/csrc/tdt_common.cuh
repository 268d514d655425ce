// Shared helpers of the port's CUDA kernels: float conversions for the
// element types the wrappers pass, and the dtype codes of the C ABI.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes the Python wrappers pass for a tensor's element type
enum TdtDtype { TDT_F32 = 0, TDT_BF16 = 1, TDT_I8 = 2 };

template <typename T>
__device__ __forceinline__ float tdt_to_f(T v);
template <>
__device__ __forceinline__ float tdt_to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float tdt_to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float tdt_to_f<int8_t>(int8_t v) {
  return static_cast<float>(v);
}

template <typename T>
__device__ __forceinline__ T tdt_from_f(float v);
template <>
__device__ __forceinline__ float tdt_from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 tdt_from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
