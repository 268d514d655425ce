// Shared helpers of the port's CUDA kernels: float conversions for the
// element types the wrappers pass, the dtype codes of the C ABI, and the
// byte copy of the data-movement kernels.
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

// Copy `bytes` bytes from src to dst as one thread of a grid-stride walk
// (first index t0, stride `stride` threads): 16 bytes a step where both
// pointers are 16-byte aligned, then byte by byte. Any dtype: the bytes
// move unchanged.
__device__ __forceinline__ void tdt_copy_bytes(char* __restrict__ dst,
                                               const char* __restrict__ src,
                                               long long bytes, long long t0,
                                               long long stride) {
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) &
       15) == 0) {
    const long long nv = bytes / 16;
    const uint4* __restrict__ s4 = reinterpret_cast<const uint4*>(src);
    uint4* __restrict__ d4 = reinterpret_cast<uint4*>(dst);
    for (long long i = t0; i < nv; i += stride) d4[i] = s4[i];
    done = nv * 16;
  }
  for (long long i = done + t0; i < bytes; i += stride) dst[i] = src[i];
}
