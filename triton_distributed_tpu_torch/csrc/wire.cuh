// The quantized wire's arithmetic, as device functions: the in-kernel
// pipelines of triton_distributed_tpu/lang/wire.py, shared by wire.cu
// (tdt_quantize_slab), ag_gemm.cu (the dequantizing row source of
// ggemm_tiles.cuh), gemm_rs.cu (the reduce fold) and allgather.cu.
//
// A slab travels as 1-byte codes, fp8 e4m3 or int8, and one f32 scale a
// chunk of rows: scale = max(amax, 1e-12) / QMAX (QMAX 448 or 127) and
// code = x / scale, a division (never a multiply by the reciprocal),
// int8 rounded half to even and clipped to +-127, fp8 converted with
// saturation and round to nearest even; value = code * scale in f32.
// These are the plain versions' torch ops element for element
// (lang/wire.py quantize_slab / dequantize_slab), so the codes equal
// theirs byte for byte. The products and sums use the _rn intrinsics,
// which nvcc never contracts into an FMA: the plain versions multiply
// and add in separate ops.
//
// Counterparts of the JAX pipelines: quant_pipeline (:254) and
// quant_rows_into (:492) are wire_quant_chunk (amax, scale, codes);
// dequant_pipeline (:319) and dequant_rows_into (:516) wire_value, which
// the loads of ggemm_tiles.cuh's PeerRowsQ and allgather.cu apply;
// dequant_add_pipeline (:359) and dequant_add_requant_pipeline (:404)
// gemm_rs.cu's fold, from these functions (one reduce hop: requantize
// the running sum, dequantize it, add the next partial in f32).
#pragma once

#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "tdt_common.cuh"

// wire codes the Python wrappers pass
enum TdtWire { TDT_WIRE_FP8 = 1, TDT_WIRE_INT8 = 2 };

constexpr int WIRE_THREADS = 256;

namespace {

__device__ __forceinline__ float wire_qmax(int quant) {
  return quant == TDT_WIRE_FP8 ? 448.f : 127.f;
}

// scale = max(amax, 1e-12) / QMAX
__device__ __forceinline__ float wire_scale(float amax, int quant) {
  return __fdiv_rn(fmaxf(amax, 1e-12f), wire_qmax(quant));
}

// the code of x at `scale`
__device__ __forceinline__ uint8_t wire_code(float x, float scale,
                                             int quant) {
  const float y = __fdiv_rn(x, scale);
  if (quant == TDT_WIRE_FP8)
    return static_cast<uint8_t>(
        __nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3));
  const float r = fminf(fmaxf(rintf(y), -127.f), 127.f);
  return static_cast<uint8_t>(static_cast<int8_t>(r));
}

// code * scale in f32
__device__ __forceinline__ float wire_value(uint8_t code, float scale,
                                            int quant) {
  float v;
  if (quant == TDT_WIRE_FP8) {
    const __half_raw h = __nv_cvt_fp8_to_halfraw(code, __NV_E4M3);
    v = __half2float(__half(h));
  } else {
    v = static_cast<float>(static_cast<int8_t>(code));
  }
  return __fmul_rn(v, scale);
}

// two codes (c0 first) * scale in f32: one paired fp8 conversion
__device__ __forceinline__ float2 wire_value2(uint8_t c0, uint8_t c1,
                                              float scale, int quant) {
  float2 v;
  if (quant == TDT_WIRE_FP8) {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(c0 | (c1 << 8)), __NV_E4M3);
    v = __half22float2(__half2(h));
  } else {
    v = make_float2(static_cast<float>(static_cast<int8_t>(c0)),
                    static_cast<float>(static_cast<int8_t>(c1)));
  }
  return make_float2(__fmul_rn(v.x, scale), __fmul_rn(v.y, scale));
}

// 8 consecutive elements as f32, and back (one 16-byte access for bf16,
// two for f32)
__device__ __forceinline__ void wire_ld8(const __nv_bfloat16* p,
                                         float (&v)[8]) {
  union {
    uint4 u;
    unsigned short h[8];
  } t;
  t.u = *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    v[i] = __bfloat162float(__ushort_as_bfloat16(t.h[i]));
}
__device__ __forceinline__ void wire_ld8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void wire_st8(__nv_bfloat16* p,
                                         const float (&v)[8]) {
  union {
    uint4 u;
    unsigned short h[8];
  } t;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    t.h[i] = __bfloat16_as_ushort(__float2bfloat16_rn(v[i]));
  *reinterpret_cast<uint4*>(p) = t.u;
}
__device__ __forceinline__ void wire_st8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// the block's max of v (every thread's value >= 0), returned to every
// thread; `red` is 32 floats of shared memory, free again on return
__device__ __forceinline__ float wire_block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const float r = red[0];
  __syncthreads();
  return r;
}

// max |x| over n elements of one chunk (the whole block walks it);
// vec: n % 8 == 0 and p 16-byte aligned
template <typename T>
__device__ __forceinline__ float wire_chunk_amax(const T* p, long long n,
                                                 bool vec, float* red) {
  float m = 0.f;
  if (vec) {
    for (long long i = 8ll * threadIdx.x; i < n; i += 8ll * blockDim.x) {
      float v[8];
      wire_ld8(p + i, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(v[j]));
    }
  } else {
    for (long long i = threadIdx.x; i < n; i += blockDim.x)
      m = fmaxf(m, fabsf(tdt_to_f<T>(p[i])));
  }
  return wire_block_max(m, red);
}

// quantize one chunk of n elements: its scale into *s, its codes into q
// (quant_pipeline / quant_rows_into); the whole block calls it
template <typename T>
__device__ __forceinline__ void wire_quant_chunk(const T* src, uint8_t* q,
                                                 float* s, long long n,
                                                 int quant, bool vec,
                                                 float* red) {
  const float scale = wire_scale(wire_chunk_amax(src, n, vec, red), quant);
  if (threadIdx.x == 0) *s = scale;
  if (vec) {
    for (long long i = 8ll * threadIdx.x; i < n; i += 8ll * blockDim.x) {
      float v[8];
      wire_ld8(src + i, v);
      union {
        uint2 u;
        uint8_t b[8];
      } t;
#pragma unroll
      for (int j = 0; j < 8; ++j) t.b[j] = wire_code(v[j], scale, quant);
      *reinterpret_cast<uint2*>(q + i) = t.u;
    }
  } else {
    for (long long i = threadIdx.x; i < n; i += blockDim.x)
      q[i] = wire_code(tdt_to_f<T>(src[i]), scale, quant);
  }
}

}  // namespace
