// The Hopper pieces of the port's tensor-core kernels, shared by
// cp_ring.cu (ring_attention_tc_kernel), wg_gemm.cuh (the warpgroup GEMM
// of ag_gemm.cu, gemm_rs.cu and moe_tp_fused.cu) and group_gemm.cu
// (W8A8's w8a8_tc_kernel, on the s8 products): the mbarriers that pace
// TMA stages, the TMA copies (loads, and stores in bulk groups), wgmma's
// shared-memory descriptor and its products, and the tensor maps'
// encoding on the host.
//
// wgmma (sm_90a): a warpgroup of four warps issues an asynchronous product
// of a 64-row tile, d (64 x N, f32 in registers) += a (64 x 16 bf16) @ b
// (16 x N bf16 in shared memory, through a descriptor); a from registers
// (each warp its 16 rows in mma.sync's m16n8k16 A layout) or from shared
// memory. The products a warpgroup issued since its last commit form a
// group; wgmma.wait_group N returns once at most N groups are in flight,
// and only then may the accumulators, or a register operand, be touched.
//
// TMA: one thread asks for a box of a tensor map (CUtensorMap, encoded on
// the host by cuTensorMapEncodeTiled through the runtime's driver entry
// point, so nothing links libcuda); the copy lands in shared memory in the
// map's swizzle and completes `bytes` on an mbarrier, which the consumers
// wait on. Elements of a box past the tensor land as zeros.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "tdt_common.cuh"

namespace {

__device__ __forceinline__ uint32_t tc_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the mbarriers of the TMA stages (`count` arrivals a phase)
__device__ __forceinline__ void tc_bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(tc_smem(bar)), "r"(count));
}

__device__ __forceinline__ void tc_bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(tc_smem(bar)) : "memory");
}


__device__ __forceinline__ void tc_bar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(tc_smem(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tc_bar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nTC_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra TC_DONE;\nbra TC_WAIT;\nTC_DONE:\n}\n"
      :: "r"(tc_smem(bar)), "r"(parity) : "memory");
}

// one TMA box of a 5-D map at coordinates (c0, ..., c4), innermost first,
// into dst; `bar` counts its bytes (elements past the tensor land as zeros)
__device__ __forceinline__ void tc_tma(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1, int c2,
                                       int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n"
      :: "r"(tc_smem(dst)), "l"(map), "r"(tc_smem(bar)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// one TMA box of a 2-D map at (c0 innermost, c1) into dst; `bar` counts its
// bytes (elements past the tensor land as zeros)
__device__ __forceinline__ void tc_tma_2d(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(tc_smem(dst)), "l"(map), "r"(tc_smem(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// one TMA box of a 3-D map at (c0 innermost, c1, c2) into dst; `bar`
// counts its bytes (elements past the tensor land as zeros)
__device__ __forceinline__ void tc_tma_3d(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(tc_smem(dst)), "l"(map), "r"(tc_smem(bar)), "r"(c0), "r"(c1),
         "r"(c2)
      : "memory");
}

// one TMA box of shared memory at src stored to a 2-D map at (c0
// innermost, c1), in this thread's bulk group (elements past the tensor
// are not written)
__device__ __forceinline__ void tc_tma_store_2d(const CUtensorMap* map,
                                                const void* src, int c0,
                                                int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}],"
      " [%1];\n"
      :: "l"(map), "r"(tc_smem(src)), "r"(c0), "r"(c1) : "memory");
}

// this thread's TMA stores since the last commit form one bulk group
__device__ __forceinline__ void tc_bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's bulk groups have read their shared memory (READ) or are
// complete
template <bool READ>
__device__ __forceinline__ void tc_bulk_wait() {
  if constexpr (READ)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// this thread's writes to shared memory are visible to TMA (the async
// proxy)
__device__ __forceinline__ void tc_fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tc_ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(tc_smem(p)));
}

// (x, y) rounded to a bf16 pair, x in the low half (mma's A element order)
__device__ __forceinline__ uint32_t tc_bf16x2(float x, float y) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(y), "f"(x));
  return r;
}

// wgmma's shared-memory operand descriptor: the start address, `lbo` and
// `sbo` the byte strides between core matrices (without swizzle: along K
// and along M / N), `swz` 1 for the 128-byte swizzle (0: none)
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo,
                                            uint32_t sbo, int swz) {
  return static_cast<uint64_t>((tc_smem(p) >> 4) & 0x3FFF) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(swz) << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// the registers a product reads or writes, pinned in program order against
// wg_fence and the waits (the compiler would otherwise be free to move a
// plain read or write of them across those)
template <int N>
__device__ __forceinline__ void wg_pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int M, int N>
__device__ __forceinline__ void wg_pin(uint32_t (&d)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

// the warpgroup's products issued since the last commit are done, and
// their accumulators may be read
template <int N>
__device__ __forceinline__ void wg_commit_wait(float (&d)[N]) {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  wg_pin(d);
}

// commit the products issued since the last commit as one group
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// at most N of this warpgroup's groups are still in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// d (64 x N, f32) = or += a (64 x 16, bf16 from registers: the warp's 16
// rows in mma.sync's A layout) @ b (16 x N, bf16 in shared memory); wg_s:
// b K-major (S = Q K^T, K's rows are the keys), wg_pv: b MN-major (P V,
// V's rows are the keys; N 16 to 256 by the accumulator's size)
// the accumulator operands d[i .. i + 7] / d[i .. i + 15] of one wgmma
#define TC_ACC8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define TC_ACC16(i) TC_ACC8(i), TC_ACC8(i + 8)
__device__ __forceinline__ void wg_s(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : TC_ACC16(0), TC_ACC16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}
__device__ __forceinline__ void wg_pv(float (&d)[8], const uint32_t (&a)[4],
                                       uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : TC_ACC8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}
__device__ __forceinline__ void wg_pv(float (&d)[16], const uint32_t (&a)[4],
                                       uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : TC_ACC16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}
__device__ __forceinline__ void wg_pv(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : TC_ACC16(0), TC_ACC16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}
__device__ __forceinline__ void wg_pv(float (&d)[64], const uint32_t (&a)[4],
                                       uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : TC_ACC16(0), TC_ACC16(16), TC_ACC16(32), TC_ACC16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}
__device__ __forceinline__ void wg_pv(float (&d)[128], const uint32_t (&a)[4],
                                       uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46,"
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76,"
      "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91,"
      "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105,"
      "%106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118,"
      "%119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : TC_ACC16(0), TC_ACC16(16), TC_ACC16(32), TC_ACC16(48),
        TC_ACC16(64), TC_ACC16(80), TC_ACC16(96), TC_ACC16(112)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// d (64 x 256, f32) = or += a (64 x 16, bf16 in shared memory, K-major) @
// b (16 x 256, bf16 in shared memory, MN-major): both operands by
// descriptor
__device__ __forceinline__ void wg_ss_t(float (&d)[128], uint64_t a,
                                        uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46,"
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76,"
      "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91,"
      "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105,"
      "%106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118,"
      "%119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : TC_ACC16(0), TC_ACC16(16), TC_ACC16(32), TC_ACC16(48),
        TC_ACC16(64), TC_ACC16(80), TC_ACC16(96), TC_ACC16(112)
      : "l"(a), "l"(b), "r"(acc));
}
// the m64n192k16 forms of wg_pv (a from registers) and wg_ss_t (a from
// shared memory, K-major); b MN-major
__device__ __forceinline__ void wg_pv(float (&d)[96], const uint32_t (&a)[4],
                                       uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : TC_ACC16(0), TC_ACC16(16), TC_ACC16(32), TC_ACC16(48),
        TC_ACC16(64), TC_ACC16(80)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}
__device__ __forceinline__ void wg_ss_t(float (&d)[96], uint64_t a,
                                        uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 1;\n}\n"
      : TC_ACC16(0), TC_ACC16(16), TC_ACC16(32), TC_ACC16(48),
        TC_ACC16(64), TC_ACC16(80)
      : "l"(a), "l"(b), "r"(acc));
}
#undef TC_ACC16
#undef TC_ACC8

template <int N>
__device__ __forceinline__ void wg_pin(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x N, s32) = or += a (64 x 32, s8) @ b (32 x N, s8), both in shared
// memory K-major by descriptor (an 8-bit operand has no transpose: both
// K-major), exact integer sums; N 128 or 256 by the accumulator's size
#define TC_IACC8(i)                                                       \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),             \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define TC_IACC16(i) TC_IACC8(i), TC_IACC8(i + 8)
__device__ __forceinline__ void wg_ss_s8(int (&d)[64], uint64_t a, uint64_t b,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : TC_IACC16(0), TC_IACC16(16), TC_IACC16(32), TC_IACC16(48)
      : "l"(a), "l"(b), "r"(acc));
}
__device__ __forceinline__ void wg_ss_s8(int (&d)[128], uint64_t a,
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : TC_IACC16(0), TC_IACC16(16), TC_IACC16(32), TC_IACC16(48),
        TC_IACC16(64), TC_IACC16(80), TC_IACC16(96), TC_IACC16(112)
      : "l"(a), "l"(b), "r"(acc));
}
#undef TC_IACC16
#undef TC_IACC8

// cuTensorMapEncodeTiled, from the driver through the runtime (null where
// the driver has none)
inline PFN_cuTensorMapEncodeTiled_v12000 tc_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                                reinterpret_cast<void**>(&encode),
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      encode = nullptr;
  }
  return encode;
}

// a row-major (rows, cols) tensor of `esize`-byte elements at `base`, rows
// `pitch` bytes apart, as a map of boxes of box_cols x box_rows in swizzle
// `swz`; false where TMA cannot take it (a base or pitch not 16-byte
// aligned, or no encoder)
inline bool tc_map_2d(CUtensorMap* map, const void* base,
                      CUtensorMapDataType type, int esize, long long rows,
                      long long cols, long long pitch, int box_cols,
                      int box_rows, CUtensorMapSwizzle swz) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tc_encoder();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0 ||
      pitch % 16 != 0 || rows <= 0 || cols <= 0 || pitch < cols * esize)
    return false;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                        static_cast<cuuint64_t>(rows)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch)};
  cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                       static_cast<cuuint32_t>(box_rows)};
  cuuint32_t one[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box,
                one, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a (d2, d1, d0) tensor of `esize`-byte elements at `base`, innermost d0,
// its d1 rows `pitch1` bytes apart and its d2 slices `pitch2`, as a map of
// boxes of b0 x b1 x b2 in swizzle `swz`; false where TMA cannot take it
inline bool tc_map_3d(CUtensorMap* map, const void* base,
                      CUtensorMapDataType type, int esize, long long d0,
                      long long d1, long long d2, long long pitch1,
                      long long pitch2, int b0, int b1, int b2,
                      CUtensorMapSwizzle swz) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tc_encoder();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0 ||
      pitch1 % 16 != 0 || pitch2 % 16 != 0 || d0 <= 0 || d1 <= 0 ||
      d2 <= 0 || pitch1 < d0 * esize || pitch2 < d1 * pitch1)
    return false;
  cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                        static_cast<cuuint64_t>(d1),
                        static_cast<cuuint64_t>(d2)};
  cuuint64_t strides[2] = {static_cast<cuuint64_t>(pitch1),
                           static_cast<cuuint64_t>(pitch2)};
  cuuint32_t box[3] = {static_cast<cuuint32_t>(b0),
                       static_cast<cuuint32_t>(b1),
                       static_cast<cuuint32_t>(b2)};
  cuuint32_t one[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(base), dims, strides, box,
                one, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
