// KV page ship: page runs of (pool, rail) pairs copied from source page
// ids to landing page ids, the bytes unchanged.
//
// Replaces triton_distributed_tpu/kernels/kv_ship.py:_kv_ship_kernel
// (:117): every rank r pushes its staged pages to rank (r + n/2) % n at
// the landing slots of a table, `coalesce` pages a tick, each tick's
// int8 payload and its f32 scale plane as a dual-rail DMA pair on their
// own semaphores. JAX's serving engine ships over ppermute / device_put
// instead; the port's DisaggregatedEngine ships through this kernel.
//
// On the card the ship is a copy through a table of (pool, rail) pairs,
// one row each: source base, landing base, bytes a page and the row of
// the id tables it reads. One launch serves every pair: the mesh form
// (each rank's staged payload and scale buffers → its partner's, one id
// row a rank) and the engine form (a cohort's pages from every layer's K
// and V pool of the prefill role into the decode role's, payload and
// scale rails, one id row). Block (x, y) copies tick x of pair y: the
// `coalesce` pages starting at the tick's first source id, as one run,
// to the run starting at its first landing id (the wrapper refuses
// tables whose ticks are not contiguous runs on both sides). Every
// source page is complete before the launch, by stream order, and the
// decode role reads a landing page only after the ship's commit, later
// on the same stream: nothing waits, no semaphore.
//
// What bounds it on an H100: device memory, each shipped byte read once
// and written once. DeepSeek-MoE-16B's engine form at a 1024-token
// request (64 pages x 56 pools, 32 KiB payload + 1 KiB scales a page)
// moves 121 MB each way: 0.072 ms at 3.35 TB/s. A block copies its run
// with 16-byte loads, four in flight a thread, when both runs are
// 16-byte aligned (the pools' pages are), else byte by byte.

#include "tdt_common.cuh"

namespace {

constexpr int SHIP_THREADS = 256;
constexpr int SHIP_UNROLL = 4;
constexpr int SHIP_MAX_X = 65535;  // blocks along x; ticks beyond loop

__device__ __forceinline__ void ship_run(char* __restrict__ dst,
                                         const char* __restrict__ src,
                                         long long bytes) {
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst) |
        static_cast<uintptr_t>(bytes)) & 15) == 0) {
    const uint4* __restrict__ s4 = reinterpret_cast<const uint4*>(src);
    uint4* __restrict__ d4 = reinterpret_cast<uint4*>(dst);
    const long long nv = bytes / 16;
    for (long long i0 = threadIdx.x; i0 < nv;
         i0 += SHIP_THREADS * SHIP_UNROLL) {
      uint4 v[SHIP_UNROLL];
#pragma unroll
      for (int k = 0; k < SHIP_UNROLL; ++k) {
        const long long i = i0 + k * SHIP_THREADS;
        if (i < nv) v[k] = s4[i];
      }
#pragma unroll
      for (int k = 0; k < SHIP_UNROLL; ++k) {
        const long long i = i0 + k * SHIP_THREADS;
        if (i < nv) d4[i] = v[k];
      }
    }
    return;
  }
  for (long long i = threadIdx.x; i < bytes; i += SHIP_THREADS) dst[i] = src[i];
}

// desc: (npairs, 4) int64 rows (source base, landing base, bytes a page,
// id row); ids: (rows, 2, pages) int32, [row][0] source page ids,
// [row][1] landing page ids.
__global__ void __launch_bounds__(SHIP_THREADS)
kv_ship_kernel(const long long* __restrict__ desc,
               const int* __restrict__ ids, int pages, int coalesce) {
  const long long* d = desc + 4 * static_cast<long long>(blockIdx.y);
  const char* src = reinterpret_cast<const char*>(__ldg(d + 0));
  char* dst = reinterpret_cast<char*>(__ldg(d + 1));
  const long long page_bytes = __ldg(d + 2);
  const int* row = ids + __ldg(d + 3) * 2 * static_cast<long long>(pages);
  const int ticks = pages / coalesce;
  for (int t = blockIdx.x; t < ticks; t += gridDim.x) {
    const long long s = __ldg(row + t * coalesce);
    const long long l = __ldg(row + pages + t * coalesce);
    ship_run(dst + l * page_bytes, src + s * page_bytes,
             page_bytes * coalesce);
  }
}

}  // namespace

extern "C" {

int tdt_kv_ship(const void* desc, const void* ids, int npairs, int pages,
                int coalesce, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (npairs <= 0 || pages <= 0 || coalesce <= 0) return 0;
  int ticks = pages / coalesce;
  dim3 grid(static_cast<unsigned>(ticks < SHIP_MAX_X ? ticks : SHIP_MAX_X),
            static_cast<unsigned>(npairs));
  kv_ship_kernel<<<grid, SHIP_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(desc), static_cast<const int*>(ids),
      pages, coalesce);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
