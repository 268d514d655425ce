// Reduce-scatter over a mesh: rank r ends with row block r of the sum of
// every rank's contribution, the hops added in the ring's order.
//
// Replaces triton_distributed_tpu/kernels/reduce_scatter.py:
// _ring_rs_kernel (:87), the VMEM-resident ring, and the HBM-streaming
// rings _rs_stream_kernel (:153) and _rs_stream_kernel3 (:181, one more
// ring slot). All three compute the same values: at step s rank i
// forwards its running partial of block (i + 1 + s) to its left
// neighbour, which adds its own contribution and rounds the slab to the
// dtype. So destination d's block is x_{d-1}[d] + x_{d-2}[d] + ... +
// x_d[d], added left to right with one rounding to the dtype per hop
// (in bf16 several ulps from a single f32 sum; in f32 the order fixes
// the bits).
//
// On the card the ring becomes a pull through the peer table: one launch
// covers the destination ranks rank0 .. rank0 + nranks - 1 on this
// device (blockIdx.y), the blocks along x walk the destination's n_local
// elements, and each element's hops are read from the ranks in ring
// order and added in registers: f32 sums __fadd_rn (never contracted),
// rounded to the dtype after each hop as the ring rounds its slab. Eight
// elements a thread through 16-byte accesses where the pointers and the
// block size allow it, one by one otherwise. Every contribution is
// complete before the launch, by stream order, so nothing waits; the
// ring's depth has no counterpart.
//
// What bounds it on an H100: device memory, every rank's contribution
// read once and every output written once. At DeepSeek-MoE-16B's
// composed MoE-TP (4 ranks, 8192 token rows of 2048 bf16 a rank) that is
// 128 MiB read and 32 MiB written, 0.050 ms at 3.35 TB/s; at 1024 rows
// 0.0063 ms, where the launch bounds it.

#include "wire.cuh"

namespace {

constexpr int RS_THREADS = 256;
constexpr int RS_MAX_BLOCKS = 1024;  // blocks along x per destination

__device__ __forceinline__ float rs_round(float v, float) { return v; }
__device__ __forceinline__ float rs_round(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__global__ void __launch_bounds__(RS_THREADS)
reduce_scatter_kernel(const unsigned long long* __restrict__ in_peers,
                      const unsigned long long* __restrict__ out_peers,
                      long long n_local, int world, int rank0, int vec) {
  const int d = rank0 + blockIdx.y;
  const size_t off = static_cast<size_t>(d) * n_local;
  T* __restrict__ out = reinterpret_cast<T*>(out_peers[d]);
  const long long stride = static_cast<long long>(gridDim.x) * RS_THREADS;
  const long long t0 = static_cast<long long>(blockIdx.x) * RS_THREADS +
                       threadIdx.x;
  if (vec) {
    for (long long i = 8 * t0; i < n_local; i += 8 * stride) {
      float acc[8], nxt[8];
      wire_ld8(reinterpret_cast<const T*>(in_peers[(d + world - 1) % world]) +
                   off + i, acc);
      for (int k = 2; k <= world; ++k) {
        wire_ld8(reinterpret_cast<const T*>(
                     in_peers[(d + world - k) % world]) + off + i, nxt);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[j] = rs_round(__fadd_rn(acc[j], nxt[j]), T());
      }
      wire_st8(out + i, acc);
    }
    return;
  }
  for (long long i = t0; i < n_local; i += stride) {
    float acc = tdt_to_f<T>(reinterpret_cast<const T*>(
        in_peers[(d + world - 1) % world])[off + i]);
    for (int k = 2; k <= world; ++k) {
      const T* src =
          reinterpret_cast<const T*>(in_peers[(d + world - k) % world]);
      acc = rs_round(__fadd_rn(acc, tdt_to_f<T>(src[off + i])), T());
    }
    out[i] = tdt_from_f<T>(acc);
  }
}

}  // namespace

extern "C" {

// in_peers: (world,) pointers to every rank's contribution (world *
// n_local elements of dtype TDT_BF16 or TDT_F32); out_peers: (world,)
// pointers to out_r (n_local elements). Writes out_r for r in [rank0,
// rank0 + nranks). aligned: every pointer on a 16-byte boundary and
// n_local * itemsize a multiple of 16.
int tdt_reduce_scatter(const void* in_peers, const void* out_peers,
                       long long n_local, int world, int rank0, int nranks,
                       int dtype, int aligned, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (n_local <= 0 || world <= 0 || nranks <= 0) return 0;
  const int vec = aligned && n_local % 8 == 0;
  long long runs = ((vec ? n_local / 8 : n_local) + RS_THREADS - 1) /
                   RS_THREADS;
  if (runs > RS_MAX_BLOCKS) runs = RS_MAX_BLOCKS;
  dim3 grid(static_cast<unsigned>(runs), nranks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned long long* ip =
      static_cast<const unsigned long long*>(in_peers);
  const unsigned long long* op =
      static_cast<const unsigned long long*>(out_peers);
  if (dtype == TDT_BF16)
    reduce_scatter_kernel<__nv_bfloat16><<<grid, RS_THREADS, 0, st>>>(
        ip, op, n_local, world, rank0, vec);
  else if (dtype == TDT_F32)
    reduce_scatter_kernel<float><<<grid, RS_THREADS, 0, st>>>(
        ip, op, n_local, world, rank0, vec);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
