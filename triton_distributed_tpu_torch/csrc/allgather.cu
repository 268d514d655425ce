// All-gather over a mesh: every rank ends with the concatenation of all
// ranks' shards along dim 0.
//
// Replaces triton_distributed_tpu/kernels/allgather.py:_ring_ag_kernel
// (:42), the 1-D ring (each step forwards one shard to the right
// neighbour), and _ll_push_ag_kernel (:199), the small-message push of
// every shard to every peer. Both give the same bytes: out_r =
// concat_q x_q. On the card the gather is a pull through the peer
// tables: one launch covers the destination ranks rank0 .. rank0 +
// nranks - 1 on this device (blockIdx.z), blockIdx.y is the source rank
// q, and the blocks along x copy a run of x_q into out_r at byte offset
// q * bytes, 16 bytes a thread where source and destination allow it,
// byte by byte otherwise. Any dtype: the kernel moves bytes. Every shard
// is complete before the launch, by stream order, so nothing waits.
//
// What bounds it on an H100: device memory, nranks * world * bytes read
// and written once. The decode path gathers each rank's attention
// partial ((B 8, Hq 32, D 128) bf16 out, (8, 32) f32 lse) over 4 ranks:
// ~1 MB, ~0.6 us at 3.35 TB/s, so the launch itself bounds it.

#include "tdt_common.cuh"

namespace {

constexpr int AG_THREADS = 256;
constexpr int AG_MAX_BLOCKS = 256;  // blocks along x per (source, rank)

__global__ void __launch_bounds__(AG_THREADS)
all_gather_kernel(const unsigned long long* __restrict__ in_peers,
                  const unsigned long long* __restrict__ out_peers,
                  long long bytes, int rank0) {
  const int q = blockIdx.y, r = rank0 + blockIdx.z;
  const char* __restrict__ src = reinterpret_cast<const char*>(in_peers[q]);
  char* __restrict__ dst = reinterpret_cast<char*>(out_peers[r]) +
                           static_cast<long long>(q) * bytes;
  const long long stride = static_cast<long long>(gridDim.x) * AG_THREADS;
  const long long t0 = static_cast<long long>(blockIdx.x) * AG_THREADS +
                       threadIdx.x;
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

}  // namespace

extern "C" {

// in_peers: (world,) pointers to the shards x_q (`bytes` bytes each);
// out_peers: (world,) pointers to out_r (world * bytes). Writes out_r for
// r in [rank0, rank0 + nranks).
int tdt_all_gather(const void* in_peers, const void* out_peers,
                   long long bytes, int world, int rank0, int nranks,
                   void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (bytes <= 0 || world <= 0 || nranks <= 0) return 0;
  long long runs = (bytes / 16 + AG_THREADS - 1) / AG_THREADS;
  if (runs < 1) runs = 1;
  if (runs > AG_MAX_BLOCKS) runs = AG_MAX_BLOCKS;
  dim3 grid(static_cast<unsigned>(runs), world, nranks);
  all_gather_kernel<<<grid, AG_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(in_peers),
      static_cast<const unsigned long long*>(out_peers), bytes, rank0);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
