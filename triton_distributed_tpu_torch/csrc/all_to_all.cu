// Dense all-to-all of equal row blocks over a mesh: row block j of rank
// i lands in row block i of rank j.
//
// Replaces triton_distributed_tpu/kernels/all_to_all.py:_a2a_kernel
// (:30): each device copies its own block into place and puts block j
// into peer j's slot `me` with n - 1 remote DMAs, then waits for its
// n - 1 arrivals. It is the padded-slot ("pallas") EP transport
// (kernels/moe_all_to_all.py), whose slots are int32 words: bitcast
// tokens, per-token scales and the per-expert counts.
//
// On the card it is a pull through the peer tables: one launch covers
// the destination ranks rank0 .. rank0 + nranks - 1 on this device
// (blockIdx.z); blockIdx.y is the source rank q, and the blocks along x
// copy q's block r (byte offset r * block_bytes of x_q) into r's block q.
// The bytes move unchanged, whatever the dtype, 16 bytes a thread where
// the pointers allow it (tdt_copy_bytes). Every input is complete before
// the launch, by stream order, so nothing waits.
//
// What bounds it on an H100: device memory, world * nranks blocks read
// and written once. The EP transport at DeepSeek-MoE-16B's 4 x 2048
// tokens a rank (top-6, fp8 wire, 12288-row slots of 2048 B plus their
// scale and count rows) moves 4 x 100.9 MB: 0.24 ms at 3.35 TB/s.

#include "tdt_common.cuh"

namespace {

constexpr int A2A_THREADS = 256;
constexpr int A2A_MAX_BLOCKS = 256;  // blocks along x per (source, rank)

__global__ void __launch_bounds__(A2A_THREADS)
all_to_all_kernel(const unsigned long long* __restrict__ in_peers,
                  const unsigned long long* __restrict__ out_peers,
                  long long block_bytes, int rank0) {
  const int q = blockIdx.y, r = rank0 + blockIdx.z;
  const char* src = reinterpret_cast<const char*>(in_peers[q]) +
                    static_cast<long long>(r) * block_bytes;
  char* dst = reinterpret_cast<char*>(out_peers[r]) +
              static_cast<long long>(q) * block_bytes;
  const long long stride = static_cast<long long>(gridDim.x) * A2A_THREADS;
  const long long t0 = static_cast<long long>(blockIdx.x) * A2A_THREADS +
                       threadIdx.x;
  tdt_copy_bytes(dst, src, block_bytes, t0, stride);
}

}  // namespace

extern "C" {

// in_peers: (world,) pointers to x_q (world * block_bytes bytes each);
// out_peers: (world,) pointers to out_r (the same size). Writes out_r
// for r in [rank0, rank0 + nranks).
int tdt_all_to_all(const void* in_peers, const void* out_peers,
                   long long block_bytes, int world, int rank0, int nranks,
                   void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (block_bytes <= 0 || world <= 0 || nranks <= 0) return 0;
  long long runs = (block_bytes / 16 + A2A_THREADS - 1) / A2A_THREADS;
  if (runs < 1) runs = 1;
  if (runs > A2A_MAX_BLOCKS) runs = A2A_MAX_BLOCKS;
  dim3 grid(static_cast<unsigned>(runs), world, nranks);
  all_to_all_kernel<<<grid, A2A_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(in_peers),
      static_cast<const unsigned long long*>(out_peers), block_bytes, rank0);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
