// All-gather + GEMM for column-parallel tensor parallelism, over a mesh.
//
// Replaces triton_distributed_tpu/kernels/ag_gemm.py:_fused_kernel
// (:227) with its ring, ag_forward_ring (kernels/ring.py:115): every
// rank forwards the row shards of A around the ring while mm_pipeline
// (:128-162) consumes each shard as it arrives, so that rank r ends with
// out_r (W * m, N_r) = [A_0; ...; A_{W-1}] @ B_r, f32 sums, the output in
// A's dtype.
//
// On the card the ring becomes a pull through the peer table: one launch
// covers the ranks rank0 .. rank0 + nranks - 1 that live on this device
// (blockIdx.z is the rank; on the loopback mesh all W of them), and each
// output tile loads its A rows straight from the peer rank that holds
// them (PeerRows in ggemm_tiles.cuh). Every rank's A is complete before
// the launch, by stream order on the one device, so no block waits on
// another. The tile rows are rotated so that a rank's first M-tiles are
// its own shard, the ring's step-0 order.
//
// What bounds it on an H100: the tensor cores. At the Llama-2-7B tp = 4
// prefill (A 4 x 2048 x 4096 bf16 rows; B_r 4096 x 3072 for wqkv or
// 4096 x 2752 for up) one launch over the four ranks is 2 * 8192 * 4096
// * N flops (0.83 / 0.75 ms at 989 TFLOP/s) on ~0.3 GB of operands.
//
// Design (right and simple first): the tile loops of ggemm_tiles.cuh
// (bf16 on mma.sync, f32 on FMA) with the PeerRows row source; no
// overlap of the gather with the product, no wgmma, no TMA. The ring's
// overlap needs a persistent grid or the copy engine as producer and
// comes with the push-and-signal redesign.

#include "ggemm_tiles.cuh"

extern "C" {

// a_peers: (world,) pointers to the row shards A_q (m, K); w_peers /
// out_peers: (world,) pointers to B_r (K, N) and out_r (world * m, N).
// zero: one int32 0 (the one expert of the tile loops). Writes out_r
// for r in [rank0, rank0 + nranks). x_dtype TDT_BF16 or
// TDT_F32 (B alike), out_dtype TDT_BF16 or TDT_F32; aligned: every A
// and B shard starts on a 16-byte boundary.
int tdt_ag_gemm(const void* a_peers, const void* w_peers,
                const void* out_peers, const void* zero, int m, int K,
                int N, int world, int rank0, int nranks, int x_dtype,
                int out_dtype, int aligned, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (m <= 0 || N <= 0 || nranks <= 0) return 0;
  const PeerRows rows{static_cast<const unsigned long long*>(a_peers),
                      static_cast<const unsigned long long*>(w_peers),
                      static_cast<const unsigned long long*>(out_peers),
                      m, world, rank0, K,
                      x_dtype == TDT_BF16 ? 2 : 4};
  const int M = world * m;
  // the kernel's own A, w and out are unused: the rows source reads
  // the peer tables
  return launch_float_ggemm_z(nullptr, nullptr, static_cast<const int*>(zero),
                              nullptr, M, K, N, M, x_dtype, out_dtype,
                              static_cast<cudaStream_t>(stream), rows,
                              aligned != 0, aligned != 0, nranks);
}

}  // extern "C"
