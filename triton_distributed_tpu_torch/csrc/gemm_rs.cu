// GEMM + reduce-scatter for row-parallel tensor parallelism, over a mesh.
//
// Replaces triton_distributed_tpu/kernels/gemm_rs.py:_fused_kernel
// (:248) with its ack-credited ring, reduce_ring (kernels/ring.py:238),
// and the fold ew_add_pipeline (:72): every rank computes its partial
// product A_q @ B_q (A_q the rank's K columns of all W * m rows, B_q its
// K rows of the weight) and the ring folds the partials so that rank r
// ends with out_r (m, N) = sum_q A_q[r * m : (r + 1) * m] @ B_q. The TPU
// ring writes each hop's partial into slabs of the output type
// (gemm_rs.py:551), so in bf16 it rounds once per hop.
//
// On the card the reduction becomes a pull through the peer tables: one
// launch covers the ranks rank0 .. rank0 + nranks - 1 on this device
// (blockIdx.z is the rank), and each output tile runs its K loop over
// (rank q, k-block), A's rows and B both read from rank q (PeerSum in
// ggemm_tiles.cuh). The sum over ranks and K stays in f32 registers and
// the tile is written once, rounded once: in bf16 it differs from the
// ring by up to about W - 1 bf16 ulps of the result, in f32 only by the
// summation order. Every rank's A and B are complete before the launch
// by stream order, so no block waits on another.
//
// What bounds it on an H100: the tensor cores. At the Llama-2-7B tp = 4
// prefill (A_q 8192 x 1024 for wo or 8192 x 2752 for down, bf16; B_q
// 1024 or 2752 x 4096) one launch over the four ranks is 2 * 8192 * K *
// 4096 flops (0.28 / 0.75 ms at 989 TFLOP/s).
//
// Design (right and simple first): the tile loops of ggemm_tiles.cuh
// with the PeerSum source; no overlap, no wgmma, no TMA.

#include "ggemm_tiles.cuh"

extern "C" {

// a_peers: (world,) pointers to A_q (world * m, K); w_peers: (world,)
// pointers to B_q (K, N); out_peers: (world,) pointers to out_r (m, N).
// zero: one int32 0 (the one expert of the tile loops). Writes out_r
// for r in [rank0, rank0 + nranks). x_dtype TDT_BF16 or
// TDT_F32 (B alike), out_dtype TDT_BF16 or TDT_F32; aligned: every A and
// B shard starts on a 16-byte boundary.
int tdt_gemm_rs(const void* a_peers, const void* w_peers,
                const void* out_peers, const void* zero, int m, int K,
                int N, int world, int rank0, int nranks, int x_dtype,
                int out_dtype, int aligned, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (m <= 0 || N <= 0 || nranks <= 0) return 0;
  const PeerSum rows{static_cast<const unsigned long long*>(a_peers),
                     static_cast<const unsigned long long*>(w_peers),
                     static_cast<const unsigned long long*>(out_peers),
                     m, world, rank0, K};
  // the kernel's own A, w and out are unused: the rows source reads
  // the peer tables
  return launch_float_ggemm_z(nullptr, nullptr, static_cast<const int*>(zero),
                              nullptr, m, K, N, m, x_dtype, out_dtype,
                              static_cast<cudaStream_t>(stream), rows,
                              aligned != 0, aligned != 0, nranks);
}

}  // extern "C"
