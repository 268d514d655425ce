// The MoE tensor-parallel GEMMs at world size 1: AG + grouped GEMM and
// grouped GEMM + reduce-scatter.
//
// Replaces triton_distributed_tpu/kernels/moe_tp_fused.py:
//   * ag_group_gemm_kernel (:172): the ring all-gather of each shard's
//     expert-sorted token slab, each arriving slab streamed through a
//     grouped GEMM: out (tp * cap_s, N) = xs (cap_s, K) @ w[be[src, i]]
//     (E, K, N), f32 sums, out in the compute type. With one rank the
//     ring calls its consumer once on the local slab
//     (kernels/ring.py:141-145): one grouped GEMM.
//   * moe_reduce_rs_kernel (:285): each rank's partial (cap_s, H) = y
//     (cap_s, F) @ w[be] (E, F, H) computed into the reduce ring. With
//     one rank the ring is that one partial (kernels/ring.py:269-271).
//     The top-k combine stays outside, in moe_utils.scatter_combine.
//
// The TPU kernel reads a pre-sorted slab xs (built outside the kernel,
// ops/moe_tp.py:262-272) because its DMAs want contiguous rows. Here
// tdt_ag_group_gemm loads each A-tile row straight from token
// sti[r] / topk of x (a row of zeros at the sentinel sti[r] >= M * topk):
// the gather is fused into the tile load, and the top-k-times duplicated
// slab (cap_s x K, 235 MB at the H100 prefill's 57344 x 2048 bf16) is
// never written or read. tdt_moe_reduce_rs reads its rows in place; the
// reduce over ranks comes with the collectives.
//
// What bounds it on an H100: the tensor cores. At the DeepSeek-MoE-16B
// prefill (8192 tokens, top-6, 64 experts of 2048 x 1408, 57344 sorted
// rows at block_m 128) each launch is ~331 GFLOP on 0.56 GB (up) or
// 0.77 GB (down) of operands read and written once.
//
// Design: the tile loops of ggemm_tiles.cuh (bf16 on mma.sync, f32 on
// FMA) with a row source: GatherRows for the up projection, DenseRows
// for the down projection.

#include "ggemm_tiles.cuh"

extern "C" {

// x (M_tok, K), sti (cap,) int32 sorted token ids (sentinel M_tok * topk
// at the padding), w (E, K, N), block_expert (cap / block_m,) ->
// out (cap, N); x_dtype TDT_BF16 or TDT_F32 (w alike), out_dtype
// TDT_BF16 or TDT_F32
int tdt_ag_group_gemm(const void* x, const void* sti, const void* w,
                      const void* block_expert, void* out, int M_tok,
                      int topk, int cap, int K, int N, int block_m,
                      int x_dtype, int out_dtype, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (cap <= 0 || N <= 0) return 0;
  const GatherRows rows{static_cast<const int*>(sti), cap, K, topk,
                        M_tok * topk};
  return launch_float_ggemm(
      x, w, static_cast<const int*>(block_expert), out, cap, K, N, block_m,
      x_dtype, out_dtype, static_cast<cudaStream_t>(stream), rows,
      (reinterpret_cast<uintptr_t>(x) & 15) == 0);
}

// y (cap, F) sorted post-activation rows, w (E, F, H), block_expert
// (cap / block_m,) -> out (cap, H): this rank's partial, the whole sum
// at world size 1
int tdt_moe_reduce_rs(const void* y, const void* w, const void* block_expert,
                      void* out, int cap, int F, int H, int block_m,
                      int x_dtype, int out_dtype, void* stream) {
  cudaGetLastError();
  if (cap <= 0 || H <= 0) return 0;
  return launch_float_ggemm(
      y, w, static_cast<const int*>(block_expert), out, cap, F, H, block_m,
      x_dtype, out_dtype, static_cast<cudaStream_t>(stream),
      DenseRows{cap, F}, (reinterpret_cast<uintptr_t>(y) & 15) == 0);
}

}  // extern "C"
