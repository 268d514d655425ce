// The MoE tensor-parallel GEMMs: AG + grouped GEMM and grouped GEMM +
// reduce-scatter, at world size 1 and over a mesh.
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
//
// Over a mesh (tdt_ag_group_gemm_mesh, tdt_moe_reduce_rs_mesh) the rings
// become pulls through the peer tables, as in ag_gemm.cu / gemm_rs.cu:
// one launch covers the ranks rank0 .. rank0 + nranks - 1 on this device
// (blockIdx.z is the rank), and every rank's inputs are complete before
// the launch by stream order, so no block waits on another.
//   * AG + grouped GEMM: rank r's out_r (W * cap_s, N_r) stacks, for
//     each source shard s, its expert-sorted rows x_s[sti[s, i] / topk]
//     @ w_r[be[s, i / block_m]] (PeerGatherRows: the token's rank, then
//     its sorted row; no gathered slab is written). Each shard was
//     aligned on its own (cap_s = its tokens * topk + E * block_m,
//     rounded), so the rows are ~1.4x those of one alignment over all
//     tokens at the DeepSeek-MoE-16B tp = 4 prefill (81920 against 57344).
//   * grouped GEMM + RS: rank r's out_r (cap_s, H) = sum_q y_q[r * cap_s
//     + i] @ w_q[be[r, i / block_m]] (PeerSum, grouped): the K loop runs
//     over (rank q, F-block) with y_q and w_q looked up once a part, the
//     sum in f32 and rounded once. The TPU's reduce ring rounds each hop's
//     partial to the compute type, so in bf16 the two differ by up to
//     about W - 1 ulps of the result, as the mesh GEMM-RS does.
// At the DeepSeek-MoE-16B tp = 4 prefill N_r = F / 4 = 352 (up) and the
// down K a rank is 352: the tile loops mask the ragged N edge (352 = 2.75
// tiles of 128) and the K loop takes 11 whole steps of 32.

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

// Over a mesh. x_peers: (world,) pointers to the row shards x_s
// (m_tok, K); w_peers / out_peers: (world,) pointers to w_r (E, K, N) and
// out_r (world * cap_s, N); sti (world * cap_s,) and block_expert
// (world * cap_s / block_m,) int32: the shards' tables stacked. Writes
// out_r for r in [rank0, rank0 + nranks); aligned: every x and w shard
// starts on a 16-byte boundary.
int tdt_ag_group_gemm_mesh(const void* x_peers, const void* w_peers,
                           const void* out_peers, const void* sti,
                           const void* block_expert, int m_tok, int topk,
                           int cap_s, int K, int N, int block_m, int world,
                           int rank0, int nranks, int x_dtype, int out_dtype,
                           int aligned, void* stream) {
  cudaGetLastError();
  if (cap_s <= 0 || N <= 0 || nranks <= 0) return 0;
  const PeerGatherRows rows{static_cast<const unsigned long long*>(x_peers),
                            static_cast<const unsigned long long*>(w_peers),
                            static_cast<const unsigned long long*>(out_peers),
                            static_cast<const int*>(sti),
                            cap_s, world, rank0, K,
                            x_dtype == TDT_BF16 ? 2 : 4, topk, m_tok * topk};
  return launch_float_ggemm_z(nullptr, nullptr,
                              static_cast<const int*>(block_expert), nullptr,
                              world * cap_s, K, N, block_m, x_dtype,
                              out_dtype, static_cast<cudaStream_t>(stream),
                              rows, aligned != 0, aligned != 0, nranks);
}

// y_peers: (world,) pointers to y_q (world * cap_s, F); w_peers: to w_q
// (E, F, H); out_peers: to out_r (cap_s, H); block_expert (world * cap_s
// / block_m,) int32, the shards' block tables stacked. Writes out_r for
// r in [rank0, rank0 + nranks).
int tdt_moe_reduce_rs_mesh(const void* y_peers, const void* w_peers,
                           const void* out_peers, const void* block_expert,
                           int cap_s, int F, int H, int block_m, int world,
                           int rank0, int nranks, int x_dtype, int out_dtype,
                           int aligned, void* stream) {
  cudaGetLastError();
  if (cap_s <= 0 || H <= 0 || nranks <= 0) return 0;
  const PeerSum rows{static_cast<const unsigned long long*>(y_peers),
                     static_cast<const unsigned long long*>(w_peers),
                     static_cast<const unsigned long long*>(out_peers),
                     cap_s, world, rank0, F, /*grouped=*/true};
  return launch_float_ggemm_z(nullptr, nullptr,
                              static_cast<const int*>(block_expert), nullptr,
                              cap_s, F, H, block_m, x_dtype, out_dtype,
                              static_cast<cudaStream_t>(stream), rows,
                              aligned != 0, aligned != 0, nranks);
}

}  // extern "C"
