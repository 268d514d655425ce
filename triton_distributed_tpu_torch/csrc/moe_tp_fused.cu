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
// Design: in bf16, where wg_grouped_form_ok holds (block_m and cap a
// multiple of 128: the prefill's shapes), the grouped warpgroup GEMM of
// wg_gemm.cuh (wg_grouped_kernel: wgmma fed by a persistent producer
// warpgroup, the weight a 3-D TMA map looked up by the tile's expert, TMA
// stores that overlap the next tile) on a one-rank table: the up
// projection over WgPeerGatherRows (the producer warpgroup gathers each
// tile's sorted rows from x by cp.async into the swizzled stage, 128 x 192
// tiles, all-padding tiles stored as zeros without their K loop), the
// down projection over WgGroupedPeerSum (rows in place, 128 x 256 tiles).
// Elsewhere (f32, 64-row blocks) the tile loops of ggemm_tiles.cuh (bf16
// on mma.sync, f32 on FMA) with a row source: GatherRows for the up
// projection, DenseRows for the down projection.
//
// Over a mesh (tdt_ag_group_gemm_mesh, tdt_moe_reduce_rs_mesh) the rings
// become pulls through the peer tables, as in ag_gemm.cu / gemm_rs.cu:
// one launch covers the ranks rank0 .. rank0 + nranks - 1 on this device,
// and every rank's inputs are complete before the launch by stream order,
// so no block waits on another.
//   * AG + grouped GEMM: rank r's out_r (W * cap_s, N_r) stacks, for
//     each source shard s, its expert-sorted rows x_s[sti[s, i] / topk]
//     @ w_r[be[s, i / block_m]] (the token's rank, then its sorted row;
//     no gathered slab is written): in bf16 WgPeerGatherRows over every
//     rank's tiles, elsewhere PeerGatherRows on the tile loops
//     (blockIdx.z the rank). Each shard was aligned on its own (cap_s =
//     its tokens * topk + E * block_m, rounded), so the rows are ~1.4x
//     those of one alignment over all tokens at the DeepSeek-MoE-16B tp =
//     4 prefill (81920 against 57344).
//   * grouped GEMM + RS: rank r's out_r (cap_s, H) = sum_q y_q[r * cap_s
//     + i] @ w_q[be[r, i / block_m]]: the K loop runs over (rank q,
//     F-block) with y_q and w_q looked up once a part, the sum in f32 and
//     rounded once (in bf16 WgGroupedPeerSum, the part's stages by TMA;
//     elsewhere grouped PeerSum on the tile loops). The TPU's reduce ring
//     rounds each hop's partial to the compute type, so in bf16 the two
//     differ by up to about W - 1 ulps of the result, as the mesh GEMM-RS
//     does.
// At the DeepSeek-MoE-16B tp = 4 prefill N_r = F / 4 = 352 (up) and the
// down K a rank is 352: two 192-wide tiles cover the up projection's N
// (TMA clips the store), and each part's K is 5.5 stages of 64, the last
// half TMA's zeros (the weight's 3-D map never reads the next expert's
// rows).
//
// The quantized wires (MoETPContext.wire_dtype) replace
// ag_group_gemm_kernel_w (:208), ag_group_gemm_kernel_mx (:243) with its
// gmm_q8_pipeline (:114), and moe_reduce_rs_kernel_w (:322). As JAX
// quantizes the materialized sorted slab on the XLA side, the wrapper
// gathers every shard's slab (W x (cap_s, K), padding rows zero) and
// quantizes all W in one tdt_quantize_slab launch (wire.cu): fp8 / int8
// at the chunk rows of make_wire_format(cap_s), int8-mxu at one chunk a
// routing block (block_m rows).
//   * tdt_ag_group_gemm_w: rank r's own shard exact, a peer's sorted rows
//     its codes times the chunk scale rounded to x's dtype (what JAX's
//     dequant_pipeline writes into the bf16 workspace), f32 sums, one
//     rounding. Where wg_grouped_form_ok holds (bf16, block_m and cap_s
//     multiples of 128: the wire path's shapes) the grouped warpgroup GEMM
//     of wg_gemm.cuh over WgPeerGatherRowsQ (128 x 192 tiles, the own rows
//     by TMA from the sorted slabs quantize_sorted materialized for the
//     quantizer and returned, the codes converted in registers, all-padding tiles
//     stored as zeros without their K loop); elsewhere the tile loops over
//     PeerGatherRowsQ (the own rows gathered from the tokens).
//   * tdt_ag_group_gemm_mx: every slab's codes, the own one too, through
//     s8_mma_kernel (s8_tiles.cuh) over PeerSortedMx against the block's
//     expert of the rank's per-(expert, column) int8 weight (the wrapper
//     quantizes it on every call, as JAX does, and hands it over (E, N,
//     K)), exact s32 sums, epilogue acc * (row scale * column scale).
//   * tdt_moe_reduce_rs_partials: every rank's grouped partials y_q @
//     w_q[be] over all W * cap_s rows, each rounded once to the output
//     type as JAX's partial_into writes its slab (the grouped warpgroup
//     GEMM over WgGroupedLocal, 128 x 256 tiles on a persistent grid whose
//     TMA stores overlap the next tile's products, where
//     wg_grouped_form_ok holds; PeerLocal grouped on the tile loops
//     elsewhere); then
//     gemm_rs.cu's tdt_gemm_rs_fold (m = cap_s) replays the reduce ring's
//     requantizing hops, rank d - 1's partial first and the own last. On
//     the loopback mesh no byte crosses a link: a hop's codes are made
//     and consumed in registers.
// What bounds them at the tp = 4 prefill: the tensor cores, over the
// 49152 real sorted rows (2 * 49152 * 2048 * 1408 operations: 0.29 ms at
// 989 TFLOP/s bf16, 0.14 ms at 1979 TOP/s int8); the partials, the 16
// slabs of 20480 x 2048 bf16 they write (1.34 GB, 0.40 ms); the fold,
// device memory (those slabs read once, ~0.5 ms).

#include "s8_tiles.cuh"
#include "wg_gemm.cuh"

extern "C" {

// x (M_tok, K), sti (cap,) int32 sorted token ids (sentinel M_tok * topk
// at the padding), w (E, K, N), block_expert (cap / block_m,) ->
// out (cap, N); x_dtype TDT_BF16 or TDT_F32 (w alike), out_dtype
// TDT_BF16 or TDT_F32; experts: E. wgmma: run the grouped warpgroup form
// on a one-rank table (the caller's choice by wg_grouped_form_ok's rule;
// refused where it fails), else the tile loops. *form: the MeshGemmForm
// launched.
int tdt_ag_group_gemm(const void* x, const void* sti, const void* w,
                      const void* block_expert, void* out, int M_tok,
                      int topk, int cap, int K, int N, int experts,
                      int block_m, int x_dtype, int out_dtype, int wgmma,
                      int* form, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (cap <= 0 || N <= 0) return 0;
  if (wgmma) {
    *form = GEMM_WGMMA;
    const unsigned long long xh = reinterpret_cast<uintptr_t>(x);
    const unsigned long long wh = reinterpret_cast<uintptr_t>(w);
    const unsigned long long oh = reinterpret_cast<uintptr_t>(out);
    return wg_grouped<WgPeerGatherRows, WG_GROUP_BN_AG>(
        nullptr, 0, &xh, topk, &wh, &oh, cap, nullptr, nullptr,
        static_cast<const int*>(sti), static_cast<const int*>(block_expert),
        M_tok * topk, cap, K, N, experts, block_m, 1, 0, 1, 1, 0, x_dtype,
        out_dtype, static_cast<cudaStream_t>(stream));
  }
  *form = x_dtype == TDT_BF16 ? GEMM_MMA_SYNC : GEMM_FMA;
  const GatherRows rows{static_cast<const int*>(sti), cap, K, topk,
                        M_tok * topk};
  return launch_float_ggemm(
      x, w, static_cast<const int*>(block_expert), out, cap, K, N, block_m,
      x_dtype, out_dtype, static_cast<cudaStream_t>(stream), rows,
      (reinterpret_cast<uintptr_t>(x) & 15) == 0);
}

// y (cap, F) sorted post-activation rows, w (E, F, H), block_expert
// (cap / block_m,) -> out (cap, H): this rank's partial, the whole sum
// at world size 1; experts: E. wgmma: the grouped warpgroup form on a
// one-rank table (refused where wg_grouped_form_ok fails), else the tile
// loops; *form: the MeshGemmForm launched.
int tdt_moe_reduce_rs(const void* y, const void* w, const void* block_expert,
                      void* out, int cap, int F, int H, int experts,
                      int block_m, int x_dtype, int out_dtype, int wgmma,
                      int* form, void* stream) {
  cudaGetLastError();
  if (cap <= 0 || H <= 0) return 0;
  if (wgmma) {
    *form = GEMM_WGMMA;
    const unsigned long long yh = reinterpret_cast<uintptr_t>(y);
    const unsigned long long wh = reinterpret_cast<uintptr_t>(w);
    const unsigned long long oh = reinterpret_cast<uintptr_t>(out);
    return wg_grouped<WgGroupedPeerSum, WG_GROUP_BN_RS>(
        &yh, 1, nullptr, 1, &wh, &oh, cap, nullptr, nullptr, nullptr,
        static_cast<const int*>(block_expert), 0, cap, F, H, experts,
        block_m, 1, 0, 1, 1, 0, x_dtype, out_dtype,
        static_cast<cudaStream_t>(stream));
  }
  *form = x_dtype == TDT_BF16 ? GEMM_MMA_SYNC : GEMM_FMA;
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
// starts on a 16-byte boundary; experts: E. wgmma: run the grouped
// warpgroup form over x_host / w_host / out_host, the three tables'
// pointers in host memory (the tensor maps, and the gather's shards by
// value; the caller's choice by wg_grouped_form_ok's rule; refused where
// it fails; the device tables are then unused), else the tile loops
// (the host tables unused); *form: the MeshGemmForm launched.
int tdt_ag_group_gemm_mesh(const void* x_peers, const void* w_peers,
                           const void* out_peers, const void* sti,
                           const void* block_expert, const void* x_host,
                           const void* w_host, const void* out_host,
                           int m_tok, int topk, int cap_s, int K, int N,
                           int experts, int block_m, int world, int rank0,
                           int nranks, int x_dtype, int out_dtype,
                           int aligned, int wgmma, int* form, void* stream) {
  cudaGetLastError();
  if (cap_s <= 0 || N <= 0 || nranks <= 0) return 0;
  if (wgmma) {
    *form = GEMM_WGMMA;
    return wg_grouped<WgPeerGatherRows, WG_GROUP_BN_AG>(
        nullptr, 0, static_cast<const unsigned long long*>(x_host), topk,
        static_cast<const unsigned long long*>(w_host),
        static_cast<const unsigned long long*>(out_host),
        static_cast<long long>(world) * cap_s, nullptr, nullptr,
        static_cast<const int*>(sti), static_cast<const int*>(block_expert),
        m_tok * topk, cap_s, K, N, experts, block_m, world, rank0, nranks, 1,
        0, x_dtype, out_dtype, static_cast<cudaStream_t>(stream));
  }
  *form = x_dtype == TDT_BF16 ? GEMM_MMA_SYNC : GEMM_FMA;
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
// r in [rank0, rank0 + nranks); experts: E. wgmma: the grouped warpgroup
// form over y_host / w_host / out_host, the tables' pointers in host
// memory (refused where wg_grouped_form_ok fails; the device tables are
// then unused), else the tile loops; *form: the MeshGemmForm launched.
int tdt_moe_reduce_rs_mesh(const void* y_peers, const void* w_peers,
                           const void* out_peers, const void* block_expert,
                           const void* y_host, const void* w_host,
                           const void* out_host, int cap_s, int F, int H,
                           int experts, int block_m, int world, int rank0,
                           int nranks, int x_dtype, int out_dtype,
                           int aligned, int wgmma, int* form, void* stream) {
  cudaGetLastError();
  if (cap_s <= 0 || H <= 0 || nranks <= 0) return 0;
  if (wgmma) {
    *form = GEMM_WGMMA;
    return wg_grouped<WgGroupedPeerSum, WG_GROUP_BN_RS>(
        static_cast<const unsigned long long*>(y_host), world, nullptr, 1,
        static_cast<const unsigned long long*>(w_host),
        static_cast<const unsigned long long*>(out_host), cap_s, nullptr,
        nullptr, nullptr, static_cast<const int*>(block_expert), 0, cap_s, F,
        H, experts, block_m, world, rank0, nranks, 1, 0, x_dtype, out_dtype,
        static_cast<cudaStream_t>(stream));
  }
  *form = x_dtype == TDT_BF16 ? GEMM_MMA_SYNC : GEMM_FMA;
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

// The fp8 / int8 wire: x_peers, sti, block_expert, w_peers, out_peers as
// for tdt_ag_group_gemm_mesh (rank r's own shard read exact from its
// tokens); q: (world, cap_s, K) wire codes of every shard's sorted slab,
// s: (world, cap_s / chunk_rows) f32 scales; quant TDT_WIRE_FP8 or
// TDT_WIRE_INT8; experts: E of w_r (E, K, N). wgmma: run the grouped
// warpgroup form (the caller's choice by wg_grouped_form_ok's rule;
// refused where it fails), which reads the own rows from xs, the (world,
// cap_s, K) sorted slabs (gather_sorted of every shard, zeros at the
// padding), and the weights and outputs through w_host / out_host, the
// (world,) pointers in host memory (the tensor maps); the device tables
// x_peers, w_peers and out_peers are then unused. Else the tile loops
// (xs, w_host and out_host unused). *form: the MeshGemmForm launched.
int tdt_ag_group_gemm_w(const void* x_peers, const void* q, const void* s,
                        const void* w_peers, const void* out_peers,
                        const void* sti, const void* block_expert,
                        const void* xs, const void* w_host,
                        const void* out_host, int m_tok, int topk, int cap_s,
                        int K, int N, int experts, int block_m, int world,
                        int rank0, int nranks, int chunk_rows, int quant,
                        int x_dtype, int out_dtype, int aligned, int wgmma,
                        int* form, void* stream) {
  cudaGetLastError();
  if (cap_s <= 0 || N <= 0 || nranks <= 0) return 0;
  if (chunk_rows <= 0 || cap_s % chunk_rows ||
      (quant != TDT_WIRE_FP8 && quant != TDT_WIRE_INT8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (wgmma) {
    *form = GEMM_WGMMA;
    if (xs == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const unsigned long long a = reinterpret_cast<uintptr_t>(xs);
    return wg_grouped<WgPeerGatherRowsQ, WG_GROUP_BN_AG>(
        &a, 1, nullptr, topk, static_cast<const unsigned long long*>(w_host),
        static_cast<const unsigned long long*>(out_host),
        static_cast<long long>(world) * cap_s, q,
        static_cast<const float*>(s), static_cast<const int*>(sti),
        static_cast<const int*>(block_expert), m_tok * topk, cap_s, K, N,
        experts, block_m, world, rank0, nranks, chunk_rows, quant, x_dtype,
        out_dtype, static_cast<cudaStream_t>(stream));
  }
  *form = x_dtype == TDT_BF16 ? GEMM_MMA_SYNC : GEMM_FMA;
  const PeerGatherRowsQ rows{
      {static_cast<const unsigned long long*>(x_peers),
       static_cast<const uint8_t*>(q), static_cast<const float*>(s),
       static_cast<const unsigned long long*>(w_peers),
       static_cast<const unsigned long long*>(out_peers), cap_s, world,
       rank0, K, x_dtype == TDT_BF16 ? 2 : 4, chunk_rows, quant},
      static_cast<const int*>(sti), topk, m_tok * topk};
  return launch_float_ggemm_z(nullptr, nullptr,
                              static_cast<const int*>(block_expert), nullptr,
                              world * cap_s, K, N, block_m, x_dtype,
                              out_dtype, static_cast<cudaStream_t>(stream),
                              rows, aligned != 0, aligned != 0, nranks);
}

// The int8-mxu wire: q: (world, cap_s, K) int8 codes of every shard's
// sorted slab, s: (world, cap_s / chunk_rows) f32 scales (chunk_rows =
// block_m, or cap_s); block_expert (world * cap_s / block_m,) int32, the
// shards' tables stacked; wt: (world, E, N, K) int8 per-(expert, column)
// quantized weights, transposed; ws: (world, E, N) f32; out_peers:
// (world,) pointers to out_r (world * cap_s, N) of out_dtype (TDT_BF16 or
// TDT_F32). Writes out_r for r in [rank0, rank0 + nranks); world 1 is the
// one-rank form.
int tdt_ag_group_gemm_mx(const void* q, const void* s,
                         const void* block_expert, const void* wt,
                         const void* ws, const void* out_peers, int cap_s,
                         int K, int N, int experts, int block_m, int world,
                         int rank0, int nranks, int chunk_rows,
                         int out_dtype, void* stream) {
  cudaGetLastError();
  if (cap_s <= 0 || N <= 0 || nranks <= 0) return 0;
  if (chunk_rows <= 0 || cap_s % chunk_rows || block_m <= 0 ||
      cap_s % block_m)
    return static_cast<int>(cudaErrorInvalidValue);
  const PeerSortedMx rows{static_cast<const int8_t*>(q),
                          static_cast<const float*>(s),
                          static_cast<const unsigned long long*>(out_peers),
                          cap_s, world, rank0, chunk_rows, experts};
  const bool vec = K % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) |
                     reinterpret_cast<uintptr_t>(wt)) & 15) == 0;
  return launch_s8_mma(static_cast<const int8_t*>(wt),
                       static_cast<const float*>(ws),
                       static_cast<const int*>(block_expert), world * cap_s,
                       K, N, block_m, vec, out_dtype,
                       static_cast<cudaStream_t>(stream), rows, nranks);
}

// The fp8 / int8 wire's partials: y_peers: (world,) pointers to y_q
// (world * cap_s, F); w_peers: to w_q (E, F, H); part_peers: to each
// rank's partial slab (world * cap_s, H) of out_dtype, rank q's y_q @
// w_q[be] over all its rows; block_expert (world * cap_s / block_m,)
// int32, the shards' tables stacked; experts: E. Every rank's partials
// feed every destination's fold, so the launch covers all ranks. wgmma:
// run the grouped warpgroup form over y_host / w_host / part_host, the
// three tables' pointers in host memory (the caller's choice by
// wg_grouped_form_ok's rule; refused where it fails; the device tables
// are then unused), else the tile loops; *form: the MeshGemmForm launched.
int tdt_moe_reduce_rs_partials(const void* y_peers, const void* w_peers,
                               const void* part_peers,
                               const void* block_expert, const void* y_host,
                               const void* w_host, const void* part_host,
                               int cap_s, int F, int H, int experts,
                               int block_m, int world, int x_dtype,
                               int out_dtype, int aligned, int wgmma,
                               int* form, void* stream) {
  cudaGetLastError();
  if (cap_s <= 0 || H <= 0 || world <= 0) return 0;
  if (wgmma) {
    *form = GEMM_WGMMA;
    return wg_grouped<WgGroupedLocal, WG_GROUP_BN_RS>(
        static_cast<const unsigned long long*>(y_host), world, nullptr, 1,
        static_cast<const unsigned long long*>(w_host),
        static_cast<const unsigned long long*>(part_host),
        static_cast<long long>(world) * cap_s, nullptr, nullptr, nullptr,
        static_cast<const int*>(block_expert), 0, cap_s, F, H, experts,
        block_m, world, 0, world, 1, 0, x_dtype, out_dtype,
        static_cast<cudaStream_t>(stream));
  }
  *form = x_dtype == TDT_BF16 ? GEMM_MMA_SYNC : GEMM_FMA;
  const PeerLocal rows{static_cast<const unsigned long long*>(y_peers),
                       static_cast<const unsigned long long*>(w_peers),
                       static_cast<const unsigned long long*>(part_peers),
                       world * cap_s, F, 0};
  return launch_float_ggemm_z(nullptr, nullptr,
                              static_cast<const int*>(block_expert), nullptr,
                              world * cap_s, F, H, block_m, x_dtype,
                              out_dtype, static_cast<cudaStream_t>(stream),
                              rows, aligned != 0, aligned != 0, world);
}

}  // extern "C"
