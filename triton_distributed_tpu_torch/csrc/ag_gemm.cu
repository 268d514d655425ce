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
// them (WgPeerRows in wg_gemm.cuh, PeerRows in ggemm_tiles.cuh). Every
// rank's A is complete before the launch, by stream order on the one
// device, so no block waits on another. The tile rows are rotated so that
// a rank's first M-tiles are its own shard, the ring's step-0 order.
//
// What bounds it on an H100: the tensor cores. At the Llama-2-7B tp = 4
// prefill (A 4 x 2048 x 4096 bf16 rows; B_r 4096 x 3072 for wqkv or
// 4096 x 2752 for up) one launch over the four ranks is 2 * 8192 * 4096
// * N flops (0.83 / 0.75 ms at 989 TFLOP/s) on ~0.3 GB of operands.
//
// Design: in bf16 the warpgroup GEMM of wg_gemm.cuh (wgmma m64n256k16 fed
// by TMA, 128 x 256 tiles, a producer warpgroup keeping 4 stages in
// flight) over the WgPeerRows source, every shard tiled on its own so that
// any m takes it; world size 1 (ag_gemm on tensors) is the same launch on
// a one-rank table. Where wg_form_ok fails (f32, K or N not a multiple of
// 8, a base off the 16-byte grid), the tile loops of ggemm_tiles.cuh (bf16
// on mma.sync, f32 on FMA) with the PeerRows row source. No overlap of the
// gather with the product: the ring's overlap needs a persistent grid or
// the copy engine as producer and comes with the push-and-signal redesign.
//
// The quantized wires (tdt_ag_gemm_w, tdt_ag_gemm_mx) replace
// _fused_kernel_w (:266) and _fused_kernel_mx (:309). Their wrapper
// quantizes every rank's shard first (tdt_quantize_slab, wire.cu: codes
// (W, m, K), one f32 scale a chunk of rows), as JAX quantizes on the XLA
// side before its kernels. _w: rank r's own shard exact, a peer's rows
// its codes times the chunk scale rounded to A's dtype (the receiver's
// dequantize), f32 sums; on the warpgroup GEMM of wg_gemm.cuh (wgmma fed
// by TMA, a peer's codes converted in registers into wgmma's A fragment)
// where wg_form_ok holds, which the wire path's shapes do, else the tile
// loops over PeerRowsQ. _mx: every slab's
// int8 codes (the own one too, PeerRowsMx) against the per-column int8
// weight, exact s32 sums, epilogue (acc * row scale) * column scale. On
// the loopback mesh no byte crosses
// a link: the card shows what the wire costs and its numerics, not a
// bandwidth gain. At the tp = 4 prefill the _mx product is 2 * 8192 *
// 4096 * N int8 operations (0.42 / 0.37 ms at 1979 TOP/s for wqkv / up).
// Its loop is s8_mma_kernel (s8_tiles.cuh), over the PeerRowsMx rows;
// the wrapper hands B over transposed, (N, K) a rank.

#include "s8_tiles.cuh"
#include "wg_gemm.cuh"

extern "C" {

// a_peers: (world,) pointers to the row shards A_q (m, K); w_peers /
// out_peers: (world,) pointers to B_r (K, N) and out_r (world * m, N).
// zero: one int32 0 (the one expert of the tile loops); a_host / w_host /
// out_host: the three tables' world pointers in host memory (the
// warpgroup form's tensor maps). Writes out_r for r in [rank0, rank0 +
// nranks). x_dtype TDT_BF16 or TDT_F32 (B alike), out_dtype TDT_BF16 or
// TDT_F32; aligned: every A and B shard starts on a 16-byte boundary;
// wgmma: run the warpgroup form (the caller's choice by wg_form_ok's
// rule; refused where it fails; the device tables and zero are then
// unused), else the tile loops; *form: the MeshGemmForm launched.
int tdt_ag_gemm(const void* a_peers, const void* w_peers,
                const void* out_peers, const void* zero, const void* a_host,
                const void* w_host, const void* out_host, int m, int K,
                int N, int world, int rank0, int nranks, int x_dtype,
                int out_dtype, int aligned, int wgmma, int* form,
                void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (m <= 0 || N <= 0 || nranks <= 0) return 0;
  if (wgmma) {
    *form = GEMM_WGMMA;
    return wg_gemm<WgPeerRows>(
        static_cast<const unsigned long long*>(a_host), m,
        static_cast<const unsigned long long*>(w_host),
        static_cast<const unsigned long long*>(out_host), nullptr, nullptr,
        m, K, N, world, rank0, nranks, 1, 0, x_dtype, out_dtype,
        static_cast<cudaStream_t>(stream));
  }
  *form = x_dtype == TDT_BF16 ? GEMM_MMA_SYNC : GEMM_FMA;
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

// The fp8 / int8 wire: a_peers as for tdt_ag_gemm (rank r's own shard,
// read exact); q: (world, m, K) wire codes, s: (world, m / chunk_rows)
// f32 scales (tdt_quantize_slab of every shard); quant TDT_WIRE_FP8 or
// TDT_WIRE_INT8; a_host / w_host / out_host: the three peer tables' world
// pointers in host memory (the warpgroup form's tensor maps); wgmma: run
// the warpgroup form (the caller's choice by wg_form_ok's rule; refused
// where it fails), else the tile loops; *form: the MeshGemmForm launched;
// the rest as for tdt_ag_gemm.
int tdt_ag_gemm_w(const void* a_peers, const void* q, const void* s,
                  const void* w_peers, const void* out_peers,
                  const void* zero, const void* a_host, const void* w_host,
                  const void* out_host, int m, int K, int N, int world,
                  int rank0, int nranks, int chunk_rows, int quant,
                  int x_dtype, int out_dtype, int aligned, int wgmma,
                  int* form, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (m <= 0 || N <= 0 || nranks <= 0) return 0;
  if (chunk_rows <= 0 || m % chunk_rows ||
      (quant != TDT_WIRE_FP8 && quant != TDT_WIRE_INT8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (wgmma) {
    *form = GEMM_WGMMA;
    return wg_gemm<WgPeerRowsQ>(
        static_cast<const unsigned long long*>(a_host), m,
        static_cast<const unsigned long long*>(w_host),
        static_cast<const unsigned long long*>(out_host), q,
        static_cast<const float*>(s), m, K, N, world, rank0, nranks,
        chunk_rows, quant, x_dtype, out_dtype,
        static_cast<cudaStream_t>(stream));
  }
  *form = x_dtype == TDT_BF16 ? GEMM_MMA_SYNC : GEMM_FMA;
  const PeerRowsQ rows{static_cast<const unsigned long long*>(a_peers),
                       static_cast<const uint8_t*>(q),
                       static_cast<const float*>(s),
                       static_cast<const unsigned long long*>(w_peers),
                       static_cast<const unsigned long long*>(out_peers),
                       m, world, rank0, K, x_dtype == TDT_BF16 ? 2 : 4,
                       chunk_rows, quant};
  const int M = world * m;
  return launch_float_ggemm_z(nullptr, nullptr, static_cast<const int*>(zero),
                              nullptr, M, K, N, M, x_dtype, out_dtype,
                              static_cast<cudaStream_t>(stream), rows,
                              aligned != 0, aligned != 0, nranks);
}

// The int8-mxu wire: q: (world, m, K) int8 codes of every shard, s:
// (world, m / chunk_rows) f32 scales; wt: (world, N, K) int8 per-column
// quantized weights, transposed; ws: (world, N) f32 column scales;
// out_peers: (world,) pointers to out_r (world * m, N); out_dtype
// TDT_BF16 or TDT_F32. Writes out_r for r in [rank0, rank0 + nranks).
int tdt_ag_gemm_mx(const void* q, const void* s, const void* wt,
                   const void* ws, const void* out_peers, int m, int K,
                   int N, int world, int rank0, int nranks, int chunk_rows,
                   int out_dtype, void* stream) {
  cudaGetLastError();
  if (m <= 0 || N <= 0 || nranks <= 0) return 0;
  if (chunk_rows <= 0 || m % chunk_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const PeerRowsMx rows{static_cast<const int8_t*>(q),
                        static_cast<const float*>(s),
                        static_cast<const unsigned long long*>(out_peers),
                        m, world, rank0, chunk_rows};
  const int M = world * m;
  const bool vec = K % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) |
                     reinterpret_cast<uintptr_t>(wt)) & 15) == 0;
  return launch_s8_mma(static_cast<const int8_t*>(wt),
                       static_cast<const float*>(ws), nullptr, M, K, N, M,
                       vec, out_dtype, static_cast<cudaStream_t>(stream),
                       rows, nranks);
}

}  // extern "C"
