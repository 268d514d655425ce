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
//
// The quantized wire replaces _fused_kernel_w (:281),
// whose ring requantizes each hop's running partial: its numerics are the
// XLA twin's (gemm_rs_device, :759-810), which the plain version replays.
// For destination d the twin starts from P_{d-1}[d] (rank d - 1's partial
// product of d's rows, rounded to the output type), and at each of the
// W - 1 hops quantizes the running sum (scale from its chunk's amax),
// dequantizes it in f32, adds the next partial P_{d-2}[d], ..., P_d[d]
// (the own one last) in f32 and rounds to the output type. A single f32
// sum (PeerSum) would be the wrong numerics here. So two launches,
// tdt_gemm_rs_partials and tdt_gemm_rs_fold:
// (a) every rank's partials A_q @ B_q for all W * m rows, each rank into
// its own slab (the tile loops over PeerLocal; W * W * m * N elements,
// 268 MB in bf16 at the Llama-2-7B tp = 4 wo / down); (b) the fold, one
// block per (destination, chunk of chunk_rows rows), no cross-block
// waits: each hop reads the running chunk twice (its amax, then
// quantize -> dequantize -> add -> store; 64 x 4096 elements are past a
// block's shared memory) and the next partial once. On the loopback mesh
// no byte crosses a link, so a hop's codes are made and consumed in
// registers; the card shows the numerics and what the fold costs.

#include "ggemm_tiles.cuh"

namespace {

// the reduce ring's fold over the ranks' partial slabs (see above):
// blockIdx.y the destination rank, blockIdx.x a chunk of its rows
template <typename T>
__global__ void __launch_bounds__(WIRE_THREADS)
gemm_rs_fold_kernel(const unsigned long long* __restrict__ part_peers,
                    const unsigned long long* __restrict__ out_peers, int m,
                    int N, int world, int rank0, int chunk_rows, int quant,
                    int aligned) {
  __shared__ float red[32];
  const int d = rank0 + blockIdx.y;
  const long long n = static_cast<long long>(chunk_rows) * N;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * chunk_rows;
  const size_t off = (static_cast<size_t>(d) * m + row0) * N;
  T* acc = reinterpret_cast<T*>(out_peers[d]) + row0 * N;
  const bool vec = aligned && N % 8 == 0;
  const T* cur =
      reinterpret_cast<const T*>(part_peers[(d + world - 1) % world]) + off;
  if (world == 1) {
    for (long long i = threadIdx.x; i < n; i += blockDim.x) acc[i] = cur[i];
    return;
  }
  for (int j = 2; j <= world; ++j) {
    const T* add =
        reinterpret_cast<const T*>(part_peers[(d + world - j) % world]) + off;
    wire_fold_hop(cur, add, acc, n, quant, vec, red);
    cur = acc;
  }
}

}  // namespace

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
                     m, world, rank0, K, /*grouped=*/false};
  // the kernel's own A, w and out are unused: the rows source reads
  // the peer tables
  return launch_float_ggemm_z(nullptr, nullptr, static_cast<const int*>(zero),
                              nullptr, m, K, N, m, x_dtype, out_dtype,
                              static_cast<cudaStream_t>(stream), rows,
                              aligned != 0, aligned != 0, nranks);
}

// The fp8 / int8 wire, launch (a): a_peers / w_peers as for
// tdt_gemm_rs; part_peers: (world,) pointers to each rank's partial slab
// (world * m, N) of out_dtype: rank q's A_q @ B_q over all its rows.
// Every rank's partials feed every destination's fold, so the launch
// covers all ranks.
int tdt_gemm_rs_partials(const void* a_peers, const void* w_peers,
                         const void* part_peers, const void* zero, int m,
                         int K, int N, int world, int x_dtype, int out_dtype,
                         int aligned, void* stream) {
  cudaGetLastError();
  if (m <= 0 || N <= 0 || world <= 0) return 0;
  const PeerLocal rows{static_cast<const unsigned long long*>(a_peers),
                       static_cast<const unsigned long long*>(w_peers),
                       static_cast<const unsigned long long*>(part_peers),
                       world * m, K, 0};
  return launch_float_ggemm_z(nullptr, nullptr, static_cast<const int*>(zero),
                              nullptr, world * m, K, N, world * m, x_dtype,
                              out_dtype, static_cast<cudaStream_t>(stream),
                              rows, aligned != 0, aligned != 0, world);
}

// Launch (b), the fold: part_peers as above; out_peers: (world,)
// pointers to out_r (m, N) of out_dtype (TDT_BF16 or TDT_F32); chunk_rows
// rows share a scale; quant TDT_WIRE_FP8 or TDT_WIRE_INT8; aligned:
// every partial slab and output starts on a 16-byte boundary. Writes
// out_r for r in [rank0, rank0 + nranks).
int tdt_gemm_rs_fold(const void* part_peers, const void* out_peers, int m,
                     int N, int world, int rank0, int nranks, int chunk_rows,
                     int quant, int out_dtype, int aligned, void* stream) {
  cudaGetLastError();
  if (m <= 0 || N <= 0 || nranks <= 0) return 0;
  if (chunk_rows <= 0 || m % chunk_rows ||
      (quant != TDT_WIRE_FP8 && quant != TDT_WIRE_INT8))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(m / chunk_rows, nranks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned long long* parts =
      static_cast<const unsigned long long*>(part_peers);
  const unsigned long long* outs =
      static_cast<const unsigned long long*>(out_peers);
  if (out_dtype == TDT_BF16)
    gemm_rs_fold_kernel<__nv_bfloat16><<<grid, WIRE_THREADS, 0, st>>>(
        parts, outs, m, N, world, rank0, chunk_rows, quant, aligned);
  else if (out_dtype == TDT_F32)
    gemm_rs_fold_kernel<float><<<grid, WIRE_THREADS, 0, st>>>(
        parts, outs, m, N, world, rank0, chunk_rows, quant, aligned);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
