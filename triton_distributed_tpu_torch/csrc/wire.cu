// Quantize slabs for a wire: per-chunk amax -> scale -> codes.
//
// The counterpart of lang/wire.py quantize_slab (:171), which JAX runs
// on the XLA side before its fused wire kernels take the codes
// (ag_gemm.py:_fused_kernel_w / _mx, allgather.py:_ring_ag_kernel_w).
// The port runs it as this kernel so that the codes come from the same
// device functions (wire.cuh) as the GEMM-RS fold's: identical by
// construction, and equal byte for byte to the plain version's torch
// ops. One launch quantizes every rank's shard: blockIdx.y is the rank,
// blockIdx.x a chunk of chunk_rows rows (one row a chunk for the
// all-gather's per-row scales).
//
// What bounds it on an H100: device memory, each shard read twice (the
// amax pass, then the codes pass; a chunk of 64 x 4096 bf16 is 512 KB,
// past a block's shared memory) and its codes written once. At the
// Llama-2-7B tp = 4 prefill (4 x (2048, 4096) bf16) that is ~100 MB, ~30
// us at 3.35 TB/s.

#include "wire.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(WIRE_THREADS)
quantize_slab_kernel(const unsigned long long* __restrict__ in_peers,
                     uint8_t* __restrict__ q, float* __restrict__ s,
                     int rows, int cols, int chunk_rows, int quant,
                     int aligned) {
  __shared__ float red[32];
  const int r = blockIdx.y, c = blockIdx.x;
  const int chunks = rows / chunk_rows;
  const long long n = static_cast<long long>(chunk_rows) * cols;
  const size_t off = static_cast<size_t>(c) * n;
  const T* src = reinterpret_cast<const T*>(in_peers[r]) + off;
  uint8_t* dst = q + static_cast<size_t>(r) * rows * cols + off;
  const bool vec = aligned && cols % 8 == 0;
  wire_quant_chunk(src, dst, s + static_cast<size_t>(r) * chunks + c, n,
                   quant, vec, red);
}

}  // namespace

extern "C" {

// in_peers: (nranks,) pointers to the (rows, cols) slabs, x_dtype
// TDT_BF16 or TDT_F32; q: (nranks, rows, cols) codes; s: (nranks, rows /
// chunk_rows) f32 scales; quant TDT_WIRE_FP8 or TDT_WIRE_INT8; aligned:
// every slab starts on a 16-byte boundary.
int tdt_quantize_slab(const void* in_peers, void* q, void* s, int rows,
                      int cols, int nranks, int chunk_rows, int x_dtype,
                      int quant, int aligned, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (rows <= 0 || cols <= 0 || nranks <= 0) return 0;
  if (chunk_rows <= 0 || rows % chunk_rows ||
      (quant != TDT_WIRE_FP8 && quant != TDT_WIRE_INT8))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(rows / chunk_rows, nranks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned long long* peers =
      static_cast<const unsigned long long*>(in_peers);
  uint8_t* qb = static_cast<uint8_t*>(q);
  float* sf = static_cast<float*>(s);
  if (x_dtype == TDT_BF16)
    quantize_slab_kernel<__nv_bfloat16><<<grid, WIRE_THREADS, 0, st>>>(
        peers, qb, sf, rows, cols, chunk_rows, quant, aligned);
  else if (x_dtype == TDT_F32)
    quantize_slab_kernel<float><<<grid, WIRE_THREADS, 0, st>>>(
        peers, qb, sf, rows, cols, chunk_rows, quant, aligned);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
