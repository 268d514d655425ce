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
//
// The quantized wire, tdt_all_gather_w, replaces _ring_ag_kernel_w (:87):
// the ring forwards each shard's 1-byte codes and per-row f32 scales
// (lang/wire with chunk_rows 1) and every receiver dequantizes them into
// the shard's dtype; its own slab is written exact (:93-96). Here the
// wrapper quantizes every shard first (tdt_quantize_slab, per row), and
// each destination rank pulls its peers' codes and scales and writes
// code * scale rounded to the dtype, and its own shard's bytes. On the
// loopback mesh no byte crosses a link: the card shows the numerics and
// the cost of the quantize and dequantize passes, not a bandwidth gain.
// Bound: nranks * world * m * cols output elements written and the codes
// read, plus the shards read twice by the quantize (device memory).

#include "wire.cuh"

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
  tdt_copy_bytes(dst, src, bytes, t0, stride);
}

// blockIdx.y the source rank q, blockIdx.z the destination r: out_r's
// rows [q * m, (q + 1) * m) are x_q's own bytes where q == r, else the
// dequantized codes of q (one scale a row)
template <typename T>
__global__ void __launch_bounds__(AG_THREADS)
all_gather_w_kernel(const unsigned long long* __restrict__ in_peers,
                    const uint8_t* __restrict__ q,
                    const float* __restrict__ s,
                    const unsigned long long* __restrict__ out_peers, int m,
                    int cols, int rank0, int quant, int aligned) {
  const int src = blockIdx.y, r = rank0 + blockIdx.z;
  const long long n = static_cast<long long>(m) * cols;
  T* __restrict__ dst = reinterpret_cast<T*>(out_peers[r]) +
                        static_cast<size_t>(src) * n;
  const long long stride = static_cast<long long>(gridDim.x) * AG_THREADS;
  const long long t0 = static_cast<long long>(blockIdx.x) * AG_THREADS +
                       threadIdx.x;
  const bool vec = aligned && cols % 8 == 0;
  if (src == r) {
    const T* __restrict__ x = reinterpret_cast<const T*>(in_peers[src]);
    if (vec) {
      for (long long i = 8 * t0; i < n; i += 8 * stride) {
        float v[8];
        wire_ld8(x + i, v);
        wire_st8(dst + i, v);
      }
    } else {
      for (long long i = t0; i < n; i += stride) dst[i] = x[i];
    }
    return;
  }
  const uint8_t* __restrict__ qs = q + static_cast<size_t>(src) * n;
  const float* __restrict__ ss = s + static_cast<size_t>(src) * m;
  if (vec) {
    for (long long i = 8 * t0; i < n; i += 8 * stride) {
      const float sc = ss[i / cols];
      union {
        uint2 u;
        uint8_t b[8];
      } c;
      c.u = *reinterpret_cast<const uint2*>(qs + i);
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = wire_value(c.b[j], sc, quant);
      wire_st8(dst + i, v);
    }
  } else {
    for (long long i = t0; i < n; i += stride)
      dst[i] = tdt_from_f<T>(wire_value(qs[i], ss[i / cols], quant));
  }
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

// The fp8 / int8 wire: in_peers: (world,) pointers to the (m, cols)
// shards x_q (x_dtype TDT_BF16 or TDT_F32); q: (world, m, cols) codes,
// s: (world, m) f32 per-row scales (tdt_quantize_slab at chunk_rows 1);
// out_peers: (world,) pointers to out_r (world * m, cols); aligned:
// every shard starts on a 16-byte boundary. Writes out_r for r in
// [rank0, rank0 + nranks).
int tdt_all_gather_w(const void* in_peers, const void* q, const void* s,
                     const void* out_peers, int m, int cols, int world,
                     int rank0, int nranks, int x_dtype, int quant,
                     int aligned, void* stream) {
  cudaGetLastError();
  if (m <= 0 || cols <= 0 || world <= 0 || nranks <= 0) return 0;
  if (quant != TDT_WIRE_FP8 && quant != TDT_WIRE_INT8)
    return static_cast<int>(cudaErrorInvalidValue);
  long long runs =
      (static_cast<long long>(m) * cols / 8 + AG_THREADS - 1) / AG_THREADS;
  if (runs < 1) runs = 1;
  if (runs > AG_MAX_BLOCKS) runs = AG_MAX_BLOCKS;
  dim3 grid(static_cast<unsigned>(runs), world, nranks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned long long* ip =
      static_cast<const unsigned long long*>(in_peers);
  const unsigned long long* op =
      static_cast<const unsigned long long*>(out_peers);
  const uint8_t* qb = static_cast<const uint8_t*>(q);
  const float* sf = static_cast<const float*>(s);
  if (x_dtype == TDT_BF16)
    all_gather_w_kernel<__nv_bfloat16><<<grid, AG_THREADS, 0, st>>>(
        ip, qb, sf, op, m, cols, rank0, quant, aligned);
  else if (x_dtype == TDT_F32)
    all_gather_w_kernel<float><<<grid, AG_THREADS, 0, st>>>(
        ip, qb, sf, op, m, cols, rank0, quant, aligned);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
