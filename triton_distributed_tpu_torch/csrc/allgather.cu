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
//
// tdt_all_gather_bidir replaces _ring_bidir_ag_kernel (:150): two rings
// at once, the clockwise one carrying columns [0, kh) of every shard
// (kh the schedule's split8 eighths, lane-aligned, :160-167) and the
// counter-clockwise one columns [kh, k), so that each link moves part of
// every shard. The pull keeps both: block (x, s, r) copies rank r's
// step-s arrivals, columns [0, kh) of shard r - s and [kh, k) of shard
// r + s, as rows of split_bytes and row_bytes - split_bytes bytes at a
// pitch of row_bytes (any dtype; a column is every element past dim 1).
// Over the W steps each (shard, column) is copied once, so the bytes
// equal the one-ring gather's; the split decides only the order and the
// row segments. Bound: nranks * world * shard bytes read and written.
//
// tdt_all_gather_persist replaces _ll_persist_kernel (:231), the
// barrier-free LL gather over a persistent workspace of two parity
// windows (2 * world * m rows a rank): call c pushes every shard into
// window c % 2 of every rank's workspace and drains the window into the
// output, so a lagging peer's call c - 1 writes the other window. On the
// loopback mesh every shard is complete before the launch, by stream
// order, and one launch covers every rank: block (x, q, r) copies shard q
// into rank r's window and rank r's output in one pass. No block reads
// what another block of the launch writes, so nothing waits on a flag.
// Bound: the shards read once a destination, the window and the output
// written: 3 * nranks * world * shard bytes.

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

// Copy `rows` rows of `seg` bytes, row i at src + i * pitch to dst +
// i * pitch, as one thread of a grid-stride walk (first index t0, stride
// `stride` threads): 16 bytes a step where the pointers, the segment and
// the pitch allow, byte by byte otherwise.
__device__ __forceinline__ void tdt_copy_rows(char* __restrict__ dst,
                                              const char* __restrict__ src,
                                              long long rows, long long seg,
                                              long long pitch, long long t0,
                                              long long stride) {
  if (rows <= 0 || seg <= 0) return;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst) |
        static_cast<uintptr_t>(seg) | static_cast<uintptr_t>(pitch)) &
       15) == 0) {
    const long long per = seg / 16, total = rows * per;
    for (long long i = t0; i < total; i += stride) {
      const long long r = i / per, c = 16 * (i - r * per);
      *reinterpret_cast<uint4*>(dst + r * pitch + c) =
          *reinterpret_cast<const uint4*>(src + r * pitch + c);
    }
    return;
  }
  const long long total = rows * seg;
  for (long long i = t0; i < total; i += stride) {
    const long long r = i / seg, c = i - r * seg;
    dst[r * pitch + c] = src[r * pitch + c];
  }
}

// blockIdx.y the ring step s, blockIdx.z the destination rank r
__global__ void __launch_bounds__(AG_THREADS)
all_gather_bidir_kernel(const unsigned long long* __restrict__ in_peers,
                        const unsigned long long* __restrict__ out_peers,
                        int m, long long row_bytes, long long split_bytes,
                        int world, int rank0) {
  const int s = blockIdx.y, r = rank0 + blockIdx.z;
  const int cw = (r - s + world) % world, ccw = (r + s) % world;
  char* out = reinterpret_cast<char*>(out_peers[r]);
  const long long shard = static_cast<long long>(m) * row_bytes;
  const long long stride = static_cast<long long>(gridDim.x) * AG_THREADS;
  const long long t0 = static_cast<long long>(blockIdx.x) * AG_THREADS +
                       threadIdx.x;
  // the clockwise ring's columns [0, kh) of shard r - s
  tdt_copy_rows(out + cw * shard, reinterpret_cast<const char*>(in_peers[cw]),
                m, split_bytes, row_bytes, t0, stride);
  // the counter-clockwise ring's columns [kh, k) of shard r + s
  tdt_copy_rows(out + ccw * shard + split_bytes,
                reinterpret_cast<const char*>(in_peers[ccw]) + split_bytes, m,
                row_bytes - split_bytes, row_bytes, t0, stride);
}

// blockIdx.y the source rank q, blockIdx.z the destination r: shard q's
// bytes into window slot q of rank r's workspace and into rank r's output
__global__ void __launch_bounds__(AG_THREADS)
all_gather_persist_kernel(const unsigned long long* __restrict__ in_peers,
                          const unsigned long long* __restrict__ ws_peers,
                          const unsigned long long* __restrict__ out_peers,
                          long long bytes, int win, int rank0) {
  const int q = blockIdx.y, r = rank0 + blockIdx.z;
  const char* __restrict__ src = reinterpret_cast<const char*>(in_peers[q]);
  char* __restrict__ ws = reinterpret_cast<char*>(ws_peers[r]) +
                          static_cast<long long>(win + q) * bytes;
  char* __restrict__ out = reinterpret_cast<char*>(out_peers[r]) +
                           static_cast<long long>(q) * bytes;
  const long long stride = static_cast<long long>(gridDim.x) * AG_THREADS;
  const long long t0 = static_cast<long long>(blockIdx.x) * AG_THREADS +
                       threadIdx.x;
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(ws) |
        reinterpret_cast<uintptr_t>(out)) & 15) == 0) {
    const long long nv = bytes / 16;
    for (long long i = t0; i < nv; i += stride) {
      const uint4 v = reinterpret_cast<const uint4*>(src)[i];
      reinterpret_cast<uint4*>(ws)[i] = v;
      reinterpret_cast<uint4*>(out)[i] = v;
    }
    done = nv * 16;
  }
  for (long long i = done + t0; i < bytes; i += stride) {
    const char v = src[i];
    ws[i] = v;
    out[i] = v;
  }
}

// blocks along x for a copy of `bytes` bytes a (source, rank) pair
unsigned ag_runs(long long bytes) {
  long long runs = (bytes / 16 + AG_THREADS - 1) / AG_THREADS;
  if (runs < 1) runs = 1;
  if (runs > AG_MAX_BLOCKS) runs = AG_MAX_BLOCKS;
  return static_cast<unsigned>(runs);
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

// The bidirectional ring: in_peers: (world,) pointers to the shards x_q
// (m rows of row_bytes bytes each); out_peers: (world,) pointers to
// out_r (world * m rows); split_bytes: the bytes of a row's first kh
// columns (0 <= split_bytes <= row_bytes). Writes out_r for r in [rank0,
// rank0 + nranks).
int tdt_all_gather_bidir(const void* in_peers, const void* out_peers, int m,
                         long long row_bytes, long long split_bytes,
                         int world, int rank0, int nranks, void* stream) {
  cudaGetLastError();
  if (m <= 0 || row_bytes <= 0 || world <= 0 || nranks <= 0) return 0;
  if (split_bytes < 0 || split_bytes > row_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(ag_runs(static_cast<long long>(m) * row_bytes), world, nranks);
  all_gather_bidir_kernel<<<grid, AG_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(in_peers),
      static_cast<const unsigned long long*>(out_peers), m, row_bytes,
      split_bytes, world, rank0);
  return static_cast<int>(cudaGetLastError());
}

// The persistent LL gather: in_peers: (world,) pointers to the shards
// (`bytes` bytes each); ws_peers: (world,) pointers to each rank's
// workspace (2 * world shards); out_peers: (world,) pointers to out_r
// (world * bytes); win: the window's first shard slot, parity * world.
// Writes window `win` of ws_r and out_r for r in [rank0, rank0 + nranks).
int tdt_all_gather_persist(const void* in_peers, const void* ws_peers,
                           const void* out_peers, long long bytes, int win,
                           int world, int rank0, int nranks, void* stream) {
  cudaGetLastError();
  if (bytes <= 0 || world <= 0 || nranks <= 0) return 0;
  if (win != 0 && win != world) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(ag_runs(bytes), world, nranks);
  all_gather_persist_kernel<<<grid, AG_THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(in_peers),
      static_cast<const unsigned long long*>(ws_peers),
      static_cast<const unsigned long long*>(out_peers), bytes, win, rank0);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
