// Count-bounded chunked MoE all-to-all, at EP world size 1.
//
// Replaces triton_distributed_tpu/kernels/moe_dispatch.py:346
// (_chunked_a2a_kernel). Rank `me` pushes sendk[p] chunks of chunk_u*a
// rows from payload row (offs[p] + c*chunk_u)*a to receive row
// (par*n*slot_u + me*slot_u + c*chunk_u)*a of peer p, plus its
// mr x 128 int32 metadata block into meta block par*n + me. With one
// rank that is a self-copy into the caller's window: a fresh pair in
// barrier mode (one window, par = 0), or window par of the persistent
// double-buffered workspace in LL mode (written in place; the TPU's
// aliased input -> output). Rows past the shipped chunks are left as
// they were. The peer loop (symmetric memory, signals) comes with the
// collectives; the entry refuses n != 1.
//
// What bounds it on an H100: bytes. At the serving step's shapes
// (4608 assignments of 2048 fp8 bytes, 64-row chunks) it moves up to
// 9.4 MB of rows and 20 KB of metadata, read once and written once.
//
// Design: the chunks of one peer are contiguous in the source and in
// the window, so the copy is one byte range whose length is read from
// device memory (sendk), never from the host: no synchronisation per
// call. The grid is sized from the static maximum (n_chunks_max
// chunks); each block copies one 16 KB piece as 16-byte vectors and
// exits at once when its piece starts past sendk[0] chunks. The last
// blocks copy the metadata block. parity, offs and sendk are clamped
// to the window count, to >= 0 and to n_chunks_max, and the range to
// the payload's rows, so corrupt counts cannot address outside the
// buffers.

#include "tdt_common.cuh"

namespace {

constexpr int A2A_THREADS = 256;
constexpr long long A2A_PIECE = 16384;  // bytes per block

__device__ __forceinline__ void copy_piece(uint8_t* __restrict__ dst,
                                           const uint8_t* __restrict__ src,
                                           long long len) {
  const int tid = threadIdx.x;
  const uintptr_t mis = reinterpret_cast<uintptr_t>(dst) |
                        reinterpret_cast<uintptr_t>(src) |
                        static_cast<uintptr_t>(len);
  if ((mis & 15) == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (long long i = tid; i < len / 16; i += A2A_THREADS) d[i] = s[i];
  } else if ((mis & 3) == 0) {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
    for (long long i = tid; i < len / 4; i += A2A_THREADS) d[i] = s[i];
  } else {
    for (long long i = tid; i < len; i += A2A_THREADS) dst[i] = src[i];
  }
}

__global__ void __launch_bounds__(A2A_THREADS)
chunked_a2a_kernel(const int* __restrict__ parity, const int* __restrict__ offs,
                   const int* __restrict__ sendk,
                   const uint8_t* __restrict__ payload,
                   const uint8_t* __restrict__ meta,
                   uint8_t* __restrict__ dst_tok, uint8_t* __restrict__ dst_meta,
                   int a, int chunk_u, int slot_u, int mr, int kmax,
                   long long row_bytes, long long src_rows, int n_windows,
                   int tok_blocks) {
  int par = parity[0];
  par = par < 0 ? 0 : (par >= n_windows ? n_windows - 1 : par);
  const int b = blockIdx.x;
  if (b < tok_blocks) {
    int k = sendk[0];
    k = k < 0 ? 0 : (k > kmax ? kmax : k);
    const long long src0 = static_cast<long long>(offs[0] < 0 ? 0 : offs[0]) * a;
    long long rows = static_cast<long long>(k) * chunk_u * a;
    if (rows > src_rows - src0) rows = src_rows - src0 > 0 ? src_rows - src0 : 0;
    const long long total = rows * row_bytes;
    const long long beg = static_cast<long long>(b) * A2A_PIECE;
    if (beg >= total) return;  // past the shipped chunks
    const long long len = total - beg < A2A_PIECE ? total - beg : A2A_PIECE;
    const long long dst0 = static_cast<long long>(par) * slot_u * a;  // n = 1
    copy_piece(dst_tok + dst0 * row_bytes + beg, payload + src0 * row_bytes + beg,
               len);
  } else {
    const long long total = static_cast<long long>(mr) * 128 * 4;
    const long long beg = static_cast<long long>(b - tok_blocks) * A2A_PIECE;
    if (beg >= total) return;
    const long long len = total - beg < A2A_PIECE ? total - beg : A2A_PIECE;
    copy_piece(dst_meta + static_cast<long long>(par) * total + beg, meta + beg,
               len);
  }
}

}  // namespace

extern "C" {

// One rank's chunked push into window parity[0] of (dst_tok, dst_meta).
// offs in a-row units; row_bytes = hidden * wire itemsize; src_rows =
// payload rows; n_windows = 1 (barrier mode) or 2 (LL workspace).
int tdt_chunked_a2a(const void* parity, const void* offs, const void* sendk,
                    const void* payload, const void* meta, void* dst_tok,
                    void* dst_meta, int n, int a, int chunk_u, int slot_u,
                    int mr, int kmax, int row_bytes, int src_rows,
                    int n_windows, void* stream) {
  cudaGetLastError();
  if (n != 1 || n_windows < 1 || n_windows > 2 || a <= 0 || chunk_u <= 0 ||
      kmax < 0 || row_bytes <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tok_bytes =
      static_cast<long long>(kmax) * chunk_u * a * row_bytes;
  const int tok_blocks = static_cast<int>((tok_bytes + A2A_PIECE - 1) / A2A_PIECE);
  const long long meta_bytes = static_cast<long long>(mr) * 128 * 4;
  const int meta_blocks =
      static_cast<int>((meta_bytes + A2A_PIECE - 1) / A2A_PIECE);
  if (tok_blocks + meta_blocks == 0) return 0;
  chunked_a2a_kernel<<<tok_blocks + meta_blocks, A2A_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(parity), static_cast<const int*>(offs),
      static_cast<const int*>(sendk), static_cast<const uint8_t*>(payload),
      static_cast<const uint8_t*>(meta), static_cast<uint8_t*>(dst_tok),
      static_cast<uint8_t*>(dst_meta), a, chunk_u, slot_u, mr, kmax, row_bytes,
      src_rows, n_windows, tok_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
