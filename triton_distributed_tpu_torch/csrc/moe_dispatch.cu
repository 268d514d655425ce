// Count-bounded chunked MoE all-to-all, over the n ranks of a mesh.
//
// Replaces triton_distributed_tpu/kernels/moe_dispatch.py:346
// (_chunked_a2a_kernel). There rank `me` pushes sendk[p] chunks of
// chunk_u*a rows from payload row (offs[p] + c*chunk_u)*a to receive row
// (par*n*slot_u + me*slot_u + c*chunk_u)*a of peer p, plus its
// mr x 128 int32 metadata block into meta block par*n + me, and each
// receiver waits for the chunk count it learns from the landed meta head
// (dispatch) or already knows (combine: recvk, what it dispatched). A
// fresh receive pair in barrier mode (one window, par = 0), or window par
// of the persistent double-buffered workspace in LL mode (written in
// place; the TPU's aliased input -> output). Rows past the shipped chunks
// are left as they were.
//
// On the card the push becomes a pull: one launch covers every rank of
// the loopback mesh, block (x, p, r) copying piece x of sender p's
// segment for receiver r (blockIdx.y the sender, blockIdx.z the
// receiver). Receiver r's slot p takes k chunks from sender p's segment
// offs_p[r]: k = sendk_r[r] for its own slot, else the count in p's meta
// block for r (dispatch; the same word the TPU reads from the landed
// head) or recvk_r[p] (combine). Every sender's payload and metadata are
// complete before the launch, by stream order on the one device, so
// there is no semaphore, no barrier and no wait. The ranks' data
// pointers (the peer table of each operand) travel by value in the
// launch's parameters: nothing is copied to the device for them, and a
// CUDA graph captures them with the launch.
//
// What bounds it on an H100: bytes. At the serving step's shapes
// (4608 assignments of 2048 fp8 bytes, 64-row chunks, one rank) it moves
// up to 9.4 MB of rows and 20 KB of metadata, read once and written once;
// at the tp = 4 decode a few hundred KB.
//
// Design: the chunks of one (sender, receiver) pair are contiguous in
// the source and in the window, so the copy is one byte range whose
// length is read from device memory, never from the host: no
// synchronisation per call. The grid is sized from the static maximum
// (n_chunks_max chunks); each block copies one 16 KB piece as 16-byte
// vectors and exits at once when its piece starts past the shipped
// chunks. The last blocks copy the metadata block. parity, offs and the
// counts are clamped to the window count, to >= 0 and to n_chunks_max,
// and the range to the payload's rows, so corrupt counts cannot address
// outside the buffers.

#include "tdt_common.cuh"

namespace {

constexpr int A2A_THREADS = 256;
constexpr long long A2A_PIECE = 16384;  // bytes per block
constexpr int A2A_MAX_RANKS = 8;

// The peer tables of the transport's seven per-rank operands, by value:
// sender side payload, meta, offs, sendk; receiver side recvk, dst_tok,
// dst_meta.
struct A2APeers {
  unsigned long long payload[A2A_MAX_RANKS];
  unsigned long long meta[A2A_MAX_RANKS];
  unsigned long long offs[A2A_MAX_RANKS];
  unsigned long long sendk[A2A_MAX_RANKS];
  unsigned long long recvk[A2A_MAX_RANKS];
  unsigned long long dst_tok[A2A_MAX_RANKS];
  unsigned long long dst_meta[A2A_MAX_RANKS];
};
constexpr int A2A_TABLES = 7;

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

template <typename T>
__device__ __forceinline__ const T* peer(unsigned long long p) {
  return reinterpret_cast<const T*>(p);
}

__global__ void __launch_bounds__(A2A_THREADS)
chunked_a2a_kernel(A2APeers P, const int* __restrict__ parity, int n, int a,
                   int chunk_u, int slot_u, int mr, int kmax, int nck_row,
                   int nck_lane, long long row_bytes, long long src_rows,
                   int n_windows, int tok_blocks, int know_recv, int rank0) {
  int par = parity[0];
  par = par < 0 ? 0 : (par >= n_windows ? n_windows - 1 : par);
  const int p = blockIdx.y;           // sender, and the receiver's slot
  const int r = rank0 + blockIdx.z;   // receiver
  const int b = blockIdx.x;
  const long long meta_bytes = static_cast<long long>(mr) * 128 * 4;
  const uint8_t* __restrict__ meta_pr = peer<uint8_t>(P.meta[p]) + r * meta_bytes;
  const long long slot = static_cast<long long>(par) * n + p;
  if (b < tok_blocks) {
    int k;
    if (p == r)
      k = peer<int>(P.sendk[p])[r];
    else if (know_recv)
      k = peer<int>(P.recvk[r])[p];
    else
      k = reinterpret_cast<const int*>(meta_pr)[nck_row * 128 + nck_lane];
    k = k < 0 ? 0 : (k > kmax ? kmax : k);
    const int o = peer<int>(P.offs[p])[r];
    const long long src0 = static_cast<long long>(o < 0 ? 0 : o) * a;
    long long rows = static_cast<long long>(k) * chunk_u * a;
    if (rows > src_rows - src0) rows = src_rows - src0 > 0 ? src_rows - src0 : 0;
    const long long total = rows * row_bytes;
    const long long beg = static_cast<long long>(b) * A2A_PIECE;
    if (beg >= total) return;  // past the shipped chunks
    const long long len = total - beg < A2A_PIECE ? total - beg : A2A_PIECE;
    const long long dst0 = slot * slot_u * a;
    copy_piece(reinterpret_cast<uint8_t*>(P.dst_tok[r]) + dst0 * row_bytes + beg,
               peer<uint8_t>(P.payload[p]) + src0 * row_bytes + beg, len);
  } else {
    const long long beg = static_cast<long long>(b - tok_blocks) * A2A_PIECE;
    if (beg >= meta_bytes) return;
    const long long len =
        meta_bytes - beg < A2A_PIECE ? meta_bytes - beg : A2A_PIECE;
    copy_piece(reinterpret_cast<uint8_t*>(P.dst_meta[r]) + slot * meta_bytes +
                   beg,
               meta_pr + beg, len);
  }
}

}  // namespace

extern "C" {

// The chunked all-to-all of n ranks in one launch. tables: 7 * n host
// pointers, table by table (payload, meta, offs, sendk, recvk, dst_tok,
// dst_meta; see A2APeers), each rank's data pointer of the operand:
// payload (src_rows, hidden) wire rows, meta (n * mr, 128) int32, offs /
// sendk / recvk (n,) int32 (offs in a-row units), dst_tok (n_windows * n
// * slot_u * a, hidden), dst_meta (n_windows * n * mr, 128). parity: one
// int32 on the device, shared by the ranks. row_bytes = hidden * wire
// itemsize; n_windows = 1 (barrier mode) or 2 (LL workspace); know_recv:
// the combine leg (counts from recvk) rather than the dispatch leg
// (counts from the senders' meta heads at (nck_row, nck_lane)).
int tdt_chunked_a2a(const unsigned long long* tables, const void* parity,
                    int n, int a, int chunk_u, int slot_u, int mr, int kmax,
                    int nck_row, int nck_lane, int row_bytes, int src_rows,
                    int n_windows, int know_recv, void* stream) {
  cudaGetLastError();
  if (n < 1 || n > A2A_MAX_RANKS || n_windows < 1 || n_windows > 2 || a <= 0 ||
      chunk_u <= 0 || kmax < 0 || row_bytes <= 0 || mr <= 0 || nck_lane < 0 ||
      nck_lane >= 128 || nck_row < 0 || nck_row >= mr)
    return static_cast<int>(cudaErrorInvalidValue);
  A2APeers P{};
  unsigned long long* dst[A2A_TABLES] = {P.payload, P.meta,    P.offs,
                                         P.sendk,   P.recvk,   P.dst_tok,
                                         P.dst_meta};
  for (int t = 0; t < A2A_TABLES; ++t)
    for (int q = 0; q < n; ++q) dst[t][q] = tables[t * n + q];
  const long long tok_bytes =
      static_cast<long long>(kmax) * chunk_u * a * row_bytes;
  const int tok_blocks = static_cast<int>((tok_bytes + A2A_PIECE - 1) / A2A_PIECE);
  const long long meta_bytes = static_cast<long long>(mr) * 128 * 4;
  const int meta_blocks =
      static_cast<int>((meta_bytes + A2A_PIECE - 1) / A2A_PIECE);
  if (tok_blocks + meta_blocks == 0) return 0;
  dim3 grid(tok_blocks + meta_blocks, n, n);
  chunked_a2a_kernel<<<grid, A2A_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      P, static_cast<const int*>(parity), n, a, chunk_u, slot_u, mr, kmax,
      nck_row, nck_lane, row_bytes, src_rows, n_windows, tok_blocks,
      know_recv, 0);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
