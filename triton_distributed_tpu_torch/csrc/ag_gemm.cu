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
// them (PeerRows in ggemm_tiles.cuh). Every rank's A is complete before
// the launch, by stream order on the one device, so no block waits on
// another. The tile rows are rotated so that a rank's first M-tiles are
// its own shard, the ring's step-0 order.
//
// What bounds it on an H100: the tensor cores. At the Llama-2-7B tp = 4
// prefill (A 4 x 2048 x 4096 bf16 rows; B_r 4096 x 3072 for wqkv or
// 4096 x 2752 for up) one launch over the four ranks is 2 * 8192 * 4096
// * N flops (0.83 / 0.75 ms at 989 TFLOP/s) on ~0.3 GB of operands.
//
// Design (right and simple first): the tile loops of ggemm_tiles.cuh
// (bf16 on mma.sync, f32 on FMA) with the PeerRows row source; no
// overlap of the gather with the product, no wgmma, no TMA. The ring's
// overlap needs a persistent grid or the copy engine as producer and
// comes with the push-and-signal redesign.
//
// The quantized wires (tdt_ag_gemm_w, tdt_ag_gemm_mx) replace
// _fused_kernel_w (:266) and _fused_kernel_mx (:309). Their wrapper
// quantizes every rank's shard first (tdt_quantize_slab, wire.cu: codes
// (W, m, K), one f32 scale a chunk of rows), as JAX quantizes on the XLA
// side before its kernels. _w: the tile loops over PeerRowsQ, rank r's
// own shard exact, a peer's rows its codes times the chunk scale rounded
// to A's dtype (the receiver's dequantize), f32 sums. _mx: every slab's
// int8 codes (the own one too, PeerRowsMx) against the per-column int8
// weight, exact s32 sums, epilogue (acc * row scale) * column scale. On
// the loopback mesh no byte crosses
// a link: the card shows what the wire costs and its numerics, not a
// bandwidth gain. At the tp = 4 prefill the _mx product is 2 * 8192 *
// 4096 * N int8 operations (0.42 / 0.37 ms at 1979 TOP/s for wqkv / up).
// Its loop, s8_mma_kernel below, is the bf16 loop's shape on int8:
// 64 x 128 tiles, four warps of 32 x 64, mma.sync m16n8k32 s8 -> s32 fed
// by ldmatrix, K steps of 64 bytes loaded into registers while the
// current one multiplies. An s8 fragment along k is byte for byte a bf16
// one, so A's ldmatrix is the bf16 loop's; B's cannot be transposed by
// ldmatrix (it moves 16-bit words), so the wrapper hands B over
// transposed, (N, K) a rank, and both tiles load k-contiguous rows.

#include "ggemm_tiles.cuh"

namespace {

// int8-mxu rows: every row of the gathered A is wire codes (int8; the
// rank's own shard quantized too, q: (W, m, K)) with its chunk's scale
// (s: (W, m / chunk_rows)); rank r = rank0 + blockIdx.z multiplies its
// per-column quantized weight (wt: (W, N, K) int8, transposed; ws: (W,
// N) f32) into out_r, rows rotated as in PeerRows.
struct PeerRowsMx {
  struct Ref {
    const int8_t* p;  // the row's codes; nullptr past the rows
    float s;
  };
  const int8_t* __restrict__ q;
  const float* __restrict__ s;
  const unsigned long long* __restrict__ out_peers;
  int m, world, rank0, chunk_rows;
  __device__ __forceinline__ int rank() const { return rank0 + blockIdx.z; }
  __device__ __forceinline__ int orow(int t) const {
    return (t + rank() * m) % (world * m);
  }
  __device__ __forceinline__ Ref at(int t, int K) const {
    if (t >= world * m) return Ref{nullptr, 0.f};
    const int g = orow(t), src = g / m, i = g % m;
    return Ref{q + (static_cast<size_t>(src) * m + i) * K,
               s[static_cast<size_t>(src) * (m / chunk_rows) +
                 i / chunk_rows]};
  }
};

constexpr int QBK = 64;         // K bytes a stage
constexpr int QPAD = QBK + 16;  // 80-byte rows: 16-byte aligned, and the
                                // ldmatrix rows conflict-free

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes of a row from byte col, zero past ncols or on no row; one
// 16-byte load when it is inside and the rows are 16-byte aligned
__device__ __forceinline__ uint4 load16b(const int8_t* row, int col,
                                         int ncols, bool vec) {
  union {
    uint4 u;
    int8_t b[16];
  } t;
  t.u = make_uint4(0, 0, 0, 0);
  if (row == nullptr) return t.u;
  const int8_t* p = row + col;
  if (vec && col + 16 <= ncols) return *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (col + i < ncols) t.b[i] = p[i];
  return t.u;
}

// out_r (M = W * m, N) = codes (M, K) @ wt_r^T, s32 sums, epilogue
// (acc * row scale) * column scale; vec: K % 16 == 0 (16-byte rows)
template <typename OutT>
__global__ void __launch_bounds__(TC_THREADS)
s8_mma_kernel(const int8_t* __restrict__ wt, const float* __restrict__ ws,
              int M, int K, int N, bool vec, PeerRowsMx rows) {
  __shared__ __align__(16) int8_t As[2][TBM][QPAD];
  __shared__ __align__(16) int8_t Bs[2][TBN][QPAD];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
  const int m0 = blockIdx.y * TBM, n0 = blockIdx.x * TBN;
  const int r = rows.rank();
  const int8_t* __restrict__ wr = wt + static_cast<size_t>(r) * N * K;
  // the two A rows this thread loads (rows idx >> 2 of gload below)
  const PeerRowsMx::Ref a_ref[2] = {rows.at(m0 + (tid >> 2), K),
                                    rows.at(m0 + ((tid + TC_THREADS) >> 2), K)};

  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0;

  uint4 ra[2], rb[4];
  auto gload = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // A: 64 rows x 4 vectors
      const int c = ((tid + i * TC_THREADS) & 3) * 16;
      ra[i] = load16b(a_ref[i].p, k0 + c, K, vec);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // B^T: 128 rows (n) x 4 vectors
      const int idx = tid + i * TC_THREADS, n = n0 + (idx >> 2);
      rb[i] = load16b(n < N ? wr + static_cast<size_t>(n) * K : nullptr,
                      k0 + (idx & 3) * 16, K, vec);
    }
  };
  auto sstore = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * TC_THREADS;
      *reinterpret_cast<uint4*>(&As[buf][idx >> 2][(idx & 3) * 16]) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * TC_THREADS;
      *reinterpret_cast<uint4*>(&Bs[buf][idx >> 2][(idx & 3) * 16]) = rb[i];
    }
  };

  const int nk = (K + QBK - 1) / QBK;
  gload(0);
  sstore(0);
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const int buf = t & 1;
    if (t + 1 < nk) gload((t + 1) * QBK);  // in flight during the mma
#pragma unroll
    for (int kk = 0; kk < QBK; kk += 32) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(af[mi], &As[buf][wm + mi * 16 + (lane & 15)]
                           [kk + (lane >> 4) * 16]);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        // x4 over 16 (n) x 32 (k) bytes: registers 0/1 are the k 0-15 /
        // 16-31 halves of n-tile 2nj, registers 2/3 of 2nj + 1
        uint32_t bf[4];
        ldsm_x4(bf, &Bs[buf][wn + nj * 16 + (lane & 7) + ((lane >> 4) << 3)]
                           [kk + ((lane >> 3) & 1) * 16]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_s8(acc[mi][2 * nj], af[mi], bf[0], bf[1]);
          mma_s8(acc[mi][2 * nj + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
    if (t + 1 < nk) sstore(buf ^ 1);
    __syncthreads();
  }

  OutT* __restrict__ out = reinterpret_cast<OutT*>(rows.out_peers[r]);
  const float* __restrict__ wsr = ws + static_cast<size_t>(r) * N;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + mi * 16 + (lane >> 2) + h * 8;
      if (m >= M) continue;
      const float sx = rows.at(m, K).s;
      const size_t orow = static_cast<size_t>(rows.orow(m)) * N;
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + nj * 8 + (lane & 3) * 2 + e;
          if (n >= N) continue;
          // (acc * row scale) * column scale, the order of the TPU
          // epilogue
          float v = static_cast<float>(acc[mi][nj][h * 2 + e]) * sx;
          v = v * wsr[n];
          out[orow + n] = tdt_from_f<OutT>(v);
        }
    }
}

}  // namespace

extern "C" {

// a_peers: (world,) pointers to the row shards A_q (m, K); w_peers /
// out_peers: (world,) pointers to B_r (K, N) and out_r (world * m, N).
// zero: one int32 0 (the one expert of the tile loops). Writes out_r
// for r in [rank0, rank0 + nranks). x_dtype TDT_BF16 or
// TDT_F32 (B alike), out_dtype TDT_BF16 or TDT_F32; aligned: every A
// and B shard starts on a 16-byte boundary.
int tdt_ag_gemm(const void* a_peers, const void* w_peers,
                const void* out_peers, const void* zero, int m, int K,
                int N, int world, int rank0, int nranks, int x_dtype,
                int out_dtype, int aligned, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (m <= 0 || N <= 0 || nranks <= 0) return 0;
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
// TDT_WIRE_INT8; the rest as for tdt_ag_gemm.
int tdt_ag_gemm_w(const void* a_peers, const void* q, const void* s,
                  const void* w_peers, const void* out_peers,
                  const void* zero, int m, int K, int N, int world,
                  int rank0, int nranks, int chunk_rows, int quant,
                  int x_dtype, int out_dtype, int aligned, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (m <= 0 || N <= 0 || nranks <= 0) return 0;
  if (chunk_rows <= 0 || m % chunk_rows ||
      (quant != TDT_WIRE_FP8 && quant != TDT_WIRE_INT8))
    return static_cast<int>(cudaErrorInvalidValue);
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
  dim3 grid((N + TBN - 1) / TBN, (M + TBM - 1) / TBM, nranks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* w = static_cast<const int8_t*>(wt);
  const float* wsf = static_cast<const float*>(ws);
  const bool vec = K % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) |
                     reinterpret_cast<uintptr_t>(wt)) & 15) == 0;
  if (out_dtype == TDT_BF16)
    s8_mma_kernel<__nv_bfloat16><<<grid, TC_THREADS, 0, st>>>(
        w, wsf, M, K, N, vec, rows);
  else if (out_dtype == TDT_F32)
    s8_mma_kernel<float><<<grid, TC_THREADS, 0, st>>>(w, wsf, M, K, N, vec,
                                                      rows);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
