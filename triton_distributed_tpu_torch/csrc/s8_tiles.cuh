// The s8 x s8 -> s32 tile loop of the int8-mxu wires, shared by
// ag_gemm.cu (tdt_ag_gemm_mx) and moe_tp_fused.cu (tdt_ag_group_gemm_mx).
//
// out (M, N) = codes (M, K) @ B^T, s32 sums, then an f32 epilogue with the
// row's wire scale and the column's weight scale. The loop is the bf16
// loop's shape on int8: 64 x 128 tiles, four warps of 32 x 64,
// mma.sync m16n8k32 s8 -> s32 fed by ldmatrix, K steps of 64 bytes loaded
// into registers while the current one multiplies. An s8 fragment along k
// is byte for byte a bf16 one, so A's ldmatrix is the bf16 loop's; B's
// cannot be transposed by ldmatrix (it moves 16-bit words), so the
// wrappers hand B over transposed, (N, K), and both tiles load
// k-contiguous rows.
//
// A row source (compile-time trait) says where the codes live:
//   at(t, K)        the codes of tile row t and its wire scale (nullptr
//                   past the rows: a row of zeros);
//   orow(t)         the output row t is stored to;
//   expert(be, m0, block_m), b_codes(wt, e, N, K), b_scales(ws, e, N)
//                   the tile's B (N, K) codes and its (N,) column scales;
//   out_base<T>()   the rank's output;
//   epilogue(acc, row scale, column scale) in f32.
// PeerRowsMx (the dense AG-GEMM's gathered, rotated rows, one weight a
// rank) and PeerSortedMx (the MoE AG + grouped GEMM's sorted slabs, one
// weight an expert) are the two.
#pragma once

#include "ggemm_tiles.cuh"

namespace {

// int8-mxu rows of the dense AG-GEMM: every row of the gathered A is wire
// codes (int8; the rank's own shard quantized too, q: (W, m, K)) with its
// chunk's scale (s: (W, m / chunk_rows)); rank r = rank0 + blockIdx.z
// multiplies its per-column quantized weight (wt: (W, N, K) int8,
// transposed; ws: (W, N) f32) into out_r, rows rotated as in PeerRows.
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
  __device__ __forceinline__ int expert(const int*, int, int) const {
    return 0;
  }
  __device__ __forceinline__ const int8_t* b_codes(const int8_t* wt, int,
                                                   int N, int K) const {
    return wt + static_cast<size_t>(rank()) * N * K;
  }
  __device__ __forceinline__ const float* b_scales(const float* ws, int,
                                                   int N) const {
    return ws + static_cast<size_t>(rank()) * N;
  }
  template <typename T>
  __device__ __forceinline__ T* out_base() const {
    return reinterpret_cast<T*>(out_peers[rank()]);
  }
  // (acc * row scale) * column scale, the order of the dense TPU epilogue
  __device__ __forceinline__ static float epilogue(int acc, float sx,
                                                   float sw) {
    return __fmul_rn(__fmul_rn(static_cast<float>(acc), sx), sw);
  }
};

// int8-mxu rows of the MoE AG + grouped GEMM: row t = s * cap_s + i of
// rank r's output is sorted row i of shard s, its codes q (W, cap_s, K)
// (every shard's materialized sorted slab quantized, the own one too;
// padding rows are codes 0) with the scale of its chunk of chunk_rows
// rows (s: (W, cap_s / chunk_rows), one a routing block), not rotated;
// rank r multiplies expert be[t / block_m] of its per-(expert, column)
// quantized weight (wt: (W, E, N, K) int8, transposed; ws: (W, E, N)).
struct PeerSortedMx {
  struct Ref {
    const int8_t* p;
    float s;
  };
  const int8_t* __restrict__ q;
  const float* __restrict__ s;
  const unsigned long long* __restrict__ out_peers;
  int m, world, rank0, chunk_rows, experts;  // m: cap_s
  __device__ __forceinline__ int rank() const { return rank0 + blockIdx.z; }
  __device__ __forceinline__ int orow(int t) const { return t; }
  __device__ __forceinline__ Ref at(int t, int K) const {
    if (t >= world * m) return Ref{nullptr, 0.f};
    return Ref{q + static_cast<size_t>(t) * K, s[t / chunk_rows]};
  }
  __device__ __forceinline__ int expert(const int* be, int m0,
                                        int block_m) const {
    return be[m0 / block_m];
  }
  __device__ __forceinline__ const int8_t* b_codes(const int8_t* wt, int e,
                                                   int N, int K) const {
    return wt + (static_cast<size_t>(rank()) * experts + e) * N * K;
  }
  __device__ __forceinline__ const float* b_scales(const float* ws, int e,
                                                   int N) const {
    return ws + (static_cast<size_t>(rank()) * experts + e) * N;
  }
  template <typename T>
  __device__ __forceinline__ T* out_base() const {
    return reinterpret_cast<T*>(out_peers[rank()]);
  }
  // acc * (row scale * column scale): the scale product first, as the
  // TPU's grouped epilogue (gmm_q8_pipeline) computes it
  __device__ __forceinline__ static float epilogue(int acc, float sx,
                                                   float sw) {
    return __fmul_rn(static_cast<float>(acc), __fmul_rn(sx, sw));
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

// out (M, N) = codes (M, K) @ B^T for rank rows.rank(), B the tile's
// expert's; with more than one M-block, block_m is a multiple of 64, so a
// tile never straddles two experts. vec: K % 16 == 0 and 16-byte aligned
// codes (16-byte rows).
template <typename OutT, typename Rows>
__global__ void __launch_bounds__(TC_THREADS)
s8_mma_kernel(const int8_t* __restrict__ wt, const float* __restrict__ ws,
              const int* __restrict__ block_expert, int M, int K, int N,
              int block_m, bool vec, Rows rows) {
  __shared__ __align__(16) int8_t As[2][TBM][QPAD];
  __shared__ __align__(16) int8_t Bs[2][TBN][QPAD];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
  const int m0 = blockIdx.y * TBM, n0 = blockIdx.x * TBN;
  const int e = rows.expert(block_expert, m0, block_m);
  const int8_t* __restrict__ wr = rows.b_codes(wt, e, N, K);
  // the two A rows this thread loads (rows idx >> 2 of gload below)
  const typename Rows::Ref a_ref[2] = {
      rows.at(m0 + (tid >> 2), K), rows.at(m0 + ((tid + TC_THREADS) >> 2), K)};

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

  OutT* __restrict__ out = rows.template out_base<OutT>();
  const float* __restrict__ wsr = rows.b_scales(ws, e, N);
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
        for (int e2 = 0; e2 < 2; ++e2) {
          const int n = n0 + wn + nj * 8 + (lane & 3) * 2 + e2;
          if (n >= N) continue;
          out[orow + n] = tdt_from_f<OutT>(
              Rows::epilogue(acc[mi][nj][h * 2 + e2], sx, wsr[n]));
        }
    }
}

// s8_mma_kernel over nz ranks (blockIdx.z) into out_dtype TDT_BF16 or
// TDT_F32; returns the launch's cudaGetLastError()
template <typename Rows>
int launch_s8_mma(const int8_t* wt, const float* ws, const int* be, int M,
                  int K, int N, int block_m, bool vec, int out_dtype,
                  cudaStream_t st, Rows rows, int nz) {
  dim3 grid((N + TBN - 1) / TBN, (M + TBM - 1) / TBM, nz);
  if (out_dtype == TDT_BF16)
    s8_mma_kernel<__nv_bfloat16, Rows><<<grid, TC_THREADS, 0, st>>>(
        wt, ws, be, M, K, N, block_m, vec, rows);
  else if (out_dtype == TDT_F32)
    s8_mma_kernel<float, Rows><<<grid, TC_THREADS, 0, st>>>(
        wt, ws, be, M, K, N, block_m, vec, rows);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
