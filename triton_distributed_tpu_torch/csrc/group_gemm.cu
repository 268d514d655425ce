// Grouped GEMM: W8A8 (s8 x s8 -> s32), W8A16, and the float mode.
//
// Replaces triton_distributed_tpu/kernels/group_gemm.py:
//   * _ggemm_q8a_kernel (:74): x (M, K) int8 with per-row f32 scales
//     x_scale (M,), w (E, K, N) int8 with per-(expert, out-channel) f32
//     scales w_scale (E, N); s32 accumulator, epilogue
//     acc * x_scale[m] * w_scale[e, n] cast to the output type.
//   * _ggemm_q_kernel (:50): x (M, K) bf16 or f32, w int8 widened per
//     tile, f32 accumulator, epilogue acc * w_scale[e, n].
//   * _ggemm_kernel (:32): x and w both bf16 or both f32, f32
//     accumulator stored to the output type (the bf16 MoE experts).
// The M dim is cut into blocks of block_m rows; block b multiplies the
// weight of expert block_expert[b] (E = 1 with one block for the dense
// projections of the serving step, E = 64 for the MoE experts).
//
// What bounds it on an H100: at the serving step's shapes (M = 768
// packed tokens, K = 4096/11008, N up to 12288) the W8A8 products do
// ~100 operations per weight byte and are bound by integer math; the
// lm_head W8A16 product (M = 16 slots, N = 32000) reads 131 MB of
// weights for 4 GFLOP and is bound by device memory. The MoE expert
// GEMMs (8704 sorted rows, 64 experts of 2048 x 1408) do ~50 GFLOP
// each on 0.4 GB of bf16 weights: bound by the tensor cores.
//
// Design (right and simple first): 64 x 64 output tiles, 256 threads
// with a 4 x 4 micro-tile each, the K loop staged through shared
// memory. W8A8 packs four consecutive k of a weight column into one
// 32-bit word while it stages the tile (the weight is (K, N) with N
// contiguous) and accumulates with __dp4a, exactly, in int32; W8A16
// and the f32 mode widen both operands to f32 in shared memory and use
// FMAs. Rows padded by 1 word keep the shared-memory reads free of bank
// conflicts. The bf16 mode runs on the tensor cores instead: 64 x 128
// tiles, four warps of 32 x 64, mma.sync m16n8k16 (bf16 in, f32 sums)
// fed by ldmatrix (.trans for the (K, N) weight), the next K step
// loaded into registers while the current one multiplies (two shared
// buffers, one barrier per step). All mask the ragged M, N and K edges
// themselves; with more than one M-block, block_m is a multiple of 64,
// so a tile never straddles two experts. wgmma and TMA staging are
// later work.

#include "tdt_common.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

// ---------------------------------------------------------------- W8A8
constexpr int BK8 = 64;       // K bytes staged per step
constexpr int KQ = BK8 / 4;   // packed 32-bit words per row and step

__device__ __forceinline__ int pack_x(const int8_t* __restrict__ row, int k,
                                      int K) {
  if (k + 3 < K && ((reinterpret_cast<uintptr_t>(row + k) & 3) == 0))
    return *reinterpret_cast<const int*>(row + k);
  int v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (k + b < K) v |= static_cast<int>(static_cast<uint8_t>(row[k + b])) << (8 * b);
  return v;
}

template <typename OutT>
__global__ void __launch_bounds__(THREADS)
w8a8_kernel(const int8_t* __restrict__ x, const float* __restrict__ xs,
            const int8_t* __restrict__ w, const float* __restrict__ ws,
            const int* __restrict__ block_expert, OutT* __restrict__ out,
            int M, int K, int N, int block_m) {
  __shared__ int As[BM][KQ + 1];
  __shared__ int Bs[BN][KQ + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int e = block_expert[m0 / block_m];
  const int8_t* __restrict__ we = w + static_cast<size_t>(e) * K * N;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK8) {
    for (int idx = tid; idx < BM * KQ; idx += THREADS) {
      const int r = idx / KQ, c = idx % KQ;
      const int m = m0 + r;
      As[r][c] = m < M ? pack_x(x + static_cast<size_t>(m) * K, k0 + 4 * c, K) : 0;
    }
    for (int idx = tid; idx < KQ * BN; idx += THREADS) {
      const int c = idx / BN, n = idx % BN;  // n fastest: coalesced bytes
      const int k = k0 + 4 * c, nn = n0 + n;
      int v = 0;
      if (nn < N) {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (k + b < K)
            v |= static_cast<int>(static_cast<uint8_t>(
                     we[static_cast<size_t>(k + b) * N + nn])) << (8 * b);
      }
      Bs[n][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < KQ; ++c) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[ty + 16 * i][c];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[tx + 16 * j][c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const float sx = xs[m];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      // (acc * x_scale) * w_scale, the order of the TPU epilogue
      float v = static_cast<float>(acc[i][j]) * sx;
      v = v * ws[static_cast<size_t>(e) * N + n];
      out[static_cast<size_t>(m) * N + n] = tdt_from_f<OutT>(v);
    }
  }
}

// ------------------------------------------------------ W8A16 and f32
constexpr int BK = 32;

// ws == nullptr: unscaled weights (the f32 mode)
template <typename XT, typename WT, typename OutT>
__global__ void __launch_bounds__(THREADS)
fma_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
           const float* __restrict__ ws, const int* __restrict__ block_expert,
           OutT* __restrict__ out, int M, int K, int N, int block_m) {
  __shared__ float As[BM][BK + 1];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int e = block_expert[m0 / block_m];
  const WT* __restrict__ we = w + static_cast<size_t>(e) * K * N;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += THREADS) {
      const int r = idx / BK, c = idx % BK;
      const int m = m0 + r, k = k0 + c;
      As[r][c] = (m < M && k < K) ? tdt_to_f<XT>(x[static_cast<size_t>(m) * K + k]) : 0.f;
    }
    for (int idx = tid; idx < BK * BN; idx += THREADS) {
      const int c = idx / BN, n = idx % BN;
      const int k = k0 + c, nn = n0 + n;
      Bs[c][n] = (k < K && nn < N)
                     ? tdt_to_f<WT>(we[static_cast<size_t>(k) * N + nn])
                     : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[ty + 16 * i][k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      const float v = ws ? acc[i][j] * ws[static_cast<size_t>(e) * N + n]
                         : acc[i][j];
      out[static_cast<size_t>(m) * N + n] = tdt_from_f<OutT>(v);
    }
  }
}

// ---------------------------------------------------- bf16 tensor cores
constexpr int TBM = 64, TBN = 128, TBK = 32;
constexpr int TC_THREADS = 128;  // 4 warps as 2 x 2, 32 x 64 outputs each
constexpr int APAD = TBK + 8;    // 80-byte rows: 16-byte aligned, and the
constexpr int BPAD = TBN + 8;    // 272-byte rows: ldmatrix conflict-free

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 8 consecutive bf16 (as raw 16-bit words) of row `row_off` from column
// col, zero past ncols or on an invalid row; one 16-byte load when the
// whole vector is inside and the rows are 16-byte aligned
__device__ __forceinline__ uint4 load8(const unsigned short* __restrict__ base,
                                       size_t row_off, int col, int ncols,
                                       bool row_ok, bool vec) {
  union {
    uint4 u;
    unsigned short h[8];
  } t;
  t.u = make_uint4(0, 0, 0, 0);
  if (!row_ok) return t.u;
  const unsigned short* p = base + row_off + col;
  if (vec && col + 8 <= ncols) return *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (col + i < ncols) t.h[i] = p[i];
  return t.u;
}

template <typename OutT>
__global__ void __launch_bounds__(TC_THREADS)
bf16_mma_kernel(const unsigned short* __restrict__ x,
                const unsigned short* __restrict__ w,
                const int* __restrict__ block_expert, OutT* __restrict__ out,
                int M, int K, int N, int block_m, bool vec_a, bool vec_b) {
  __shared__ __align__(16) unsigned short As[2][TBM][APAD];
  __shared__ __align__(16) unsigned short Bs[2][TBK][BPAD];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
  const int m0 = blockIdx.y * TBM, n0 = blockIdx.x * TBN;
  const int e = block_expert[m0 / block_m];
  const unsigned short* __restrict__ we = w + static_cast<size_t>(e) * K * N;

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  uint4 ra[2], rb[4];
  auto gload = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // A: 64 rows x 4 vectors
      const int idx = tid + i * TC_THREADS, r = idx >> 2, c = (idx & 3) * 8;
      const int m = m0 + r;
      ra[i] = load8(x, static_cast<size_t>(m) * K, k0 + c, K, m < M, vec_a);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // B: 32 rows x 16 vectors
      const int idx = tid + i * TC_THREADS, r = idx >> 4, c = (idx & 15) * 8;
      const int k = k0 + r;
      rb[i] = load8(we, static_cast<size_t>(k) * N, n0 + c, N, k < K, vec_b);
    }
  };
  auto sstore = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * TC_THREADS;
      *reinterpret_cast<uint4*>(&As[buf][idx >> 2][(idx & 3) * 8]) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * TC_THREADS;
      *reinterpret_cast<uint4*>(&Bs[buf][idx >> 4][(idx & 15) * 8]) = rb[i];
    }
  };

  const int nk = (K + TBK - 1) / TBK;
  gload(0);
  sstore(0);
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const int buf = t & 1;
    if (t + 1 < nk) gload((t + 1) * TBK);  // in flight during the mma
#pragma unroll
    for (int kk = 0; kk < TBK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(af[mi], &As[buf][wm + mi * 16 + (lane & 15)][kk + (lane >> 4) * 8]);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        // x4.trans over a 16 (k) x 16 (n) block: registers 0/1 are the
        // k 0-7 / 8-15 halves of n-tile 2nj, registers 2/3 of 2nj + 1
        uint32_t bf[4];
        ldsm_x4_t(bf, &Bs[buf][kk + (lane & 15)][wn + nj * 16 + (lane >> 4) * 8]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * nj], af[mi], bf[0], bf[1]);
          mma_bf16(acc[mi][2 * nj + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
    if (t + 1 < nk) sstore(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) {
      const int r = m0 + wm + mi * 16 + (lane >> 2);
      const int c = n0 + wn + nj * 8 + (lane & 3) * 2;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int m = r + (v >> 1) * 8, n = c + (v & 1);
        if (m < M && n < N)
          out[static_cast<size_t>(m) * N + n] = tdt_from_f<OutT>(acc[mi][nj][v]);
      }
    }
}

}  // namespace

extern "C" {

const char* tdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out_dtype: TDT_F32 or TDT_BF16
int tdt_ggemm_w8a8(const void* x, const void* x_scale, const void* w,
                   const void* w_scale, const void* block_expert, void* out,
                   int M, int K, int N, int block_m, int out_dtype,
                   void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (M <= 0 || N <= 0) return 0;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xq = static_cast<const int8_t*>(x);
  const float* xs = static_cast<const float*>(x_scale);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* wsp = static_cast<const float*>(w_scale);
  const int* be = static_cast<const int*>(block_expert);
  if (out_dtype == TDT_BF16)
    w8a8_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        xq, xs, wq, wsp, be, static_cast<__nv_bfloat16*>(out), M, K, N, block_m);
  else if (out_dtype == TDT_F32)
    w8a8_kernel<float><<<grid, THREADS, 0, s>>>(
        xq, xs, wq, wsp, be, static_cast<float*>(out), M, K, N, block_m);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// x_dtype, out_dtype: TDT_F32 or TDT_BF16
int tdt_ggemm_w8a16(const void* x, const void* w, const void* w_scale,
                    const void* block_expert, void* out, int M, int K, int N,
                    int block_m, int x_dtype, int out_dtype, void* stream) {
  cudaGetLastError();
  if (M <= 0 || N <= 0) return 0;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* wsp = static_cast<const float*>(w_scale);
  const int* be = static_cast<const int*>(block_expert);
#define TDT_W8A16(XT, OT)                                                   \
  fma_kernel<XT, int8_t, OT><<<grid, THREADS, 0, s>>>(                      \
      static_cast<const XT*>(x), wq, wsp, be, static_cast<OT*>(out), M, K, N, \
      block_m)
  if (x_dtype == TDT_BF16 && out_dtype == TDT_BF16) TDT_W8A16(__nv_bfloat16, __nv_bfloat16);
  else if (x_dtype == TDT_BF16 && out_dtype == TDT_F32) TDT_W8A16(__nv_bfloat16, float);
  else if (x_dtype == TDT_F32 && out_dtype == TDT_BF16) TDT_W8A16(float, __nv_bfloat16);
  else if (x_dtype == TDT_F32 && out_dtype == TDT_F32) TDT_W8A16(float, float);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef TDT_W8A16
  return static_cast<int>(cudaGetLastError());
}

// The float mode: x and w both TDT_BF16 (tensor cores) or both TDT_F32
// (FMA); out_dtype TDT_F32 or TDT_BF16.
int tdt_ggemm_f(const void* x, const void* w, const void* block_expert,
                void* out, int M, int K, int N, int block_m, int x_dtype,
                int out_dtype, void* stream) {
  cudaGetLastError();
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* be = static_cast<const int*>(block_expert);
  if (x_dtype == TDT_BF16) {
    dim3 grid((N + TBN - 1) / TBN, (M + TBM - 1) / TBM);
    const unsigned short* xb = static_cast<const unsigned short*>(x);
    const unsigned short* wb = static_cast<const unsigned short*>(w);
    const bool vec_a = K % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    const bool vec_b = N % 8 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
    if (out_dtype == TDT_BF16)
      bf16_mma_kernel<__nv_bfloat16><<<grid, TC_THREADS, 0, s>>>(
          xb, wb, be, static_cast<__nv_bfloat16*>(out), M, K, N, block_m,
          vec_a, vec_b);
    else if (out_dtype == TDT_F32)
      bf16_mma_kernel<float><<<grid, TC_THREADS, 0, s>>>(
          xb, wb, be, static_cast<float*>(out), M, K, N, block_m, vec_a, vec_b);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (x_dtype == TDT_F32) {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(w);
    if (out_dtype == TDT_F32)
      fma_kernel<float, float, float><<<grid, THREADS, 0, s>>>(
          xf, wf, nullptr, be, static_cast<float*>(out), M, K, N, block_m);
    else if (out_dtype == TDT_BF16)
      fma_kernel<float, float, __nv_bfloat16><<<grid, THREADS, 0, s>>>(
          xf, wf, nullptr, be, static_cast<__nv_bfloat16*>(out), M, K, N,
          block_m);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
