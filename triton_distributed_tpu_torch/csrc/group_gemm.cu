// Grouped GEMM: W8A8 (s8 x s8 -> s32), W8A16, and the float mode.
//
// Replaces triton_distributed_tpu/kernels/group_gemm.py:
//   * _ggemm_q8a_kernel (:74): x (M, K) int8 with per-row f32 scales
//     x_scale (M,), w (E, K, N) int8 with per-(expert, out-channel) f32
//     scales w_scale (E, N); s32 accumulator, epilogue
//     acc * x_scale[m] * w_scale[e, n] cast to the output type.
//   * _ggemm_q_kernel (:50): x (M, K) bf16 or f32, w int8 widened to
//     x's dtype, f32 accumulator, epilogue acc * w_scale[e, n].
//   * _ggemm_kernel (:32): x and w both bf16 or both f32, f32
//     accumulator stored to the output type (the bf16 MoE experts).
// The M dim is cut into blocks of block_m rows; block b multiplies the
// weight of expert block_expert[b] (E = 1 with one block for the dense
// projections of the serving step, E = 64 for the MoE experts).
//
// What bounds it on an H100: at the serving step's shapes (M = 768
// packed tokens, K = 4096/11008, N up to 12288) the W8A8 products do
// ~100 operations per weight byte and are bound by integer math; the
// lm_head W8A16 product (M = 16 slots, K = 2048, N = 102400 for
// DeepSeek-MoE-16B; M = 8, K = 4096, N = 32000 for Llama-2-7B's decode)
// reads 210 MB of int8 weights for 6.7 GFLOP and is bound by device
// memory (0.063 ms). The MoE expert GEMMs (8704 sorted rows, 64 experts
// of 2048 x 1408) do ~50 GFLOP each on 0.4 GB of bf16 weights: bound by
// the tensor cores. The MoE routers' f32 product (M = 768 or 8, K 2048,
// N 64) is bound by the latency of its K-long FMA chains.
//
// Design. W8A8: 64 x 64 output tiles, 256 threads with a 4 x 4
// micro-tile each, the K loop staged through shared memory; four
// consecutive k of a weight column packed into one 32-bit word while the
// tile is staged (the weight is (K, N) with N contiguous), __dp4a sums,
// exact, in int32. W8A16 on bf16 x (w8a16_tc_kernel, below): the weight
// as mma.sync's A operand and x as its B operand, so the few rows of x
// fill the 8-wide side; 128 weight columns a CTA through a four-stage
// cp.async ring; each int8 code widened to bf16 with two byte permutes
// and an f32 subtraction, no int -> float conversion. W8A16 on f32 x and
// the f32 mode at N > 64: fma_kernel, both operands widened to f32 in
// shared memory, FMAs (rows padded by 1 word: no bank conflicts). The
// f32 mode at N <= 64 and the routers (tdt_narrow_f32, bf16 or f32 x and
// router as they are): narrow_f32_kernel, fma_kernel's chains in 32 x 16
// tiles behind a cp.async ring. The bf16 mode runs on the tensor cores:
// 64 x 128 tiles, four warps of 32 x 64, mma.sync m16n8k16 (bf16 in, f32
// sums) fed by ldmatrix (.trans for the (K, N) weight), the next K step
// loaded into registers while the current one multiplies (two shared
// buffers, one barrier per step). All mask the ragged M, N and K edges
// themselves; with more than one M-block, block_m is a multiple of 64,
// so a tile never straddles two experts. wgmma and TMA staging are
// later work. The float loops live in ggemm_tiles.cuh, shared with the
// MoE-TP kernels of moe_tp_fused.cu.

#include "ggemm_tiles.cuh"

namespace {

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

// --------------------------------------------------- W8A16, tensor cores
// x bf16 (M, K), w int8 (E, K, N), f32 sums, epilogue acc * w_scale[e, n].
// JAX's arithmetic (x @ w.astype(x.dtype) with f32 sums): the int8 codes
// widened to bf16 (exact for |q| <= 127), bf16 x bf16 products (exact in
// f32) on mma.sync.m16n8k16, f32 sums in the tensor cores' order.
//
// The operands swap (out^T = w^T x^T): the weight is mma's A operand, its
// 16-row tiles run over N, and x is the B operand, its 8-column tiles over
// M, so M <= 16 (the lm_head's slots) wastes no tensor-core row. 128
// threads a CTA, 128 weight columns (a warp owns 32); a CTA takes up to
// MT rows of x (16, or 64 when M > 16: a 64-row tile never straddles two
// experts, block_m being a multiple of 64 with several M-blocks); the grid
// runs over N (800 CTAs at N 102400) and the M tiles. K in steps of 64
// through a ring of four stages in shared memory filled by cp.async
// (weights and x rows in 16-byte pieces, zeros past M, N and K), three
// steps in flight while one multiplies: 24 KB of weights in flight a CTA,
// four CTAs an SM. A warp's A fragments come from shared memory as 32-bit
// words: the warp's column j of a 16-row tile i is w[., n0 + 4g + 2i + h]
// for lane group g, so one word of a weight row holds a lane's columns of
// both tiles, and each value is widened without an int -> float
// conversion (16 a clock an SM): the biased byte q + 128 is placed into an
// f32 of 2^23 by prmt, 2^23 + 128 is subtracted (exact), and prmt packs
// the upper halves of two such f32 (whose lower 16 bits are zero) into a
// bf16x2. x's B fragments by ldmatrix. Where a weight row or x's row is
// not whole 16-byte pieces, or not 16-byte aligned (N % 16, K % 8), the
// stage is copied element by element, synchronously (W8A16_TC_NARROW).
// What bounds it: the weight's bytes (210 MB at the lm_head's N 102400,
// K 2048: 0.063 ms at 3.35 TB/s); the widening costs 2.75 integer and
// float operations a weight, below that.
enum W8a16Variant { W8A16_FMA = 0, W8A16_TC = 1, W8A16_TC_NARROW = 2 };

constexpr int QBN = 128;         // weight columns a CTA
constexpr int QBK = 64;          // k a stage
constexpr int QSTAGES = 4;
constexpr int Q_THREADS = 128;   // four warps of 32 columns
constexpr int QWP = QBN + 16;    // a weight row in shared memory (bytes)
constexpr int QXP = QBK + 8;     // an x row in shared memory (bf16)

template <int MT>
__host__ __device__ constexpr int q_stage_bytes() {
  return QBK * QWP + MT * QXP * 2;
}

// code j of four int8 codes (each biased by 128: u = w ^ 0x80808080) as f32
template <int J>
__device__ __forceinline__ float q8_f32(uint32_t u) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | J)) -
         8388736.f;  // 2^23 + 128
}
// the bf16x2 of two f32 whose lower halves are zero: lo in the lower half
__device__ __forceinline__ uint32_t q8_pack(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}
// the A fragment of 16-row tile I from the words of weight rows k, k + 1,
// k + 8, k + 9 (codes 2I and 2I + 1 of each: rows g and g + 8 of the tile)
template <int I>
__device__ __forceinline__ void q8_frag(uint32_t (&a)[4], const uint32_t (&u)[4]) {
  a[0] = q8_pack(q8_f32<2 * I>(u[0]), q8_f32<2 * I>(u[1]));
  a[1] = q8_pack(q8_f32<2 * I + 1>(u[0]), q8_f32<2 * I + 1>(u[1]));
  a[2] = q8_pack(q8_f32<2 * I>(u[2]), q8_f32<2 * I>(u[3]));
  a[3] = q8_pack(q8_f32<2 * I + 1>(u[2]), q8_f32<2 * I + 1>(u[3]));
}

template <int MT, typename OutT>
__global__ void __launch_bounds__(Q_THREADS, 4)
w8a16_tc_kernel(const unsigned short* __restrict__ x,
                const int8_t* __restrict__ w, const float* __restrict__ ws,
                const int* __restrict__ block_expert, OutT* __restrict__ out,
                int M, int K, int N, int block_m, bool vec) {
  constexpr int NT = MT / 8;  // x's 8-row tiles
  extern __shared__ __align__(16) unsigned char q_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * QBN, m0 = blockIdx.y * MT;
  const int e = block_expert[m0 / block_m];
  const int8_t* __restrict__ we = w + static_cast<size_t>(e) * K * N;
  const int nk = (K + QBK - 1) / QBK;

  unsigned char* const smem = q_smem;
  auto wst = [&](int st) { return smem + st * q_stage_bytes<MT>(); };
  auto xst = [&](int st) {
    return reinterpret_cast<unsigned short*>(wst(st) + QBK * QWP);
  };
  auto load = [&](int st, int k0) {
    unsigned char* wsm = wst(st);
    unsigned short* xsm = xst(st);
    if (vec) {
      for (int c = tid; c < QBK * (QBN / 16); c += Q_THREADS) {
        const int kr = c / (QBN / 16), nn = n0 + (c % (QBN / 16)) * 16;
        const bool ok = k0 + kr < K && nn < N;
        gg_cp_async16(wsm + kr * QWP + (nn - n0),
                      ok ? we + static_cast<size_t>(k0 + kr) * N + nn : we,
                      ok ? 16 : 0);
      }
      for (int c = tid; c < MT * (QBK / 8); c += Q_THREADS) {
        const int r = c / (QBK / 8), kk = k0 + (c % (QBK / 8)) * 8;
        const bool ok = m0 + r < M && kk < K;
        gg_cp_async16(xsm + r * QXP + (kk - k0),
                      ok ? x + static_cast<size_t>(m0 + r) * K + kk : x,
                      ok ? 16 : 0);
      }
    } else {
      for (int c = tid; c < QBK * QBN; c += Q_THREADS) {
        const int kr = c / QBN, nn = n0 + c % QBN;
        wsm[kr * QWP + (nn - n0)] =
            (k0 + kr < K && nn < N)
                ? static_cast<unsigned char>(we[static_cast<size_t>(k0 + kr) * N + nn])
                : 0;
      }
      for (int c = tid; c < MT * QBK; c += Q_THREADS) {
        const int r = c / QBK, kk = k0 + c % QBK;
        xsm[r * QXP + (kk - k0)] =
            (m0 + r < M && kk < K) ? x[static_cast<size_t>(m0 + r) * K + kk] : 0;
      }
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

#pragma unroll
  for (int st = 0; st < QSTAGES - 1; ++st) {
    if (st < nk) load(st, st * QBK);
    gg_cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    gg_cp_wait<QSTAGES - 2>();
    __syncthreads();
    if (kt + QSTAGES - 1 < nk)
      load((kt + QSTAGES - 1) % QSTAGES, (kt + QSTAGES - 1) * QBK);
    gg_cp_commit();
    const unsigned char* wsm = wst(kt % QSTAGES) + warp * 32 + 4 * g;
    const unsigned short* xsm = xst(kt % QSTAGES);
#pragma unroll
    for (int kk = 0; kk < QBK; kk += 16) {
      uint32_t u[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)  // weight rows kk + 2t, +1, +8, +9
        u[r] = *reinterpret_cast<const uint32_t*>(
                   wsm + (kk + 2 * t + (r & 1) + 8 * (r >> 1)) * QWP) ^
               0x80808080u;
      uint32_t a[2][4];
      q8_frag<0>(a[0], u);
      q8_frag<1>(a[1], u);
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {  // x rows 16p .. 16p + 15
        uint32_t b[4];
        ldsm_x4(b, xsm + (16 * p + ((lane >> 4) << 3) + (lane & 7)) * QXP + kk +
                       ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * p], a[i], b[0], b[1]);
          mma_bf16(acc[i][2 * p + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  gg_cp_wait<0>();

  // lane (g, t) holds columns n0 + 32 warp + 4g + {0, 1, 2, 3} (tile 0 rows
  // g, g + 8, tile 1 rows g, g + 8) of x rows 8j + 2t and 8j + 2t + 1
  const int nb = n0 + warp * 32 + 4 * g;
  float sc[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    sc[q] = nb + q < N ? ws[static_cast<size_t>(e) * N + nb + q] : 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 8 * j + 2 * t + h;
      if (m >= M) continue;
      const float v[4] = {acc[0][j][h], acc[0][j][2 + h], acc[1][j][h],
                          acc[1][j][2 + h]};
      OutT* row = out + static_cast<size_t>(m) * N;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (nb + q < N) row[nb + q] = tdt_from_f<OutT>(v[q] * sc[q]);
    }
}

template <int MT, typename OutT>
int w8a16_tc_launch(const void* x, const int8_t* w, const float* ws,
                    const int* be, void* out, int M, int K, int N,
                    int block_m, bool vec, cudaStream_t s) {
  constexpr int bytes = QSTAGES * q_stage_bytes<MT>();
  static bool attr = false;  // above 48 KB only after this, once a kernel
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        w8a16_tc_kernel<MT, OutT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = true;
  }
  const dim3 grid((N + QBN - 1) / QBN, (M + MT - 1) / MT);
  w8a16_tc_kernel<MT, OutT><<<grid, Q_THREADS, bytes, s>>>(
      static_cast<const unsigned short*>(x), w, ws, be,
      static_cast<OutT*>(out), M, K, N, block_m, vec);
  return static_cast<int>(cudaGetLastError());
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

// x_dtype, out_dtype: TDT_F32 or TDT_BF16; *variant: the kernel launched
// (W8A16_TC or W8A16_TC_NARROW for bf16 x, W8A16_FMA for f32 x)
int tdt_ggemm_w8a16(const void* x, const void* w, const void* w_scale,
                    const void* block_expert, void* out, int M, int K, int N,
                    int block_m, int x_dtype, int out_dtype, int* variant,
                    void* stream) {
  cudaGetLastError();
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* wsp = static_cast<const float*>(w_scale);
  const int* be = static_cast<const int*>(block_expert);
  if (x_dtype == TDT_BF16) {
    // JAX widens w to x's dtype: bf16 products on the tensor cores
    const bool vec = ((reinterpret_cast<uintptr_t>(x) |
                       reinterpret_cast<uintptr_t>(w)) & 15) == 0 &&
                     K % 8 == 0 && N % 16 == 0;
    *variant = vec ? W8A16_TC : W8A16_TC_NARROW;
#define TDT_W8A16_TC(MT, OT) \
  w8a16_tc_launch<MT, OT>(x, wq, wsp, be, out, M, K, N, block_m, vec, s)
    if (out_dtype == TDT_F32)
      return M <= 16 ? TDT_W8A16_TC(16, float) : TDT_W8A16_TC(64, float);
    if (out_dtype == TDT_BF16)
      return M <= 16 ? TDT_W8A16_TC(16, __nv_bfloat16)
                     : TDT_W8A16_TC(64, __nv_bfloat16);
#undef TDT_W8A16_TC
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // f32 x: JAX widens w to f32, so f32 products, on the FMA loop
  *variant = W8A16_FMA;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
#define TDT_W8A16(XT, OT)                                                   \
  fma_kernel<XT, int8_t, OT, DenseRows><<<grid, THREADS, 0, s>>>(           \
      static_cast<const XT*>(x), wq, wsp, be, static_cast<OT*>(out), M, K, N, \
      block_m, DenseRows{M, K})
  if (x_dtype == TDT_F32 && out_dtype == TDT_BF16) TDT_W8A16(float, __nv_bfloat16);
  else if (x_dtype == TDT_F32 && out_dtype == TDT_F32) TDT_W8A16(float, float);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef TDT_W8A16
  return static_cast<int>(cudaGetLastError());
}

// x (M, K) at row pitch lda and w (K, N), each TDT_F32 or TDT_BF16, f32
// out (M, N): narrow_f32_kernel at any N, one expert (every MoE router's
// logits, bf16 activations without a cast)
int tdt_narrow_f32(const void* x, long long lda, const void* w, void* out,
                   int M, int K, int N, int x_dtype, int w_dtype,
                   void* stream) {
  cudaGetLastError();
  if (M <= 0 || N <= 0) return 0;
  return launch_narrow_f32(x, lda, w, nullptr, out, M, K, N, M, x_dtype,
                           w_dtype, TDT_F32, static_cast<cudaStream_t>(stream));
}

// The float mode: x and w both TDT_BF16 (tensor cores) or both TDT_F32
// (FMA); out_dtype TDT_F32 or TDT_BF16.
int tdt_ggemm_f(const void* x, const void* w, const void* block_expert,
                void* out, int M, int K, int N, int block_m, int x_dtype,
                int out_dtype, void* stream) {
  cudaGetLastError();
  if (M <= 0 || N <= 0) return 0;
  return launch_float_ggemm(
      x, w, static_cast<const int*>(block_expert), out, M, K, N, block_m,
      x_dtype, out_dtype, static_cast<cudaStream_t>(stream), DenseRows{M, K},
      (reinterpret_cast<uintptr_t>(x) & 15) == 0);
}

}  // extern "C"
