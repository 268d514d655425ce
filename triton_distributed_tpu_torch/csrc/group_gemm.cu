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
// later work. The W8A16/f32 and bf16 loops live in ggemm_tiles.cuh,
// shared with the MoE-TP kernels of moe_tp_fused.cu.

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
  fma_kernel<XT, int8_t, OT, DenseRows><<<grid, THREADS, 0, s>>>(           \
      static_cast<const XT*>(x), wq, wsp, be, static_cast<OT*>(out), M, K, N, \
      block_m, DenseRows{M, K})
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
  return launch_float_ggemm(
      x, w, static_cast<const int*>(block_expert), out, M, K, N, block_m,
      x_dtype, out_dtype, static_cast<cudaStream_t>(stream), DenseRows{M, K},
      (reinterpret_cast<uintptr_t>(x) & 15) == 0);
}

}  // extern "C"
