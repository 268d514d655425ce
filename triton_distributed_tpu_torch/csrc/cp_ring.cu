// Cross-rank LSE-combine of context-parallel serving: merge the cp shards'
// attention partials (out_r, lse_r) into one softmax.
//
// Replaces triton_distributed_tpu/kernels/cp_ring.py _cp_lse_combine_kernel
// (:306) and _cp_lse_combine_kernel3 (:341, one more ring slot). On the TPU
// each rank weights its partial against the pre-agreed running max, so the
// merge is an f32 add-reduce over ranks of the numerator rows w_r * out_r
// and the denominator row w_r, carried hop by hop around the cp ring. JAX's
// serving step computes the same merge in XLA (kernels/flash_decode.py:1367
// combine_gqa_partials); this kernel is that function:
//   m     = max_r lse_r
//   w_r   = lse_r > NEG_INF / 2 ? exp(lse_r - m) : 0
//   den   = max(w_0 + w_1 + ... , 1e-30)
//   out   = (w_0 * out_0 + w_1 * out_1 + ...) / den      (f32, then cast)
//   lse   = m > NEG_INF / 2 ? m + log(den) : NEG_INF
// The sums run over r = 0, 1, ... in that order, each product and each add
// rounded on its own (__fmul_rn / __fadd_rn: never contracted into an FMA)
// and the division IEEE (__fdiv_rn), so the plain version's torch ops give
// the same bits. A row whose only finite lse is shard 0's has weights 1 and
// 0: it comes out bit-equal to shard 0's partial. A row every shard masked
// (all lses at NEG_INF, partials 0) stays 0 with lse NEG_INF.
//
// On one card the cp shards are slices of one stacked pool, so the ring
// becomes a read of every shard's partial: nothing waits, and the ring's
// depth (2 or 3 slots) has no counterpart. The partials are addressed by
// strides (shard, kv head; the TG rows and D are contiguous), so the
// serving step passes the one ragged launch's output for all shards
// without a copy.
//
// What bounds it on an H100: device memory. Every shard's partial is read
// once and the merged one written once: at DeepSeek-MoE-16B's serving step
// (cp = 2, Hkv 16, 768 rows, D 128, bf16) 6.3 MB read and 3.1 MB written,
// 2.8 us at 3.35 TB/s, where one launch costs about as much.
//
// Design (right and simple first): one warp a (kv head, row); the lanes
// read the R lses, take the max and the weights in registers, then walk D
// four elements a lane (8- or 16-byte loads where the strides allow it,
// one element at a time otherwise).

#include "tdt_common.cuh"

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr int MAX_R = 8;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

struct Args {
  const void* outs;
  const float* lses;
  void* out;
  float* lse;
  int r, hkv, tg, d;
  long long o_sr, o_sh, l_sr, l_sh;
};

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  uint2 x;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
  h[0] = __halves2bfloat162(__float2bfloat16_rn(v[0]), __float2bfloat16_rn(v[1]));
  h[1] = __halves2bfloat162(__float2bfloat16_rn(v[2]), __float2bfloat16_rn(v[3]));
  *reinterpret_cast<uint2*>(p) = x;
}

template <typename TI, typename TO, bool VEC>
__global__ void __launch_bounds__(THREADS) cp_lse_combine_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const long long rows = static_cast<long long>(a.hkv) * a.tg;
  const long long nwarps = static_cast<long long>(gridDim.x) * WARPS;
  const TI* __restrict__ outs = static_cast<const TI*>(a.outs);
  TO* __restrict__ out = static_cast<TO*>(a.out);
  for (long long row = static_cast<long long>(blockIdx.x) * WARPS +
                       (threadIdx.x >> 5);
       row < rows; row += nwarps) {
    const int h = static_cast<int>(row / a.tg);
    const int t = static_cast<int>(row % a.tg);
    float lr[MAX_R], w[MAX_R];
    float m = NEG_INF;
    for (int r = 0; r < a.r; ++r) {
      lr[r] = a.lses[r * a.l_sr + h * a.l_sh + t];
      m = fmaxf(m, lr[r]);
    }
    float den = 0.f;
    for (int r = 0; r < a.r; ++r) {
      w[r] = lr[r] > NEG_INF / 2 ? expf(__fsub_rn(lr[r], m)) : 0.f;
      den = r == 0 ? w[0] : __fadd_rn(den, w[r]);
    }
    den = fmaxf(den, 1e-30f);
    const long long src0 = h * a.o_sh + static_cast<long long>(t) * a.d;
    TO* __restrict__ dst = out + row * a.d;
    if (VEC) {
      for (int dd = 4 * lane; dd < a.d; dd += 128) {
        float acc[4], x[4];
        load4(outs + src0 + dd, x);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = __fmul_rn(w[0], x[j]);
        for (int r = 1; r < a.r; ++r) {
          load4(outs + r * a.o_sr + src0 + dd, x);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[j] = __fadd_rn(acc[j], __fmul_rn(w[r], x[j]));
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = __fdiv_rn(acc[j], den);
        store4(dst + dd, acc);
      }
    } else {
      for (int dd = lane; dd < a.d; dd += 32) {
        float acc = __fmul_rn(w[0], tdt_to_f<TI>(outs[src0 + dd]));
        for (int r = 1; r < a.r; ++r)
          acc = __fadd_rn(acc, __fmul_rn(w[r], tdt_to_f<TI>(
                                                   outs[r * a.o_sr + src0 + dd])));
        dst[dd] = tdt_from_f<TO>(__fdiv_rn(acc, den));
      }
    }
    if (lane == 0)
      a.lse[row] = m > NEG_INF / 2 ? __fadd_rn(m, logf(den)) : NEG_INF;
  }
}

template <typename TI, typename TO>
int launch(const Args& a, bool vec, cudaStream_t s) {
  const long long rows = static_cast<long long>(a.hkv) * a.tg;
  const int blocks = static_cast<int>(
      (rows + WARPS - 1) / WARPS < 65535 ? (rows + WARPS - 1) / WARPS : 65535);
  if (vec)
    cp_lse_combine_kernel<TI, TO, true><<<blocks, THREADS, 0, s>>>(a);
  else
    cp_lse_combine_kernel<TI, TO, false><<<blocks, THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tdt_cp_lse_combine(const void* outs, const void* lses, void* out,
                                  void* lse, int r, int hkv, int tg, int d,
                                  long long o_sr, long long o_sh, long long l_sr,
                                  long long l_sh, int in_dtype, int out_dtype,
                                  int vec, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (r < 1 || r > MAX_R) return static_cast<int>(cudaErrorInvalidValue);
  if (hkv <= 0 || tg <= 0 || d <= 0) return 0;
  Args a{outs, static_cast<const float*>(lses), out, static_cast<float*>(lse),
         r, hkv, tg, d, o_sr, o_sh, l_sr, l_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v = vec != 0;
  if (in_dtype == TDT_BF16 && out_dtype == TDT_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(a, v, s);
  if (in_dtype == TDT_BF16 && out_dtype == TDT_F32)
    return launch<__nv_bfloat16, float>(a, v, s);
  if (in_dtype == TDT_F32 && out_dtype == TDT_BF16)
    return launch<float, __nv_bfloat16>(a, v, s);
  if (in_dtype == TDT_F32 && out_dtype == TDT_F32)
    return launch<float, float>(a, v, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
