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

// ===================================================== context-parallel prefill
//
// tdt_ring_attention: the port of _kv_rotate_kernel (:71) together with the
// attention partial it exists for (its `consume` hook, :82), and of the
// ring attention body JAX runs in XLA (kernels/ring_attention.py:70-119).
// On the TPU every rank holds its q, k and v sequence blocks; the KV blocks
// travel around the cp ring, and each arrival is folded into the rank's
// online softmax. On one card the ranks' blocks are slices of one stacked
// tensor, so the ring becomes a read: every CTA walks the source blocks in
// the ring's arrival order, src = r, r - 1, ..., r - n + 1 (mod n), and
// reads block src's K/V rows through the peer tables (one pointer a rank).
// It masks causally by global positions, query r * S + t against key
// src * S + t', and folds each 64-key tile into (m, l, acc) in f32; the
// output is acc / max(l, 1e-30) in q's dtype. Ulysses' local body (dense
// attention over the whole sequence on the rank's heads) is the same
// function on a ring of one block, so it runs here with n = 1. Where the
// caller passes an lse buffer (training: the backward's softmax gradient
// needs it), each query row's m + log(max(l, 1e-30)) lands there too.
//
// Wholly masked blocks are skipped: under the causal mask every key of a
// block src > r lies after every query of block r. JAX's body computes those
// blocks all the same (kernels/ring_attention.py:104-113): their scores are
// all -1e30, so their own max is -1e30 and their p = exp(0) = 1, but they
// merge with weight exp(-1e30 - m_acc) = 0 exactly, because step 0 (the own
// block, where every query sees at least its own key) has already set a
// finite m_acc. Leaving them out therefore changes no value. Inside the own
// block the tiles past the q tile's last token are wholly masked too.
//
// What bounds it on an H100: operations. The scores and the P @ V product
// are 4 * S_q * S_k * D flops a (batch, head), about half of them under the
// causal mask: at Llama-2-7B's prefill on 4 ranks (B 2, S 4032, 32 heads,
// D 128) 2.7e11 flops a layer, 0.27 ms at the bf16 tensor-core rate; the
// bytes (q, k, v read once, out written once: 264 MB) take 0.079 ms.
//
// Design (right and simple first): f32 FMA, no tensor cores, so that the f32
// path is exact to rounding and the bf16 path rounds once, at the output.
// One CTA of 256 threads (16 x 16) a (rank, batch, KV head, tile of 64 q
// rows); a tile's rows are 64 / G tokens times the G query heads of the KV
// head. The q tile stays in shared memory (f32); K and then V of each 64-key
// tile pass through one shared buffer. Thread (ty, tx) holds rows ty + 16 i
// and keys tx + 16 j of the scores (4 x 4) and rows ty + 16 i of the output
// accumulator; the row max and sum reduce over the 16 lanes that share ty.
// The rescale's exp and products are left to the compiler (it may contract
// them into FMAs): the kernel agrees with the plain version to rounding,
// not bit for bit. CTAs are issued heaviest first (last q tiles, last
// rank), which evens out the causal triangle's tail.
//
// tdt_ulysses_a2a: the port of _ulysses_a2a_kernel (:127), the dense
// equal-split all-to-all under Ulysses' sequence <-> heads re-shard
// (lax.all_to_all(tiled=True), kernels/ring_attention.py:145-157). One pull
// launch serves every rank for one direction. A run is one (destination
// rank R, batch b, source rank Q, token t): H/n * D contiguous elements at
// both ends, copied by one warp in 16-byte pieces where both ends allow it:
//   scatter_heads: out[R, b, Q * S + t, :, :] = x[Q, b, t, R * H/n : +H/n, :]
//   gather_heads:  out[Q', b, t, R' * H/n : +H/n, :] = x[R', b, Q' * S + t, :, :]
// (the wrapper names the source and destination blocks through peer tables
// and byte strides, so both directions are the same loop). Byte-exact. What
// bounds it: bytes, each element read once and written once.

namespace {

constexpr int RA_BQ = 64;       // q rows a CTA
constexpr int RA_BK = 64;       // keys a tile
constexpr int RA_THREADS = 256;

struct RingArgs {
  const void* q;
  const unsigned long long* k_peers;
  const unsigned long long* v_peers;
  void* out;
  float* lse;  // null, or (n, b, s, hkv * g) f32: each row's log-sum-exp
  int n, b, s, hkv, g, causal;
  float scale;
  long long q_sr, q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sr, o_sb, o_st, o_sh;
};

__device__ __forceinline__ void load4(const float* p, float4& v) {
  v = *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float4& v) {
  float x[4];
  load4(p, x);
  v = make_float4(x[0], x[1], x[2], x[3]);
}

// rows [0, 64) of a (64, D) tile -> shared memory as f32 at pitch LD; row i
// is at base + off(i), zeros where off(i) < 0
template <typename T, int D, typename Off>
__device__ __forceinline__ void ra_load_tile(float* dst, const T* base,
                                             Off off) {
  constexpr int LD = D + 4;
  for (int idx = threadIdx.x; idx < RA_BQ * (D / 4); idx += RA_THREADS) {
    const int i = idx / (D / 4);
    const int c = (idx % (D / 4)) * 4;
    const long long o = off(i);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (o >= 0) load4(base + o + c, v);
    *reinterpret_cast<float4*>(dst + i * LD + c) = v;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(RA_THREADS, 2)
    ring_attention_kernel(RingArgs a) {
  constexpr int LD = D + 4;      // row pitch of the q and K/V tiles (floats)
  constexpr int LP = RA_BK + 4;  // row pitch of P
  constexpr int DPT = D / 16;    // output dims a thread
  extern __shared__ __align__(16) float ra_smem[];
  float* qs = ra_smem;                 // [64][LD]
  float* kv = qs + RA_BQ * LD;         // [64][LD]: the K tile, then the V tile
  float* ps = kv + RA_BK * LD;         // [64][LP]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int tile = gridDim.x - 1 - blockIdx.x;
  const int r = gridDim.z - 1 - blockIdx.z;
  const int bb = blockIdx.y / a.hkv, h = blockIdx.y % a.hkv;
  const int tpt = RA_BQ / a.g;         // tokens a tile
  const int t0 = tile * tpt;
  const int t_end = min(a.s, t0 + tpt);

  const T* q = static_cast<const T*>(a.q) + r * a.q_sr + bb * a.q_sb;
  ra_load_tile<T, D>(qs, q, [&](int i) -> long long {
    const int t = t0 + i / a.g;
    return t < a.s ? t * a.q_st + static_cast<long long>(h * a.g + i % a.g) *
                                      a.q_sh
                   : -1;
  });

  float m[4], l[4], o[4][DPT];
  int qpos[4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    m[ii] = -INFINITY;
    l[ii] = 0.f;
#pragma unroll
    for (int e = 0; e < DPT; ++e) o[ii][e] = 0.f;
    qpos[ii] = r * a.s + t0 + (ty + 16 * ii) / a.g;
  }

  for (int step = 0; step < a.n; ++step) {
    const int src = (r - step + a.n) % a.n;   // the block that arrives now
    if (a.causal && src > r) continue;        // wholly masked: see the header
    const int kend = (a.causal && src == r) ? t_end : a.s;
    const T* kb = reinterpret_cast<const T*>(a.k_peers[src]) + bb * a.k_sb +
                  h * a.k_sh;
    const T* vb = reinterpret_cast<const T*>(a.v_peers[src]) + bb * a.v_sb +
                  h * a.v_sh;
    for (int k0 = 0; k0 < kend; k0 += RA_BK) {
      __syncthreads();  // the previous tile's P @ V is done with kv and ps
      ra_load_tile<T, D>(kv, kb, [&](int j) -> long long {
        return k0 + j < kend ? static_cast<long long>(k0 + j) * a.k_st : -1;
      });
      __syncthreads();
      float sc[4][4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sc[ii][jj] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float4 qv[4], kk[4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
          qv[ii] = *reinterpret_cast<const float4*>(qs + (ty + 16 * ii) * LD + d);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          kk[jj] = *reinterpret_cast<const float4*>(kv + (tx + 16 * jj) * LD + d);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            float acc = sc[ii][jj];
            acc = fmaf(qv[ii].x, kk[jj].x, acc);
            acc = fmaf(qv[ii].y, kk[jj].y, acc);
            acc = fmaf(qv[ii].z, kk[jj].z, acc);
            acc = fmaf(qv[ii].w, kk[jj].w, acc);
            sc[ii][jj] = acc;
          }
      }
      // mask, scale and the online softmax; P to shared memory
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        float mx = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int key = k0 + tx + 16 * jj;
          const bool ok = key < kend && (!a.causal || src * a.s + key <= qpos[ii]);
          sc[ii][jj] = ok ? sc[ii][jj] * a.scale : -INFINITY;
          mx = fmaxf(mx, sc[ii][jj]);
        }
#pragma unroll
        for (int sh = 8; sh > 0; sh >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
        const float mn = fmaxf(m[ii], mx);
        const float base = mn == -INFINITY ? 0.f : mn;
        const float alpha = expf(m[ii] - base);
        float sum = 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float p = sc[ii][jj] == -INFINITY ? 0.f : expf(sc[ii][jj] - base);
          ps[(ty + 16 * ii) * LP + tx + 16 * jj] = p;
          sum += p;
        }
#pragma unroll
        for (int sh = 8; sh > 0; sh >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, sh);
        l[ii] = l[ii] * alpha + sum;
        m[ii] = mn;
#pragma unroll
        for (int e = 0; e < DPT; ++e) o[ii][e] *= alpha;
      }
      __syncthreads();  // every thread is done with the K tile
      ra_load_tile<T, D>(kv, vb, [&](int j) -> long long {
        return k0 + j < kend ? static_cast<long long>(k0 + j) * a.v_st : -1;
      });
      __syncthreads();
#pragma unroll 2
      for (int j = 0; j < RA_BK; j += 4) {
        float4 pv[4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
          pv[ii] = *reinterpret_cast<const float4*>(ps + (ty + 16 * ii) * LP + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float* vr = kv + (j + jj) * LD;
          float vv[DPT];
          if constexpr (D % 64 == 0) {
#pragma unroll
            for (int c = 0; c < D / 64; ++c) {
              const float4 x = *reinterpret_cast<const float4*>(vr + c * 64 + tx * 4);
              vv[4 * c] = x.x;
              vv[4 * c + 1] = x.y;
              vv[4 * c + 2] = x.z;
              vv[4 * c + 3] = x.w;
            }
          } else {
#pragma unroll
            for (int e = 0; e < DPT; ++e) vv[e] = vr[tx + 16 * e];
          }
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            const float p = jj == 0 ? pv[ii].x : jj == 1 ? pv[ii].y
                          : jj == 2 ? pv[ii].z : pv[ii].w;
#pragma unroll
            for (int e = 0; e < DPT; ++e) o[ii][e] = fmaf(p, vv[e], o[ii][e]);
          }
        }
      }
    }
  }

  T* out = static_cast<T*>(a.out) + r * a.o_sr + bb * a.o_sb;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int i = ty + 16 * ii;
    const int t = t0 + i / a.g;
    if (t >= t_end) continue;
    const float den = fmaxf(l[ii], 1e-30f);
    if (a.lse != nullptr && tx == 0)
      a.lse[((static_cast<long long>(r) * a.b + bb) * a.s + t) * a.hkv * a.g +
            h * a.g + i % a.g] = m[ii] + logf(den);
    T* row = out + t * a.o_st + static_cast<long long>(h * a.g + i % a.g) * a.o_sh;
    if constexpr (D % 64 == 0) {
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        float y[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) y[e] = o[ii][4 * c + e] / den;
        store4(row + c * 64 + tx * 4, y);
      }
    } else {
#pragma unroll
      for (int e = 0; e < DPT; ++e) row[tx + 16 * e] = tdt_from_f<T>(o[ii][e] / den);
    }
  }
}

template <typename T, int D>
int ring_launch(const RingArgs& a, cudaStream_t s) {
  constexpr int bytes = (RA_BQ * (D + 4) + RA_BK * (D + 4) + RA_BQ * (RA_BK + 4)) *
                        static_cast<int>(sizeof(float));
  static bool attr = false;  // above 48 KB only after this, once a kernel
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        ring_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const dim3 grid((a.s * a.g + RA_BQ - 1) / RA_BQ, a.b * a.hkv, a.n);
  ring_attention_kernel<T, D><<<grid, RA_THREADS, bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int ring_dispatch(const RingArgs& a, int d, cudaStream_t s) {
  switch (d) {
    case 16: return ring_launch<T, 16>(a, s);
    case 32: return ring_launch<T, 32>(a, s);
    case 64: return ring_launch<T, 64>(a, s);
    case 128: return ring_launch<T, 128>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

struct A2AArgs {
  const unsigned long long* src_peers;
  const unsigned long long* dst_peers;
  int n, b, t;
  long long run;                // bytes a run
  long long s_sb, s_st, s_r;    // source: batch, token, destination-rank bytes
  long long d_sb, d_st, d_q;    // destination: batch, token, source-rank bytes
};

constexpr int A2A_WARPS = 8;

__global__ void __launch_bounds__(A2A_WARPS * 32) ulysses_a2a_kernel(A2AArgs a) {
  const long long runs = static_cast<long long>(a.n) * a.b * a.n * a.t;
  const int lane = threadIdx.x & 31;
  const long long nw = static_cast<long long>(gridDim.x) * A2A_WARPS;
  for (long long w = static_cast<long long>(blockIdx.x) * A2A_WARPS +
                     (threadIdx.x >> 5);
       w < runs; w += nw) {
    long long x = w;
    const long long t = x % a.t;
    x /= a.t;
    const long long qq = x % a.n;
    x /= a.n;
    const long long bb = x % a.b;
    const long long rr = x / a.b;
    const char* src = reinterpret_cast<const char*>(a.src_peers[qq]) +
                      bb * a.s_sb + t * a.s_st + rr * a.s_r;
    char* dst = reinterpret_cast<char*>(a.dst_peers[rr]) + bb * a.d_sb +
                t * a.d_st + qq * a.d_q;
    tdt_copy_bytes(dst, src, a.run, lane, 32);
  }
}

}  // namespace

extern "C" int tdt_ring_attention(
    const void* q, const void* k_peers, const void* v_peers, void* out,
    void* lse, int n,
    int b, int s, int hkv, int g, int d, int causal, float scale,
    long long q_sr, long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh, long long v_sb,
    long long v_st, long long v_sh, long long o_sr, long long o_sb,
    long long o_st, long long o_sh, int dtype, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (n < 1 || g < 1 || RA_BQ % g != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0 || s <= 0 || hkv <= 0) return 0;
  RingArgs a{q, static_cast<const unsigned long long*>(k_peers),
             static_cast<const unsigned long long*>(v_peers), out,
             static_cast<float*>(lse), n, b, s,
             hkv, g, causal, scale, q_sr, q_sb, q_st, q_sh, k_sb, k_st, k_sh,
             v_sb, v_st, v_sh, o_sr, o_sb, o_st, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == TDT_BF16) return ring_dispatch<__nv_bfloat16>(a, d, st);
  if (dtype == TDT_F32) return ring_dispatch<float>(a, d, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int tdt_ulysses_a2a(const void* src_peers, const void* dst_peers,
                               int n, int b, int t, long long run,
                               long long s_sb, long long s_st, long long s_r,
                               long long d_sb, long long d_st, long long d_q,
                               void* stream) {
  cudaGetLastError();
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long runs = static_cast<long long>(n) * b * n * t;
  if (runs <= 0 || run <= 0) return 0;
  A2AArgs a{static_cast<const unsigned long long*>(src_peers),
            static_cast<const unsigned long long*>(dst_peers), n, b, t, run,
            s_sb, s_st, s_r, d_sb, d_st, d_q};
  const long long want = (runs + A2A_WARPS - 1) / A2A_WARPS;
  const int blocks = static_cast<int>(want < 65535 ? want : 65535);
  ulysses_a2a_kernel<<<blocks, A2A_WARPS * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
