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

#include "hopper.cuh"

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
// reads block src's K/V rows at src rank strides into the stacked view.
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
// Two kernels, chosen by dtype.
//
// bf16 (ring_attention_tc_kernel): both products on the tensor cores, as
// Hopper's warpgroup products (wgmma m64nNk16, bf16 -> f32). One CTA a
// (rank, batch, KV head, tile of 128 q rows: 128 / G tokens times the G
// query heads): two consumer warpgroups of 64 rows each and one producer
// warp. The producer keeps K and V in flight by TMA: 64-key tiles of the (n,
// B, S, Hkv, D) views through two tensor maps (one box of 64 x 64 elements
// per 64 of D, in the 128-byte swizzle that wgmma reads, keys past S as
// zeros), into a ring of four stages in shared memory, each stage completing
// on an mbarrier and refilled once all eight consumer warps have released
// it; so the warpgroups need not keep in step. Views that TMA cannot take (D
// 16 or 32, a base or stride not 16-byte aligned) run the same kernel with
// the consumers loading the tiles by cp.async (8-byte copies where a row is
// only 8-byte aligned) into wgmma's layout without swizzle, in step, one
// barrier a tile. Q is read once into shared memory; its A fragments go to
// registers by ldmatrix again each tile, not held across tiles: ptxas 12.9
// gave some of their registers to P's fragments at D 64, wrong from the
// second tile on. S = Q K^T takes K's tile as wgmma's K-major B operand; the
// scores stay in registers: each thread holds rows g and g + 8 of its warp's
// 16, the row max reduces over the 4 lanes that share them (two shuffles),
// the online softmax (m, l, the rescale of the accumulator) runs in f32 on
// the fragments, and exp is exp2 of the scores scaled by scale * log2(e),
// less the row max so scaled (a constant error of a row cancels in o / l).
// Products of bf16 values are exact in f32, so S differs from the plain
// version only in the order of its sums. P is not rounded to one bf16, which
// would move the output by about 2^-9 of its terms, far past the tests'
// 1e-5: it is split in registers into p_hi = bf16(p) and p_lo = bf16(p -
// p_hi) (p - p_hi is exact), and both products P_hi V and P_lo V add into
// the one f32 accumulator, keeping about 16 bits of p; V is exact in bf16.
// So P @ V costs two products, and the kernel does 1.5x the tensor work of
// plain flash attention. P's A fragments are the S accumulators' layout, so
// P never leaves registers; V's tile is the transposed (MN-major) B operand.
// The causal mask runs only on the tiles that cross the diagonal or the
// keys' end; blocks src > r and, in the own block, the tiles past the q
// tile's last token are skipped. The output is acc / max(l, 1e-30), the lse
// m * scale + log(max(l, 1e-30)). CTAs are issued heaviest first: the grid's
// fastest axis is (batch, KV head), then the q tiles from the last, then the
// ranks from the last, so that work falls along the issue order. What holds
// it back (PERF.md): each warpgroup's softmax runs while the tensor cores
// wait on it.
//
// f32 (ring_attention_kernel): f32 FMA, no tensor cores, so that the f32
// path (the trainer's, held to 1e-5) is exact to rounding; TF32 would not be.
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

// the kernel a tdt_ring_attention call launched, as it reports it
enum RingVariant { RING_FMA = 0, RING_CP_ASYNC = 1, RING_TMA = 2 };

struct RingArgs {
  const void* q;
  const void* k;  // rank 0's K block; rank r's at k + r * k_sr elements
  const void* v;
  void* out;
  float* lse;  // null, or (n, b, s, hkv * g) f32: each row's log-sum-exp
  int n, b, s, hkv, g, causal;
  float scale;
  long long q_sr, q_sb, q_st, q_sh;
  long long k_sr, k_sb, k_st, k_sh;
  long long v_sr, v_sb, v_st, v_sh;
  long long o_sr, o_sb, o_st, o_sh;
};

__device__ __forceinline__ void load4(const float* p, float4& v) {
  v = *reinterpret_cast<const float4*>(p);
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
    const T* kb = static_cast<const T*>(a.k) + src * a.k_sr + bb * a.k_sb +
                  h * a.k_sh;
    const T* vb = static_cast<const T*>(a.v) + src * a.v_sr + bb * a.v_sb +
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

// ------------------------------------- the bf16 form, on the tensor cores

constexpr int TC_BQ = 128;      // q rows a CTA: 2 warpgroups of 64
constexpr int TC_BK = 64;       // keys a tile
constexpr int TC_THREADS = 256; // the consumers (the producer warp is extra)
constexpr int TC_STAGES = 4;    // K / V tiles in flight

// Shared memory (1024-byte aligned): TC_STAGES stages of a K and a V tile,
// then the q tile in rows padded by 16 bytes (ldmatrix reads it without
// bank conflicts). A K or V tile is 64 keys x D. Loaded by TMA, it is D / 64
// regions of 64 keys x 128 bytes (64 elements of D), each in the 128-byte
// swizzle that TMA writes and wgmma reads. Loaded by cp.async (views that
// TMA cannot take), it is wgmma's layout without swizzle: 16-byte chunk c
// (elements 8c .. 8c + 7) of key row i at byte (c * TC_BK + i) * 16, so that
// each 8 x 8 core matrix is 128 contiguous bytes.
template <int D>
struct TcTiles {
  static constexpr int LDQ = D + 8;              // q row pitch (bf16)
  static constexpr int KV = TC_BK * D * 2;       // bytes of a K or V tile
  static constexpr int Q = TC_BQ * LDQ * 2;      // bytes of the q tile
  static constexpr int bytes = 2 * TC_STAGES * KV + Q + 1024;  // + alignment
};

// 16 bytes from global to shared memory, in flight until waited for: one
// 16-byte copy where src is 16-byte aligned, two 8-byte ones otherwise
// (the wrapper guarantees 8); zeros where !ok (src then only names a
// valid address, nothing is read). cp.async.ca: through L1, which streams
// faster than .cg on the H100
__device__ __forceinline__ void tc_copy16(uint32_t dst,
                                          const __nv_bfloat16* src, bool ok) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(ok ? 16 : 0));
  } else {
    const int n = ok ? 8 : 0;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(dst), "l"(src), "r"(n));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(dst + 8), "l"(src + 4), "r"(n));
  }
}

__device__ __forceinline__ void tc_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// this thread's copies but the newest N groups have landed, and are
// visible to wgmma (the async proxy) once the CTA has passed a barrier
template <int N>
__device__ __forceinline__ void tc_wait_landed() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the tiles of one CTA in the ring's arrival order: src = r, r - 1, ...,
// each block's keys [0, kend) in steps of TC_BK. Under the causal mask
// the blocks src > r are wholly masked, and so are the own block's keys
// past the q tile's last token (t_end)
struct TcTileWalk {
  int r, n, s, t_end, causal, nsteps;
  int step, src, k0, kend;
  __device__ TcTileWalk(int r_, int n_, int s_, int t_end_, int causal_)
      : r(r_), n(n_), s(s_), t_end(t_end_), causal(causal_),
        nsteps(causal_ ? r_ + 1 : n_), step(0), src(r_), k0(0),
        kend(causal_ ? t_end_ : s_) {}
  __device__ bool valid() const { return step < nsteps; }
  __device__ void advance() {
    k0 += TC_BK;
    if (k0 < kend) return;
    ++step;
    src = (r - step + n) % n;
    k0 = 0;
    kend = (causal && src == r) ? t_end : s;
  }
};

// the q tile's TC_BQ rows at pitch D + 8: row i from row(i), zeros where
// row(i) is null (`safe` is any valid address)
template <int D, typename Row>
__device__ __forceinline__ void tc_load_q(__nv_bfloat16* dst, Row row,
                                          const __nv_bfloat16* safe) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
  constexpr int N = TC_BQ * CH;
  const uint32_t base = tc_smem(dst);
#pragma unroll
  for (int it = 0; it < (N + TC_THREADS - 1) / TC_THREADS; ++it) {
    const int idx = threadIdx.x + it * TC_THREADS;
    if (N % TC_THREADS != 0 && idx >= N) break;
    const int i = idx / CH, c = idx % CH;
    const __nv_bfloat16* p = row(i);
    tc_copy16(base + (i * (D + 8) + c * 8) * 2, p != nullptr ? p + c * 8 : safe,
              p != nullptr);
  }
}

// a K or V tile's TC_BK rows in the chunk-major layout of TcTiles. Eight
// consecutive threads take one chunk of eight consecutive rows (eight
// distinct bank groups), a warp four chunks of them (64 bytes a row)
template <int D, typename Row>
__device__ __forceinline__ void tc_load_kv(char* dst, Row row,
                                           const __nv_bfloat16* safe) {
  constexpr int CH = D / 8;
  constexpr int N = TC_BK * CH;
  const uint32_t base = tc_smem(dst);
#pragma unroll
  for (int it = 0; it < (N + TC_THREADS - 1) / TC_THREADS; ++it) {
    const int idx = threadIdx.x + it * TC_THREADS;
    if (N % TC_THREADS != 0 && idx >= N) break;
    const int i = idx / (8 * CH) * 8 + idx % 8, c = idx / 8 % CH;
    const __nv_bfloat16* p = row(i);
    tc_copy16(base + (c * TC_BK + i) * 16, p != nullptr ? p + c * 8 : safe,
              p != nullptr);
  }
}

// a barrier of the TC_THREADS consumer threads (the producer warp is not in it)
__device__ __forceinline__ void tc_consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(TC_THREADS) : "memory");
}

// (x, y) as bf16 pairs hi = bf16(x, y) and lo = bf16((x, y) - hi): x - hi.x
// is exact in f32, so hi + lo keeps about 16 bits of each
__device__ __forceinline__ void tc_split(float x, float y, uint32_t& hi,
                                         uint32_t& lo) {
  hi = tc_bf16x2(x, y);
  lo = tc_bf16x2(x - __uint_as_float(hi << 16),
                 y - __uint_as_float(hi & 0xffff0000u));
}

// B of S = Q K^T, k-step kd (D elements kd * 16 ..): K's keys are wgmma's
// N, D its K (K-major). Swizzled: region kd / 4, 32 bytes a k-step within
// its 128-byte rows, 8-row groups 1024 bytes apart
template <bool TMA>
__device__ __forceinline__ uint64_t tc_kdesc(const char* k, int kd) {
  return TMA ? wg_desc(k + kd / 4 * 8192 + kd % 4 * 32, 16, 1024, 1)
             : wg_desc(k + kd * 2 * TC_BK * 16, TC_BK * 16, 128, 0);
}

// B of O += P V, k-step kk (keys kk * 16 ..): V's keys are wgmma's K, D its
// N (MN-major). Swizzled: 8-key groups 1024 bytes apart, the regions of 64
// elements of D 8192 apart
template <bool TMA>
__device__ __forceinline__ uint64_t tc_vdesc(const char* v, int kk) {
  return TMA ? wg_desc(v + kk * 2048, 8192, 1024, 1)
             : wg_desc(v + kk * 256, 128, TC_BK * 16, 0);
}

// TMA: K and V tiles by TMA through the tensor maps tk / tv (D a multiple
// of 64, every stride and base 16-byte aligned), issued by a producer warp
// (warp 8) that runs up to TC_STAGES tiles ahead: a stage is refilled once
// all 8 consumer warps have released it (`empty`), and each warpgroup
// takes a tile as soon as it has landed (`full`), so the two warpgroups
// need not keep in step. Otherwise K and V by cp.async, issued by the
// consumers themselves, in step (one barrier a tile).
template <int D, bool TMA>
__global__ void __launch_bounds__(TC_THREADS + 32, 1)
    ring_attention_tc_kernel(RingArgs a, const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv) {
  using bf16 = __nv_bfloat16;
  using L = TcTiles<D>;
  constexpr int NT = TC_BK / 8;  // key n-tiles of S
  constexpr int DT = D / 8;      // d n-tiles of the output
  extern __shared__ unsigned char tc_raw[];
  __shared__ uint64_t full[TC_STAGES];   // TMA: stage st has landed
  __shared__ uint64_t empty[TC_STAGES];  // TMA: the consumers are done with st
  char* kvs = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(tc_raw) + 1023) & ~uintptr_t(1023));
  bf16* qs = reinterpret_cast<bf16*>(kvs + 2 * TC_STAGES * L::KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool consumer = threadIdx.x < TC_THREADS;
  const int bb = blockIdx.x / a.hkv, h = blockIdx.x % a.hkv;
  const int tile = gridDim.y - 1 - blockIdx.y;
  const int r = gridDim.z - 1 - blockIdx.z;
  const int tpt = TC_BQ / a.g;  // tokens a tile
  const int t0 = tile * tpt;
  const int t_end = min(a.s, t0 + tpt);

  const bf16* q = static_cast<const bf16*>(a.q) + r * a.q_sr + bb * a.q_sb;
  if (consumer) {
    tc_load_q<D>(qs, [&](int i) -> const bf16* {
      const int t = t0 + i / a.g;
      return t < a.s ? q + t * a.q_st +
                           static_cast<long long>(h * a.g + i % a.g) * a.q_sh
                     : nullptr;
    }, q);
    tc_commit();  // the q tile: the first cp.async group
  }
  if (TMA && threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < TC_STAGES; ++st) {
      tc_bar_init(&full[st], 1);
      tc_bar_init(&empty[st], TC_THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  TcTileWalk cur(r, a.n, a.s, t_end, a.causal), ld = cur;

  if (!consumer) {  // the producer warp
    if (TMA && lane == 0) {
      for (int j = 0; ld.valid(); ++j, ld.advance()) {
        const int st = j % TC_STAGES;
        if (j >= TC_STAGES) tc_bar_wait(&empty[st], (j / TC_STAGES + 1) & 1);
        char* ks = kvs + st * 2 * L::KV;
        tc_bar_expect(&full[st], 2 * L::KV);
#pragma unroll
        for (int rg = 0; rg < D / 64; ++rg) {
          tc_tma(ks + rg * 8192, &tk, &full[st], rg * 64, h, ld.k0, bb, ld.src);
          tc_tma(ks + L::KV + rg * 8192, &tv, &full[st], rg * 64, h, ld.k0, bb,
                 ld.src);
        }
      }
    }
    return;
  }

  // cp.async: a tile's K and V into stage `stage` by the consumers (a commit
  // group each, empty past the end)
  auto load_kv = [&](int stage, const TcTileWalk& w) {
    char* ks = kvs + stage * 2 * L::KV;
    if (w.valid()) {
      const bf16* kb = static_cast<const bf16*>(a.k) + w.src * a.k_sr +
                       bb * a.k_sb + h * a.k_sh;
      const bf16* vb = static_cast<const bf16*>(a.v) + w.src * a.v_sr +
                       bb * a.v_sb + h * a.v_sh;
      tc_load_kv<D>(ks, [&](int j) -> const bf16* {
        return w.k0 + j < w.kend ? kb + static_cast<long long>(w.k0 + j) * a.k_st
                                 : nullptr;
      }, kb);
      tc_load_kv<D>(ks + L::KV, [&](int j) -> const bf16* {
        return w.k0 + j < w.kend ? vb + static_cast<long long>(w.k0 + j) * a.v_st
                                 : nullptr;
      }, vb);
    }
    tc_commit();
  };
  if (!TMA) {  // the first TC_STAGES - 1 tiles in flight
#pragma unroll
    for (int p = 0; p < TC_STAGES - 1; ++p) {
      load_kv(p, ld);
      ld.advance();
    }
  }

  // this thread's rows of the S and output fragments: rg and rg + 8 (warp
  // w holds rows 16w .. 16w + 15, the 16 of its warpgroup's 64 that
  // wgmma gives it)
  const int rg = warp * 16 + (lane >> 2), c2 = 2 * (lane & 3);
  const int tq0 = t0 + rg / a.g, tq1 = t0 + (rg + 8) / a.g;
  const float sl2 = a.scale * 1.4426950408889634f;  // scale * log2(e)
  float m0 = -INFINITY, m1 = -INFINITY;  // row max of the raw scores
  float l0 = 0.f, l1 = 0.f;              // this thread's part of the sums
  float o[D / 2], sc[NT * 4];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
#pragma unroll
  for (int j = 0; j < NT * 4; ++j) sc[j] = 0.f;
  // the q tile (the oldest cp.async group), seen by every consumer
  if (TMA)
    tc_wait_landed<0>();
  else
    tc_wait_landed<TC_STAGES - 1>();
  tc_consumer_sync();
  for (int it = 0, stage = 0; cur.valid();
       ++it, stage = (stage + 1) % TC_STAGES) {
    if (TMA) {
      tc_bar_wait(&full[stage], it / TC_STAGES & 1);
    } else {
      // the current tile has landed, and every warp is done with the stage
      // the previous tile used, which the tile TC_STAGES - 1 ahead now fills
      tc_wait_landed<TC_STAGES - 2>();
      tc_consumer_sync();
      load_kv((stage + TC_STAGES - 1) % TC_STAGES, ld);
      ld.advance();
    }
    const int src = cur.src, k0 = cur.k0, kend = cur.kend;
    const char* ks = kvs + stage * 2 * L::KV;

    // S = Q K^T, Q's A fragments read from shared memory each tile (not
    // held across tiles: ptxas 12.9 gave some of their registers to P)
    uint32_t qf[D / 16][4];
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      tc_ldsm_x4(qf[kd], qs + (warp * 16 + (lane & 15)) * L::LDQ + kd * 16 +
                             (lane >> 4) * 8);
    wg_pin(sc);
    wg_fence();
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      wg_s(sc, qf[kd], tc_kdesc<TMA>(ks, kd), kd > 0);
    wg_commit_wait(sc);
    // the mask, only where the tile crosses the keys' end or the diagonal
    const bool diag = a.causal && src == r;
    if (k0 + TC_BK > kend || (diag && k0 + TC_BK - 1 > t0)) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + c2 + e;
          if (key >= kend || (diag && key > tq0)) sc[4 * j + e] = -INFINITY;
          if (key >= kend || (diag && key > tq1)) sc[4 * j + 2 + e] = -INFINITY;
        }
    }
    // the online softmax on the fragments
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int sh = 1; sh < 4; sh <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
    }
    const float b0 = mx0 == -INFINITY ? 0.f : mx0 * sl2;
    const float b1 = mx1 == -INFINITY ? 0.f : mx1 * sl2;
    const float al0 = exp2f(m0 * sl2 - b0), al1 = exp2f(m1 * sl2 - b1);
    m0 = mx0;
    m1 = mx1;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = exp2f(fmaf(sc[4 * j + e], sl2, -b0));
        sc[4 * j + 2 + e] = exp2f(fmaf(sc[4 * j + 2 + e], sl2, -b1));
        s0 += sc[4 * j + e];
        s1 += sc[4 * j + 2 + e];
      }
    l0 = l0 * al0 + s0;
    l1 = l1 * al1 + s1;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o[4 * j] *= al0;
      o[4 * j + 1] *= al0;
      o[4 * j + 2] *= al1;
      o[4 * j + 3] *= al1;
    }
    // O += P_hi V + P_lo V; the A fragment of 16 keys is the S fragments
    // of two key n-tiles
    uint32_t ph[TC_BK / 16][4], pl[TC_BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f)
        tc_split(sc[8 * kk + 2 * f], sc[8 * kk + 2 * f + 1], ph[kk][f],
                 pl[kk][f]);
    wg_pin(o);
    wg_pin(ph);
    wg_pin(pl);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      const uint64_t vd = tc_vdesc<TMA>(ks + L::KV, kk);
      wg_pv(o, ph[kk], vd, 1);
      wg_pv(o, pl[kk], vd, 1);
    }
    wg_commit_wait(o);
    if (TMA) {  // this warp is done with the stage
      __syncwarp();
      if (lane == 0) tc_bar_arrive(&empty[stage]);
    }
    cur.advance();
  }

  // the sums over the 4 lanes of a row, then out = acc / max(l, 1e-30)
#pragma unroll
  for (int sh = 1; sh < 4; sh <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
    l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
  }
  bf16* out = static_cast<bf16*>(a.out) + r * a.o_sr + bb * a.o_sb;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = rg + 8 * half;
    const int t = t0 + i / a.g;
    if (t >= t_end) continue;
    const float den = fmaxf(half ? l1 : l0, 1e-30f);
    if (a.lse != nullptr && (lane & 3) == 0)
      a.lse[((static_cast<long long>(r) * a.b + bb) * a.s + t) * a.hkv * a.g +
            h * a.g + i % a.g] = (half ? m1 : m0) * a.scale + logf(den);
    bf16* row = out + t * a.o_st +
                static_cast<long long>(h * a.g + i % a.g) * a.o_sh;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + c2) =
          __floats2bfloat162_rn(o[4 * j + 2 * half] / den,
                                o[4 * j + 2 * half + 1] / den);
  }
}

// the (n, B, S, Hkv, D) bf16 view at `base` with element strides st[0..3]
// (Hkv, S, B, n) as a TMA map of boxes of 64 x 1 x 64 x 1 x 1 in the
// 128-byte swizzle; false where TMA cannot take it (a base or stride not
// 16-byte aligned, D not a multiple of 64)
bool tc_map(CUtensorMap* map, const void* base, int n, int b, int s, int hkv,
            int d, const long long st[4]) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tc_encoder();
  if (encode == nullptr) return false;
  if (d % 64 != 0 || reinterpret_cast<uintptr_t>(base) % 16 != 0) return false;
  cuuint64_t dims[5] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(hkv),
                        static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(b),
                        static_cast<cuuint64_t>(n)};
  cuuint64_t strides[4];
  for (int i = 0; i < 4; ++i) {
    if (st[i] <= 0 || st[i] * 2 % 16 != 0) return false;
    strides[i] = static_cast<cuuint64_t>(st[i] * 2);
  }
  cuuint32_t box[5] = {64, 1, TC_BK, 1, 1}, one[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
                const_cast<void*>(base), dims, strides, box, one,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool TMA>
int ring_tc_launch(const RingArgs& a, const CUtensorMap& tk,
                   const CUtensorMap& tv, cudaStream_t s) {
  constexpr int bytes = TcTiles<D>::bytes;
  static bool attr = false;  // above 48 KB only after this, once a kernel
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        ring_attention_tc_kernel<D, TMA>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const dim3 grid(a.b * a.hkv, (a.s * a.g + TC_BQ - 1) / TC_BQ, a.n);
  ring_attention_tc_kernel<D, TMA><<<grid, TC_THREADS + 32, bytes, s>>>(a, tk,
                                                                    tv);
  return static_cast<int>(cudaGetLastError());
}

// TMA where both K and V take it (D 64 or 128), cp.async otherwise; the
// variant launched lands in *variant (RING_TMA or RING_CP_ASYNC)
int ring_tc_dispatch(const RingArgs& a, int d, int* variant, cudaStream_t s) {
  CUtensorMap tk, tv;
  const long long ks[4] = {a.k_sh, a.k_st, a.k_sb, a.k_sr};
  const long long vs[4] = {a.v_sh, a.v_st, a.v_sb, a.v_sr};
  const bool tma = tc_map(&tk, a.k, a.n, a.b, a.s, a.hkv, d, ks) &&
                   tc_map(&tv, a.v, a.n, a.b, a.s, a.hkv, d, vs);
  *variant = tma ? RING_TMA : RING_CP_ASYNC;
  switch (d) {
    case 16: return ring_tc_launch<16, false>(a, tk, tv, s);
    case 32: return ring_tc_launch<32, false>(a, tk, tv, s);
    case 64:
      return tma ? ring_tc_launch<64, true>(a, tk, tv, s)
                 : ring_tc_launch<64, false>(a, tk, tv, s);
    case 128:
      return tma ? ring_tc_launch<128, true>(a, tk, tv, s)
                 : ring_tc_launch<128, false>(a, tk, tv, s);
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

// q, k, v, out: rank 0's blocks of the stacked (n, B, S, H, D) views, with
// their strides in elements (rank, batch, token, head); *variant: the kernel
// launched (RING_FMA, RING_CP_ASYNC or RING_TMA)
extern "C" int tdt_ring_attention(
    const void* q, const void* k, const void* v, void* out, void* lse, int n,
    int b, int s, int hkv, int g, int d, int causal, float scale,
    long long q_sr, long long q_sb, long long q_st, long long q_sh,
    long long k_sr, long long k_sb, long long k_st, long long k_sh,
    long long v_sr, long long v_sb, long long v_st, long long v_sh,
    long long o_sr, long long o_sb, long long o_st, long long o_sh, int dtype,
    int* variant, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  const int rows = dtype == TDT_BF16 ? TC_BQ : RA_BQ;  // q rows a CTA
  if (n < 1 || g < 1 || rows % g != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0 || s <= 0 || hkv <= 0) return 0;
  RingArgs a{q, k, v, out, static_cast<float*>(lse), n, b, s, hkv, g,
             causal, scale, q_sr, q_sb, q_st, q_sh, k_sr, k_sb, k_st, k_sh,
             v_sr, v_sb, v_st, v_sh, o_sr, o_sb, o_st, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == TDT_BF16) return ring_tc_dispatch(a, d, variant, st);
  *variant = RING_FMA;
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
