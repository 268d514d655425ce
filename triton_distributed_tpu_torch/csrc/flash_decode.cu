// Flash-decode: one new query token per batch row attends over its KV
// cache (GQA: G query heads share a KV head), returning the softmax
// output and its log-sum-exp, the (out, lse) partial that decode merges
// with the new token's own partial.
//
// Replaces triton_distributed_tpu/kernels/flash_decode.py:
//   * _decode_kernel (:51), _decode_kernel_dyn (:144) and
//     _decode_kernel_dyn_mh (:331): a contiguous cache. tdt_flash_decode
//     walks it through (b, h, s) strides, so (B, Hkv, S, D) and
//     (B, S, Hkv, D) are both views;
//   * _paged_decode_kernel (:1005) and _paged_kernel_dyn_mh (:470): a
//     (npages, Hkv, page, D) page pool read through a (B, pps) block
//     table. tdt_paged_decode.
// Both entries run one device function, decode_body, and differ only in
// where position p of a row lives (StridedWalk, PagedWalk). K/V are f32,
// bf16, or int8 with f32 per-position scales; int8 folds the scales
// exactly: k_scale per column into the scores, v_scale into p for the PV
// product only (l sums the unscaled p), as the TPU kernels do. p is
// rounded to V's type before the PV product (bf16 for bf16 and int8
// caches), also as on the TPU.
//
// What bounds it on an H100: decode reads every valid K/V row once and
// does 4·D operations per (query head, position), so it is bound by
// device memory (B = 8, Hkv = 32, D = 128, bf16, mean length ≈ 600:
// ≈ 80 MB a layer, ≈ 24 µs at 3.35 TB/s).
//
// Design (right and simple first): one block of 128 threads per (batch
// row, KV head); the trip count is the row's true length clamped to the
// cache's capacity, as on the TPU (:197-202, :495). The walk goes in
// tiles of TK = 64 positions, the same for both layouts, so a contiguous
// cache and its paged copy sum in the same order and give equal outputs.
// Each tile's K and V rows (and scales) are staged into shared memory
// with cp.async while the previous tile computes (two buffers); rows are
// padded by 16 bytes, which keeps the 16-byte row reads free of bank
// conflicts. Per tile: the scores (thread = position x half of the 16-
// byte chunks of its row), an online-softmax update per query head (a
// warp each), then the PV product (thread = output element). Positions
// past the length are zero-filled and masked, p included, so an empty
// row gives out = 0 and lse = NEG_INF (:117-124, :137-141). Split-KV,
// TMA and tensor cores are later work.

#include <type_traits>

#include "tdt_common.cuh"

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr int TK = 64;         // KV positions per tile
constexpr int THREADS = 128;   // 2 threads a position in the scores
constexpr int MAXE = 16;       // output elements a thread: G * D <= 2048
constexpr int ROW_PAD = 16;    // bytes after each staged row

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// acc + q[0:n] . (the n elements of one 16-byte chunk of a K row)
template <typename KT>
__device__ __forceinline__ float chunk_dot(const float* q, const uint4& raw,
                                           float acc);

template <>
__device__ __forceinline__ float chunk_dot<float>(const float* q,
                                                  const uint4& raw,
                                                  float acc) {
  const float4 qv = *reinterpret_cast<const float4*>(q);
  const float* k = reinterpret_cast<const float*>(&raw);
  acc = fmaf(qv.x, k[0], acc);
  acc = fmaf(qv.y, k[1], acc);
  acc = fmaf(qv.z, k[2], acc);
  return fmaf(qv.w, k[3], acc);
}

template <>
__device__ __forceinline__ float chunk_dot<__nv_bfloat16>(const float* q,
                                                          const uint4& raw,
                                                          float acc) {
  const __nv_bfloat162* k = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float4 qv = *reinterpret_cast<const float4*>(q + 4 * i);
    const float2 a = __bfloat1622float2(k[2 * i]);
    const float2 b = __bfloat1622float2(k[2 * i + 1]);
    acc = fmaf(qv.x, a.x, acc);
    acc = fmaf(qv.y, a.y, acc);
    acc = fmaf(qv.z, b.x, acc);
    acc = fmaf(qv.w, b.y, acc);
  }
  return acc;
}

template <>
__device__ __forceinline__ float chunk_dot<int8_t>(const float* q,
                                                   const uint4& raw,
                                                   float acc) {
  const int8_t* k = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 qv = *reinterpret_cast<const float4*>(q + 4 * i);
    acc = fmaf(qv.x, static_cast<float>(k[4 * i]), acc);
    acc = fmaf(qv.y, static_cast<float>(k[4 * i + 1]), acc);
    acc = fmaf(qv.z, static_cast<float>(k[4 * i + 2]), acc);
    acc = fmaf(qv.w, static_cast<float>(k[4 * i + 3]), acc);
  }
  return acc;
}

// p as the PV product takes it: V's type (bf16 for int8 V, which the TPU
// widens to bf16), f32 for an f32 cache
template <typename KT>
__device__ __forceinline__ float round_p(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <>
__device__ __forceinline__ float round_p<float>(float x) {
  return x;
}

// what every block needs, whatever the layout
struct Common {
  const void* q;      // (B, Hkv * G, D) contiguous, f32 or bf16
  int q_bf16;
  const int* kv_lens;  // (B,)
  void* out;           // (B, Hkv * G, D) contiguous
  float* lse;          // (B, Hkv * G)
  int hkv, g, d;
  int cap;             // positions a row can hold
  float scale, soft_cap;
};

// contiguous cache: position p of (b, h) at byte offset p * ss * elem
// from the (b, h) base; its scales at element p * scs
struct StridedArgs {
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  int sb, sh, ss;      // K/V strides in elements
  int scb, sch, scs;   // scale strides in elements
};

struct StridedWalk {
  const char* k;
  const char* v;
  const float* ks;
  const float* vs;
  long long s_bytes;
  long long sc_stride;
  __device__ __forceinline__ long long row_off(int p) const {
    return p * s_bytes;
  }
  __device__ __forceinline__ long long sc_off(int p) const {
    return p * sc_stride;
  }
};

// page pool: position p of row b lives in page table[b, p / page] (clamped
// into the pool, :503) at offset p % page
struct PagedArgs {
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* table;    // (B, pps)
  int pps, npages, page;
};

struct PagedWalk {
  const char* k;
  const char* v;
  const float* ks;
  const float* vs;
  const int* table;    // this row's pps entries
  int h, hkv, page, npages;
  long long row_bytes;
  __device__ __forceinline__ long long slot(int p) const {
    const int pid = min(max(table[p / page], 0), npages - 1);
    return (static_cast<long long>(pid) * hkv + h) * page + p % page;
  }
  __device__ __forceinline__ long long row_off(int p) const {
    return slot(p) * row_bytes;
  }
  __device__ __forceinline__ long long sc_off(int p) const { return slot(p); }
};

__host__ __device__ inline size_t smem_bytes(int g, int d, int elem) {
  const size_t rb = static_cast<size_t>(d) * elem + ROW_PAD;
  return 4 * TK * rb +
         (4 * TK + static_cast<size_t>(g) * d + 3 * g * TK + 3 * g) *
             sizeof(float);
}

template <typename KT, typename OT, typename Walk>
__device__ void decode_body(const Common& c, const Walk& w, int b, int h) {
  constexpr bool QUANT = std::is_same<KT, int8_t>::value;
  constexpr int EPC = 16 / sizeof(KT);  // elements in a 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = c.g, D = c.d, GD = G * D;
  const int nch = D * static_cast<int>(sizeof(KT)) / 16;
  const int rb = D * static_cast<int>(sizeof(KT)) + ROW_PAD;
  unsigned char* kbuf = smem;                  // [2][TK][rb]
  unsigned char* vbuf = kbuf + 2 * TK * rb;    // [2][TK][rb]
  float* kss = reinterpret_cast<float*>(vbuf + 2 * TK * rb);  // [2][TK]
  float* vss = kss + 2 * TK;                   // [2][TK]
  float* qs = vss + 2 * TK;                    // [G][D]
  float* sp = qs + GD;                         // [2][G][TK] half scores
  float* sc = sp + 2 * G * TK;                 // [G][TK] scores, then p
  float* m_s = sc + G * TK;                    // [G] running max
  float* l_s = m_s + G;                        // [G] running sum
  float* a_s = l_s + G;                        // [G] this tile's rescale

  const size_t head0 = (static_cast<size_t>(b) * c.hkv + h) * G;
  OT* out = static_cast<OT*>(c.out) + head0 * D;
  const int len = min(max(c.kv_lens[b], 0), c.cap);
  if (len == 0) {
    for (int e = tid; e < GD; e += THREADS) out[e] = tdt_from_f<OT>(0.f);
    if (tid < G) c.lse[head0 + tid] = NEG_INF;
    return;
  }
  for (int e = tid; e < GD; e += THREADS)
    qs[e] = c.q_bf16
                ? __bfloat162float(
                      static_cast<const __nv_bfloat16*>(c.q)[head0 * D + e])
                : static_cast<const float*>(c.q)[head0 * D + e];
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  auto issue = [&](int t) {  // stage tile t into buffer t & 1
    const int buf = t & 1, p0 = t * TK;
    unsigned char* kb = kbuf + buf * TK * rb;
    unsigned char* vb = vbuf + buf * TK * rb;
    for (int i = tid; i < TK * nch; i += THREADS) {
      const int j = i / nch, ch = i - j * nch, p = p0 + j;
      const bool ok = p < len;
      const long long off = (ok ? w.row_off(p) : 0) + 16 * ch;
      cp_async16(kb + j * rb + 16 * ch, w.k + off, ok ? 16 : 0);
      cp_async16(vb + j * rb + 16 * ch, w.v + off, ok ? 16 : 0);
    }
    if (QUANT) {
      for (int j = tid; j < TK; j += THREADS) {
        const int p = p0 + j;
        const bool ok = p < len;
        const long long off = ok ? w.sc_off(p) : 0;
        cp_async4(kss + buf * TK + j, w.ks + off, ok ? 4 : 0);
        cp_async4(vss + buf * TK + j, w.vs + off, ok ? 4 : 0);
      }
    }
    cp_commit();
  };

  float acc[MAXE];
#pragma unroll
  for (int i = 0; i < MAXE; ++i) acc[i] = 0.f;

  const int nt = (len + TK - 1) / TK;
  issue(0);
  for (int t = 0; t < nt; ++t) {
    if (t + 1 < nt) {
      issue(t + 1);  // in flight while this tile computes
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int buf = t & 1, p0 = t * TK;
    const unsigned char* kb = kbuf + buf * TK * rb;
    const unsigned char* vb = vbuf + buf * TK * rb;

    {  // half scores: position j, chunks ch = half, half + 2, ...
      const int j = tid % TK, half = tid / TK;
      const unsigned char* kr = kb + j * rb;
      for (int gg = 0; gg < G; ++gg) {
        const float* qg = qs + gg * D;
        float part = 0.f;
        for (int ch = half; ch < nch; ch += 2)
          part = chunk_dot<KT>(qg + ch * EPC,
                               *reinterpret_cast<const uint4*>(kr + 16 * ch),
                               part);
        sp[(half * G + gg) * TK + j] = part;
      }
    }
    __syncthreads();
    // scores: (q . k) * scale, the k scale, the soft cap, the length mask
    for (int e = tid; e < G * TK; e += THREADS) {
      const int j = e % TK;
      float s = (sp[e] + sp[G * TK + e]) * c.scale;
      if (QUANT) s *= kss[buf * TK + j];
      if (c.soft_cap > 0.f) s = c.soft_cap * tanhf(s / c.soft_cap);
      sc[e] = p0 + j < len ? s : NEG_INF;
    }
    __syncthreads();
    // online softmax, a warp per query head; p (times the v scale) goes
    // back into the score row, rounded as the PV product takes it
    for (int gg = warp; gg < G; gg += THREADS / 32) {
      float* row = sc + gg * TK;
      const float s0 = row[lane], s1 = row[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[gg];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      const float e0 = p0 + lane < len ? expf(s0 - m_new) : 0.f;
      const float e1 = p0 + lane + 32 < len ? expf(s1 - m_new) : 0.f;
      float sum = e0 + e1;
#pragma unroll
      for (int o = 16; o; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      float w0 = e0, w1 = e1;
      if (QUANT) {
        w0 *= vss[buf * TK + lane];
        w1 *= vss[buf * TK + lane + 32];
      }
      row[lane] = round_p<KT>(w0);
      row[lane + 32] = round_p<KT>(w1);
      if (lane == 0) {
        l_s[gg] = alpha * l_s[gg] + sum;
        m_s[gg] = m_new;
        a_s[gg] = alpha;
      }
    }
    __syncthreads();
    // PV: thread owns output elements e = tid + 128 i
#pragma unroll
    for (int i = 0; i < MAXE; ++i) {
      const int e = tid + i * THREADS;
      if (e < GD) {
        const int gg = e / D, dd = e - gg * D;
        const float* prow = sc + gg * TK;
        const unsigned char* vc = vb + dd * sizeof(KT);
        float dot = 0.f;
#pragma unroll 8
        for (int j = 0; j < TK; ++j)
          dot = fmaf(prow[j],
                     tdt_to_f<KT>(*reinterpret_cast<const KT*>(vc + j * rb)),
                     dot);
        acc[i] = a_s[gg] * acc[i] + dot;
      }
    }
    __syncthreads();  // before the next issue refills this buffer
  }

#pragma unroll
  for (int i = 0; i < MAXE; ++i) {
    const int e = tid + i * THREADS;
    if (e < GD) {
      const float l = l_s[e / D];
      out[e] = tdt_from_f<OT>(acc[i] / (l > 0.f ? l : 1.f));
    }
  }
  if (tid < G) {
    const float l = l_s[tid];
    c.lse[head0 + tid] = l > 0.f ? m_s[tid] + logf(l) : NEG_INF;
  }
}

template <typename KT, typename OT>
__global__ void __launch_bounds__(THREADS)
strided_kernel(Common c, StridedArgs a) {
  const int h = blockIdx.x, b = blockIdx.y;
  const long long elem = sizeof(KT);
  const long long base = (static_cast<long long>(b) * a.sb +
                          static_cast<long long>(h) * a.sh) * elem;
  const long long sbase = static_cast<long long>(b) * a.scb +
                          static_cast<long long>(h) * a.sch;
  StridedWalk w{static_cast<const char*>(a.k) + base,
                static_cast<const char*>(a.v) + base,
                a.ks ? a.ks + sbase : nullptr,
                a.vs ? a.vs + sbase : nullptr,
                a.ss * elem, a.scs};
  decode_body<KT, OT>(c, w, b, h);
}

template <typename KT, typename OT>
__global__ void __launch_bounds__(THREADS)
paged_kernel(Common c, PagedArgs a) {
  const int h = blockIdx.x, b = blockIdx.y;
  PagedWalk w{static_cast<const char*>(a.k), static_cast<const char*>(a.v),
              a.ks, a.vs, a.table + static_cast<size_t>(b) * a.pps,
              h, c.hkv, a.page, a.npages,
              static_cast<long long>(c.d) * sizeof(KT)};
  decode_body<KT, OT>(c, w, b, h);
}

template <typename KT, typename OT, typename Args>
int launch(void (*k)(Common, Args), const Common& c, const Args& a, int batch,
           cudaStream_t s) {
  const size_t smem = smem_bytes(c.g, c.d, sizeof(KT));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  k<<<dim3(c.hkv, batch), THREADS, smem, s>>>(c, a);
  return static_cast<int>(cudaGetLastError());
}

// the (KV type, out type) instantiation of the kernel for Args
#define TDT_FD_DISPATCH(KERNEL)                                              \
  if (kv_dtype == TDT_BF16 && out_dtype == TDT_BF16)                         \
    return launch<__nv_bfloat16, __nv_bfloat16>(                             \
        KERNEL<__nv_bfloat16, __nv_bfloat16>, c, a, batch, s);               \
  if (kv_dtype == TDT_BF16 && out_dtype == TDT_F32)                          \
    return launch<__nv_bfloat16, float>(KERNEL<__nv_bfloat16, float>, c, a,  \
                                        batch, s);                           \
  if (kv_dtype == TDT_F32 && out_dtype == TDT_BF16)                          \
    return launch<float, __nv_bfloat16>(KERNEL<float, __nv_bfloat16>, c, a,  \
                                        batch, s);                           \
  if (kv_dtype == TDT_F32 && out_dtype == TDT_F32)                           \
    return launch<float, float>(KERNEL<float, float>, c, a, batch, s);       \
  if (kv_dtype == TDT_I8 && out_dtype == TDT_BF16)                           \
    return launch<int8_t, __nv_bfloat16>(KERNEL<int8_t, __nv_bfloat16>, c,   \
                                         a, batch, s);                       \
  if (kv_dtype == TDT_I8 && out_dtype == TDT_F32)                            \
    return launch<int8_t, float>(KERNEL<int8_t, float>, c, a, batch, s);     \
  return static_cast<int>(cudaErrorInvalidValue)

int check_geometry(int batch, int hkv, int g, int d, int kv_dtype) {
  const int elem = kv_dtype == TDT_F32 ? 4 : kv_dtype == TDT_BF16 ? 2 : 1;
  if (batch < 0 || hkv <= 0 || g <= 0 || d <= 0 || g * d > MAXE * THREADS ||
      (d * elem) % 16 || d * elem > 512)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

extern "C" {

// q: (B, Hkv * G, D), q_dtype TDT_F32 / TDT_BF16; k, v: KV_DTYPE
// (TDT_F32, TDT_BF16 or TDT_I8 with f32 scales ks, vs) at element
// strides (sb, sh, ss) for (batch, head, position); scales at (scb, sch,
// scs); out (B, Hkv * G, D) in out_dtype; lse (B, Hkv * G) f32.
int tdt_flash_decode(const void* q, const void* k, const void* v,
                     const void* ks, const void* vs, const void* kv_lens,
                     void* out, void* lse, int batch, int hkv, int g, int d,
                     int cap, int sb, int sh, int ss, int scb, int sch,
                     int scs, float scale, float soft_cap, int q_dtype,
                     int kv_dtype, int out_dtype, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (int rc = check_geometry(batch, hkv, g, d, kv_dtype)) return rc;
  if (batch == 0) return 0;
  Common c{q, q_dtype == TDT_BF16, static_cast<const int*>(kv_lens), out,
           static_cast<float*>(lse), hkv, g, d, cap, scale, soft_cap};
  StridedArgs a{k, v, static_cast<const float*>(ks),
                static_cast<const float*>(vs), sb, sh, ss, scb, sch, scs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TDT_FD_DISPATCH(strided_kernel);
}

// k_pool, v_pool: (npages, Hkv, page, D) in KV_DTYPE, scales (npages,
// Hkv, page) f32 for int8; table (B, pps) int32; the rest as above.
int tdt_paged_decode(const void* q, const void* k_pool, const void* v_pool,
                     const void* ks, const void* vs, const void* kv_lens,
                     const void* table, void* out, void* lse, int batch,
                     int hkv, int g, int d, int pps, int npages, int page,
                     float scale, float soft_cap, int q_dtype, int kv_dtype,
                     int out_dtype, void* stream) {
  cudaGetLastError();
  if (int rc = check_geometry(batch, hkv, g, d, kv_dtype)) return rc;
  if (page <= 0 || pps <= 0 || npages <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  Common c{q, q_dtype == TDT_BF16, static_cast<const int*>(kv_lens), out,
           static_cast<float*>(lse), hkv, g, d, pps * page, scale, soft_cap};
  PagedArgs a{k_pool, v_pool, static_cast<const float*>(ks),
              static_cast<const float*>(vs), static_cast<const int*>(table),
              pps, npages, page};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TDT_FD_DISPATCH(paged_kernel);
}

}  // extern "C"
