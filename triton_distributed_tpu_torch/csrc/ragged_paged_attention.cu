// Ragged paged attention: mixed prefill-chunk and decode rows, one launch.
//
// Replaces triton_distributed_tpu/kernels/ragged_paged_attention.py
// _ragged_kernel (:216). Layout (kept from the TPU kernel):
//   q, out   (Hkv, T*G, D)  GQA rows; row r's tokens occupy rows
//            [q_starts[r]*G, (q_starts[r]+q_lens[r])*G) of dim 1
//   pools    (npages, Hkv, page, D), int8 with (npages, Hkv, page) f32
//            scales, or in q's type
//   table    (R, pps) pool page ids (clamped into [0, npages), -1 too)
//   topo     optional (R, 2+2W) row descriptors [kind, aux, anc[W], ...]
//   lse      (Hkv, T*G) f32: m + log(l), or -1e30 where nothing is seen
// Row kinds: CAUSAL and SHARED_PREFIX mask pos < kv_len - q_len + t + 1;
// TREE sees pos < kv_len with positions at or past kv_len - q_len only
// through the ancestor bitmask anc[t]; CP sees pos < kv_len and
// pos < limit + aux. A q_len == 0 row writes nothing.
//
// What bounds it on an H100: a decode row reads its whole KV walk for
// one query token (bytes); a prefill chunk reuses each page for up to
// block_q * G query rows and is bound by the softmax and dot arithmetic.
//
// Design (right and simple first). Grid (query tile, kv head, row):
// the TPU's sequential grid over rows, with its cross-row prefetch and
// out-DMA "self-heal" ordering, becomes independent blocks, so every
// store is masked to the row's own span and never races another row.
// A block holds 16 query rows (4 warps x 4 rows); each lane owns D/32
// dims of q and of the f32 accumulator. The block walks its row's pages
// through the block table, staging each page's K and V (and the int8
// scales) in shared memory as f32, and stops at the last page any of its
// query rows can see (the causal frontier of its last token). Scores
// are a warp reduction per position; the online softmax runs in f32 and
// the int8 scales fold exactly into the score (s * k_scale) and into p
// (p * v_scale), as on the TPU. Tensor cores, double-buffered staging and
// split-KV for long decode walks are later work.

#include <type_traits>

#include "tdt_common.cuh"

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr int TOPO_TREE = 1;
constexpr int TOPO_CP = 3;
constexpr int WARPS = 4;
constexpr int RPW = 4;               // query rows per warp
constexpr int BQ = WARPS * RPW;      // query rows per block
constexpr int THREADS = WARPS * 32;

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* kv_lens;
  const int* q_lens;
  const int* q_starts;
  const int* table;
  const int* topo;
  void* out;
  float* lse;
  int pps, npages, hkv, g, d, page, tg, topo_w;
  float scale, soft_cap;
};

template <typename QT, typename KT, int DPL>
__global__ void __launch_bounds__(THREADS) ragged_kernel(Args a) {
  extern __shared__ float smem[];
  constexpr bool QUANT = std::is_same<KT, int8_t>::value;
  const int d = a.d, page = a.page, g = a.g;
  float* ks = smem;                  // page * d
  float* vs = ks + page * d;         // page * d
  float* kss = vs + page * d;        // page (int8 scales)
  float* vss = kss + page;           // page

  const int r = blockIdx.z, h = blockIdx.y;
  const int q_len = a.q_lens[r];
  const int nrows = q_len * g;
  const int row0 = blockIdx.x * BQ;
  if (q_len <= 0 || row0 >= nrows) return;  // uniform over the block
  const int kv_len = a.kv_lens[r];
  const int q_start = a.q_starts[r];
  const int base = kv_len - q_len;
  const int tw2 = 2 + 2 * a.topo_w;
  int kind = 0, aux = 0;
  if (a.topo != nullptr) {
    kind = a.topo[r * tw2];
    aux = a.topo[r * tw2 + 1];
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const QT* __restrict__ q = static_cast<const QT*>(a.q);
  const size_t head_rows = static_cast<size_t>(h) * a.tg;

  float qv[RPW][DPL], acc[RPW][DPL], m[RPW], l[RPW];
  int lim[RPW];
  unsigned anc[RPW];
  bool act[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int ri = row0 + warp * RPW + i;
    act[i] = ri < nrows;
    const int t = ri / g;
    lim[i] = base + t + 1;
    anc[i] = (kind == TOPO_TREE && t < a.topo_w && act[i])
                 ? static_cast<unsigned>(a.topo[r * tw2 + 2 + t])
                 : 0u;
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int dd = lane + 32 * c;
      acc[i][c] = 0.f;
      qv[i][c] = (act[i] && dd < d)
                     ? tdt_to_f<QT>(q[(head_rows + static_cast<size_t>(q_start) * g + ri) * d + dd])
                     : 0.f;
    }
  }

  // the block's walk: the row's ceil(kv_len/page) pages (at least one,
  // at most pps), cut at the last position any of its query rows sees
  const int last_t = (min(row0 + BQ, nrows) - 1) / g;
  int hi = kv_len;
  if (kind == TOPO_CP)
    hi = min(kv_len, base + last_t + 1 + aux);
  else if (kind != TOPO_TREE)
    hi = min(kv_len, base + last_t + 1);
  const int nb = min(max((kv_len + page - 1) / page, 1), a.pps);
  const int walk = min(nb, (max(hi, 0) + page - 1) / page);

  const KT* __restrict__ kpool = static_cast<const KT*>(a.k_pool);
  const KT* __restrict__ vpool = static_cast<const KT*>(a.v_pool);
  for (int j = 0; j < walk; ++j) {
    int pid = a.table[r * a.pps + j];
    pid = min(max(pid, 0), a.npages - 1);
    const size_t off = (static_cast<size_t>(pid) * a.hkv + h) * page;
    __syncthreads();  // the previous page is consumed
    for (int idx = threadIdx.x; idx < page * d; idx += THREADS) {
      ks[idx] = tdt_to_f<KT>(kpool[off * d + idx]);
      vs[idx] = tdt_to_f<KT>(vpool[off * d + idx]);
    }
    if (QUANT) {
      for (int idx = threadIdx.x; idx < page; idx += THREADS) {
        kss[idx] = a.k_scale[off + idx];
        vss[idx] = a.v_scale[off + idx];
      }
    }
    __syncthreads();
    const int pos0 = j * page;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      if (!act[i]) continue;
      for (int jj = 0; jj < page; ++jj) {
        const int pos = pos0 + jj;
        bool valid;
        if (kind == TOPO_TREE) {
          const int rel = pos - base;
          valid = pos < kv_len &&
                  (rel < 0 || ((anc[i] >> min(rel, 31)) & 1u));
        } else if (kind == TOPO_CP) {
          valid = pos < kv_len && pos < lim[i] + aux;
        } else {
          valid = pos < lim[i];
        }
        if (!valid) continue;  // uniform over the warp
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          const int dd = lane + 32 * c;
          if (dd < d) part = fmaf(qv[i][c], ks[jj * d + dd], part);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        float s = part * a.scale;
        if (QUANT) s = s * kss[jj];
        if (a.soft_cap > 0.f) s = a.soft_cap * tanhf(s / a.soft_cap);
        const float mn = fmaxf(m[i], s);
        const float alpha = expf(m[i] - mn);
        const float p = expf(s - mn);
        l[i] = l[i] * alpha + p;
        const float pv = QUANT ? p * vss[jj] : p;
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          const int dd = lane + 32 * c;
          if (dd < d) acc[i][c] = fmaf(pv, vs[jj * d + dd], acc[i][c] * alpha);
        }
        m[i] = mn;
      }
    }
  }

  QT* __restrict__ out = static_cast<QT*>(a.out);
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    if (!act[i]) continue;
    const int ri = row0 + warp * RPW + i;
    const size_t row = head_rows + static_cast<size_t>(q_start) * g + ri;
    const float safe = l[i] > 0.f ? l[i] : 1.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int dd = lane + 32 * c;
      if (dd < d) out[row * d + dd] = tdt_from_f<QT>(acc[i][c] / safe);
    }
    if (lane == 0) a.lse[row] = l[i] > 0.f ? m[i] + logf(safe) : NEG_INF;
  }
}

template <typename QT, typename KT>
int launch_d(const Args& a, dim3 grid, size_t smem, cudaStream_t s) {
  void (*k)(Args) = nullptr;
  if (a.d <= 32) k = ragged_kernel<QT, KT, 1>;
  else if (a.d <= 64) k = ragged_kernel<QT, KT, 2>;
  else if (a.d <= 128) k = ragged_kernel<QT, KT, 4>;
  else if (a.d <= 256) k = ragged_kernel<QT, KT, 8>;
  else return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  k<<<grid, THREADS, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tdt_ragged_paged_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* kv_lens, const void* q_lens,
    const void* q_starts, const void* table, const void* topo, void* out,
    void* lse, int rows, int pps, int npages, int hkv, int g, int d, int page,
    int tg, int block_q, int topo_w, float scale, float soft_cap, int q_dtype,
    int quant, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  Args a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
         static_cast<const float*>(v_scale), static_cast<const int*>(kv_lens),
         static_cast<const int*>(q_lens), static_cast<const int*>(q_starts),
         static_cast<const int*>(table), static_cast<const int*>(topo), out,
         static_cast<float*>(lse), pps, npages, hkv, g, d, page, tg, topo_w,
         scale, soft_cap};
  const int tiles = (block_q * g + BQ - 1) / BQ;
  if (rows <= 0 || tiles <= 0 || hkv <= 0) return 0;
  dim3 grid(tiles, hkv, rows);
  const size_t smem = (2 * static_cast<size_t>(page) * d + 2 * page) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == TDT_BF16)
    return quant ? launch_d<__nv_bfloat16, int8_t>(a, grid, smem, s)
                 : launch_d<__nv_bfloat16, __nv_bfloat16>(a, grid, smem, s);
  if (q_dtype == TDT_F32)
    return quant ? launch_d<float, int8_t>(a, grid, smem, s)
                 : launch_d<float, float>(a, grid, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
