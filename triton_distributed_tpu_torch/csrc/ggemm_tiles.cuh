// The float and W8A16 tile loops of the grouped GEMM, shared by
// group_gemm.cu (tdt_ggemm_f, tdt_ggemm_w8a16), moe_tp_fused.cu
// (tdt_ag_group_gemm, tdt_moe_reduce_rs, their mesh forms and wires),
// ag_gemm.cu (tdt_ag_gemm, tdt_ag_gemm_w) and gemm_rs.cu (tdt_gemm_rs,
// tdt_gemm_rs_partials).
//
// out (M, N) = A (M, K) @ w[block_expert[m / block_m]] (K, N): output
// row m's A row is read from wherever a row source says, so the same
// loop runs a dense A (DenseRows), a gather fused into the tile load
// (GatherRows: the expert-sorted slab of the MoE-TP up projection,
// never written out), and the two tensor-parallel GEMMs over the peer
// tables of a mesh (PeerRows, PeerSum). A row source is a compile-time
// trait: at(m) gives a row reference, ok(ref) whether the row is real (a
// row of zeros otherwise), off(ref) its element offset from a_base(x,
// ref). DenseRows' reference is m itself and its bases are the kernel's
// own pointers, so its loops compute x + m * K and m < M where they load,
// as a plain dense GEMM does; GatherRows' reference is the offset looked
// up in sti, resolved once before the K loop (into shared memory for the
// FMA loop, into registers for the two rows each thread loads in the
// tensor-core loop).
//
// The mesh traits read the rank from blockIdx.z (one launch covers
// every rank on the device) and their operands from peer tables (the
// ranks' data pointers): w_expert / out_base pick the rank's weight (the
// block's expert of it) and output. PeerRows gathers A's rows over the
// ranks' shards (row g of the gathered A is row g % m of rank g / m; its
// reference is the row's address); PeerGatherRows composes that with
// GatherRows (row t of the gathered expert-sorted slab is token
// sti[t] / topk of rank t / cap_s's shard); PeerSum runs the K loop over
// (rank q, k-block) with kParts, A and w both from rank q, looked up once
// a part, and with `grouped` reads each rank's own rows of a stacked
// block -> expert table. DenseRows and GatherRows have one part and
// return the kernel's pointers, so their loops compile as before. The
// wires: PeerRowsQ (kQuant) is PeerRows with each peer's rows read from
// its 1-byte wire codes and dequantized in the load (wire.cuh), the own
// shard exact, and PeerGatherRowsQ the same on PeerGatherRows' sorted
// rows; PeerLocal runs each rank's own (grouped) product into its own
// output.
//
// Two loops: fma_kernel (64 x 64 tiles, 256 threads with 4 x 4 FMA
// micro-tiles, both operands widened to f32 in shared memory; f32 or
// bf16 A, f32 or int8 weights with a per-(expert, column) scale) and
// bf16_mma_kernel (64 x 128 tiles, four warps of 32 x 64, mma.sync
// m16n8k16 bf16 -> f32 fed by ldmatrix, the next K step loaded into
// registers while the current one multiplies). Both mask the ragged M,
// N and K edges; with more than one M-block, block_m is a multiple of
// 64, so a tile never straddles two experts. A dense f32 product at
// N <= 64 runs narrow_f32_kernel instead (below): fma_kernel's sums, the
// same bits, in 32 x 16 tiles behind a cp.async ring, its operands each
// f32 or bf16 (the MoE routers' bf16 activations, group_gemm.cu's
// tdt_narrow_f32).
#pragma once

#include <type_traits>

#include "wire.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

// ------------------------------------------------------------ row sources

// The operands of a source that reads the kernel's own A (or, with
// kParts, the current part's) and w, and stores output row m in row m.
#define TDT_KERNEL_OPERANDS                                                 \
  template <typename T>                                                     \
  __device__ __forceinline__ const T* a_base(const T* x, Ref) const {       \
    return x;                                                               \
  }                                                                         \
  template <typename T>                                                     \
  __device__ __forceinline__ const T* w_expert(const T* w, int e, int K,    \
                                               int N) const {               \
    return w + static_cast<size_t>(e) * K * N;                              \
  }                                                                         \
  template <typename T>                                                     \
  __device__ __forceinline__ T* out_base(T* out) const { return out; }      \
  __device__ __forceinline__ int orow(int m) const { return m; }            \
  __device__ __forceinline__ int expert(const int* be, int m0,              \
                                        int block_m) const {                \
    return be[m0 / block_m];                                                \
  }

// row m of a dense (M, K) A; nothing to look up
struct DenseRows {
  static constexpr bool kLookup = false;
  static constexpr bool kParts = false;
  static constexpr bool kQuant = false;
  using Ref = int;
  int M, K;
  __device__ __forceinline__ Ref at(int m) const { return m; }
  __device__ __forceinline__ bool ok(Ref m) const { return m < M; }
  __device__ __forceinline__ size_t off(Ref m) const {
    return static_cast<size_t>(m) * K;
  }
  TDT_KERNEL_OPERANDS
};

// row m of the expert-sorted slab: token sti[m] / topk of x (., K), or
// zeros where sti[m] is the padding sentinel (>= total = tokens * topk);
// the reference is the row's element offset, -1 for a row of zeros
struct GatherRows {
  static constexpr bool kLookup = true;
  static constexpr bool kParts = false;
  static constexpr bool kQuant = false;
  using Ref = long long;
  const int* __restrict__ sti;
  int M, K, topk, total;
  __device__ __forceinline__ Ref at(int m) const {
    if (m >= M) return -1;
    const int s = sti[m];
    return (s >= 0 && s < total) ? static_cast<long long>(s / topk) * K : -1;
  }
  __device__ __forceinline__ bool ok(Ref r) const { return r >= 0; }
  __device__ __forceinline__ size_t off(Ref r) const {
    return static_cast<size_t>(r);
  }
  TDT_KERNEL_OPERANDS
};

// AG-GEMM over a mesh: rank r = rank0 + blockIdx.z computes
// out_r (W * m, N) = [A_0; A_1; ...; A_{W-1}] @ w_r, where A_q (m, K) is
// rank q's row shard. The tile rows are rotated so that rank r's first
// M-tiles are its own shard (the TPU ring's step-0 order): tile row t is
// gathered row g = (t + r * m) mod (W * m), row g % m of rank g / m.
struct PeerRows {
  static constexpr bool kLookup = true;
  static constexpr bool kParts = false;
  static constexpr bool kQuant = false;
  using Ref = const char*;  // the row's first byte; nullptr past the rows
  const unsigned long long* __restrict__ a_peers;
  const unsigned long long* __restrict__ w_peers;
  const unsigned long long* __restrict__ out_peers;
  int m, world, rank0, K, esize;  // esize: bytes per A element
  __device__ __forceinline__ int rank() const { return rank0 + blockIdx.z; }
  __device__ __forceinline__ int orow(int t) const {
    return (t + rank() * m) % (world * m);
  }
  __device__ __forceinline__ Ref at(int t) const {
    if (t >= world * m) return nullptr;
    const int g = orow(t);
    return reinterpret_cast<const char*>(a_peers[g / m]) +
           static_cast<size_t>(g % m) * K * esize;
  }
  __device__ __forceinline__ bool ok(Ref r) const { return r != nullptr; }
  __device__ __forceinline__ size_t off(Ref) const { return 0; }
  template <typename T>
  __device__ __forceinline__ const T* a_base(const T*, Ref r) const {
    return reinterpret_cast<const T*>(r);
  }
  template <typename T>
  __device__ __forceinline__ const T* w_expert(const T*, int e, int K,
                                               int N) const {
    return reinterpret_cast<const T*>(w_peers[rank()]) +
           static_cast<size_t>(e) * K * N;
  }
  template <typename T>
  __device__ __forceinline__ T* out_base(T*) const {
    return reinterpret_cast<T*>(out_peers[rank()]);
  }
  __device__ __forceinline__ int expert(const int* be, int m0,
                                        int block_m) const {
    return be[m0 / block_m];
  }
};

// MoE AG + grouped GEMM over a mesh: rank r = rank0 + blockIdx.z computes
// out_r (W * cap_s, N) whose row t = s * cap_s + i is token sti[t] / topk
// of rank s's row shard x_s (zeros where sti[t] is the padding sentinel,
// >= total = tokens a shard * topk) times w_r[block_expert[t / block_m]]:
// every shard's expert-sorted slab, gathered, never written out. sti and
// block_expert are the W shards' tables stacked; w_r (E, K, N) is rank r's
// column shard of every expert. The reference is the row's first byte.
struct PeerGatherRows {
  static constexpr bool kLookup = true;
  static constexpr bool kParts = false;
  static constexpr bool kQuant = false;
  using Ref = const char*;  // the row's first byte; nullptr for zeros
  const unsigned long long* __restrict__ a_peers;
  const unsigned long long* __restrict__ w_peers;
  const unsigned long long* __restrict__ out_peers;
  const int* __restrict__ sti;
  int cap_s, world, rank0, K, esize, topk, total;
  __device__ __forceinline__ int rank() const { return rank0 + blockIdx.z; }
  __device__ __forceinline__ Ref at(int t) const {
    if (t >= world * cap_s) return nullptr;
    const int v = sti[t];
    if (v < 0 || v >= total) return nullptr;
    return reinterpret_cast<const char*>(a_peers[t / cap_s]) +
           static_cast<size_t>(v / topk) * K * esize;
  }
  __device__ __forceinline__ bool ok(Ref r) const { return r != nullptr; }
  __device__ __forceinline__ size_t off(Ref) const { return 0; }
  template <typename T>
  __device__ __forceinline__ const T* a_base(const T*, Ref r) const {
    return reinterpret_cast<const T*>(r);
  }
  template <typename T>
  __device__ __forceinline__ const T* w_expert(const T*, int e, int K,
                                               int N) const {
    return reinterpret_cast<const T*>(w_peers[rank()]) +
           static_cast<size_t>(e) * K * N;
  }
  template <typename T>
  __device__ __forceinline__ T* out_base(T*) const {
    return reinterpret_cast<T*>(out_peers[rank()]);
  }
  __device__ __forceinline__ int orow(int t) const { return t; }
  __device__ __forceinline__ int expert(const int* be, int m0,
                                        int block_m) const {
    return be[m0 / block_m];
  }
};

// GEMM-RS over a mesh: rank r = rank0 + blockIdx.z computes
// out_r (m, N) = sum_q A_q[r * m : (r + 1) * m] @ w_q, where A_q (W * m,
// K) holds rank q's K columns and w_q (K, N) its weight rows. The K loop
// runs over (rank q, k-block) with kParts: part q's A and w come from
// part_a(q) / part_w(q), looked up once a part; f32 sums across ranks and
// K, one rounding at the store. With `grouped` (the MoE grouped GEMM +
// RS) w_q is (E, K, N) and output row i of rank r takes expert
// block_expert[(r * m + i) / block_m], the W ranks' block tables stacked;
// without it block_expert is the one expert 0.
struct PeerSum {
  static constexpr bool kLookup = false;
  static constexpr bool kParts = true;
  static constexpr bool kQuant = false;
  using Ref = int;
  const unsigned long long* __restrict__ a_peers;
  const unsigned long long* __restrict__ w_peers;
  const unsigned long long* __restrict__ out_peers;
  int m, world, rank0, K;
  bool grouped;
  __device__ __forceinline__ int rank() const { return rank0 + blockIdx.z; }
  __device__ __forceinline__ int parts() const { return world; }
  template <typename T>
  __device__ __forceinline__ const T* part_a(int q) const {
    return reinterpret_cast<const T*>(a_peers[q]);
  }
  template <typename T>
  __device__ __forceinline__ const T* part_w(int q, int e, int N) const {
    return reinterpret_cast<const T*>(w_peers[q]) +
           static_cast<size_t>(e) * K * N;
  }
  __device__ __forceinline__ int expert(const int* be, int m0,
                                        int block_m) const {
    return grouped ? be[(rank() * m + m0) / block_m] : be[0];
  }
  __device__ __forceinline__ Ref at(int i) const { return i; }
  __device__ __forceinline__ bool ok(Ref i) const { return i < m; }
  __device__ __forceinline__ size_t off(Ref i) const {
    return (static_cast<size_t>(rank()) * m + i) * K;
  }
  template <typename T>
  __device__ __forceinline__ const T* a_base(const T* x, Ref) const {
    return x;
  }
  template <typename T>
  __device__ __forceinline__ const T* w_expert(const T* w, int, int,
                                               int) const {
    return w;  // unused: the parts carry the weights
  }
  template <typename T>
  __device__ __forceinline__ T* out_base(T*) const {
    return reinterpret_cast<T*>(out_peers[rank()]);
  }
  __device__ __forceinline__ int orow(int i) const { return i; }
};

// GEMM-RS on a quantized wire, its partials: rank r = rank0 + blockIdx.z
// computes out_r (M, N) = A_r (M, K) @ w_r[block_expert[m / block_m]], its
// own A (all W * m rows of its K columns) against its own weight rows,
// into its own slab of partials (the fold of gemm_rs.cu then replays the
// ring's hops). The dense GEMM-RS passes one expert (block_m = M, the
// table one 0); the MoE grouped GEMM-RS w_r (E, K, N) and the W shards'
// block tables stacked, so that row m = d * cap_s + i (destination d's
// sorted row i) takes expert be[d, i / block_m].
struct PeerLocal {
  static constexpr bool kLookup = false;
  static constexpr bool kParts = false;
  static constexpr bool kQuant = false;
  using Ref = int;
  const unsigned long long* __restrict__ a_peers;
  const unsigned long long* __restrict__ w_peers;
  const unsigned long long* __restrict__ out_peers;
  int M, K, rank0;
  __device__ __forceinline__ int rank() const { return rank0 + blockIdx.z; }
  __device__ __forceinline__ Ref at(int m) const { return m; }
  __device__ __forceinline__ bool ok(Ref m) const { return m < M; }
  __device__ __forceinline__ size_t off(Ref m) const {
    return static_cast<size_t>(m) * K;
  }
  template <typename T>
  __device__ __forceinline__ const T* a_base(const T*, Ref) const {
    return reinterpret_cast<const T*>(a_peers[rank()]);
  }
  template <typename T>
  __device__ __forceinline__ const T* w_expert(const T*, int e, int K_,
                                               int N) const {
    return reinterpret_cast<const T*>(w_peers[rank()]) +
           static_cast<size_t>(e) * K_ * N;
  }
  template <typename T>
  __device__ __forceinline__ T* out_base(T*) const {
    return reinterpret_cast<T*>(out_peers[rank()]);
  }
  __device__ __forceinline__ int orow(int m) const { return m; }
  __device__ __forceinline__ int expert(const int* be, int m0,
                                        int block_m) const {
    return be[m0 / block_m];
  }
};

// AG-GEMM on a quantized wire (kQuant): PeerRows' gathered, rotated rows,
// but only rank r's own shard is read exact, from its rows of A's dtype;
// a peer's rows are its wire codes (fp8 or int8, q: (W, m, K) bytes)
// times its chunk's scale (s: (W, m / chunk_rows) f32), rounded to A's
// dtype as the receiver's dequantize does, then fed to the same product.
struct PeerRowsQ {
  static constexpr bool kLookup = true;
  static constexpr bool kParts = false;
  static constexpr bool kQuant = true;
  struct Ref {
    const char* p;  // the row's first byte; nullptr past the rows
    float s;        // a peer row's scale
    bool q;         // a peer row: codes
  };
  const unsigned long long* __restrict__ a_peers;
  const uint8_t* __restrict__ q;
  const float* __restrict__ s;
  const unsigned long long* __restrict__ w_peers;
  const unsigned long long* __restrict__ out_peers;
  int m, world, rank0, K, esize, chunk_rows, quant;
  __device__ __forceinline__ int rank() const { return rank0 + blockIdx.z; }
  __device__ __forceinline__ int orow(int t) const {
    return (t + rank() * m) % (world * m);
  }
  __device__ __forceinline__ Ref at(int t) const {
    if (t >= world * m) return Ref{nullptr, 0.f, false};
    const int g = orow(t), src = g / m, i = g % m;
    if (src == rank())
      return Ref{reinterpret_cast<const char*>(a_peers[src]) +
                     static_cast<size_t>(i) * K * esize,
                 0.f, false};
    return Ref{reinterpret_cast<const char*>(q) +
                   (static_cast<size_t>(src) * m + i) * K,
               s[static_cast<size_t>(src) * (m / chunk_rows) + i / chunk_rows],
               true};
  }
  __device__ __forceinline__ bool ok(Ref r) const { return r.p != nullptr; }
  // element k of a row as f32, a peer's rounded to XT first
  template <typename XT>
  __device__ __forceinline__ float load_f(Ref r, int k) const {
    if (!r.q) return tdt_to_f<XT>(reinterpret_cast<const XT*>(r.p)[k]);
    const float v = wire_value(reinterpret_cast<const uint8_t*>(r.p)[k], r.s,
                               quant);
    return tdt_to_f<XT>(tdt_from_f<XT>(v));
  }
  // 8 bf16 of a row from column col (zero past ncols or the rows); vec:
  // K % 8 == 0 and 16-byte aligned shards
  __device__ __forceinline__ uint4 qload8(Ref r, int col, int ncols,
                                          bool vec) const;
  template <typename T>
  __device__ __forceinline__ const T* w_expert(const T*, int e, int K_,
                                               int N) const {
    return reinterpret_cast<const T*>(w_peers[rank()]) +
           static_cast<size_t>(e) * K_ * N;
  }
  template <typename T>
  __device__ __forceinline__ T* out_base(T*) const {
    return reinterpret_cast<T*>(out_peers[rank()]);
  }
  __device__ __forceinline__ int expert(const int* be, int m0,
                                        int block_m) const {
    return be[m0 / block_m];
  }
};

// MoE AG + grouped GEMM on a quantized wire (kQuant): PeerGatherRows'
// sorted layout (row t = s * cap_s + i is shard s's sorted row i, not
// rotated; m is cap_s), with PeerRowsQ's loads: rank r's own shard is
// read exact from its tokens (x_r[sti[t] / topk]); a peer shard's row is
// its wire codes (q: (W, cap_s, K), the shard's materialized sorted slab
// quantized) times its chunk's scale (s: (W, cap_s / chunk_rows)),
// rounded to x's dtype. A row at the padding sentinel (>= total = tokens
// a shard * topk) is zeros on both, as its codes are.
struct PeerGatherRowsQ : PeerRowsQ {
  const int* __restrict__ sti;
  int topk, total;
  __device__ __forceinline__ int orow(int t) const { return t; }
  __device__ __forceinline__ Ref at(int t) const {
    if (t >= world * m) return Ref{nullptr, 0.f, false};
    const int v = sti[t];
    if (v < 0 || v >= total) return Ref{nullptr, 0.f, false};
    if (t / m == rank())
      return Ref{reinterpret_cast<const char*>(a_peers[t / m]) +
                     static_cast<size_t>(v / topk) * K * esize,
                 0.f, false};
    return Ref{reinterpret_cast<const char*>(q) + static_cast<size_t>(t) * K,
               s[t / chunk_rows], true};
  }
};

// ------------------------------------------------------ W8A16 and f32
constexpr int BK = 32;

// ws == nullptr: unscaled weights (the f32 mode)
template <typename XT, typename WT, typename OutT, typename Rows>
__global__ void __launch_bounds__(THREADS)
fma_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
           const float* __restrict__ ws, const int* __restrict__ block_expert,
           OutT* __restrict__ out, int M, int K, int N, int block_m,
           Rows rows) {
  using Ref = typename Rows::Ref;
  __shared__ float As[BM][BK + 1];
  __shared__ float Bs[BK][BN];
  __shared__ Ref a_ref[Rows::kLookup ? BM : 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int e = rows.expert(block_expert, m0, block_m);
  const WT* __restrict__ we = rows.w_expert(w, e, K, N);
  if constexpr (Rows::kLookup) {
    if (tid < BM) a_ref[tid] = rows.at(m0 + tid);
    __syncthreads();
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // one K step over A (or a part's A) xa and weights wa
  auto step = [&](const XT* __restrict__ xa, const WT* __restrict__ wa,
                  int k0) {
    for (int idx = tid; idx < BM * BK; idx += THREADS) {
      const int r = idx / BK, c = idx % BK;
      Ref ref;
      if constexpr (Rows::kLookup) ref = a_ref[r];
      else ref = rows.at(m0 + r);
      const int k = k0 + c;
      if constexpr (Rows::kQuant)
        As[r][c] = (rows.ok(ref) && k < K)
                       ? rows.template load_f<XT>(ref, k)
                       : 0.f;
      else
        As[r][c] = (rows.ok(ref) && k < K)
                       ? tdt_to_f<XT>(rows.a_base(xa, ref)[rows.off(ref) + k])
                       : 0.f;
    }
    const WT* __restrict__ wp = wa;
    for (int idx = tid; idx < BK * BN; idx += THREADS) {
      const int c = idx / BN, n = idx % BN;
      const int k = k0 + c, nn = n0 + n;
      Bs[c][n] = (k < K && nn < N)
                     ? tdt_to_f<WT>(wp[static_cast<size_t>(k) * N + nn])
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
  };
  if constexpr (Rows::kParts) {
    for (int q = 0; q < rows.parts(); ++q) {
      const XT* __restrict__ xq = rows.template part_a<XT>(q);
      const WT* __restrict__ wq = rows.template part_w<WT>(q, e, N);
      for (int k0 = 0; k0 < K; k0 += BK) step(xq, wq, k0);
    }
  } else {
    for (int k0 = 0; k0 < K; k0 += BK) step(x, we, k0);
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
      rows.out_base(out)[static_cast<size_t>(rows.orow(m)) * N + n] =
          tdt_from_f<OutT>(v);
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

__device__ __forceinline__ uint4 PeerRowsQ::qload8(Ref r, int col, int ncols,
                                                  bool vec) const {
  if (!r.q)
    return load8(reinterpret_cast<const unsigned short*>(r.p), 0, col, ncols,
                 r.p != nullptr, vec);
  union {
    uint2 u;
    uint8_t b[8];
  } c;
  c.u = make_uint2(0, 0);  // code 0 is the value 0 in both wires
  const uint8_t* p = reinterpret_cast<const uint8_t*>(r.p) + col;
  if (vec && col + 8 <= ncols) {
    c.u = *reinterpret_cast<const uint2*>(p);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (col + i < ncols) c.b[i] = p[i];
  }
  // pairs: one conversion of two fp8 codes, one rounding of two f32 to
  // bf16 (the element of the lower address in the lower half)
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = wire_value2(c.b[2 * i], c.b[2 * i + 1], r.s, quant);
    const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename OutT, typename Rows>
__global__ void __launch_bounds__(TC_THREADS)
bf16_mma_kernel(const unsigned short* __restrict__ x,
                const unsigned short* __restrict__ w,
                const int* __restrict__ block_expert, OutT* __restrict__ out,
                int M, int K, int N, int block_m, bool vec_a, bool vec_b,
                Rows rows) {
  __shared__ __align__(16) unsigned short As[2][TBM][APAD];
  __shared__ __align__(16) unsigned short Bs[2][TBK][BPAD];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
  const int m0 = blockIdx.y * TBM, n0 = blockIdx.x * TBN;
  const int e = rows.expert(block_expert, m0, block_m);
  const unsigned short* __restrict__ we = rows.w_expert(w, e, K, N);
  // the two A rows this thread loads (rows idx >> 2 of gload below)
  const typename Rows::Ref a_ref[2] = {rows.at(m0 + (tid >> 2)),
                                       rows.at(m0 + ((tid + TC_THREADS) >> 2))};

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  uint4 ra[2], rb[4];
  // the A and weights the K loop reads: the kernel's own, or (kParts)
  // the current part's
  const unsigned short* __restrict__ xa = x;
  const unsigned short* __restrict__ wa = we;
  auto gload = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // A: 64 rows x 4 vectors
      const int c = ((tid + i * TC_THREADS) & 3) * 8;
      if constexpr (Rows::kQuant)
        ra[i] = rows.qload8(a_ref[i], k0 + c, K, vec_a);
      else
        ra[i] = load8(rows.a_base(xa, a_ref[i]), rows.off(a_ref[i]), k0 + c,
                      K, rows.ok(a_ref[i]), vec_a);
    }
    const unsigned short* __restrict__ wp = wa;
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // B: 32 rows x 16 vectors
      const int idx = tid + i * TC_THREADS, r = idx >> 4, c = (idx & 15) * 8;
      const int k = k0 + r;
      rb[i] = load8(wp, static_cast<size_t>(k) * N, n0 + c, N, k < K, vec_b);
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

  // one pipelined K loop a part: the next K step is loaded into
  // registers while the current one multiplies
  const int nk = (K + TBK - 1) / TBK;
  int nparts = 1;
  if constexpr (Rows::kParts) nparts = rows.parts();
  for (int part = 0; part < nparts; ++part) {
    if constexpr (Rows::kParts) {
      xa = rows.template part_a<unsigned short>(part);
      wa = rows.template part_w<unsigned short>(part, e, N);
    }
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
          ldsm_x4(af[mi], &As[buf][wm + mi * 16 + (lane & 15)]
                             [kk + (lane >> 4) * 8]);
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          // x4.trans over a 16 (k) x 16 (n) block: registers 0/1 are the
          // k 0-7 / 8-15 halves of n-tile 2nj, registers 2/3 of 2nj + 1
          uint32_t bf[4];
          ldsm_x4_t(bf, &Bs[buf][kk + (lane & 15)]
                            [wn + nj * 16 + (lane >> 4) * 8]);
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
          rows.out_base(out)[static_cast<size_t>(rows.orow(m)) * N + n] =
              tdt_from_f<OutT>(acc[mi][nj][v]);
      }
    }
}

// ------------------------------------------------ f32 sums, narrow outputs
// The f32 mode on a dense A at narrow N (the MoE routers: N = experts,
// M = 768 packed rows a serving step, 8 rows a decode step, K = 2048).
// Each output is fma_kernel's sum: one fmaf chain over k = 0, 1, ..., K - 1
// from 0, zero-padded past K, so its bits equal fma_kernel's and a row's
// bits do not depend on M (no split K: the chain is one thread's). What
// bounds it is not the 0.2 GFLOP nor the 3 MB of operands but each
// thread's K-long stream of FMAs and the shared-memory loads that feed
// them: about 24 cycles a k on an H100, the same at 8 rows as at 768, the
// same with 3 to 8 stages in flight and 32 to 128 k a stage (PERF.md).
// So: 32 x 16 output tiles (96 CTAs at M 768, N 64; four at M 8, N cut
// across them), 128 threads of 2 x 2 outputs, four chains a thread
// interleaved; K in steps of 64 through a ring of stages in shared memory
// filled by cp.async (16-byte pieces, zeros past M, N and K), the next
// stages in flight while one multiplies, one barrier a stage. A 32-row
// tile reads the weight once for 32 rows (8-row tiles would read the whole
// 512 KB f32 router from L2 96 times at M 768). x and w are each f32 or
// bf16, widened to f32 exactly as they are read from shared memory, so the
// router takes bf16 activations without a cast. Rows of any pitch; pieces
// narrower than 16 bytes (a row or the weight not 16-byte aligned, or
// ragged in units of 16 bytes) are copied element by element,
// synchronously.
constexpr int NR_BM = 32;                         // rows a CTA
constexpr int NR_BN = 16;                         // columns a CTA
constexpr int NR_BK = 64;                         // k a stage
constexpr int NR_TR = 2;                          // rows a thread
constexpr int NR_RS = NR_BM / NR_TR;              // its rows: ty + NR_RS i
constexpr int NR_THREADS = NR_RS * (NR_BN / 2);   // two columns a thread

// the ring's depth: four stages for bf16 x, three for f32 x (its stage is
// twice as large)
template <typename XS>
__host__ __device__ constexpr int nr_stages() {
  return sizeof(XS) == 4 ? 3 : 4;
}

__device__ __forceinline__ void gg_cp_async16(void* dst, const void* src,
                                              int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void gg_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void gg_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four consecutive elements of a row in shared memory as f32 (bf16 held
// as its bits)
__device__ __forceinline__ void nr_quad(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void nr_quad(const unsigned short* p,
                                        float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(t.x << 16);
  v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16);
  v[3] = __uint_as_float(t.y & 0xffff0000u);
}
// two consecutive elements as f32
__device__ __forceinline__ float2 nr_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 nr_pair(const unsigned short* p) {
  const uint32_t t = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(t << 16),
                     __uint_as_float(t & 0xffff0000u));
}

// out (M, N) = x (M, K; row pitch lda) @ w[e] (K, N), e = block_expert[m0 /
// block_m] (expert 0 when block_expert is null). vec_x / vec_w: x's rows /
// w's rows are 16-byte aligned and whole 16-byte pieces (cp.async).
template <typename XS, typename WS, typename OutT>
__global__ void __launch_bounds__(NR_THREADS)
narrow_f32_kernel(const XS* __restrict__ x, long long lda,
                  const WS* __restrict__ w, const int* __restrict__ block_expert,
                  OutT* __restrict__ out, int M, int K, int N, int block_m,
                  bool vec_x, bool vec_w) {
  constexpr int S = nr_stages<XS>();
  constexpr int XP = NR_BK + 16 / static_cast<int>(sizeof(XS));  // x pitch
  constexpr int XE = 16 / static_cast<int>(sizeof(XS));  // x elements a piece
  constexpr int WE = 16 / static_cast<int>(sizeof(WS));  // w elements a piece
  __shared__ __align__(16) XS xs[S][NR_BM][XP];
  __shared__ __align__(16) WS wsm[S][NR_BK][NR_BN];
  // thread (ty, tx): rows ty + NR_RS i, columns 2tx and 2tx + 1
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int m0 = blockIdx.y * NR_BM, n0 = blockIdx.x * NR_BN;
  const int e = block_expert ? block_expert[m0 / block_m] : 0;
  const WS* __restrict__ we = w + static_cast<size_t>(e) * K * N;
  const int nk = (K + NR_BK - 1) / NR_BK;

  auto load = [&](int st, int k0) {
    if (vec_x) {
      for (int c = tid; c < NR_BM * (NR_BK / XE); c += NR_THREADS) {
        const int r = c / (NR_BK / XE), kk = k0 + (c % (NR_BK / XE)) * XE;
        const bool ok = m0 + r < M && kk < K;
        gg_cp_async16(&xs[st][r][kk - k0],
                      ok ? x + (m0 + r) * lda + kk : x, ok ? 16 : 0);
      }
    } else {
      for (int c = tid; c < NR_BM * NR_BK; c += NR_THREADS) {
        const int r = c / NR_BK, kk = k0 + c % NR_BK;
        xs[st][r][kk - k0] = (m0 + r < M && kk < K) ? x[(m0 + r) * lda + kk]
                                                    : XS(0);
      }
    }
    if (vec_w) {
      for (int c = tid; c < NR_BK * (NR_BN / WE); c += NR_THREADS) {
        const int kr = c / (NR_BN / WE), nn = n0 + (c % (NR_BN / WE)) * WE;
        const bool ok = k0 + kr < K && nn < N;
        gg_cp_async16(&wsm[st][kr][nn - n0],
                      ok ? we + static_cast<size_t>(k0 + kr) * N + nn : we,
                      ok ? 16 : 0);
      }
    } else {
      for (int c = tid; c < NR_BK * NR_BN; c += NR_THREADS) {
        const int kr = c / NR_BN, nn = n0 + c % NR_BN;
        wsm[st][kr][nn - n0] = (k0 + kr < K && nn < N)
                                   ? we[static_cast<size_t>(k0 + kr) * N + nn]
                                   : WS(0);
      }
    }
  };

#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < nk) load(st, st * NR_BK);
    gg_cp_commit();
  }
  float acc[NR_TR][2];
#pragma unroll
  for (int i = 0; i < NR_TR; ++i) acc[i][0] = acc[i][1] = 0.f;
  for (int t = 0; t < nk; ++t) {
    gg_cp_wait<S - 2>();  // stage t has landed (this thread's pieces)
    __syncthreads();      // everyone's; and stage t - 1 is consumed
    if (t + S - 1 < nk) load((t + S - 1) % S, (t + S - 1) * NR_BK);
    gg_cp_commit();
    const int st = t % S;
    const WS* __restrict__ wc = &wsm[st][0][2 * tx];
#pragma unroll
    for (int k = 0; k < NR_BK; k += 4) {
      float a[NR_TR][4];
#pragma unroll
      for (int i = 0; i < NR_TR; ++i) nr_quad(&xs[st][ty + NR_RS * i][k], a[i]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float2 b = nr_pair(wc + (k + kk) * NR_BN);
#pragma unroll
        for (int i = 0; i < NR_TR; ++i) {
          acc[i][0] = fmaf(a[i][kk], b.x, acc[i][0]);
          acc[i][1] = fmaf(a[i][kk], b.y, acc[i][1]);
        }
      }
    }
  }
  gg_cp_wait<0>();  // no copy outlives the block

#pragma unroll
  for (int i = 0; i < NR_TR; ++i) {
    const int m = m0 + ty + NR_RS * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + 2 * tx + j;
      if (n < N) out[static_cast<size_t>(m) * N + n] = tdt_from_f<OutT>(acc[i][j]);
    }
  }
}

template <typename XS, typename WS>
int launch_narrow_f32_t(const void* x, long long lda, const void* w,
                        const int* be, void* out, int M, int K, int N,
                        int block_m, int out_dtype, cudaStream_t s) {
  const XS* xp = static_cast<const XS*>(x);
  const WS* wp = static_cast<const WS*>(w);
  const bool vec_x = (reinterpret_cast<uintptr_t>(xp) & 15) == 0 &&
                     (lda * static_cast<long long>(sizeof(XS))) % 16 == 0 &&
                     (K * static_cast<long long>(sizeof(XS))) % 16 == 0;
  const bool vec_w = (reinterpret_cast<uintptr_t>(wp) & 15) == 0 &&
                     (N * static_cast<long long>(sizeof(WS))) % 16 == 0;
  const dim3 grid((N + NR_BN - 1) / NR_BN, (M + NR_BM - 1) / NR_BM);
  if (out_dtype == TDT_F32)
    narrow_f32_kernel<XS, WS, float><<<grid, NR_THREADS, 0, s>>>(
        xp, lda, wp, be, static_cast<float*>(out), M, K, N, block_m, vec_x,
        vec_w);
  else if (out_dtype == TDT_BF16)
    narrow_f32_kernel<XS, WS, __nv_bfloat16><<<grid, NR_THREADS, 0, s>>>(
        xp, lda, wp, be, static_cast<__nv_bfloat16*>(out), M, K, N, block_m,
        vec_x, vec_w);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// narrow_f32_kernel on x (M, K) at row pitch lda and w (E, K, N), each
// TDT_F32 or TDT_BF16; out (M, N) TDT_F32 or TDT_BF16. be: the block ->
// expert table (null: one expert). Returns the launch's cudaGetLastError().
inline int launch_narrow_f32(const void* x, long long lda, const void* w,
                             const int* be, void* out, int M, int K, int N,
                             int block_m, int x_dtype, int w_dtype,
                             int out_dtype, cudaStream_t s) {
  if (x_dtype == TDT_F32 && w_dtype == TDT_F32)
    return launch_narrow_f32_t<float, float>(x, lda, w, be, out, M, K, N,
                                             block_m, out_dtype, s);
  if (x_dtype == TDT_BF16 && w_dtype == TDT_F32)
    return launch_narrow_f32_t<unsigned short, float>(x, lda, w, be, out, M, K,
                                                     N, block_m, out_dtype, s);
  if (x_dtype == TDT_F32 && w_dtype == TDT_BF16)
    return launch_narrow_f32_t<float, unsigned short>(x, lda, w, be, out, M, K,
                                                     N, block_m, out_dtype, s);
  if (x_dtype == TDT_BF16 && w_dtype == TDT_BF16)
    return launch_narrow_f32_t<unsigned short, unsigned short>(
        x, lda, w, be, out, M, K, N, block_m, out_dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The float mode on `rows`: x and w both TDT_BF16 (tensor cores) or
// both TDT_F32 (FMA); out_dtype TDT_F32 or TDT_BF16. `a_aligned` /
// `b_aligned`: every A row / the weights start on a 16-byte boundary
// (the bf16 loop's vector loads); `nz` ranks along blockIdx.z (the mesh
// traits; 1 otherwise). Returns the launch's cudaGetLastError().
template <typename Rows>
int launch_float_ggemm_z(const void* x, const void* w, const int* be,
                         void* out, int M, int K, int N, int block_m,
                         int x_dtype, int out_dtype, cudaStream_t s,
                         Rows rows, bool a_aligned, bool b_aligned, int nz) {
  if (x_dtype == TDT_BF16) {
    dim3 grid((N + TBN - 1) / TBN, (M + TBM - 1) / TBM, nz);
    const unsigned short* xb = static_cast<const unsigned short*>(x);
    const unsigned short* wb = static_cast<const unsigned short*>(w);
    const bool vec_a = K % 8 == 0 && a_aligned;
    const bool vec_b = N % 8 == 0 && b_aligned;
    if (out_dtype == TDT_BF16)
      bf16_mma_kernel<__nv_bfloat16, Rows><<<grid, TC_THREADS, 0, s>>>(
          xb, wb, be, static_cast<__nv_bfloat16*>(out), M, K, N, block_m,
          vec_a, vec_b, rows);
    else if (out_dtype == TDT_F32)
      bf16_mma_kernel<float, Rows><<<grid, TC_THREADS, 0, s>>>(
          xb, wb, be, static_cast<float*>(out), M, K, N, block_m, vec_a,
          vec_b, rows);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (x_dtype == TDT_F32) {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, nz);
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(w);
    if constexpr (std::is_same<Rows, DenseRows>::value) {
      if (N <= BN && nz == 1)
        return launch_narrow_f32(xf, K, wf, be, out, M, K, N, block_m,
                                 TDT_F32, TDT_F32, out_dtype, s);
    }
    if (out_dtype == TDT_F32)
      fma_kernel<float, float, float, Rows><<<grid, THREADS, 0, s>>>(
          xf, wf, nullptr, be, static_cast<float*>(out), M, K, N, block_m,
          rows);
    else if (out_dtype == TDT_BF16)
      fma_kernel<float, float, __nv_bfloat16, Rows><<<grid, THREADS, 0, s>>>(
          xf, wf, nullptr, be, static_cast<__nv_bfloat16*>(out), M, K, N,
          block_m, rows);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// launch_float_ggemm_z on the kernel's own operands, one rank
template <typename Rows>
int launch_float_ggemm(const void* x, const void* w, const int* be, void* out,
                       int M, int K, int N, int block_m, int x_dtype,
                       int out_dtype, cudaStream_t s, Rows rows,
                       bool a_aligned) {
  return launch_float_ggemm_z(
      x, w, be, out, M, K, N, block_m, x_dtype, out_dtype, s, rows,
      a_aligned, (reinterpret_cast<uintptr_t>(w) & 15) == 0, 1);
}

}  // namespace
