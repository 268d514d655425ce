// GEMM + reduce-scatter for row-parallel tensor parallelism, over a mesh.
//
// Replaces triton_distributed_tpu/kernels/gemm_rs.py:_fused_kernel
// (:248) with its ack-credited ring, reduce_ring (kernels/ring.py:238),
// and the fold ew_add_pipeline (:72): every rank computes its partial
// product A_q @ B_q (A_q the rank's K columns of all W * m rows, B_q its
// K rows of the weight) and the ring folds the partials so that rank r
// ends with out_r (m, N) = sum_q A_q[r * m : (r + 1) * m] @ B_q. The TPU
// ring writes each hop's partial into slabs of the output type
// (gemm_rs.py:551), so in bf16 it rounds once per hop.
//
// On the card the reduction becomes a pull through the peer tables: one
// launch covers the ranks rank0 .. rank0 + nranks - 1 on this device
// (blockIdx.z is the rank), and each output tile runs its K loop over
// (rank q, k-block), A's rows and B both read from rank q (WgPeerSum in
// wg_gemm.cuh, PeerSum in ggemm_tiles.cuh). The sum over ranks and K
// stays in f32 registers and the tile is written once, rounded once: in
// bf16 it differs from the ring by up to about W - 1 bf16 ulps of the
// result, in f32 only by the summation order. Every rank's A and B are
// complete before the launch by stream order, so no block waits on
// another.
//
// What bounds it on an H100: the tensor cores. At the Llama-2-7B tp = 4
// prefill (A_q 8192 x 1024 for wo or 8192 x 2752 for down, bf16; B_q
// 1024 or 2752 x 4096) one launch over the four ranks is 2 * 8192 * K *
// 4096 flops (0.28 / 0.75 ms at 989 TFLOP/s).
//
// Design: in bf16 the warpgroup GEMM of wg_gemm.cuh (wgmma m64n256k16 fed
// by TMA, 128 x 256 tiles) over the WgPeerSum source, its K loop over
// (rank q, k step) in the f32 accumulators, the tile rounded and stored
// once, any m; world size 1 (gemm_rs on tensors) is the same launch on a
// one-rank table. Where wg_form_ok fails (f32, K or N not a multiple of
// 8, a base off the 16-byte grid), the tile loops of ggemm_tiles.cuh with
// the PeerSum source. No overlap.
//
// The quantized wire replaces _fused_kernel_w (:281),
// whose ring requantizes each hop's running partial: its numerics are the
// XLA twin's (gemm_rs_device, :759-810), which the plain version replays.
// For destination d the twin starts from P_{d-1}[d] (rank d - 1's partial
// product of d's rows, rounded to the output type), and at each of the
// W - 1 hops quantizes the running sum (scale from its chunk's amax),
// dequantizes it in f32, adds the next partial P_{d-2}[d], ..., P_d[d]
// (the own one last) in f32 and rounds to the output type. A single f32
// sum (PeerSum) would be the wrong numerics here. So two launches,
// tdt_gemm_rs_partials and tdt_gemm_rs_fold:
// (a) every rank's partials A_q @ B_q for all W * m rows, each rank into
// its own slab (W * W * m * N elements, 268 MB in bf16 at the Llama-2-7B
// tp = 4 wo / down; the warpgroup GEMM of wg_gemm.cuh over WgLocal where
// wg_form_ok holds, which the wire path's shapes do, else the tile loops
// over PeerLocal); (b) the fold, one
// cluster of blocks per (destination, chunk of chunk_rows rows), each
// block a slice of the chunk: each hop reads the running slice and the
// next partial once and stores the sum, measuring its amax on the way;
// the cluster's blocks meet once a hop, through distributed shared
// memory, for the chunk's next scale (a chunk of 64 x 4096 elements is
// past a block's shared memory). Up to 8 blocks a cluster while the
// chunks alone would leave SMs idle. On the loopback mesh no byte crosses
// a link, so a hop's codes are made and consumed in registers; the card
// shows the numerics and what the fold costs.
//
// The int8-mxu producers replace _fused_kernel_mxw (:317) and
// _fused_kernel_mxr (:394), which JAX runs where one out tile spans every
// column (N <= 1024 at its targets, :507-521): each rank's partial is an
// s8 x s8 -> s32 product of its A codes (one scale a chunk of bm rows,
// JAX's row block) and its per-column B codes, epilogue acc * (a_scale *
// b_scale) in f32 (mm_q8_rs_pipeline / mm_q8_partial_pipeline, :108,
// :192). Two launches again: (a) tdt_gemm_rs_mx, every rank's partials
// for all its rows on the s8 tile loop of s8_tiles.cuh (LocalRowsMx),
// into f32 slabs for _mxw or slabs of the output type for _mxr; (b) the
// fold. _mxr's is tdt_gemm_rs_fold above, over the rounded partials.
// _mxw's, tdt_gemm_rs_fold_mxw (the same kernel in its MXW mode),
// quantizes hop 0 off the f32 partial
// (the producer's accumulator) and each later hop with the scale of the
// f32 running sum and the codes of that sum rounded to the output type
// (dequant_add_requant_pipeline, lang/wire.py:404); a partial enters a
// sum rounded to the output type. In f32 the two folds are one function.
// Bound at DeepSeek-MoE-16B's wo at tp = 4 (A_q 8192 x 512, N 1024):
// the partials are 2 * 4 * 8192 * 512 * 1024 int8 operations (17 us at
// 1979 TOP/s) and 134 MB of f32 slabs written (40 us at 3.35 TB/s).

#include <cooperative_groups.h>

#include "s8_tiles.cuh"
#include "wg_gemm.cuh"

namespace cg = cooperative_groups;

namespace {

// int8-mxu rows of the GEMM-RS partials: rank q = blockIdx.z multiplies
// its own A codes (q: (W, M, K), all M = W * m rows) with their chunk's
// scale (s: (W, M / chunk_rows)) by its per-column quantized weight (wt:
// (W, N, K) int8, transposed; ws: (W, N) f32) into its partial slab
// out_peers[q] (M, N), rows in place.
struct LocalRowsMx {
  struct Ref {
    const int8_t* p;
    float s;
  };
  const int8_t* __restrict__ q;
  const float* __restrict__ s;
  const unsigned long long* __restrict__ out_peers;
  int M, chunk_rows;
  __device__ __forceinline__ int rank() const { return blockIdx.z; }
  __device__ __forceinline__ int orow(int t) const { return t; }
  __device__ __forceinline__ Ref at(int t, int K) const {
    if (t >= M) return Ref{nullptr, 0.f};
    return Ref{q + (static_cast<size_t>(rank()) * M + t) * K,
               s[static_cast<size_t>(rank()) * (M / chunk_rows) +
                 t / chunk_rows]};
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
  // acc * (a scale * b scale): the scale product first, as the TPU's
  // producer epilogue computes it (gemm_rs.py:136-139)
  __device__ __forceinline__ static float epilogue(int acc, float sx,
                                                   float sw) {
    return __fmul_rn(static_cast<float>(acc), __fmul_rn(sx, sw));
  }
};

// v rounded to T and back to f32
template <typename T>
__device__ __forceinline__ float tdt_round(float v) {
  return tdt_to_f<T>(tdt_from_f<T>(v));
}

// this thread's largest |x| over its elements of a slice of n (the
// block's walk; vec: 8 at a time)
template <typename P>
__device__ __forceinline__ float fold_slice_amax(const P* p, long long n,
                                                 bool vec) {
  float m = 0.f;
  if (vec) {
    for (long long i = 8ll * threadIdx.x; i < n; i += 8ll * blockDim.x) {
      float v[8];
      wire_ld8(p + i, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) m = fmaxf(m, fabsf(v[k]));
    }
  } else {
    for (long long i = threadIdx.x; i < n; i += blockDim.x)
      m = fmaxf(m, fabsf(tdt_to_f<P>(p[i])));
  }
  return m;
}

// the largest of every thread's v (>= 0) over the `cl` blocks of this
// block's cluster: the block's own max, then the cluster's through
// distributed shared memory. `slots` is two floats of the block's shared
// memory, alternated by `hop`, so that a block a hop ahead never
// overwrites a value another block still reads.
__device__ __forceinline__ float fold_cluster_max(float v, float* red,
                                                  float* slots, int hop,
                                                  int cl) {
  const float b = wire_block_max(v, red);
  if (cl == 1) return b;
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) slots[hop & 1] = b;
  cluster.sync();
  float m = 0.f;
  for (int r = 0; r < cl; ++r)
    m = fmaxf(m, *cluster.map_shared_rank(slots + (hop & 1), r));
  return m;
}

// The reduce ring's fold over the ranks' partial slabs (see above), one
// cluster of `cl` blocks a (destination, chunk): blockIdx.y the
// destination rank, blockIdx.x / cl the chunk of its rows, blockIdx.x %
// cl a slice of the chunk's elements (the clusters keep the card busy
// where the chunks are few and large: 16 chunks of 512 x 1024 at the
// int8-mxu GEMM-RS's shape). Each thread walks the same elements at
// every hop, so it reads back only what it stored; the cluster meets
// once a hop, for the next scale, which the store pass measures.
// MXW = false: the fp8 / int8 wire and _fused_kernel_mxr, partials P = T
// of the output type; a hop ships the running sum's codes at its own
// scale. MXW = true (_fused_kernel_mxw, int8): f32 partials; hop 0 ships
// the f32 partial's codes, a later hop the rounded sum's codes at the
// scale of the f32 sum, and a partial enters the sum rounded to T.
template <typename T, typename P, bool MXW>
__global__ void __launch_bounds__(WIRE_THREADS)
gemm_rs_fold_kernel(const unsigned long long* __restrict__ part_peers,
                    const unsigned long long* __restrict__ out_peers, int m,
                    int N, int world, int rank0, int chunk_rows, int quant,
                    int cl, int aligned) {
  __shared__ float red[32];
  __shared__ float slots[2];
  const int d = rank0 + blockIdx.y;
  const int chunk = blockIdx.x / cl, part = blockIdx.x % cl;
  const long long n = static_cast<long long>(chunk_rows) * N;
  // 8-element-aligned slices keep the 16-byte accesses aligned
  const long long per = ((n + cl - 1) / cl + 7) / 8 * 8;
  const long long lo = min(n, part * per), len = min(n, lo + per) - lo;
  const size_t row0 = static_cast<size_t>(chunk) * chunk_rows;
  const size_t off = (static_cast<size_t>(d) * m + row0) * N + lo;
  T* acc = reinterpret_cast<T*>(out_peers[d]) + row0 * N + lo;
  const bool vec = aligned && N % 8 == 0;
  const P* first =
      reinterpret_cast<const P*>(part_peers[(d + world - 1) % world]) + off;
  if (world == 1) {
    for (long long i = threadIdx.x; i < len; i += blockDim.x)
      acc[i] = tdt_from_f<T>(tdt_to_f<P>(first[i]));
    return;
  }
  float scale = wire_scale(
      fold_cluster_max(fold_slice_amax(first, len, vec), red, slots, 0, cl),
      quant);
  for (int j = 2; j <= world; ++j) {
    const P* add =
        reinterpret_cast<const P*>(part_peers[(d + world - j) % world]) + off;
    float mx = 0.f;
    if (vec) {
      for (long long i = 8ll * threadIdx.x; i < len; i += 8ll * blockDim.x) {
        float c[8], a[8];
        if (j == 2)
          wire_ld8(first + i, c);
        else
          wire_ld8(acc + i, c);
        wire_ld8(add + i, a);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          c[k] = __fadd_rn(wire_value(wire_code(c[k], scale, quant), scale,
                                      quant),
                           MXW ? tdt_round<T>(a[k]) : a[k]);
          mx = fmaxf(mx, fabsf(MXW ? c[k] : tdt_round<T>(c[k])));
        }
        wire_st8(acc + i, c);
      }
    } else {
      for (long long i = threadIdx.x; i < len; i += blockDim.x) {
        const float c = j == 2 ? tdt_to_f<P>(first[i]) : tdt_to_f<T>(acc[i]);
        const float a = tdt_to_f<P>(add[i]);
        const float t = __fadd_rn(
            wire_value(wire_code(c, scale, quant), scale, quant),
            MXW ? tdt_round<T>(a) : a);
        mx = fmaxf(mx, fabsf(MXW ? t : tdt_round<T>(t)));
        acc[i] = tdt_from_f<T>(t);
      }
    }
    // the next hop's scale: the stored sum's amax, or under MXW the f32
    // sum's
    if (j < world)
      scale = wire_scale(fold_cluster_max(mx, red, slots, j - 1, cl), quant);
  }
  // no block leaves while another may still read its slots
  if (cl > 1) cg::this_cluster().sync();
}

// launch gemm_rs_fold_kernel<T, P, MXW>: clusters of up to 8 blocks a
// chunk while the chunks leave the card's SMs idle
template <typename T, typename P, bool MXW>
int launch_fold_kernel(const void* part_peers, const void* out_peers, int m,
                       int N, int world, int rank0, int nranks,
                       int chunk_rows, int quant, int aligned,
                       cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int chunks = m / chunk_rows;
  const long long n = static_cast<long long>(chunk_rows) * N;
  int cl = 1;
  while (cl < 8 && static_cast<long long>(chunks) * nranks * cl < 2 * sms &&
         n / (2 * cl) >= 8 * WIRE_THREADS)
    cl *= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(chunks * cl, nranks);
  cfg.blockDim = dim3(WIRE_THREADS);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, gemm_rs_fold_kernel<T, P, MXW>,
      static_cast<const unsigned long long*>(part_peers),
      static_cast<const unsigned long long*>(out_peers), m, N, world, rank0,
      chunk_rows, quant, cl, aligned);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// a_peers: (world,) pointers to A_q (world * m, K); w_peers: (world,)
// pointers to B_q (K, N); out_peers: (world,) pointers to out_r (m, N).
// zero: one int32 0 (the one expert of the tile loops); a_host / w_host /
// out_host, wgmma and *form as for tdt_ag_gemm. Writes out_r for r in
// [rank0, rank0 + nranks). x_dtype TDT_BF16 or TDT_F32 (B alike),
// out_dtype TDT_BF16 or TDT_F32; aligned: every A and B shard starts on a
// 16-byte boundary.
int tdt_gemm_rs(const void* a_peers, const void* w_peers,
                const void* out_peers, const void* zero, const void* a_host,
                const void* w_host, const void* out_host, int m, int K,
                int N, int world, int rank0, int nranks, int x_dtype,
                int out_dtype, int aligned, int wgmma, int* form,
                void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (m <= 0 || N <= 0 || nranks <= 0) return 0;
  if (wgmma) {
    *form = GEMM_WGMMA;
    return wg_gemm<WgPeerSum>(
        static_cast<const unsigned long long*>(a_host), world * m,
        static_cast<const unsigned long long*>(w_host),
        static_cast<const unsigned long long*>(out_host), nullptr, nullptr,
        m, K, N, world, rank0, nranks, 1, 0, x_dtype, out_dtype,
        static_cast<cudaStream_t>(stream));
  }
  *form = x_dtype == TDT_BF16 ? GEMM_MMA_SYNC : GEMM_FMA;
  const PeerSum rows{static_cast<const unsigned long long*>(a_peers),
                     static_cast<const unsigned long long*>(w_peers),
                     static_cast<const unsigned long long*>(out_peers),
                     m, world, rank0, K, /*grouped=*/false};
  // the kernel's own A, w and out are unused: the rows source reads
  // the peer tables
  return launch_float_ggemm_z(nullptr, nullptr, static_cast<const int*>(zero),
                              nullptr, m, K, N, m, x_dtype, out_dtype,
                              static_cast<cudaStream_t>(stream), rows,
                              aligned != 0, aligned != 0, nranks);
}

// The fp8 / int8 wire, launch (a): a_peers / w_peers as for
// tdt_gemm_rs; part_peers: (world,) pointers to each rank's partial slab
// (world * m, N) of out_dtype: rank q's A_q @ B_q over all its rows.
// a_host / w_host / part_host: the three tables' pointers in host memory;
// wgmma and *form as for tdt_ag_gemm_w. Every rank's partials feed every
// destination's fold, so the launch covers all ranks.
int tdt_gemm_rs_partials(const void* a_peers, const void* w_peers,
                         const void* part_peers, const void* zero,
                         const void* a_host, const void* w_host,
                         const void* part_host, int m, int K, int N,
                         int world, int x_dtype, int out_dtype, int aligned,
                         int wgmma, int* form, void* stream) {
  cudaGetLastError();
  if (m <= 0 || N <= 0 || world <= 0) return 0;
  if (wgmma) {
    *form = GEMM_WGMMA;
    return wg_gemm<WgLocal>(
        static_cast<const unsigned long long*>(a_host), world * m,
        static_cast<const unsigned long long*>(w_host),
        static_cast<const unsigned long long*>(part_host), nullptr, nullptr,
        m, K, N, world, 0, world, 1, 0, x_dtype, out_dtype,
        static_cast<cudaStream_t>(stream));
  }
  *form = x_dtype == TDT_BF16 ? GEMM_MMA_SYNC : GEMM_FMA;
  const PeerLocal rows{static_cast<const unsigned long long*>(a_peers),
                       static_cast<const unsigned long long*>(w_peers),
                       static_cast<const unsigned long long*>(part_peers),
                       world * m, K, 0};
  return launch_float_ggemm_z(nullptr, nullptr, static_cast<const int*>(zero),
                              nullptr, world * m, K, N, world * m, x_dtype,
                              out_dtype, static_cast<cudaStream_t>(stream),
                              rows, aligned != 0, aligned != 0, world);
}

// Launch (b), the fold: part_peers as above; out_peers: (world,)
// pointers to out_r (m, N) of out_dtype (TDT_BF16 or TDT_F32); chunk_rows
// rows share a scale; quant TDT_WIRE_FP8 or TDT_WIRE_INT8; aligned:
// every partial slab and output starts on a 16-byte boundary. Writes
// out_r for r in [rank0, rank0 + nranks).
int tdt_gemm_rs_fold(const void* part_peers, const void* out_peers, int m,
                     int N, int world, int rank0, int nranks, int chunk_rows,
                     int quant, int out_dtype, int aligned, void* stream) {
  cudaGetLastError();
  if (m <= 0 || N <= 0 || nranks <= 0) return 0;
  if (chunk_rows <= 0 || m % chunk_rows ||
      (quant != TDT_WIRE_FP8 && quant != TDT_WIRE_INT8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == TDT_BF16)
    return launch_fold_kernel<__nv_bfloat16, __nv_bfloat16, false>(
        part_peers, out_peers, m, N, world, rank0, nranks, chunk_rows, quant,
        aligned, st);
  if (out_dtype == TDT_F32)
    return launch_fold_kernel<float, float, false>(
        part_peers, out_peers, m, N, world, rank0, nranks, chunk_rows, quant,
        aligned, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The int8-mxu producers, launch (a): q: (world, M, K) int8 codes of
// every rank's A (M = world * m rows), s: (world, M / chunk_rows) f32
// scales; wt: (world, N, K) int8 per-column quantized weights,
// transposed; ws: (world, N) f32 column scales; part_peers: (world,)
// pointers to each rank's partial slab (M, N) of part_dtype (TDT_F32 or
// TDT_BF16). One launch for every rank.
int tdt_gemm_rs_mx(const void* q, const void* s, const void* wt,
                   const void* ws, const void* part_peers, int M, int K,
                   int N, int world, int chunk_rows, int part_dtype,
                   void* stream) {
  cudaGetLastError();
  if (M <= 0 || N <= 0 || world <= 0) return 0;
  if (chunk_rows <= 0 || M % chunk_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const LocalRowsMx rows{static_cast<const int8_t*>(q),
                         static_cast<const float*>(s),
                         static_cast<const unsigned long long*>(part_peers),
                         M, chunk_rows};
  const bool vec = K % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) |
                     reinterpret_cast<uintptr_t>(wt)) & 15) == 0;
  return launch_s8_mma(static_cast<const int8_t*>(wt),
                       static_cast<const float*>(ws), nullptr, M, K, N, M,
                       vec, part_dtype, static_cast<cudaStream_t>(stream),
                       rows, world);
}

// Launch (b) of _fused_kernel_mxw: part_peers: (world,) pointers to the
// f32 partial slabs (world * m, N); out_peers: (world,) pointers to out_r
// (m, N) of out_dtype (TDT_BF16 or TDT_F32); chunk_rows rows share a
// scale; aligned: every slab and output starts on a 16-byte boundary.
// Writes out_r for r in [rank0, rank0 + nranks).
int tdt_gemm_rs_fold_mxw(const void* part_peers, const void* out_peers,
                         int m, int N, int world, int rank0, int nranks,
                         int chunk_rows, int out_dtype, int aligned,
                         void* stream) {
  cudaGetLastError();
  if (m <= 0 || N <= 0 || nranks <= 0) return 0;
  if (chunk_rows <= 0 || m % chunk_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == TDT_BF16)
    return launch_fold_kernel<__nv_bfloat16, float, true>(
        part_peers, out_peers, m, N, world, rank0, nranks, chunk_rows,
        TDT_WIRE_INT8, aligned, st);
  if (out_dtype == TDT_F32)
    return launch_fold_kernel<float, float, true>(
        part_peers, out_peers, m, N, world, rank0, nranks, chunk_rows,
        TDT_WIRE_INT8, aligned, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
