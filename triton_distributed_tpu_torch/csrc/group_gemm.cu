// Grouped GEMM: W8A8 (s8 x s8 -> s32), W8A16, and the float mode.
//
// Replaces triton_distributed_tpu/kernels/group_gemm.py:
//   * _ggemm_q8a_kernel (:74): x (M, K) int8 with per-row f32 scales
//     x_scale (M,), w (E, K, N) int8 with per-(expert, out-channel) f32
//     scales w_scale (E, N); s32 accumulator, epilogue
//     acc * x_scale[m] * w_scale[e, n] cast to the output type. Here the
//     weight is K-major: (E, N, K) codes, the (E, K, N) weight's transpose.
//   * _ggemm_q_kernel (:50): x (M, K) bf16 or f32, w int8 widened to
//     x's dtype, f32 accumulator, epilogue acc * w_scale[e, n].
//   * _ggemm_kernel (:32): x and w both bf16 or both f32, f32
//     accumulator stored to the output type (the bf16 MoE experts).
// The M dim is cut into blocks of block_m rows; block b multiplies the
// weight of expert block_expert[b] (E = 1 with one block for the dense
// projections, E = 64 for the MoE experts).
//
// W8A8, what bounds it on an H100. The serving step's blocks (768 packed
// rows, K 2048, N 6144 / 2048 / 10944; the experts' 8704 sorted rows in
// 64-row blocks, 64 experts of 2048 x 1408 and 1408 x 2048): int8 math
// (19 GOP for wqkv: 0.010 ms at 1979 TOP/s) or, for the experts, their
// 185 MB of weights (0.055 ms at 3.35 TB/s). A decode's blocks of 1 to 16
// rows (Llama-2-7B's M = 8 at K 4096 -> N 12288, 4096, 11008 and K 11008
// -> N 4096; a tp = 4 rank's column or row shard): the weight's bytes
// (wqkv's 50 MB: 0.015 ms).
//
// W8A8, design: one entry, two forms (W8a8Variant, reported to the
// wrapper). Both read the weight K-major, as the integer tensor-core
// instructions take it: wgmma takes 8-bit operands only K-major, and
// ldmatrix moves 16-bit words, so it cannot transpose bytes.
//   * tc (blocks of more than W8_STREAM_ROWS rows): w8a8_tc_kernel,
//     wg_gemm.cuh's shape on int8. A CTA a BM x 256 tile (BM 128, or 64
//     where the blocks are 64 rows: a tile never straddles two experts),
//     one producer warpgroup keeping 4 stages of 128 k in flight by TMA
//     (x's box 128 k x BM rows, the weight's 64 k-rows boxes of a 2-D map
//     over (E N, K), both in the 128-byte swizzle, zeros past M and K),
//     two consumer warpgroups of s32 accumulators on wgmma m64n256k32 (BM
//     128: 64 rows each) or m64n128k32 (BM 64: half the columns each),
//     setmaxnreg 40 / 232; tiles in bands of 8 M-tiles, so that each
//     expert's weight is read from device memory about once; the epilogue
//     stages the tile in shared memory and stores its valid rows in
//     16-byte pieces. The weight's map is encoded once per weight
//     (w8_weight_map), x's per call.
//   * stream (blocks of up to W8_STREAM_ROWS rows): w8a8_stream_kernel,
//     out^T = w^T x^T on mma.sync m16n8k32 s8, the weight's K-major rows
//     the A operand by ldmatrix, x's 8 or 16 rows the n8 side; a 4-stage
//     cp.async ring of 16-byte copies. A CTA takes 16 weight rows, its
//     four warps each a 128-k slice of every 512-k stage (K split across
//     the warps, the s32 sums added in shared memory): N / 16 CTAs, 256
//     at N 4096, 4 resident an SM; past N 8448 (S_WIDE_N) two 16-row
//     groups, two warps each, so that the grid stays near one wave (on an
//     H100 two groups were the faster past that N and 1.3x slower at N
//     4096). Integer sums are exact in any order.
//   * narrow: the stream kernel copying element by element, where K % 16
//     or a base's alignment rules out 16-byte copies and TMA (never on a
//     main path).
// Both run the f32 epilogue (float(acc) * x_scale) * w_scale in that
// order, __fmul_rn: the plain version's bits. Threshold W8_STREAM_ROWS =
// 16, measured on an H100 80GB HBM3 at 700 W (chip_smoke.py
// check_w8a8_threshold, K 4096): at N 4096 the stream form takes 0.0105 /
// 0.0120 ms at 8 / 16 rows against the tc form's 0.0163, and from 24 rows
// tc is the faster; at N 12288 tc is 5 % faster at 8 rows too (0.0220
// against 0.0231), which the rule leaves to the stream form.
//
// The other modes. The lm_head W8A16 product (M = 16 slots, K = 2048, N
// = 102400 for DeepSeek-MoE-16B; M = 8, K = 4096, N = 32000 for Llama-2-
// 7B's decode) reads 210 MB of int8 weights for 6.7 GFLOP and is bound by
// device memory (0.063 ms). The bf16 MoE expert GEMMs (8704 sorted rows,
// 64 experts of 2048 x 1408) do ~50 GFLOP each on 0.4 GB of bf16 weights:
// bound by the tensor cores. The MoE routers' f32 product (M = 768 or 8, K
// 2048, N 64) is bound by the latency of its K-long FMA chains. W8A16 on
// bf16 x (w8a16_tc_kernel, below): the weight
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
// so a tile never straddles two experts. The float loops live in
// ggemm_tiles.cuh, shared with the MoE-TP kernels of moe_tp_fused.cu.
//
// ptxas (sm_90a, -Xptxas=-v in the build log; the smoke fails on a
// spill): w8a8_tc_kernel 168 registers a thread at entry in all four
// instantiations (BM 64 / 128, bf16 / f32 out; setmaxnreg then gives the
// producer 40, the consumers 232); w8a8_stream_kernel 56 (8 rows of x,
// one row group), 96 (8, two), 64 (16, one), 60 (16, two); no spill.

#include <mutex>
#include <unordered_map>

#include "hopper.cuh"
#include "s8_tiles.cuh"

namespace {

// ---------------------------------------------------------------- W8A8
// x (M, K) int8 with per-row f32 scales xs (M,), w int8 K-major: expert
// e's (N, K) codes at w + e N K (the (E, K, N) weight of the JAX kernel,
// transposed, as quantize_grouped_weights(..., k_major=True) stores it),
// per-(expert, column) f32 scales ws (E, N); M-block b multiplies expert
// block_expert[b]. Exact s32 sums, then (float(acc) * xs[m]) * ws[e, n],
// rounded once to the output type: the plain version's bits.

// the form a W8A8 launch ran, as tdt_ggemm_w8a8 reports it
enum W8a8Variant { W8A8_TC = 0, W8A8_STREAM = 1, W8A8_NARROW = 2 };

// blocks of up to this many rows take the stream form (see the note)
constexpr int W8_STREAM_ROWS = 16;

// ---- tc: wgmma s8 x s8 -> s32, TMA stages, a producer warpgroup
constexpr int W8_BN = 256;                // columns a CTA
constexpr int W8_BK = 128;                // k a stage: a 128-byte row
constexpr int W8_STAGES = 4;
constexpr int W8_CONSUMERS = 256;         // two consumer warpgroups
constexpr int W8_THREADS = W8_CONSUMERS + 128;
constexpr int W8_BAND = 8;                // M-tiles a band of the order
constexpr int W8_BOX = 64 * W8_BK;        // a weight box: 64 columns
constexpr int W8_PITCH = W8_BN + 8;       // the epilogue tile's row pitch

template <int BM>
__host__ __device__ constexpr int w8_stage() {
  return BM * W8_BK + (W8_BN / 64) * W8_BOX;
}
template <int BM>
__host__ __device__ constexpr int w8_smem() {
  return W8_STAGES * w8_stage<BM>() + 1024;  // + alignment
}
static_assert(128 * W8_PITCH * 4 <= W8_STAGES * w8_stage<128>() &&
                  64 * W8_PITCH * 4 <= W8_STAGES * w8_stage<64>(),
              "the f32 epilogue tile fits in the stages");

// a launch's operands, a __grid_constant__ parameter
struct W8Params {
  CUtensorMap x;      // (M, K): box 128 k x BM rows, 128-byte swizzle
  CUtensorMap w;      // (E N, K): box 128 k x 64 rows, 128-byte swizzle
  const float* xs;
  const float* ws;
  const int* be;
  void* out;
  int M, K, N, block_m;
};

// A CTA's tile is BM rows (64 or 128, one expert's) x 256 columns. At BM
// 128 each consumer warpgroup takes 64 rows x 256 columns (m64n256k32), at
// BM 64 the tile's 64 rows x 128 columns of its half (m64n128k32); both
// operands K-major from the stages, four products a stage.
template <int BM, typename OutT>
__global__ void __launch_bounds__(W8_THREADS, 1)
    w8a8_tc_kernel(const __grid_constant__ W8Params p) {
  constexpr int NACC = BM == 128 ? 128 : 64;  // a thread's accumulators
  extern __shared__ unsigned char w8_raw[];
  __shared__ uint64_t full[W8_STAGES];   // stage st has landed
  __shared__ uint64_t empty[W8_STAGES];  // the consumers are done with st
  __shared__ float wsc[W8_BN];           // the tile's column scales
  char* sm = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(w8_raw) + 1023) & ~uintptr_t(1023));
  // wg_gemm.cuh's banded order: the CTAs in flight share the band's
  // weights from L2, so an expert's (or a projection's) weight is read
  // from device memory about once
  const int pid = blockIdx.y * gridDim.x + blockIdx.x;
  const int first = pid / (W8_BAND * gridDim.x) * W8_BAND;
  const int band = min(W8_BAND, static_cast<int>(gridDim.y) - first);
  const int in = pid - first * gridDim.x;
  const int m0 = (first + in % band) * BM, n0 = in / band * W8_BN;
  const int e = p.be[m0 / p.block_m];
  const int nk = (p.K + W8_BK - 1) / W8_BK;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < W8_STAGES; ++st) {
      tc_bar_init(&full[st], 1);
      tc_bar_init(&empty[st], W8_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= W8_CONSUMERS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == W8_CONSUMERS) {
      // the weight boxes that start inside N (the rest would only feed
      // columns the epilogue never stores)
      const int nbox = min(W8_BN / 64, (p.N - n0 + 63) / 64);
      const int bytes = BM * W8_BK + nbox * W8_BOX;
      const int wrow = e * p.N + n0;
      for (int i = 0; i < nk; ++i) {
        const int st = i % W8_STAGES;
        if (i >= W8_STAGES) tc_bar_wait(&empty[st], (i / W8_STAGES + 1) & 1);
        char* s = sm + st * w8_stage<BM>();
        tc_bar_expect(&full[st], bytes);
        tc_tma_2d(s, &p.x, &full[st], i * W8_BK, m0);
        for (int j = 0; j < nbox; ++j)
          tc_tma_2d(s + BM * W8_BK + j * W8_BOX, &p.w, &full[st], i * W8_BK,
                    wrow + 64 * j);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int row0 = BM == 128 ? 64 * wg : 0;   // this warpgroup's rows
  const int col0 = BM == 128 ? 0 : 128 * wg;  // and columns
  int acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0;
  for (int i = 0; i < nk; ++i) {
    const int st = i % W8_STAGES;
    tc_bar_wait(&full[st], (i / W8_STAGES) & 1);
    const char* s = sm + st * w8_stage<BM>();
    wg_pin(acc);
    wg_fence();
    // 8-row groups 1024 bytes apart, k step kk 32 bytes into the rows
#pragma unroll
    for (int kk = 0; kk < W8_BK / 32; ++kk)
      wg_ss_s8(acc, wg_desc(s + row0 * W8_BK + kk * 32, 16, 1024, 1),
               wg_desc(s + BM * W8_BK + col0 * W8_BK + kk * 32, 16, 1024, 1),
               1);
    wg_commit();
    wg_wait<1>();  // the previous stage's products have retired
    if (i > 0) {
      __syncwarp();
      if (lane == 0) tc_bar_arrive(&empty[(i - 1) % W8_STAGES]);
    }
  }
  wg_wait<0>();
  wg_pin(acc);

  // the epilogue: scales, then the tile through shared memory (every stage
  // is consumed) and 16-byte stores of its valid rows. Accumulator 4j + v:
  // row r + 8 (v >> 1), column col0 + 8j + 2tq + (v & 1)
  asm volatile("bar.sync 1, %0;\n" :: "n"(W8_CONSUMERS) : "memory");
  wsc[threadIdx.x] = n0 + static_cast<int>(threadIdx.x) < p.N
                         ? p.ws[static_cast<size_t>(e) * p.N + n0 + threadIdx.x]
                         : 0.f;
  const int r = row0 + (warp & 3) * 16 + g;
  const float sx0 = m0 + r < p.M ? p.xs[m0 + r] : 0.f;
  const float sx1 = m0 + r + 8 < p.M ? p.xs[m0 + r + 8] : 0.f;
  asm volatile("bar.sync 1, %0;\n" :: "n"(W8_CONSUMERS) : "memory");
  OutT* stile = reinterpret_cast<OutT*>(sm);
#pragma unroll
  for (int j = 0; j < NACC / 4; ++j) {
    const int c = col0 + 8 * j + 2 * tq;
    // (acc * x_scale) * w_scale, the order of the TPU epilogue
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = __fmul_rn(__fmul_rn(static_cast<float>(acc[4 * j + q]),
                                 q < 2 ? sx0 : sx1),
                       wsc[c + (q & 1)]);
    stile[r * W8_PITCH + c] = tdt_from_f<OutT>(v[0]);
    stile[r * W8_PITCH + c + 1] = tdt_from_f<OutT>(v[1]);
    stile[(r + 8) * W8_PITCH + c] = tdt_from_f<OutT>(v[2]);
    stile[(r + 8) * W8_PITCH + c + 1] = tdt_from_f<OutT>(v[3]);
  }
  asm volatile("bar.sync 1, %0;\n" :: "n"(W8_CONSUMERS) : "memory");
  constexpr int E = 16 / static_cast<int>(sizeof(OutT));  // a piece
  constexpr int PIECES = W8_BN / E;                        // a row's
  const int rows = min(BM, p.M - m0);
  OutT* out = static_cast<OutT*>(p.out);
  for (int idx = threadIdx.x; idx < rows * PIECES; idx += W8_CONSUMERS) {
    const int row = idx / PIECES, col = (idx % PIECES) * E;
    if (n0 + col < p.N)
      *reinterpret_cast<uint4*>(
          out + static_cast<size_t>(m0 + row) * p.N + n0 + col) =
          *reinterpret_cast<const uint4*>(stile + row * W8_PITCH + col);
  }
}

// the weight's map, encoded once per (codes, E N, K): what a map holds is
// those three and this kernel's box, so a hit is always the right map
inline bool w8_weight_map(CUtensorMap* map, const void* w, long long rows,
                          int K) {
  struct Key {
    uintptr_t p;
    long long rows;
    int k;
    bool operator==(const Key& o) const {
      return p == o.p && rows == o.rows && k == o.k;
    }
  };
  struct Hash {
    size_t operator()(const Key& k) const {
      return std::hash<uintptr_t>()(k.p) ^
             (std::hash<long long>()(k.rows) * 31 + k.k);
    }
  };
  static std::mutex mu;
  static std::unordered_map<Key, CUtensorMap, Hash> cache;
  const Key key{reinterpret_cast<uintptr_t>(w), rows, K};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return true;
  }
  if (!tc_map_2d(map, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, rows, K, K, W8_BK,
                 64, CU_TENSOR_MAP_SWIZZLE_128B))
    return false;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return true;
}

template <int BM, typename OutT>
int w8a8_tc_launch(W8Params& p, cudaStream_t s) {
  static bool attr = false;  // above 48 KB only after this, once a kernel
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        w8a8_tc_kernel<BM, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        w8_smem<BM>());
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = true;
  }
  const dim3 grid((p.N + W8_BN - 1) / W8_BN, (p.M + BM - 1) / BM);
  w8a8_tc_kernel<BM, OutT><<<grid, W8_THREADS, w8_smem<BM>(), s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---- stream: mma.sync m16n8k32 with the weight as the A operand
constexpr int S_WARPS = 4;
constexpr int S_THREADS = 32 * S_WARPS;
constexpr int S_KW = 128;                // k a warp takes of a stage
constexpr int S_STAGES = 4;
// past this N a CTA takes two 16-row groups: N / 16 CTAs of one would
// outnumber the 528 an H100 holds (4 an SM), and the second wave costs
// more than fatter CTAs (measured: see the note)
constexpr int S_WIDE_N = 8448;

// a stage holds RW 16-row groups of the weight and MT rows of x, each row
// (4 / RW) 128-k slices and 16 bytes more (16-byte aligned, ldmatrix
// conflict-free)
template <int RW>
__host__ __device__ constexpr int s_pitch() {
  return S_WARPS / RW * S_KW + 16;
}
template <int MT, int RW>
__host__ __device__ constexpr int s_smem() {
  return S_STAGES * (16 * RW + MT) * s_pitch<RW>();
}

// out^T = w^T x^T: a CTA's 16 RW weight rows (output columns n0 ..) are
// RW m16 tiles of A, the MT (8 or 16) rows of x its n8 tiles; warp w takes
// row group w % RW and the (w / RW)-th 128-byte slice of every stage of K,
// and the slices' s32 sums meet in shared memory (integer sums: exact in
// any order). vec: 16-byte cp.async copies (K % 16 == 0, 16-byte aligned
// bases), else element by element (the narrow form).
template <int MT, int RW, typename OutT>
__global__ void __launch_bounds__(S_THREADS)
    w8a8_stream_kernel(const int8_t* __restrict__ x,
                       const float* __restrict__ xs,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ ws,
                       const int* __restrict__ block_expert,
                       OutT* __restrict__ out, int M, int K, int N,
                       int block_m, bool vec) {
  constexpr int NT = MT / 8;          // x's 8-row tiles
  constexpr int KS = S_WARPS / RW;    // k slices a stage
  constexpr int ROWS = 16 * RW;       // weight rows a CTA
  constexpr int BK = KS * S_KW;       // k a stage
  constexpr int PITCH = s_pitch<RW>();
  constexpr int STAGE = (ROWS + MT) * PITCH;
  extern __shared__ __align__(16) unsigned char s_smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp % RW, ks = warp / RW;
  const int n0 = blockIdx.x * ROWS, m0 = blockIdx.y * MT;
  const int e = block_expert[m0 / block_m];
  const int8_t* __restrict__ we = w + static_cast<size_t>(e) * N * K;
  const int nk = (K + BK - 1) / BK;

  // stage st: the weight's rows n0 .. n0 + ROWS - 1, then x's rows m0 ..
  auto load = [&](int st, int k0) {
    unsigned char* s = s_smem_raw + st * STAGE;
    if (vec) {
      for (int c = tid; c < (ROWS + MT) * (BK / 16); c += S_THREADS) {
        const int r = c / (BK / 16), kk = k0 + (c % (BK / 16)) * 16;
        const int8_t* src = nullptr;
        if (kk < K) {
          if (r < ROWS) {
            if (n0 + r < N) src = we + static_cast<size_t>(n0 + r) * K + kk;
          } else if (m0 + r - ROWS < M) {
            src = x + static_cast<size_t>(m0 + r - ROWS) * K + kk;
          }
        }
        gg_cp_async16(s + r * PITCH + (kk - k0), src ? src : x,
                      src ? 16 : 0);
      }
    } else {
      for (int c = tid; c < (ROWS + MT) * BK; c += S_THREADS) {
        const int r = c / BK, kk = k0 + c % BK;
        int8_t v = 0;
        if (kk < K) {
          if (r < ROWS) {
            if (n0 + r < N) v = we[static_cast<size_t>(n0 + r) * K + kk];
          } else if (m0 + r - ROWS < M) {
            v = x[static_cast<size_t>(m0 + r - ROWS) * K + kk];
          }
        }
        s[r * PITCH + (kk - k0)] = static_cast<unsigned char>(v);
      }
    }
  };

  int acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[j][v] = 0;

#pragma unroll
  for (int st = 0; st < S_STAGES - 1; ++st) {
    if (st < nk) load(st, st * BK);
    gg_cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    gg_cp_wait<S_STAGES - 2>();
    __syncthreads();
    if (kt + S_STAGES - 1 < nk)
      load((kt + S_STAGES - 1) % S_STAGES, (kt + S_STAGES - 1) * BK);
    gg_cp_commit();
    const unsigned char* s =
        s_smem_raw + (kt % S_STAGES) * STAGE + ks * S_KW;
#pragma unroll
    for (int kk = 0; kk < S_KW; kk += 32) {
      // A: weight rows 16 rg .. + 15 x k 0-31 (the four 8 x 16-byte
      // matrices in m16n8k32's register order); B: x rows 0-7 (and 8-15)
      uint32_t a[4], b[4];
      ldsm_x4(a, s + (16 * rg + (lane & 15)) * PITCH + kk + (lane >> 4) * 16);
      ldsm_x4(b, s + (ROWS + (lane & 7) + (NT > 1 ? (lane >> 4) << 3 : 0)) *
                         PITCH + kk + ((lane >> 3) & 1) * 16);
      mma_s8(acc[0], a, b[0], b[1]);
      if constexpr (NT > 1) mma_s8(acc[1], a, b[2], b[3]);
    }
  }
  gg_cp_wait<0>();
  __syncthreads();

  // the slices' sums through shared memory: lane (g, tq) holds columns
  // n0 + 16 rg + g (+ 8) of x rows 8j + 2tq (+ 1)
  int* red = reinterpret_cast<int*>(s_smem_raw);  // [ks][MT][ROWS]
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v)
      red[(ks * MT + 8 * j + 2 * tq + (v & 1)) * ROWS + 16 * rg + g +
          8 * (v >> 1)] = acc[j][v];
  __syncthreads();
  for (int idx = tid; idx < MT * ROWS; idx += S_THREADS) {
    const int m = m0 + idx / ROWS, n = n0 + idx % ROWS;
    if (m >= M || n >= N) continue;
    int sum = 0;
#pragma unroll
    for (int q = 0; q < KS; ++q) sum += red[q * MT * ROWS + idx];
    // (acc * x_scale) * w_scale, the order of the TPU epilogue
    const float v = __fmul_rn(__fmul_rn(static_cast<float>(sum), xs[m]),
                              ws[static_cast<size_t>(e) * N + n]);
    out[static_cast<size_t>(m) * N + n] = tdt_from_f<OutT>(v);
  }
}

template <int MT, typename OutT, int RW>
int w8a8_stream_launch(const int8_t* x, const float* xs, const int8_t* w,
                       const float* ws, const int* be, void* out, int M,
                       int K, int N, int block_m, bool vec, cudaStream_t s) {
  constexpr int bytes = s_smem<MT, RW>();
  static bool attr = false;  // above 48 KB only after this, once a kernel
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        w8a8_stream_kernel<MT, RW, OutT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = true;
  }
  const dim3 grid((N + 16 * RW - 1) / (16 * RW), (M + MT - 1) / MT);
  w8a8_stream_kernel<MT, RW, OutT><<<grid, S_THREADS, bytes, s>>>(
      x, xs, w, ws, be, static_cast<OutT*>(out), M, K, N, block_m, vec);
  return static_cast<int>(cudaGetLastError());
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
constexpr int QK16 = 64;         // k a stage
constexpr int QSTAGES = 4;
constexpr int Q_THREADS = 128;   // four warps of 32 columns
constexpr int QWP = QBN + 16;    // a weight row in shared memory (bytes)
constexpr int QXP = QK16 + 8;    // an x row in shared memory (bf16)

template <int MT>
__host__ __device__ constexpr int q_stage_bytes() {
  return QK16 * QWP + MT * QXP * 2;
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
  const int nk = (K + QK16 - 1) / QK16;

  unsigned char* const smem = q_smem;
  auto wst = [&](int st) { return smem + st * q_stage_bytes<MT>(); };
  auto xst = [&](int st) {
    return reinterpret_cast<unsigned short*>(wst(st) + QK16 * QWP);
  };
  auto load = [&](int st, int k0) {
    unsigned char* wsm = wst(st);
    unsigned short* xsm = xst(st);
    if (vec) {
      for (int c = tid; c < QK16 * (QBN / 16); c += Q_THREADS) {
        const int kr = c / (QBN / 16), nn = n0 + (c % (QBN / 16)) * 16;
        const bool ok = k0 + kr < K && nn < N;
        gg_cp_async16(wsm + kr * QWP + (nn - n0),
                      ok ? we + static_cast<size_t>(k0 + kr) * N + nn : we,
                      ok ? 16 : 0);
      }
      for (int c = tid; c < MT * (QK16 / 8); c += Q_THREADS) {
        const int r = c / (QK16 / 8), kk = k0 + (c % (QK16 / 8)) * 8;
        const bool ok = m0 + r < M && kk < K;
        gg_cp_async16(xsm + r * QXP + (kk - k0),
                      ok ? x + static_cast<size_t>(m0 + r) * K + kk : x,
                      ok ? 16 : 0);
      }
    } else {
      for (int c = tid; c < QK16 * QBN; c += Q_THREADS) {
        const int kr = c / QBN, nn = n0 + c % QBN;
        wsm[kr * QWP + (nn - n0)] =
            (k0 + kr < K && nn < N)
                ? static_cast<unsigned char>(we[static_cast<size_t>(k0 + kr) * N + nn])
                : 0;
      }
      for (int c = tid; c < MT * QK16; c += Q_THREADS) {
        const int r = c / QK16, kk = k0 + c % QK16;
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
    if (st < nk) load(st, st * QK16);
    gg_cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    gg_cp_wait<QSTAGES - 2>();
    __syncthreads();
    if (kt + QSTAGES - 1 < nk)
      load((kt + QSTAGES - 1) % QSTAGES, (kt + QSTAGES - 1) * QK16);
    gg_cp_commit();
    const unsigned char* wsm = wst(kt % QSTAGES) + warp * 32 + 4 * g;
    const unsigned short* xsm = xst(kt % QSTAGES);
#pragma unroll
    for (int kk = 0; kk < QK16; kk += 16) {
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

// out_dtype: TDT_F32 or TDT_BF16; w: the K-major codes (E, N, K); form: -1
// to choose by W8_STREAM_ROWS, W8A8_TC or W8A8_STREAM to ask for one (the
// threshold's measurement; cudaErrorInvalidValue where the shape rules it
// out); *variant: the form launched (W8a8Variant)
int tdt_ggemm_w8a8(const void* x, const void* x_scale, const void* w,
                   const void* w_scale, const void* block_expert, void* out,
                   int M, int K, int N, int E, int block_m, int out_dtype,
                   int form, int* variant, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (M <= 0 || N <= 0) return 0;
  if (out_dtype != TDT_F32 && out_dtype != TDT_BF16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xq = static_cast<const int8_t*>(x);
  const float* xs = static_cast<const float*>(x_scale);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* wsp = static_cast<const float*>(w_scale);
  const int* be = static_cast<const int*>(block_expert);
  const bool f32 = out_dtype == TDT_F32;
  // 16-byte rows and bases: TMA and the 16-byte copies take them
  const bool vec = ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(w)) & 15) == 0 && K % 16 == 0;
  const bool tc = vec && N % 8 == 0 &&
                  (reinterpret_cast<uintptr_t>(out) & 15) == 0 &&
                  (block_m == M || block_m % 64 == 0);
  if ((form == W8A8_TC && !tc) || (form == W8A8_STREAM && !vec))
    return static_cast<int>(cudaErrorInvalidValue);
  if (form == W8A8_TC || (form < 0 && tc && block_m > W8_STREAM_ROWS)) {
    *variant = W8A8_TC;
    W8Params p = {};
    // 128-row tiles where the blocks are whole 128-row tiles (or one
    // block of more than 64 rows), else 64: a tile never straddles two
    // experts
    const bool bm128 = block_m == M ? M > 64 : block_m % 128 == 0;
    if (!tc_map_2d(&p.x, x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M, K, K, W8_BK,
                   bm128 ? 128 : 64, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !w8_weight_map(&p.w, w, static_cast<long long>(E) * N, K))
      return static_cast<int>(cudaErrorInvalidValue);
    p.xs = xs;
    p.ws = wsp;
    p.be = be;
    p.out = out;
    p.M = M;
    p.K = K;
    p.N = N;
    p.block_m = block_m;
    if (bm128)
      return f32 ? w8a8_tc_launch<128, float>(p, s)
                 : w8a8_tc_launch<128, __nv_bfloat16>(p, s);
    return f32 ? w8a8_tc_launch<64, float>(p, s)
               : w8a8_tc_launch<64, __nv_bfloat16>(p, s);
  }
  // the stream form over 8 or 16 rows of x a CTA (16 where it tiles more
  // rows, or copies element by element), one or two 16-row groups of the
  // weight
  *variant = vec ? W8A8_STREAM : W8A8_NARROW;
#define TDT_W8A8_S(MT, OT, RW) \
  w8a8_stream_launch<MT, OT, RW>(xq, xs, wq, wsp, be, out, M, K, N, block_m, \
                                 vec, s)
#define TDT_W8A8_S2(MT, OT) \
  (N > S_WIDE_N ? TDT_W8A8_S(MT, OT, 2) : TDT_W8A8_S(MT, OT, 1))
  if (vec && M <= 8)
    return f32 ? TDT_W8A8_S2(8, float) : TDT_W8A8_S2(8, __nv_bfloat16);
  return f32 ? TDT_W8A8_S2(16, float) : TDT_W8A8_S2(16, __nv_bfloat16);
#undef TDT_W8A8_S2
#undef TDT_W8A8_S
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
