// The warpgroup GEMM of the mesh kernels on Hopper: wgmma fed by TMA, shared
// by ag_gemm.cu (tdt_ag_gemm, the bf16 AG-GEMM over a mesh and at world
// size 1; tdt_ag_gemm_w, the AG-GEMM on the fp8 / int8 wire) and gemm_rs.cu
// (tdt_gemm_rs, the bf16 GEMM-RS over a mesh and at world size 1;
// tdt_gemm_rs_partials, the GEMM-RS wire's partials), and in a grouped,
// persistent form (wg_grouped_kernel, at the end of this file) by
// moe_tp_fused.cu (the MoE-TP GEMMs in bf16 over a mesh and at world size
// 1, and the MoE-TP wire's AG and partials). It computes what
// ggemm_tiles.cuh's bf16_mma_kernel computes over the PeerRows, PeerSum,
// PeerRowsQ and PeerLocal rows (grouped: PeerGatherRows, grouped PeerSum,
// PeerGatherRowsQ and PeerLocal with the block -> expert table), f32 sums
// rounded once at the store, and runs where wg_form_ok (wg_grouped_form_ok)
// holds; the launchers take bf16_mma_kernel elsewhere.
//
// What bounds it on an H100: the tensor cores. At the Llama-2-7B tp = 4
// prefill (the AG-GEMM: A 4 x (2048, 4096), B_r (4096, 3072) or (4096,
// 2752); the GEMM-RS: A_q (8192, 1024 or 2752), B_q (., 4096), and its
// wire's partials alike) one launch over the four ranks is 2 * 8192 *
// 4096 * 4 * N_r (0.79 ms average at 989 TFLOP/s) or 2 * 4 * 8192 * K_q *
// 4096 flops.
//
// Design. One CTA an output tile of WG_BM x WG_BN = 128 x 256 of one rank
// (blockIdx.z), 384 threads: two consumer warpgroups of 64 rows each (128
// f32 accumulators a thread) and a producer warpgroup, one thread of
// which keeps WG_STAGES K steps of WG_BK = 64 in flight by TMA on
// mbarriers (a `full` and an `empty` barrier a stage): B, the bf16 (K, N)
// weight, is wgmma's
// MN-major operand, four boxes of 64 k x 64 n in the 128-byte swizzle, and
// boxes past N are not loaded (their columns are never stored); K's and
// N's edges land as zeros. ptxas gives the CTA 168 registers a thread;
// setmaxnreg then moves the producer warpgroup's to the consumers (40 and
// 232: 128 x 128 released, 256 x 64 taken, the CTA's own pool), room for
// the accumulators and two stages of code fragments. A tile's rows lie in
// one A source, so each CTA takes one of two main loops, a uniform
// branch:
// - bf16 A (the AG's own shard, exact; every partial's A_r): a box of 128
//   rows x 64 k in the 128-byte swizzle, K-major, both operands of each
//   m64n256k16 from shared memory; a stage is released once its products
//   have retired (one group a stage, wait_group 1).
// - a peer's wire codes (the AG's other shards): a box of 128 rows x 64
//   one-byte codes in the 64-byte swizzle; each consumer thread reads its
//   fragment rows' code pairs as 32-bit words (conflict-free: the swizzle
//   spreads a warp's 8 rows over the 32 banks), converts each pair as
//   wire_value2 and __floats2bfloat162_rn do (the plain version's values,
//   bit for bit) into the m16n8k16 A fragment, and feeds the register-A
//   m64n256k16. A stage's fragments are converted while the previous
//   stage's products run (wait_group 1; two buffers of a stage's four k
//   steps). A row's scale is its chunk's, looked up once a CTA.
// The epilogue stages the tile through shared memory (rows padded by 16
// bytes: conflict-free) and stores it in 16-byte pieces, ragged in N and
// in M: only the tile's first `rows` rows are stored (those of its shard,
// or of its destination; TMA fills A's rows past its map with zeros).
//
// Row sources (as bf16_mma_kernel's), compile-time: tiles(p) is the
// grid's M-tile count, tile(p, m0, part) says where tile m0's A rows and
// B come from, where its rows land and how many of them are stored; with
// parts(p) > 1 the K loop runs over (part, k step): WgPeerSum's sum over
// ranks. Every part's stage carries the same bytes (TMA counts a box's
// zero fill), so the producer's count holds across parts.
#pragma once

#include "hopper.cuh"
#include "wire.cuh"

// the form a mesh GEMM launch ran, as its C entry reports it
enum MeshGemmForm { GEMM_FMA = 0, GEMM_MMA_SYNC = 1, GEMM_WGMMA = 2 };

namespace {

constexpr int WG_BM = 128;              // rows a CTA: two warpgroups of 64
constexpr int WG_BN = 256;              // columns a CTA
constexpr int WG_BK = 64;               // k a stage
constexpr int WG_STAGES = 4;            // stages in flight
constexpr int WG_CONSUMERS = 256;       // the two consumer warpgroups
constexpr int WG_THREADS = WG_CONSUMERS + 128;  // + the producer warpgroup
constexpr int WG_MAX_RANKS = 8;         // the maps a launch carries
constexpr int WG_BAND = 8;              // M-tiles a band of the tile order
constexpr int WG_A_BYTES = WG_BM * WG_BK * 2;  // a bf16 A box
constexpr int WG_Q_BYTES = WG_BM * WG_BK;      // a codes box
constexpr int WG_BOX_BYTES = WG_BK * 64 * 2;   // a B box: 64 k x 64 n
constexpr int WG_STAGE = WG_A_BYTES + (WG_BN / 64) * WG_BOX_BYTES;
constexpr int WG_PITCH = WG_BN + 8;     // the epilogue's row pitch
constexpr int WG_SMEM = WG_STAGES * WG_STAGE + 1024;  // + alignment
static_assert(WG_BM * WG_PITCH * 4 <= WG_STAGES * WG_STAGE,
              "the f32 epilogue tile fits in the stages");

// a launch's operands, a __grid_constant__ parameter (2.3 KB of the 4 KB):
// each rank's maps and output, the wire's codes and scales
struct WgParams {
  CUtensorMap a[WG_MAX_RANKS];  // bf16 (rows, K): box 64 k x 128 rows
  CUtensorMap b[WG_MAX_RANKS];  // bf16 (K, N): box 64 n x 64 k
  CUtensorMap q;                // codes (world * m, K): box 64 k x 128 rows
  unsigned long long out[WG_MAX_RANKS];  // each rank's output (rows, N)
  const float* s;               // the codes' scales (world, m / chunk_rows)
  int m, world, rank0, K, N, chunk_rows;
};

// what tile m0 of rank rank0 + blockIdx.z reads and where it lands
struct WgTile {
  const CUtensorMap* a;  // its A rows' map (bf16, or the codes)
  int a_row;             // their first row in that map
  bool codes;            // A is a peer's wire codes
  const CUtensorMap* b;  // B's map
  int out_row;           // the tile's first output row
  int rows;              // its rows that are stored, the first `rows`
};

// tdt_ag_gemm_w: PeerRowsQ's rotated rows. Tile row t is gathered row g =
// (t + r * m) mod (W * m), row g % m of shard g / m; with m a multiple of
// WG_BM a tile lies in one shard, so it is all rank r's own rows (bf16,
// exact) or all one peer's codes (row g of q), and lands at rows g, g + 1,
// ...
struct WgPeerRowsQ {
  static constexpr bool kQuant = true;
  static int tiles(const WgParams& p) { return p.world * p.m / WG_BM; }
  __device__ static int parts(const WgParams&) { return 1; }
  __device__ static WgTile tile(const WgParams& p, int m0, int) {
    const int r = p.rank0 + blockIdx.z;
    const int g = (m0 + r * p.m) % (p.world * p.m);
    if (g / p.m == r)
      return WgTile{&p.a[r], g % p.m, false, &p.b[r], g, WG_BM};
    return WgTile{&p.q, g, true, &p.b[r], g, WG_BM};
  }
  // gathered row g's scale (a peer's): PeerRowsQ::at's
  __device__ static float scale(const WgParams& p, int g) {
    return p.s[(g / p.m) * (p.m / p.chunk_rows) + (g % p.m) / p.chunk_rows];
  }
};

// tdt_gemm_rs_partials: PeerLocal's rows. Rank r's own A_r (W * m, K)
// against its own B_r, rows in place, into its slab of partials.
struct WgLocal {
  static constexpr bool kQuant = false;
  static int tiles(const WgParams& p) {
    return (p.world * p.m + WG_BM - 1) / WG_BM;
  }
  __device__ static int parts(const WgParams&) { return 1; }
  __device__ static WgTile tile(const WgParams& p, int m0, int) {
    const int r = p.rank0 + blockIdx.z;
    return WgTile{&p.a[r], m0, false, &p.b[r], m0,
                  min(WG_BM, p.world * p.m - m0)};
  }
};

// tdt_ag_gemm in bf16 (over a mesh, and at world size 1 on a one-rank
// table): PeerRows' gathered rows, every shard tiled on its own, ceil(m /
// WG_BM) tiles a shard, so that any m >= 1 takes the loop. Rank r's tile
// t is tile t % per of shard s = (t / per + r) mod W (its own shard first,
// PeerRows' rotation; the order only schedules the work): A_s's rows i0,
// i0 + 1, ... (i0 = (t % per) * WG_BM; A_s's map holds m rows, so TMA
// fills the rows past m with zeros), landing at gathered rows s * m + i0,
// ...; the first m - i0 of them are stored.
struct WgPeerRows {
  static constexpr bool kQuant = false;
  static int tiles(const WgParams& p) {
    return p.world * ((p.m + WG_BM - 1) / WG_BM);
  }
  __device__ static int parts(const WgParams&) { return 1; }
  __device__ static WgTile tile(const WgParams& p, int m0, int) {
    const int r = p.rank0 + blockIdx.z, per = (p.m + WG_BM - 1) / WG_BM;
    const int t = m0 / WG_BM, s = (t / per + r) % p.world;
    const int i0 = (t % per) * WG_BM;
    return WgTile{&p.a[s], i0, false, &p.b[r], s * p.m + i0,
                  min(WG_BM, p.m - i0)};
  }
};

// tdt_gemm_rs in bf16 (over a mesh, and at world size 1 on a one-rank
// table): PeerSum's rows. Destination r's tile m0 sums world parts: part q
// reads A_q's rows r * m + m0, ... (A_q's map holds all W * m rows) against
// B_q, in the f32 accumulators over (part, k step); rows m0, ... of out_r
// (m rows), the first m - m0 stored. A tile's rows past m read rank r +
// 1's rows (or TMA's zeros past W * m), and none of those is stored.
struct WgPeerSum {
  static constexpr bool kQuant = false;
  static int tiles(const WgParams& p) { return (p.m + WG_BM - 1) / WG_BM; }
  __device__ static int parts(const WgParams& p) { return p.world; }
  __device__ static WgTile tile(const WgParams& p, int m0, int q) {
    const int r = p.rank0 + blockIdx.z;
    return WgTile{&p.a[q], r * p.m + m0, false, &p.b[q], m0,
                  min(WG_BM, p.m - m0)};
  }
};

// the bf16x2 A-fragment word of a code pair (its lower k in the low byte
// of `pair`, the low half of the word) at `scale`: wire_value2's values
// (code * scale in f32), then one round-to-nearest of both to bf16, as
// PeerRowsQ::qload8 converts. An int8 code is widened without I2F (a
// quarter-rate instruction): its byte, biased by 0x80, as the low byte of
// the f32 2^23, minus 2^23 + 128, is the code exactly
template <int QUANT>
__device__ __forceinline__ uint32_t wg_code_pair(uint32_t pair, float scale) {
  float2 v;
  if constexpr (QUANT == TDT_WIRE_INT8) {
    const uint32_t u = pair ^ 0x8080u;
    v = make_float2(
        __fmul_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) -
                      8388736.f, scale),
        __fmul_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) -
                      8388736.f, scale));
  } else {
    v = wire_value2(static_cast<uint8_t>(pair),
                    static_cast<uint8_t>(pair >> 8), scale, QUANT);
  }
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// the consumers' barrier (the producer warpgroup is not in it)
__device__ __forceinline__ void wg_consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(WG_CONSUMERS) : "memory");
}

// QUANT: the wire's codes (TDT_WIRE_FP8 / TDT_WIRE_INT8) of a kQuant
// source, 0 for one whose tiles never read codes
template <typename OutT, typename Src, int QUANT>
__global__ void __launch_bounds__(WG_THREADS, 1)
    wg_gemm_kernel(const __grid_constant__ WgParams p) {
  constexpr int NACC = WG_BN / 2;  // a thread's accumulators
  extern __shared__ unsigned char wg_raw[];
  __shared__ uint64_t full[WG_STAGES];   // stage st has landed
  __shared__ uint64_t empty[WG_STAGES];  // the consumers are done with st
  char* sm = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(wg_raw) + 1023) & ~uintptr_t(1023));
  // the CTA's tile of its rank's grid, in bands of WG_BAND M-tiles, the
  // M-tiles fastest within a band: the CTAs in flight share B's column
  // blocks and the band's A rows from L2, so that a B past L2's 50 MB (the
  // world-size-1 wqkv's 100 MB) is read once a band, not once every few
  // M-tiles as in row order
  const int pid = blockIdx.y * gridDim.x + blockIdx.x;
  const int first = pid / (WG_BAND * gridDim.x) * WG_BAND;
  const int band = min(WG_BAND, static_cast<int>(gridDim.y) - first);
  const int in = pid - first * gridDim.x;
  const int m0 = (first + in % band) * WG_BM, n0 = in / band * WG_BN;
  const int nk = (p.K + WG_BK - 1) / WG_BK;
  const int total = Src::parts(p) * nk;
  const WgTile tile = Src::tile(p, m0, 0);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < WG_STAGES; ++st) {
      tc_bar_init(&full[st], 1);
      tc_bar_init(&empty[st], WG_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= WG_CONSUMERS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == WG_CONSUMERS) {
      // B's boxes that start inside N (the rest would only feed columns
      // the epilogue never stores)
      const int nbox = min(WG_BN / 64, (p.N - n0 + 63) / 64);
      const int bytes =
          (tile.codes ? WG_Q_BYTES : WG_A_BYTES) + nbox * WG_BOX_BYTES;
      for (int i = 0; i < total; ++i) {
        const int st = i % WG_STAGES, k0 = (i % nk) * WG_BK;
        const WgTile t = i < nk ? tile : Src::tile(p, m0, i / nk);
        if (i >= WG_STAGES) tc_bar_wait(&empty[st], (i / WG_STAGES + 1) & 1);
        char* s = sm + st * WG_STAGE;
        tc_bar_expect(&full[st], bytes);
        tc_tma_2d(s, t.a, &full[st], k0, t.a_row);
        for (int j = 0; j < nbox; ++j)
          tc_tma_2d(s + WG_A_BYTES + j * WG_BOX_BYTES, t.b, &full[st],
                    n0 + 64 * j, k0);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  // this thread's fragment rows of the tile: r0 and r0 + 8
  const int r0 = wg * 64 + (warp & 3) * 16 + g;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  // B of k step kk of a stage: 8-k groups 1024 bytes apart, the boxes of
  // 64 n 8192 apart
  auto bdesc = [&](const char* s, int kk) {
    return wg_desc(s + WG_A_BYTES + kk * 2048, WG_BOX_BYTES, 1024, 1);
  };
  // a warp is done with stage st
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) tc_bar_arrive(&empty[st]);
  };

  if (!tile.codes) {
    // bf16 A from shared memory: this warpgroup's 64 rows, 8-row groups
    // 1024 bytes apart, k step kk 32 bytes into the 128-byte rows
    for (int i = 0; i < total; ++i) {
      const int st = i % WG_STAGES;
      tc_bar_wait(&full[st], (i / WG_STAGES) & 1);
      const char* s = sm + st * WG_STAGE;
      wg_pin(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk)
        wg_ss_t(acc, wg_desc(s + wg * 8192 + kk * 32, 16, 1024, 1),
                bdesc(s, kk), 1);
      wg_commit();
      wg_wait<1>();  // the previous stage's products have retired
      if (i > 0) release((i - 1) % WG_STAGES);
    }
  } else if constexpr (QUANT != 0) {
    // the codes, 64-byte rows in the 64-byte swizzle: 16-byte chunk c of
    // row r at chunk c ^ ((r >> 1) & 3). Register i of the fragment of k
    // step kk: row r0 + 8 (i & 1), codes 16 kk + 8 (i >> 1) + 2 tq, + 1,
    // the half (tq & 1) of the word at 4 (tq >> 1) in their chunk
    const int sw = (g >> 1) & 3, sh = (tq & 1) * 16;
    const int o0 = r0 * 64 + 4 * (tq >> 1), o1 = o0 + 8 * 64;
    const float s0 = Src::scale(p, tile.a_row + r0);
    const float s1 = Src::scale(p, tile.a_row + r0 + 8);
    // a stage's four k steps of fragments: converted while the previous
    // stage's products run, two buffers
    uint32_t f[2][WG_BK / 16][4] = {};
    auto convert = [&](uint32_t (&d)[WG_BK / 16][4], const char* s) {
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk) {
        const char* c = s + ((kk ^ sw) << 4);
        d[kk][0] = wg_code_pair<QUANT>(
            *reinterpret_cast<const uint32_t*>(c + o0) >> sh, s0);
        d[kk][1] = wg_code_pair<QUANT>(
            *reinterpret_cast<const uint32_t*>(c + o1) >> sh, s1);
        d[kk][2] = wg_code_pair<QUANT>(
            *reinterpret_cast<const uint32_t*>(c + o0 + 8) >> sh, s0);
        d[kk][3] = wg_code_pair<QUANT>(
            *reinterpret_cast<const uint32_t*>(c + o1 + 8) >> sh, s1);
      }
    };
    // stage i's products from its fragments fc, then the next stage's
    // fragments into fn, whose last reader (stage i - 1) has retired
    auto run = [&](auto& fc, auto& fn, int i) {
      const char* s = sm + (i % WG_STAGES) * WG_STAGE;
      wg_pin(acc);
      wg_pin(fc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk)
        wg_pv(acc, fc[kk], bdesc(s, kk), 1);
      wg_commit();
      wg_wait<1>();
      wg_pin(fn);
      if (i > 0) release((i - 1) % WG_STAGES);
      if (i + 1 < total) {
        const int nx = (i + 1) % WG_STAGES;
        tc_bar_wait(&full[nx], ((i + 1) / WG_STAGES) & 1);
        convert(fn, sm + nx * WG_STAGE);
      }
    };
    tc_bar_wait(&full[0], 0);
    convert(f[0], sm);
    for (int i = 0; i < total; i += 2) {
      run(f[0], f[1], i);
      if (i + 1 < total) run(f[1], f[0], i + 1);
    }
  }
  wg_wait<0>();
  wg_pin(acc);

  // the tile through shared memory (every stage is consumed: the other
  // warpgroup's last products have retired at the barrier), then 16-byte
  // stores of whole rows. Accumulator 4j + e: row r0 + 8 (e >> 1), column
  // 8j + 2tq + (e & 1)
  wg_consumer_sync();
  OutT* stile = reinterpret_cast<OutT*>(sm);
#pragma unroll
  for (int j = 0; j < NACC / 4; ++j) {
    const int c = 8 * j + 2 * tq;
    if constexpr (sizeof(OutT) == 2) {
      *reinterpret_cast<__nv_bfloat162*>(stile + r0 * WG_PITCH + c) =
          __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(stile + (r0 + 8) * WG_PITCH + c) =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
    } else {
      *reinterpret_cast<float2*>(stile + r0 * WG_PITCH + c) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(stile + (r0 + 8) * WG_PITCH + c) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  wg_consumer_sync();
  constexpr int E = 16 / static_cast<int>(sizeof(OutT));  // a piece
  constexpr int PIECES = WG_BN / E;                        // a row's
  OutT* out = reinterpret_cast<OutT*>(p.out[p.rank0 + blockIdx.z]);
  for (int idx = threadIdx.x; idx < tile.rows * PIECES;
       idx += WG_CONSUMERS) {
    const int row = idx / PIECES, col = (idx % PIECES) * E;
    if (n0 + col < p.N)
      *reinterpret_cast<uint4*>(
          out + static_cast<size_t>(tile.out_row + row) * p.N + n0 + col) =
          *reinterpret_cast<const uint4*>(stile + row * WG_PITCH + col);
  }
}

// Whether the warpgroup loop takes a launch: bf16 A and B, out_dtype bf16
// or f32, 1 <= world <= WG_MAX_RANKS, m >= 1 and, with the wire's codes q,
// a multiple of WG_BM (WgPeerRowsQ's tile lies in one shard), K and N
// multiples of 8 (K of 16 for the codes: 16-byte rows for TMA), every A,
// B, codes and output base 16-byte aligned. The Python wrappers decide by
// the same rule (kernels/ag_gemm.py wgmma_form) and pass the form; the
// launcher refuses a wgmma form that breaks it.
inline bool wg_form_ok(const unsigned long long* a, const unsigned long long* w,
                       const unsigned long long* out, const void* q, int m,
                       int K, int N, int world, int x_dtype, int out_dtype) {
  if (x_dtype != TDT_BF16 || (out_dtype != TDT_BF16 && out_dtype != TDT_F32) ||
      world < 1 || world > WG_MAX_RANKS || m <= 0 || (q && m % WG_BM) ||
      K <= 0 || K % (q ? 16 : 8) || N % 8 ||
      reinterpret_cast<uintptr_t>(q) % 16)
    return false;
  for (int r = 0; r < world; ++r)
    if ((a[r] | w[r] | out[r]) % 16) return false;
  return true;
}

template <typename OutT, typename Src, int QUANT>
int wg_launch(const WgParams& p, int nranks, cudaStream_t st) {
  static bool attr = false;  // above 48 KB only after this, once a kernel
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        wg_gemm_kernel<OutT, Src, QUANT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const dim3 grid((p.N + WG_BN - 1) / WG_BN, Src::tiles(p), nranks);
  wg_gemm_kernel<OutT, Src, QUANT><<<grid, WG_THREADS, WG_SMEM, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The warpgroup loop over `world` ranks' A (a: host pointers, m_a rows
// each, K columns), B (w: (K, N) each) and outputs (out), and with q the
// wire codes (world * m, K) and s their scales; writes ranks rank0 ..
// rank0 + nranks - 1. Encodes the maps, launches, and returns the launch's
// error (cudaErrorInvalidValue where wg_form_ok fails or TMA refuses a
// map).
template <typename Src>
int wg_gemm(const unsigned long long* a, int m_a,
            const unsigned long long* w, const unsigned long long* out,
            const void* q, const float* s, int m, int K, int N, int world,
            int rank0, int nranks, int chunk_rows, int quant, int x_dtype,
            int out_dtype, cudaStream_t st) {
  if (!wg_form_ok(a, w, out, q, m, K, N, world, x_dtype, out_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  WgParams p = {};
  bool ok = true;
  for (int r = 0; r < world; ++r) {
    ok = ok && tc_map_2d(&p.a[r], reinterpret_cast<const void*>(a[r]),
                         CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, m_a, K, 2LL * K,
                         WG_BK, WG_BM, CU_TENSOR_MAP_SWIZZLE_128B);
    ok = ok && tc_map_2d(&p.b[r], reinterpret_cast<const void*>(w[r]),
                         CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, K, N, 2LL * N,
                         64, WG_BK, CU_TENSOR_MAP_SWIZZLE_128B);
    p.out[r] = out[r];
  }
  if (q != nullptr)
    ok = ok && tc_map_2d(&p.q, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                         static_cast<long long>(world) * m, K, K, WG_BK,
                         WG_BM, CU_TENSOR_MAP_SWIZZLE_64B);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  p.s = s;
  p.m = m;
  p.world = world;
  p.rank0 = rank0;
  p.K = K;
  p.N = N;
  p.chunk_rows = chunk_rows;
  const bool f32 = out_dtype == TDT_F32;
  if constexpr (Src::kQuant) {
    if (quant == TDT_WIRE_FP8)
      return f32 ? wg_launch<float, Src, TDT_WIRE_FP8>(p, nranks, st)
                 : wg_launch<__nv_bfloat16, Src, TDT_WIRE_FP8>(p, nranks, st);
    if (quant == TDT_WIRE_INT8)
      return f32 ? wg_launch<float, Src, TDT_WIRE_INT8>(p, nranks, st)
                 : wg_launch<__nv_bfloat16, Src, TDT_WIRE_INT8>(p, nranks, st);
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return f32 ? wg_launch<float, Src, 0>(p, nranks, st)
               : wg_launch<__nv_bfloat16, Src, 0>(p, nranks, st);
  }
}

// ------------------------------------------------------------ grouped
// The grouped form (moe_tp_fused.cu: the MoE-TP grouped GEMMs over
// expert-sorted rows). In bf16 the AG + grouped GEMM (tdt_ag_group_gemm_mesh,
// and tdt_ag_group_gemm on a one-rank table) over WgPeerGatherRows, the
// grouped GEMM + RS (tdt_moe_reduce_rs_mesh, and tdt_moe_reduce_rs on a
// one-rank table) over WgGroupedPeerSum; on the fp8 / int8 wire the AG
// (tdt_ag_group_gemm_w) over WgPeerGatherRowsQ and the partials
// (tdt_moe_reduce_rs_partials) over WgGroupedLocal. Every 128-row tile lies
// in one routing block of one expert (block_m and cap_s multiples of
// WG_BM), looked up once a tile from the stacked block table, be[g /
// block_m] for the tile's first row g; the weight (E, K, N) is a 3-D map
// (N, K, E innermost first, boxes of 64 n x 64 k x 1 expert) with the
// expert as the third coordinate, so an expert's K edge (K = 352 = 5.5
// steps of 64 at the tp = 4 down projection) lands as TMA's zeros, never as
// the next expert's rows.
//
// What bounds them on an H100, at the DeepSeek-MoE-16B prefill (4 ranks:
// cap_s 20480 sorted rows a shard, F 352 a rank; one rank: cap 57344, F
// 1408): the tensor cores. The AG computes 2 x 81920 x 2048 x 352 x 4
// operations (0.48 ms at 989 TFLOP/s), about a fifth of its 128-row blocks
// all padding (skipped); the RS every row of its destination, 4 x 20480 x
// 1408 x 2048 x 2 (0.48 ms), writing 4 x 20480 x 2048 bf16 (0.17 GB); the
// partials write 4 x 81920 x 2048 bf16 (1.34 GB, 0.40 ms at 3.35 TB/s), so
// a tile's store is as long as its products.
//
// Design: a persistent grid, one CTA an SM, each walking the tiles t =
// blockIdx.x, + gridDim.x, ... (N-tiles fastest, then M-tiles, then
// ranks), with the warpgroup GEMM's producer warpgroup and two consumer
// warpgroups; the stage ring and its barriers' phases run on across tiles,
// so the producer loads the next tile's stages while the consumers store
// this one. A tile's A rows come one of three ways:
// - one TMA box a stage (the partials' and the RS's rows in place, the
//   wire AG's own rows from the sorted slabs its quantizer was given, a
//   peer's wire codes converted in registers as wg_gemm_kernel does);
// - gathered by the producer warpgroup (the bf16 AG, kGather): the
//   tile's sorted rows, token sti[g] / topk of its shard, by 16-byte
//   cp.async straight into the 128-byte swizzle that TMA writes and the
//   consumers' descriptors read (zeros at the sentinel and past K).
//   Thread t copies piece t % 8 (bytes 16 (t % 8) ..) of rows 16 j + t /
//   8, j = 0 .. 7, so that each warp instruction reads four whole 128-byte
//   rows; it holds the eight rows' pointers for the tile, and its
//   cp.async.mbarrier.arrive.noinc completes the stage's full barrier once
//   its copies have landed (1 + 128 arrivals: thread 0 also loads B by TMA
//   with expect_tx); the consumers fence the async proxy after the
//   barrier, before wgmma reads what the generic proxy wrote. No sorted
//   slab is written, and the producer warpgroup keeps 56 registers (the
//   consumers 224: 96 accumulators at 192 columns);
// - with parts(p) > 1 (the RS) the K loop runs over (part, k step) in the
//   f32 accumulators, part q's rows and weight from rank q's maps; every
//   part's stage carries the same bytes (TMA counts a box's zero fill), so
//   the producer's count holds across parts.
// The epilogue has its own shared-memory tile, in the 128-byte swizzle
// (conflict-free bf16x2 / float2 writes), stored by TMA (128 rows x 128
// bytes a box; TMA clips N's edge) in a bulk group that overlaps the next
// tile's products; the buffer is rewritten only after that store has read
// it. Tile widths: WG_GROUP_BN_RS = 256 for the partials and the RS (N =
// 2048), WG_GROUP_BN_AG = 192 for the AGs (N_r = 352: two tiles, 384
// columns, against two of 256, 512, or three of 128, which read each A tile
// three times; N 1408 at one rank: eight). The AGs' tile whose first sorted
// row is the sentinel (>= tokens * topk) is all padding: its K loop is
// skipped and its zeros stored.
constexpr int WG_GROUP_BN_RS = 256;     // the partials' and the RS's width
constexpr int WG_GROUP_BN_AG = 192;     // the AGs' tile width
constexpr int WG_SMEM_MAX = 232448;     // shared memory a CTA may take
constexpr int WG_STORE_BOX = WG_BM * 128;  // an epilogue box: 128 B rows

// the shared memory of a grouped kernel's tile of BN columns stored as
// OutT: the stages (a bf16 A box and BN / 64 B boxes each, as many as fit
// beside the epilogue tile, at most 6) and the epilogue tile
template <typename OutT, int BN>
struct WgGroupShape {
  static constexpr int NBOX = BN / 64;
  static constexpr int STAGE = WG_A_BYTES + NBOX * WG_BOX_BYTES;
  static constexpr int EC = 128 / static_cast<int>(sizeof(OutT));
  static constexpr int EPI = WG_BM * BN * static_cast<int>(sizeof(OutT));
  static constexpr int FIT = (WG_SMEM_MAX - 1024 - 256 - EPI) / STAGE;
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static constexpr int SMEM = STAGES * STAGE + EPI + 1024;
  static_assert(STAGES >= 2, "two stages fit beside the epilogue tile");
  static_assert(STAGE % 1024 == 0, "the epilogue tile is 1024-aligned");
};

// a grouped launch's operands, a __grid_constant__ parameter (3.3 KB of
// the 4 KB)
struct WgGroupParams {
  CUtensorMap a[WG_MAX_RANKS];  // bf16 A rows: box 64 k x 128 rows
  CUtensorMap b[WG_MAX_RANKS];  // each rank's (E, K, N) weight
  CUtensorMap o[WG_MAX_RANKS];  // each rank's output (rows, N)
  CUtensorMap q;                // the AG's codes (world * cap_s, K)
  unsigned long long x[WG_MAX_RANKS];  // the gather's token shards (., K)
  const int* be;                // (world * cap_s / block_m) block -> expert
  const int* sti;               // the AG's (world * cap_s) sorted token ids
  const float* s;               // the codes' (world, cap_s / chunk_rows)
  int cap_s, world, K, N, block_m, chunk_rows, total, topk;
};

// what tile m0 of rank r reads in part q
struct WgGroupTile {
  const CUtensorMap* a;  // its A rows' map (bf16, or the codes; a gather
                         // reads none)
  int a_row;             // their first row in that map
  bool codes;            // A is a peer's wire codes
  bool skip;             // all padding: no K loop, zeros stored
  int expert;            // its block's expert
  const CUtensorMap* b;  // the weight it is multiplied by
};

// tdt_moe_reduce_rs_partials: PeerLocal grouped. Rank r's own y_r (world *
// cap_s, F_r) against w_r[be[g / block_m]], rows in place, into its slab
// of partials; every row computed, as JAX's kernel does (y is any input).
struct WgGroupedLocal {
  static constexpr bool kQuant = false;
  static constexpr bool kGather = false;
  __host__ __device__ static int tiles(const WgGroupParams& p) {
    return p.world * p.cap_s / WG_BM;
  }
  __device__ static constexpr int parts(const WgGroupParams&) { return 1; }
  __device__ static WgGroupTile tile(const WgGroupParams& p, int r, int m0,
                                     int) {
    return WgGroupTile{&p.a[r], m0, false, false, p.be[m0 / p.block_m],
                       &p.b[r]};
  }
};

// tdt_moe_reduce_rs_mesh in bf16, and tdt_moe_reduce_rs on a one-rank
// table: PeerSum grouped. Destination r's tile m0 sums world parts: part q
// reads y_q's rows r * cap_s + m0, ... (a[q]: all world * cap_s rows of
// rank q's F columns) against w_q (b[q]) at the destination's block's
// expert be[(r * cap_s + m0) / block_m], into rows m0, ... of out_r (cap_s
// rows). Every row computed, as JAX's kernel does: the RS takes no sorted
// ids, so it cannot tell a padding row.
struct WgGroupedPeerSum {
  static constexpr bool kQuant = false;
  static constexpr bool kGather = false;
  __host__ __device__ static int tiles(const WgGroupParams& p) {
    return p.cap_s / WG_BM;
  }
  __device__ static int parts(const WgGroupParams& p) { return p.world; }
  __device__ static WgGroupTile tile(const WgGroupParams& p, int r, int m0,
                                     int q) {
    const int g = r * p.cap_s + m0;
    return WgGroupTile{&p.a[q], g, false, false, p.be[g / p.block_m],
                       &p.b[q]};
  }
};

// tdt_ag_group_gemm_w: PeerGatherRowsQ::at's rows. Output row g = s *
// cap_s + i of rank r is shard s's sorted row i, from the peer's codes of
// q (row g) for s != r, exact bf16 for s = r from the sorted slabs' stack
// (a[0], row g: every shard's gather_sorted, zeros at the padding, as the
// wrapper materialized them for the quantizer), against w_r[be[g /
// block_m]]; a tile lies in one shard (cap_s a multiple of WG_BM).
struct WgPeerGatherRowsQ {
  static constexpr bool kQuant = true;
  static constexpr bool kGather = false;
  __host__ __device__ static int tiles(const WgGroupParams& p) {
    return p.world * p.cap_s / WG_BM;
  }
  __device__ static constexpr int parts(const WgGroupParams&) { return 1; }
  __device__ static WgGroupTile tile(const WgGroupParams& p, int r, int m0,
                                     int) {
    const bool pad = static_cast<unsigned>(p.sti[m0]) >=
                     static_cast<unsigned>(p.total);
    const bool peer = m0 / p.cap_s != r;
    return WgGroupTile{peer ? &p.q : &p.a[0], m0, peer, pad,
                       p.be[m0 / p.block_m], &p.b[r]};
  }
  // sorted row g's scale (a peer's): PeerGatherRowsQ::at's
  __device__ static float scale(const WgGroupParams& p, int g) {
    return p.s[g / p.chunk_rows];
  }
};

// tdt_ag_group_gemm_mesh in bf16, and tdt_ag_group_gemm on a one-rank
// table: PeerGatherRows::at's rows, gathered by the producer warpgroup.
// Output row g = s * cap_s + i of rank r is token sti[g] / topk of shard
// s's x_s (zeros where sti[g] is the sentinel, >= total) against
// w_r[be[g / block_m]]; a tile lies in one shard (cap_s a multiple of
// WG_BM), and one whose first row is the sentinel is all padding (an
// expert's padding ends its block).
struct WgPeerGatherRows {
  static constexpr bool kQuant = false;
  static constexpr bool kGather = true;
  __host__ __device__ static int tiles(const WgGroupParams& p) {
    return p.world * p.cap_s / WG_BM;
  }
  __device__ static constexpr int parts(const WgGroupParams&) { return 1; }
  __device__ static WgGroupTile tile(const WgGroupParams& p, int r, int m0,
                                     int) {
    const bool pad = static_cast<unsigned>(p.sti[m0]) >=
                     static_cast<unsigned>(p.total);
    return WgGroupTile{nullptr, m0, false, pad, p.be[m0 / p.block_m],
                       &p.b[r]};
  }
  // sorted row g's first byte in its shard, nullptr at the sentinel
  __device__ static const char* row(const WgGroupParams& p, int g) {
    const int v = p.sti[g];
    if (static_cast<unsigned>(v) >= static_cast<unsigned>(p.total))
      return nullptr;
    return reinterpret_cast<const char*>(p.x[g / p.cap_s]) +
           static_cast<size_t>(v / p.topk) * p.K * 2;
  }
};

// 16 bytes from global to shared memory (the 32-bit shared address dst) by
// cp.async, zeros where !ok (src then only names a valid address, nothing
// is read); .cg: the gathered rows are not read again by this CTA
__device__ __forceinline__ void wg_cp16(uint32_t dst, const char* src,
                                        bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

// an arrival on `bar` once this thread's cp.async copies so far have
// landed, counted in the barrier's expected arrivals (.noinc)
__device__ __forceinline__ void wg_cp_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(tc_smem(bar)) : "memory");
}

// the registers a thread of a grouped kernel's producer warpgroup keeps
// (setmaxnreg), and those its consumers take: 128 x P + 256 x C = 384 x
// 168, the CTA's own pool. One TMA thread needs few; a gather's 128
// threads hold eight row pointers each.
template <typename Src>
struct WgGroupRegs {
  static constexpr int P = Src::kGather ? 56 : 40;
  static constexpr int C = Src::kGather ? 224 : 232;
  static_assert(128 * P + 256 * C == 384 * 168, "the CTA's own pool");
};

template <typename OutT, typename Src, int QUANT, int BN>
__global__ void __launch_bounds__(WG_THREADS, 1)
    wg_grouped_kernel(const __grid_constant__ WgGroupParams p, int rank0,
                      int nranks) {
  using S = WgGroupShape<OutT, BN>;
  using R = WgGroupRegs<Src>;
  constexpr int NACC = BN / 2;  // a thread's accumulators
  extern __shared__ unsigned char wg_raw[];
  __shared__ uint64_t full[S::STAGES];   // stage st has landed
  __shared__ uint64_t empty[S::STAGES];  // the consumers are done with st
  char* sm = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(wg_raw) + 1023) & ~uintptr_t(1023));
  char* epi = sm + S::STAGES * S::STAGE;
  // tile t: rank rank0 + t / (mt * nt), M-tile t / nt % mt, N-tile t % nt
  const int mt = Src::tiles(p), nt = (p.N + BN - 1) / BN;
  const int ntiles = nranks * mt * nt;
  const int nk = (p.K + WG_BK - 1) / WG_BK;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < S::STAGES; ++st) {
      // a gather's stage: the TMA thread's arrival and the 128 copiers'
      tc_bar_init(&full[st], Src::kGather ? 1 + 128 : 1);
      tc_bar_init(&empty[st], WG_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= WG_CONSUMERS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R::P));
    // its piece of a gathered A box's rows (the gather's 128 threads), or
    // the one TMA thread (t == 0)
    const int t = threadIdx.x - WG_CONSUMERS;
    constexpr int GJ = WG_BM * 8 / 128;  // a gather thread's rows
    const int gc = t % 8, grow = t / 8;  // its piece, its first row
    if (Src::kGather || t == 0) {
      int it = 0;  // the stage ring's position, across tiles
      for (int ti = blockIdx.x; ti < ntiles; ti += gridDim.x) {
        const int r = rank0 + ti / (mt * nt), m0 = ti / nt % mt * WG_BM;
        const int n0 = ti % nt * BN;
        const WgGroupTile tile0 = Src::tile(p, r, m0, 0);
        if (tile0.skip) continue;
        // B's boxes that start inside N (the rest would only feed columns
        // the epilogue never stores)
        const int nbox = min(S::NBOX, (p.N - n0 + 63) / 64);
        // a gather: this thread's rows grow + 16 j (nullptr: zeros)
        const char* src[Src::kGather ? GJ : 1];
        if constexpr (Src::kGather) {
#pragma unroll
          for (int j = 0; j < GJ; ++j)
            src[j] = Src::row(p, m0 + grow + 16 * j);
        }
        const int bytes = (Src::kGather ? 0
                           : tile0.codes ? WG_Q_BYTES : WG_A_BYTES) +
                          nbox * WG_BOX_BYTES;
        for (int q = 0; q < Src::parts(p); ++q) {
          const WgGroupTile tile = q ? Src::tile(p, r, m0, q) : tile0;
          for (int kk = 0; kk < nk; ++kk, ++it) {
            const int st = it % S::STAGES;
            if (it >= S::STAGES)
              tc_bar_wait(&empty[st], (it / S::STAGES + 1) & 1);
            char* s = sm + st * S::STAGE;
            if (t == 0) {
              tc_bar_expect(&full[st], bytes);
              if constexpr (!Src::kGather)
                tc_tma_2d(s, tile.a, &full[st], kk * WG_BK, tile.a_row);
              for (int j = 0; j < nbox; ++j)
                tc_tma_3d(s + WG_A_BYTES + j * WG_BOX_BYTES, tile.b,
                          &full[st], n0 + 64 * j, kk * WG_BK, tile.expert);
            }
            if constexpr (Src::kGather) {
              // piece gc of row g = grow + 16 j at g * 128 + ((gc ^ (g &
              // 7)) << 4), the 128-byte swizzle (g & 7 = grow & 7)
              const int k = kk * WG_BK + 8 * gc;
              const uint32_t dst = tc_smem(s) + grow * 128 +
                                   ((gc ^ (grow & 7)) << 4);
#pragma unroll
              for (int j = 0; j < GJ; ++j) {
                const bool ok = src[j] != nullptr && k < p.K;
                wg_cp16(dst + j * 16 * 128,
                        ok ? src[j] + 2 * k
                           : reinterpret_cast<const char*>(p.x[0]),
                        ok);
              }
              wg_cp_arrive(&full[st]);
            }
          }
        }
      }
      if constexpr (Src::kGather)
        asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R::C));

  const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  // this thread's fragment rows of the tile: r0 and r0 + 8
  const int r0 = wg * 64 + (warp & 3) * 16 + g;
  float acc[NACC];
  // B of k step kk of a stage: 8-k groups 1024 bytes apart, the boxes of
  // 64 n 8192 apart
  auto bdesc = [&](const char* s, int kk) {
    return wg_desc(s + WG_A_BYTES + kk * 2048, WG_BOX_BYTES, 1024, 1);
  };
  // a warp is done with stage st
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) tc_bar_arrive(&empty[st]);
  };
  auto stage = [&](int i) { return sm + (i % S::STAGES) * S::STAGE; };
  auto landed = [&](int i) {
    tc_bar_wait(&full[i % S::STAGES], (i / S::STAGES) & 1);
  };
  // a tile's stages: parts x K steps
  const int steps = Src::parts(p) * nk;

  int it = 0;  // the stage ring's position, as the producer's
  for (int ti = blockIdx.x; ti < ntiles; ti += gridDim.x) {
    const int r = rank0 + ti / (mt * nt), m0 = ti / nt % mt * WG_BM;
    const int n0 = ti % nt * BN;
    const WgGroupTile tile = Src::tile(p, r, m0, 0);
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
    if (tile.skip) {
      // all padding: zeros
    } else if (!tile.codes) {
      // bf16 A from shared memory: this warpgroup's 64 rows, 8-row groups
      // 1024 bytes apart, k step kk 32 bytes into the 128-byte rows
      for (int i = 0; i < steps; ++i) {
        landed(it + i);
        // the gathered rows came by the generic proxy; wgmma reads the
        // async proxy's view
        if constexpr (Src::kGather) tc_fence_async_smem();
        const char* s = stage(it + i);
        wg_pin(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < WG_BK / 16; ++kk)
          wg_ss_t(acc, wg_desc(s + wg * 8192 + kk * 32, 16, 1024, 1),
                  bdesc(s, kk), 1);
        wg_commit();
        wg_wait<1>();  // the previous stage's products have retired
        if (i > 0) release((it + i - 1) % S::STAGES);
      }
    } else if constexpr (QUANT != 0) {
      // the codes, as wg_gemm_kernel reads and converts them: 16-byte
      // chunk c of row r at chunk c ^ ((r >> 1) & 3); register i of the
      // fragment of k step kk: row r0 + 8 (i & 1), codes 16 kk + 8 (i >>
      // 1) + 2 tq, + 1, the half (tq & 1) of the word at 4 (tq >> 1) in
      // their chunk; a stage's fragments converted while the previous
      // stage's products run, two buffers
      const int sw = (g >> 1) & 3, sh = (tq & 1) * 16;
      const int o0 = r0 * 64 + 4 * (tq >> 1), o1 = o0 + 8 * 64;
      const float s0 = Src::scale(p, tile.a_row + r0);
      const float s1 = Src::scale(p, tile.a_row + r0 + 8);
      uint32_t f[2][WG_BK / 16][4];
      auto convert = [&](uint32_t (&d)[WG_BK / 16][4], const char* s) {
#pragma unroll
        for (int kk = 0; kk < WG_BK / 16; ++kk) {
          const char* c = s + ((kk ^ sw) << 4);
          d[kk][0] = wg_code_pair<QUANT>(
              *reinterpret_cast<const uint32_t*>(c + o0) >> sh, s0);
          d[kk][1] = wg_code_pair<QUANT>(
              *reinterpret_cast<const uint32_t*>(c + o1) >> sh, s1);
          d[kk][2] = wg_code_pair<QUANT>(
              *reinterpret_cast<const uint32_t*>(c + o0 + 8) >> sh, s0);
          d[kk][3] = wg_code_pair<QUANT>(
              *reinterpret_cast<const uint32_t*>(c + o1 + 8) >> sh, s1);
        }
      };
      // stage i's products from its fragments fc, then the next stage's
      // fragments into fn, whose last reader (stage i - 1) has retired
      auto run = [&](auto& fc, auto& fn, int i) {
        const char* s = stage(it + i);
        wg_pin(acc);
        wg_pin(fc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < WG_BK / 16; ++kk)
          wg_pv(acc, fc[kk], bdesc(s, kk), 1);
        wg_commit();
        wg_wait<1>();
        wg_pin(fn);
        if (i > 0) release((it + i - 1) % S::STAGES);
        if (i + 1 < nk) {
          landed(it + i + 1);
          convert(fn, stage(it + i + 1));
        }
      };
      landed(it);
      convert(f[0], stage(it));
      for (int i = 0; i < nk; i += 2) {
        run(f[0], f[1], i);
        if (i + 1 < nk) run(f[1], f[0], i + 1);
      }
    }
    if (!tile.skip) {
      wg_wait<0>();
      release((it + steps - 1) % S::STAGES);
      it += steps;
    }
    wg_pin(acc);

    // the epilogue tile, once the previous tile's store has read it: 128-
    // byte rows of EC columns, a box of 128 rows per EC columns, chunk c of
    // row r at chunk c ^ (r & 7). Accumulator 4j + e: row r0 + 8 (e >> 1),
    // column 8j + 2tq + (e & 1)
    if (threadIdx.x == 0) tc_bulk_wait<true>();
    wg_consumer_sync();
#pragma unroll
    for (int j = 0; j < NACC / 4; ++j) {
      const int col = 8 * j + 2 * tq;
      const int byte = col % S::EC * static_cast<int>(sizeof(OutT));
      char* box = epi + col / S::EC * WG_STORE_BOX + (byte & 15);
      char* p0 = box + r0 * 128 + (((byte >> 4) ^ g) << 4);
      char* p1 = p0 + 8 * 128;  // row r0 + 8: the same swizzle
      if constexpr (sizeof(OutT) == 2) {
        *reinterpret_cast<__nv_bfloat162*>(p0) =
            __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<__nv_bfloat162*>(p1) =
            __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
      } else {
        *reinterpret_cast<float2*>(p0) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(p1) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
    tc_fence_async_smem();
    wg_consumer_sync();
    if (threadIdx.x == 0) {
      for (int b = 0; b < BN / S::EC && n0 + b * S::EC < p.N; ++b)
        tc_tma_store_2d(&p.o[r], epi + b * WG_STORE_BOX, n0 + b * S::EC, m0);
      tc_bulk_commit();
    }
  }
  if (threadIdx.x == 0) tc_bulk_wait<false>();  // before the CTA's memory goes
}

// Whether the grouped form takes a launch: bf16 A and B, out_dtype bf16
// or f32, 1 <= world <= WG_MAX_RANKS, cap_s and block_m multiples of WG_BM
// (a tile lies in one shard and one routing block), cap_s a multiple of
// block_m, K and N multiples of 8 (K of 16 for the codes: 16-byte rows for
// TMA and cp.async), every A (na of them), token shard (x, world of them,
// where given), weight, output and codes base 16-byte aligned. The Python
// wrappers decide by the same rule (kernels/ag_gemm.py grouped_wgmma_form)
// and pass the form; the launchers refuse a wgmma form that breaks it.
inline bool wg_grouped_form_ok(const unsigned long long* a, int na,
                               const unsigned long long* x,
                               const unsigned long long* w,
                               const unsigned long long* out, const void* q,
                               int cap_s, int block_m, int K, int N,
                               int world, int x_dtype, int out_dtype) {
  if (x_dtype != TDT_BF16 || (out_dtype != TDT_BF16 && out_dtype != TDT_F32) ||
      world < 1 || world > WG_MAX_RANKS || cap_s <= 0 || cap_s % WG_BM ||
      block_m <= 0 || block_m % WG_BM || cap_s % block_m || K <= 0 ||
      K % (q ? 16 : 8) || N <= 0 || N % 8 ||
      reinterpret_cast<uintptr_t>(q) % 16)
    return false;
  for (int r = 0; r < na; ++r)
    if (a[r] % 16) return false;
  for (int r = 0; r < world; ++r)
    if ((w[r] | out[r] | (x ? x[r] : 0)) % 16) return false;
  return true;
}

template <typename OutT, typename Src, int QUANT, int BN>
int wg_grouped_launch(const WgGroupParams& p, int rank0, int nranks,
                      cudaStream_t st) {
  using S = WgGroupShape<OutT, BN>;
  static bool attr = false;  // above 48 KB only after this, once a kernel
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        wg_grouped_kernel<OutT, Src, QUANT, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long ntiles = static_cast<long long>(nranks) * Src::tiles(p) *
                           ((p.N + BN - 1) / BN);
  const int grid = static_cast<int>(ntiles < sms ? ntiles : sms);
  wg_grouped_kernel<OutT, Src, QUANT, BN>
      <<<grid, WG_THREADS, S::SMEM, st>>>(p, rank0, nranks);
  return static_cast<int>(cudaGetLastError());
}

// The grouped form over `world` ranks' weights (w: (E, K, N) each) and
// outputs (out: (out_rows, N) each), with na A maps (a: host pointers,
// world * cap_s rows of K each: every rank's y_r, or for the wire AG the
// one stack of sorted slabs) or, for a gather, the world token shards x
// (host pointers, rows of K, token sti[g] / topk of shard g / cap_s) and,
// for the wire AG, q the codes (world * cap_s, K), s their scales; sti the
// sorted token ids (sentinel >= total); be the stacked block table. Writes
// ranks rank0 .. rank0 + nranks - 1. Encodes the maps, launches, and
// returns the launch's error (cudaErrorInvalidValue where
// wg_grouped_form_ok fails or TMA refuses a map).
template <typename Src, int BN>
int wg_grouped(const unsigned long long* a, int na,
               const unsigned long long* x, int topk,
               const unsigned long long* w, const unsigned long long* out,
               long long out_rows, const void* q, const float* s,
               const int* sti, const int* be, int total, int cap_s, int K,
               int N, int E, int block_m, int world, int rank0, int nranks,
               int chunk_rows, int quant, int x_dtype, int out_dtype,
               cudaStream_t st) {
  if (!wg_grouped_form_ok(a, na, x, w, out, q, cap_s, block_m, K, N, world,
                          x_dtype, out_dtype) ||
      E <= 0 || (Src::kGather && (x == nullptr || topk <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool f32 = out_dtype == TDT_F32;
  const int esize = f32 ? 4 : 2;
  const long long rows = static_cast<long long>(world) * cap_s;
  WgGroupParams p = {};
  bool ok = true;
  for (int r = 0; r < na; ++r)
    ok = ok && tc_map_2d(&p.a[r], reinterpret_cast<const void*>(a[r]),
                         CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, rows, K, 2LL * K,
                         WG_BK, WG_BM, CU_TENSOR_MAP_SWIZZLE_128B);
  for (int r = 0; r < world; ++r) {
    ok = ok && tc_map_3d(&p.b[r], reinterpret_cast<const void*>(w[r]),
                         CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, N, K, E,
                         2LL * N, 2LL * K * N, 64, WG_BK, 1,
                         CU_TENSOR_MAP_SWIZZLE_128B);
    ok = ok && tc_map_2d(&p.o[r], reinterpret_cast<const void*>(out[r]),
                         f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                         esize, out_rows, N, 1LL * esize * N, 128 / esize,
                         WG_BM, CU_TENSOR_MAP_SWIZZLE_128B);
    if (x != nullptr) p.x[r] = x[r];
  }
  if (q != nullptr)
    ok = ok && tc_map_2d(&p.q, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, rows, K,
                         K, WG_BK, WG_BM, CU_TENSOR_MAP_SWIZZLE_64B);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  p.be = be;
  p.sti = sti;
  p.s = s;
  p.cap_s = cap_s;
  p.world = world;
  p.K = K;
  p.N = N;
  p.block_m = block_m;
  p.chunk_rows = chunk_rows;
  p.total = total;
  p.topk = topk;
  if constexpr (Src::kQuant) {
    if (quant == TDT_WIRE_FP8)
      return f32 ? wg_grouped_launch<float, Src, TDT_WIRE_FP8, BN>(
                       p, rank0, nranks, st)
                 : wg_grouped_launch<__nv_bfloat16, Src, TDT_WIRE_FP8, BN>(
                       p, rank0, nranks, st);
    if (quant == TDT_WIRE_INT8)
      return f32 ? wg_grouped_launch<float, Src, TDT_WIRE_INT8, BN>(
                       p, rank0, nranks, st)
                 : wg_grouped_launch<__nv_bfloat16, Src, TDT_WIRE_INT8, BN>(
                       p, rank0, nranks, st);
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return f32 ? wg_grouped_launch<float, Src, 0, BN>(p, rank0, nranks, st)
               : wg_grouped_launch<__nv_bfloat16, Src, 0, BN>(p, rank0,
                                                              nranks, st);
  }
}

}  // namespace
