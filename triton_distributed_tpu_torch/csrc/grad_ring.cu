// The data-parallel gradient ring on the quantized wire, with stochastic
// rounding and per-hop error feedback, and the quantize-once all-gather
// that completes it.
//
// tdt_grad_ring replaces triton_distributed_tpu/kernels/cp_ring.py
// _grad_ring_kernel_w (:187) and _grad_ring_kernel_w3 (:225, one more ring
// slot). On the TPU those are the Pallas protocol twin of the gradient
// ring: an HBM-streaming reduce ring on the int8 wire, rounding to nearest.
// The numbers training uses come from JAX's XLA body, train/grad_wire.py
// ef_ring_reduce_scatter (:144-186). This kernel computes both:
//
//   for every group g (one ring each) and rank me of the n on the ring,
//   x[g][me] is (n * srows, cols) f32, stripe i the rows [i*srows, +srows);
//   acc[me] = stripe me + 1 of x[g][me], resid[me] = 0
//   hop h = 0 .. n - 2, on every rank at once:
//     out[me]   = acc[me] + resid[me]
//     scale[me] = max(amax of the chunk of out[me], 1e-12) / QMAX
//     code[me]  = int8: floor(out / scale + u) (stochastic) or rint(out /
//                 scale) (round half to even), clipped to +-127;
//                 fp8 e4m3: out / scale rounded to nearest
//     resid[me] = ef ? fma(-code, scale, out) : 0
//     acc[me]   = fma(code[me + 1], scale[me + 1], stripe me + 2 + h of x[me])
//   rank me ends with acc[me]: owner me's reduced stripe.
//
// so that the stripe owner s collects is started by rank s - 1 and passes
// s - 2, ..., s. The residual a rank carries moves to the next stripe it
// sends (the link's shipped total telescopes to one residual). u is the
// uniform of (seed, rank me, hop h, row in the stripe, column) from the
// counter hash sr_mix (lang/wire.py sr_uniforms: the same integer
// operations), so the noise is the same in every group: a tp-replicated
// gradient stays bit-identical across tp. With ef = 0, stochastic = 0 and
// make_wire_format's chunk rows this is _grad_ring_kernel_w's arithmetic
// as JAX's interpreter computes it, bit for bit: the division, rint, and
// the dequantize-add as one fused multiply-add. Every operation is an _rn
// intrinsic, never a contraction left to the compiler, so the plain
// version (kernels/cp_ring.py grad_ring_plain, lang/wire.py fma_f32)
// gives the same bits. The ring's depth (2 or 3 slots) adds a TPU ring
// slot and no value; the wrapper counts the launch by the kernel it
// stood for.
//
// tdt_grad_allgather: the all-gather half (grad_wire.py quantized_allgather,
// :189-204). JAX quantizes each owner's stripe once and every rank, the
// owner too, takes the dequantized bytes (code * scale in f32); here one
// launch quantizes each stripe (stochastic rounding keyed by the owner and
// the all-gather's hop AG_HOP) and writes the dequantized rows to every
// rank's slab. It has no TPU kernel (JAX runs lax.all_gather).
//
// On one card the ranks' slabs are slices of one allocation, so the ring
// becomes a walk over every rank's rows in the hops' order: one warp a
// (group, chunk of rows) holds all n ranks' acc and resid rows of the chunk
// in shared memory (ef = 1), or, with ef = 0, where the stripes' chains are
// independent, one warp a (group, chunk, owner) holds one chain. Each
// element of every slab is read once and each owner's stripe written once.
// The chunk's amax is a warp max.
//
// What bounds it on an H100: device memory. At the Llama-2-7B-width
// trainer's dp gradient ring (dp 2 x tp 2 x cp 2: 8 slabs of 374.3 M f32,
// 4 rings of n = 2) 11.98 GB read and 5.99 GB written, 5.36 ms at
// 3.35 TB/s.

#include "wire.cuh"

namespace {

constexpr int GR_MAX_WARPS = 8;
constexpr unsigned GR_AG_HOP = 0xFFFFu;

__device__ __forceinline__ uint32_t sr_mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t sr_key(uint32_t seed, uint32_t ring,
                                           uint32_t hop) {
  return sr_mix(sr_mix(sr_mix(seed ^ 0x9e3779b9u) ^ ring) ^ hop);
}

// a multiple of 2^-24 in [0, 1), exact in f32
__device__ __forceinline__ float sr_uniform(uint32_t key, uint32_t row,
                                            uint32_t col) {
  return static_cast<float>(sr_mix(sr_mix(key ^ row) ^ col) >> 8) *
         5.9604644775390625e-08f;
}

// the code of v at `scale` as its f32 value
__device__ __forceinline__ float gr_code(float v, float scale, int quant,
                                         bool sr, float u) {
  const float y = __fdiv_rn(v, scale);
  if (quant == TDT_WIRE_FP8) {
    const __half_raw h = __nv_cvt_fp8_to_halfraw(
        __nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3), __NV_E4M3);
    return __half2float(__half(h));
  }
  const float r = sr ? floorf(__fadd_rn(y, u)) : rintf(y);
  return fminf(fmaxf(r, -127.f), 127.f);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct RingArgs {
  const float* x;
  float* out;
  int g, n, srows, cols, chunk_rows, quant, sr, ef;
  uint32_t seed;
  long long x_sg, x_sr;  // element strides of a group and a rank
};

// rows [row0, row0 + chunk_rows) of stripe `stripe` of rank r in group g
__device__ __forceinline__ const float* gr_rows(const RingArgs& a, int g, int r,
                                                int stripe, int row0) {
  return a.x + g * a.x_sg + r * a.x_sr +
         (static_cast<long long>(stripe) * a.srows + row0) * a.cols;
}

template <bool EF>
__global__ void grad_ring_kernel(RingArgs a) {
  extern __shared__ __align__(16) float gr_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5, n = a.n;
  const long long e_n = static_cast<long long>(a.chunk_rows) * a.cols;
  const int slots = EF ? n : 1;
  const long long per_warp = (EF ? 2 : 1) * slots * e_n + n;
  float* acc = gr_smem + warp * per_warp;  // [slots][e_n]
  float* resid = acc + slots * e_n;        // [n][e_n], EF only
  float* scl = acc + (EF ? 2 : 1) * slots * e_n;  // [n]
  const bool sr = a.sr && a.quant == TDT_WIRE_INT8;
  const int chunks = a.srows / a.chunk_rows;
  const long long items =
      static_cast<long long>(a.g) * chunks * (EF ? 1 : n);
  for (long long it = static_cast<long long>(blockIdx.x) * wpb + warp;
       it < items; it += static_cast<long long>(gridDim.x) * wpb) {
    long long t = it;
    const int s = EF ? 0 : static_cast<int>(t % n);
    if (!EF) t /= n;
    const int c = static_cast<int>(t % chunks);
    const int g = static_cast<int>(t / chunks);
    const int row0 = c * a.chunk_rows;
    if (EF) {
      for (int r = 0; r < n; ++r) {
        const float* src = gr_rows(a, g, r, (r + 1) % n, row0);
        for (long long e = lane; e < e_n; e += 32) {
          acc[r * e_n + e] = src[e];
          resid[r * e_n + e] = 0.f;
        }
      }
    } else {
      const float* src = gr_rows(a, g, (s + n - 1) % n, s, row0);
      for (long long e = lane; e < e_n; e += 32) acc[e] = src[e];
    }
    __syncwarp();
    for (int h = 0; h < n - 1; ++h) {
      if (EF) {
        for (int r = 0; r < n; ++r) {
          float m = 0.f;
          for (long long e = lane; e < e_n; e += 32)
            m = fmaxf(m, fabsf(__fadd_rn(acc[r * e_n + e], resid[r * e_n + e])));
          m = warp_max(m);
          if (lane == 0) scl[r] = wire_scale(m, a.quant);
        }
        __syncwarp();
        const uint32_t key0 = sr_key(a.seed, 0, h);
        for (long long e = lane; e < e_n; e += 32) {
          const int row = row0 + static_cast<int>(e / a.cols);
          const int col = static_cast<int>(e % a.cols);
          float out = __fadd_rn(acc[e], resid[e]);
          const float code0 =
              gr_code(out, scl[0], a.quant, sr, sr ? sr_uniform(key0, row, col) : 0.f);
          if (a.ef) resid[e] = __fmaf_rn(-code0, scl[0], out);
          for (int r = 0; r < n; ++r) {
            const int r1 = r + 1 == n ? 0 : r + 1;
            float cn = code0;
            if (r1 != 0) {
              const long long i1 = r1 * e_n + e;
              out = __fadd_rn(acc[i1], resid[i1]);
              cn = gr_code(out, scl[r1], a.quant, sr,
                           sr ? sr_uniform(sr_key(a.seed, r1, h), row, col) : 0.f);
              if (a.ef) resid[i1] = __fmaf_rn(-cn, scl[r1], out);
            }
            const float xv = gr_rows(a, g, r, (r + 2 + h) % n, row0)[e];
            acc[r * e_n + e] = __fmaf_rn(cn, scl[r1], xv);
          }
        }
      } else {
        // owner s's chain: rank (s - 1 - h) quantizes, rank (s - 2 - h) adds
        const int rq = ((s - 1 - h) % n + n) % n;
        const int rn = ((s - 2 - h) % n + n) % n;
        float m = 0.f;
        for (long long e = lane; e < e_n; e += 32) m = fmaxf(m, fabsf(acc[e]));
        const float scale = wire_scale(warp_max(m), a.quant);
        const uint32_t key = sr_key(a.seed, rq, h);
        const float* nxt = gr_rows(a, g, rn, s, row0);
        for (long long e = lane; e < e_n; e += 32) {
          const int row = row0 + static_cast<int>(e / a.cols);
          const int col = static_cast<int>(e % a.cols);
          const float code = gr_code(acc[e], scale, a.quant, sr,
                                     sr ? sr_uniform(key, row, col) : 0.f);
          acc[e] = __fmaf_rn(code, scale, nxt[e]);
        }
      }
      __syncwarp();
    }
    for (int r = 0; r < slots; ++r) {
      const int owner = EF ? r : s;
      float* dst = a.out + (static_cast<long long>(g) * n + owner) * a.srows *
                               a.cols + static_cast<long long>(row0) * a.cols;
      for (long long e = lane; e < e_n; e += 32) dst[e] = acc[r * e_n + e];
    }
    __syncwarp();
  }
}

struct AgArgs {
  const float* stripes;
  float* out;
  int g, n, srows, cols, chunk_rows, quant, sr;
  uint32_t seed;
  long long s_sg, s_sr, o_sg, o_sr;  // element strides of a group and a rank
};

__global__ void grad_allgather_kernel(AgArgs a) {
  extern __shared__ __align__(16) float gr_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  const long long e_n = static_cast<long long>(a.chunk_rows) * a.cols;
  float* buf = gr_smem + warp * e_n;
  const bool sr = a.sr && a.quant == TDT_WIRE_INT8;
  const int chunks = a.srows / a.chunk_rows;
  const long long items = static_cast<long long>(a.g) * a.n * chunks;
  for (long long it = static_cast<long long>(blockIdx.x) * wpb + warp;
       it < items; it += static_cast<long long>(gridDim.x) * wpb) {
    const int c = static_cast<int>(it % chunks);
    const int s = static_cast<int>((it / chunks) % a.n);
    const int g = static_cast<int>(it / chunks / a.n);
    const int row0 = c * a.chunk_rows;
    const float* src = a.stripes + g * a.s_sg + s * a.s_sr +
                       static_cast<long long>(row0) * a.cols;
    float m = 0.f;
    for (long long e = lane; e < e_n; e += 32) {
      buf[e] = src[e];
      m = fmaxf(m, fabsf(buf[e]));
    }
    const float scale = wire_scale(warp_max(m), a.quant);
    const uint32_t key = sr_key(a.seed, s, GR_AG_HOP);
    const long long off =
        (static_cast<long long>(s) * a.srows + row0) * a.cols;
    for (long long e = lane; e < e_n; e += 32) {
      const int row = row0 + static_cast<int>(e / a.cols);
      const int col = static_cast<int>(e % a.cols);
      const float code = gr_code(buf[e], scale, a.quant, sr,
                                 sr ? sr_uniform(key, row, col) : 0.f);
      const float v = __fmul_rn(code, scale);
      for (int r = 0; r < a.n; ++r) a.out[g * a.o_sg + r * a.o_sr + off + e] = v;
    }
    __syncwarp();
  }
}

int gr_grid(long long items, int wpb) {
  const long long want = (items + wpb - 1) / wpb;
  return static_cast<int>(want < 8192 ? want : 8192);
}

int gr_warps(long long per_warp_bytes) {
  const long long fit = (227ll * 1024) / per_warp_bytes;
  return static_cast<int>(fit < GR_MAX_WARPS ? fit : GR_MAX_WARPS);
}

template <typename F>
int gr_smem_attr(F* kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace

extern "C" {

// x: G rings of n ranks' (n * srows, cols) f32 slabs at element strides
// (x_sg, x_sr), each slab contiguous; out: (G, n, srows, cols) f32, owner
// s's reduced stripe at [g][s]. quant TDT_WIRE_FP8 or TDT_WIRE_INT8; sr:
// stochastic rounding (int8 only); ef: error feedback.
int tdt_grad_ring(const void* x, void* out, int g, int n, int srows, int cols,
                  int chunk_rows, long long x_sg, long long x_sr, int quant,
                  int sr, int ef, long long seed, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (g <= 0 || srows <= 0 || cols <= 0) return 0;
  if (n < 1 || chunk_rows <= 0 || srows % chunk_rows ||
      (quant != TDT_WIRE_FP8 && quant != TDT_WIRE_INT8))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long e_n = static_cast<long long>(chunk_rows) * cols;
  const int slots = ef ? n : 1;
  const long long per_warp = ((ef ? 2 : 1) * slots * e_n + n) * 4;
  const int wpb = gr_warps(per_warp);
  if (wpb < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = static_cast<int>(per_warp * wpb);
  const long long items =
      static_cast<long long>(g) * (srows / chunk_rows) * (ef ? 1 : n);
  RingArgs a{static_cast<const float*>(x), static_cast<float*>(out), g, n,
             srows, cols, chunk_rows, quant, sr, ef,
             static_cast<uint32_t>(seed), x_sg, x_sr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (ef) {
    if ((rc = gr_smem_attr(grad_ring_kernel<true>, bytes))) return rc;
    grad_ring_kernel<true><<<gr_grid(items, wpb), wpb * 32, bytes, st>>>(a);
  } else {
    if ((rc = gr_smem_attr(grad_ring_kernel<false>, bytes))) return rc;
    grad_ring_kernel<false><<<gr_grid(items, wpb), wpb * 32, bytes, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// stripes: G x n owners' (srows, cols) f32 stripes at element strides
// (s_sg, s_sr), each contiguous; out: every rank's (n * srows, cols) f32
// slab at element strides (o_sg, o_sr), each contiguous.
int tdt_grad_allgather(const void* stripes, void* out, int g, int n,
                       int srows, int cols, int chunk_rows, long long s_sg,
                       long long s_sr, long long o_sg, long long o_sr,
                       int quant, int sr, long long seed, void* stream) {
  cudaGetLastError();
  if (g <= 0 || n <= 0 || srows <= 0 || cols <= 0) return 0;
  if (chunk_rows <= 0 || srows % chunk_rows ||
      (quant != TDT_WIRE_FP8 && quant != TDT_WIRE_INT8))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long per_warp = static_cast<long long>(chunk_rows) * cols * 4;
  const int wpb = gr_warps(per_warp);
  if (wpb < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = static_cast<int>(per_warp * wpb);
  const long long items = static_cast<long long>(g) * n * (srows / chunk_rows);
  AgArgs a{static_cast<const float*>(stripes), static_cast<float*>(out), g, n,
           srows, cols, chunk_rows, quant, sr, static_cast<uint32_t>(seed),
           s_sg, s_sr, o_sg, o_sr};
  int rc;
  if ((rc = gr_smem_attr(grad_allgather_kernel, bytes))) return rc;
  grad_allgather_kernel<<<gr_grid(items, wpb), wpb * 32, bytes,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
