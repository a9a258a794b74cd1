// Chunked Mamba2 SSD (state-space dual) scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/ssd_scan.py::ssd_scan
// (pallas_call at line 84).  Per batch row b and head h, with scalar decay
// A_h < 0 and a single B/C group, over chunks of L steps:
//
//     cum_t   = sum_{u <= t} A dt_u                      (inclusive, in the chunk)
//     y_t     = sum_{s <= t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s
//               + exp(cum_t) C_t S_in^T
//     S_out   = exp(cum_L) S_in + sum_s exp(cum_L - cum_s) dt_s x_s B_s^T
//
// with the (dh, ds) state S carried from chunk to chunk (zero at the start);
// y only, as the TPU kernel returns.  x (b, l, h, dh), dt (b, l, h), A (h,),
// B and C (b, l, ds), y (b, l, h, dh): float32, contiguous.
//
// Bound: bytes, by a hair.  At the LM path's shape (b 2, l 2048, 112 heads,
// dh 64, ds 64, chunk 128) the 237 MB of x, y, B, C and dt take 71 us at
// 3.35 TB/s; the chunked form's 5.67 G multiply-adds (C.B^T formed once per
// (batch row, chunk)) take 69 us at the TF32 tensor-core rate for the three
// passes below, 169 us at the float32 FMA rate.  The TPU kernel walks the chunks of one
// (batch row, head) in order with the state in VMEM.  This port splits that
// walk into three launches on the caller's stream (the wrapper allocates the
// chunk states and decays; nothing is allocated here):
//
//  1. ssd_scan_kernel_state, one block per (chunk, batch row, group of G
//     heads): B of the chunk is loaded once for the group; per head the
//     chunk's state increment inc = sum_s exp(cum_L - cum_s) dt_s x_s B_s^T
//     (dh x ds) and its decay exp(cum_L) go to device memory;
//  2. ssd_scan_kernel_pass: S_in[n + 1] = exp(cum_L[n]) S_in[n] + inc[n],
//     one thread per 4 state elements walking the chunks, in place (inc[n]
//     is overwritten by the state entering chunk n);
//  3. ssd_scan_kernel_chunk, one block per (chunk, batch row, group of G
//     heads): C.B^T is formed once for the group (the heads share B and C)
//     and kept in shared memory; per head y = M (dt x) + exp(cum_t) C S_in^T
//     with M = C.B^T * exp(cum_t - cum_s).  exp is taken only at s <= t:
//     above the diagonal cum_t - cum_s > 0 can overflow to inf, and a masked
//     product inf * 0 would be NaN.  Below a 16-row tile's diagonal block
//     (s < r0 <= t) the decay factors as exp(cum_t - cum_r0) exp(cum_r0 -
//     cum_s), both at most 1: the second is a per-warp table, the first is
//     applied once to the sum, and the inter-chunk term joins that sum as
//     exp(cum_r0) C S_in^T.  exp per element is left to the diagonal blocks.
//
// G (at most 8) is the most heads whose grid still fills its waves of
// resident blocks to 90%: at zamba2-7b 7, i.e. 512 independent blocks of
// each kernel in place of 224 sequential walks, and C.B^T once per seven
// heads in place of once per head.  The next head's x (and S_in) is copied
// with cp.async while this head computes, where shared memory holds two
// (zamba2-7b; mamba2-130m's ds = 128 holds one).  The chunk states add
// 2 x 16 x 112 x 64 x 64 x 4 B = 58.7 MB, written by 1, read and rewritten
// by 2, read by 3.
//
// Every product (C.B^T, M (dt x), C S_in^T and the state increment) runs on
// the tensor cores as mma.sync.m16n8k8 in TF32, float32-exact by a hi + lo
// split of both operands: a.b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi, each
// part rounded to TF32, accumulated in float32, the hi b_hi products apart
// from the others.  The dropped a_lo b_lo and the rounding of the lo parts
// are ~2^-22 of a.b; a single TF32 pass (2^-11) would change the float32
// function (the split and the mma wrapper are in tf32_split.cuh, which
// flash_attention.cu shares).  mma.sync rather than wgmma: wgmma takes TF32
// B operands only K-major from shared memory, so dt x and S_in would have
// to be stored transposed and already split, hi and lo
// tiles of their own, twice the shared memory the head buffers take here;
// mma.sync splits each operand in registers as it loads it, and takes M as
// made there from C.B^T and the decay.  Shared-memory strides are 4 or 8
// (mod 32) floats, so that every fragment load of a warp hits 32 different
// banks.  Each warp owns 32 x 32 of y (a pair of 16-row tiles t and Lp/16 -
// 1 - t, so that every warp runs the same number of causal products) or
// 16 x 32 of inc.  Tile extents are padded to 32 with zeros, so any (chunk,
// dh, ds) whose buffers fit is taken.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_split.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;            // heads per block, at most (<= kWarps)
constexpr int kInFlight = 8;        // chunks a pass thread loads at once
constexpr int kSmemPerBlock = 232448;
constexpr int kSmemPerSM = 233472;  // 228 KB, 1 KB of it reserved per block

inline int pad32(int n) { return (n + 31) / 32 * 32; }

// Shared-memory floats of each kernel with nbuf head buffers (mirrored by
// smem_bytes in kernels/ssd_scan/ssd_scan.py).
inline int state_floats(int Lp, int dhp, int dsp, int nbuf) {
  return Lp * (dsp + 8)            // B, rows s
         + nbuf * Lp * (dhp + 8)   // x of a head, rows s
         + kMaxG * Lp;             // per head: dt_s exp(cum_L - cum_s)
}

inline int chunk_floats(int Lp, int dhp, int dsp, int nbuf) {
  const int b = Lp * (dsp + 4);                          // B, rows s
  const int buf = Lp * (dhp + 8) + dhp * (dsp + 4);      // x and S_in of a head
  return Lp * (dsp + 4)                                  // C, rows t
         + Lp * (Lp + 4)                                 // C.B^T, rows t
         + 2 * kMaxG * Lp                                // per head: dt, cum
         + kWarps * 2 * Lp                               // per warp: exp(cum_r0 - cum_s)
         + (nbuf == 2 ? buf : 0) + (buf > b ? buf : b);  // head buffers, B in the last
}

// Double-buffer the heads where that leaves the blocks an SM holds: two of
// the state kernel, one of the chunk kernel.
inline int state_nbuf(int Lp, int dhp, int dsp) {
  return 2 * (4 * state_floats(Lp, dhp, dsp, 2) + 1024) <= kSmemPerSM ? 2 : 1;
}
inline int chunk_nbuf(int Lp, int dhp, int dsp) {
  return 4 * chunk_floats(Lp, dhp, dsp, 2) <= kSmemPerBlock ? 2 : 1;
}

// Heads per block: the most (up to kMaxG) whose grid of rows x ceil(h / G)
// blocks still fills its waves of `slots` resident blocks to 90%.
inline int heads_per_block(int64_t rows, int h, int64_t slots) {
  for (int G = kMaxG; G > 1; --G) {
    const int64_t blocks = rows * ((h + G - 1) / G);
    const int64_t waves = (blocks + slots - 1) / slots;
    if (10 * blocks >= 9 * waves * slots) return G;
  }
  return 1;
}

// Starts copying rows x cols floats (source row stride src_ld) into shared
// memory (row stride ld, a multiple of 4), zero-filled to prow x pcol (pcol
// a multiple of 4): 16-byte copies where the source allows them, else 4.
__device__ void load_tile_async(float* dst, int ld, const float* __restrict__ src,
                                int64_t src_ld, int rows, int cols, int prow, int pcol) {
  const bool vec = ((cols | src_ld) & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  const int w = vec ? 4 : 1;
  const int per_row = pcol / w;
  for (int q = threadIdx.x; q < prow * per_row; q += kThreads) {
    const int r = q / per_row;
    const int c = (q - r * per_row) * w;
    const bool valid = r < rows && c < cols;
    cp_async(dst + r * ld + c, valid ? src + r * src_ld + c : src, 4 * w, valid);
  }
}

// Inclusive cumsum of a * dt_s over the chunk (dt_s at dtp[s * stride]) by
// one warp: per-lane runs, then a shuffle scan of the run totals.  Writes
// dt_s and cum_s, both zero past L.
__device__ void chunk_cumsum(const float* __restrict__ dtp, int64_t stride, float a,
                             float* dts, float* cum, int L, int Lp, int lane) {
  const int per = (L + 31) / 32;
  const int lo = min(L, lane * per);
  const int hi = min(L, lo + per);
  float run = 0.f;
  for (int s = lo; s < hi; ++s) {
    const float d = __ldg(dtp + s * stride);
    dts[s] = d;
    run += a * d;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  float acc = incl - run;  // the sum of the lanes before this one
  for (int s = lo; s < hi; ++s) {
    acc += a * dts[s];
    cum[s] = acc;
  }
  for (int s = L + lane; s < Lp; s += 32) dts[s] = cum[s] = 0.f;
  __syncwarp();
}

// dt_s exp(cum_L - cum_s) into u (0 past L) by one warp, as chunk_cumsum
// forms cum; returns cum_L.
__device__ float chunk_weights(const float* __restrict__ dtp, int64_t stride, float a,
                               float* u, int L, int Lp, int lane) {
  const int per = (L + 31) / 32;
  const int lo = min(L, lane * per);
  const int hi = min(L, lo + per);
  float run = 0.f;
  for (int s = lo; s < hi; ++s) run += a * __ldg(dtp + s * stride);
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  const float last = __shfl_sync(0xffffffffu, incl, 31);
  float acc = incl - run;
  for (int s = lo; s < hi; ++s) {
    const float d = __ldg(dtp + s * stride);
    acc += a * d;
    u[s] = d * expf(last - acc);
  }
  for (int s = L + lane; s < Lp; s += 32) u[s] = 0.f;
  return last;
}

// Stores v0, v1 at out[i], out[i + 1] (8 bytes at once where both are in
// range and n is even), i < n.
__device__ __forceinline__ void store_pair(float* out, int i, int n, float v0, float v1) {
  if (i + 1 < n && (n & 1) == 0) {
    *reinterpret_cast<float2*>(out + i) = make_float2(v0, v1);
  } else {
    if (i < n) out[i] = v0;
    if (i + 1 < n) out[i + 1] = v1;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_kernel_state(const float* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const float* __restrict__ B,
                      float* __restrict__ inc, float* __restrict__ decay, int l,
                      int h, int dh, int ds, int L, int G, int Lp, int dhp, int dsp,
                      int nbuf) {
  extern __shared__ __align__(16) float smem[];
  const int ldb = dsp + 8, ldx = dhp + 8;
  float* Bs = smem;                      // Lp x ldb: B_s
  float* X0 = Bs + Lp * ldb;             // nbuf x (Lp x ldx): x_s of a head
  float* u = X0 + nbuf * Lp * ldx;       // kMaxG x Lp: dt_s exp(cum_L - cum_s), 0 past L

  const int n = blockIdx.x, b = blockIdx.y;
  const int h0 = blockIdx.z * G, h1 = min(h, h0 + G);
  const int nc = l / L;
  const int64_t row0 = static_cast<int64_t>(b) * l + static_cast<int64_t>(n) * L;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_groups = dsp / 32;
  const int items = (dhp / 16) * n_groups;
  const int64_t xld = static_cast<int64_t>(h) * dh;
  auto x_of = [&](int hh) { return x + (row0 * h + hh) * dh; };

  load_tile_async(Bs, ldb, B + row0 * ds, ds, L, ds, Lp, dsp);
  if (nbuf == 2) load_tile_async(X0, ldx, x_of(h0), xld, L, dh, Lp, dhp);
  cp_async_commit();
  if (warp < h1 - h0) {  // one warp per head: dt exp(cum_L - cum_s) and the decay
    const int hh = h0 + warp;
    const float last = chunk_weights(dt + row0 * h + hh, h, __ldg(A + hh), u + warp * Lp,
                                     L, Lp, lane);
    if (lane == 0) decay[(static_cast<int64_t>(b) * nc + n) * h + hh] = expf(last);
  }
  cp_async_wait_all();
  __syncthreads();

  for (int i = 0, hh = h0; hh < h1; ++i, ++hh) {
    const float* X = X0 + (i % nbuf) * Lp * ldx;
    if (nbuf == 1) {
      if (i > 0) __syncthreads();  // the last head's reads of X are done
      load_tile_async(X0, ldx, x_of(hh), xld, L, dh, Lp, dhp);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
    } else if (hh + 1 < h1) {  // the next head's x, while this one computes
      load_tile_async(X0 + ((i + 1) % 2) * Lp * ldx, ldx, x_of(hh + 1), xld, L, dh,
                      Lp, dhp);
      cp_async_commit();
    }

    const float* uw = u + i * Lp;
    float* out = inc + ((static_cast<int64_t>(b) * nc + n) * h + hh) * dh * ds;
    for (int item = warp; item < items; item += kWarps) {
      const int p0 = (item / n_groups) * 16;
      const int k0 = (item % n_groups) * 32;
      float acc[4][4] = {}, accs[4][4] = {};
      struct StateRaw {
        float x[4], u[2], b[4][2];
      };
      auto state_load = [&](int s0, StateRaw& raw) {
        const int sa = s0 + t, sb = s0 + t + 4;
        raw.u[0] = uw[sa];
        raw.u[1] = uw[sb];
        const float* xa = X + sa * ldx + p0 + g;
        const float* xb = X + sb * ldx + p0 + g;
        raw.x[0] = xa[0];
        raw.x[1] = xa[8];
        raw.x[2] = xb[0];
        raw.x[3] = xb[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = k0 + 8 * j + g;
          raw.b[j][0] = Bs[sa * ldb + k];
          raw.b[j][1] = Bs[sb * ldb + k];
        }
      };
      for (int s0 = 0; s0 < Lp; s0 += 8) {
        StateRaw raw;
        state_load(s0, raw);
        // A[p][s] = dt_s exp(cum_L - cum_s) x_s[p]
        const float av[4] = {raw.x[0] * raw.u[0], raw.x[1] * raw.u[0], raw.x[2] * raw.u[1],
                             raw.x[3] * raw.u[1]};
        FragA fa;
        fa.set(av);
        FragB fb[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) fb[j].set(raw.b[j][0], raw.b[j][1]);
#pragma unroll
        for (int part = 0; part < 3; ++part) {
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_part(acc[j], accs[j], fa, fb[j], part);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + 8 * j + 2 * t;
        const float* a = acc[j];
        const float* c = accs[j];
        if (p0 + g < dh) store_pair(out + (p0 + g) * ds, k, ds, a[0] + c[0], a[1] + c[1]);
        if (p0 + g + 8 < dh)
          store_pair(out + (p0 + g + 8) * ds, k, ds, a[2] + c[2], a[3] + c[3]);
      }
    }
    if (nbuf == 2) {
      cp_async_wait_all();
      __syncthreads();  // the next head's x is in; this head's reads are done
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel_pass(float* __restrict__ S, const float* __restrict__ decay, int nc,
                     int h, int hds, int64_t total) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const int64_t e = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * V;
  if (e >= total) return;
  const int64_t per_b = static_cast<int64_t>(h) * hds;  // one chunk of one batch row
  const int64_t bi = e / per_b;
  const int64_t rem = e - bi * per_b;
  const int hh = static_cast<int>(rem / hds);
  Vec* p = reinterpret_cast<Vec*>(S + bi * nc * per_b + rem);  // chunk n at n * per_b / V
  const int64_t step = per_b / V;
  const float* dec = decay + bi * nc * h + hh;  // chunk n at dec[n * h]
  float s[V] = {};
  for (int n0 = 0; n0 < nc; n0 += kInFlight) {
    Vec v[kInFlight];
    float d[kInFlight];
#pragma unroll
    for (int i = 0; i < kInFlight; ++i) {
      if (n0 + i < nc) {
        v[i] = p[(n0 + i) * step];
        d[i] = __ldg(dec + (n0 + i) * h);
      }
    }
#pragma unroll
    for (int i = 0; i < kInFlight; ++i) {
      if (n0 + i < nc) {
        const float* vi = reinterpret_cast<const float*>(&v[i]);
        Vec out;
        float* o = reinterpret_cast<float*>(&out);
#pragma unroll
        for (int c = 0; c < V; ++c) {
          o[c] = s[c];  // the state entering chunk n0 + i
          s[c] = d[i] * s[c] + vi[c];
        }
        p[(n0 + i) * step] = out;
      }
    }
  }
}

// A warp's operands for M (dt x) on its pair of 16-row tiles of y.
struct IntraTile {
  const float* X;   // x_s, rows s
  const float* dw;  // dt_s
  const float* CB;  // C_t . B_s, rows t
  const float* Ew;  // exp(cum_r0 - cum_s) below each tile's diagonal block
  const float* cw;  // cum_s
  int ldx, ldm, Lp, L, p0, g, t;
  int rows[2];
};

// The shared-memory operands of one k-step (8 values of s) of M (dt x):
// x and dt for B; C.B^T and, below the diagonal block, E or, on it, cum_s
// for A.
struct IntraRaw {
  float x[4][2], d[2], cb[2][4], e[2][4];
};

// Per tile, kMode 0 skips it, 1 takes a k-step below its diagonal block
// (C.B^T E into yo), 2 one on it (C.B^T exp(cum_t - cum_s) at s <= t, into yd).
template <int kMode0, int kMode1>
__device__ __forceinline__ void intra_load(const IntraTile& w, int k0, IntraRaw& raw) {
  raw.d[0] = w.dw[k0 + w.t];
  raw.d[1] = w.dw[k0 + w.t + 4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float* d = w.X + (k0 + w.t) * w.ldx + w.p0 + 8 * j + w.g;
    raw.x[j][0] = d[0];
    raw.x[j][1] = d[4 * w.ldx];
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int mode = mi == 0 ? kMode0 : kMode1;
    if (mode == 0) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = w.rows[mi] + w.g + (e & 1) * 8;
      const int s = k0 + w.t + (e >> 1) * 4;
      raw.cb[mi][e] = w.CB[r * w.ldm + s];
      raw.e[mi][e] = mode == 1 ? w.Ew[mi * w.Lp + s] : w.cw[s];
    }
  }
}

template <int kMode0, int kMode1>
__device__ __forceinline__ void intra_mma(const IntraTile& w, int k0, const IntraRaw& raw,
                                          float (&yo)[2][4][4], float (&ys)[2][4][4],
                                          float (&yd)[2][4][4]) {
  FragB fb[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) fb[j].set(raw.d[0] * raw.x[j][0], raw.d[1] * raw.x[j][1]);
  FragA fa[2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int mode = mi == 0 ? kMode0 : kMode1;
    if (mode == 0) continue;
    float av[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = w.rows[mi] + w.g + (e & 1) * 8;
      const int s = k0 + w.t + (e >> 1) * 4;
      if (mode == 1)
        av[e] = raw.cb[mi][e] * raw.e[mi][e];
      else
        av[e] = (s <= r && r < w.L) ? raw.cb[mi][e] * expf(w.cw[r] - raw.e[mi][e]) : 0.f;
    }
    fa[mi].set(av);
  }
#pragma unroll
  for (int part = 0; part < 3; ++part) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int mode = mi == 0 ? kMode0 : kMode1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (mode == 1)
          mma_part(yo[mi][j], ys[mi][j], fa[mi], fb[j], part);
        else if (mode == 2)
          mma_part(yd[mi][j], yd[mi][j], fa[mi], fb[j], part);
      }
    }
  }
}

// The k-steps [k_begin, k_end) of M (dt x).  (Loading the next step's
// operands while this step's products run measured slower: more registers
// and copies, no fewer stalls.)
template <int kMode0, int kMode1>
__device__ __forceinline__ void intra_range(const IntraTile& w, int k_begin, int k_end,
                                            float (&yo)[2][4][4], float (&ys)[2][4][4],
                                            float (&yd)[2][4][4]) {
  for (int k0 = k_begin; k0 < k_end; k0 += 8) {
    IntraRaw raw;
    intra_load<kMode0, kMode1>(w, k0, raw);
    intra_mma<kMode0, kMode1>(w, k0, raw, yo, ys, yd);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel_chunk(const float* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const float* __restrict__ B,
                      const float* __restrict__ C, const float* __restrict__ S,
                      float* __restrict__ y, int l, int h, int dh, int ds, int L,
                      int G, int Lp, int dhp, int dsp, int nbuf) {
  extern __shared__ __align__(16) float smem[];
  const int ldc = dsp + 4, ldm = Lp + 4, ldx = dhp + 8;
  const int buf = Lp * ldx + dhp * ldc;
  float* Cs = smem;                   // Lp x ldc: C_t
  float* CB = Cs + Lp * ldc;          // Lp x ldm: C_t . B_s (s <= t only)
  float* dts = CB + Lp * ldm;         // kMaxG x Lp: dt_s of each head
  float* cum = dts + kMaxG * Lp;      // kMaxG x Lp
  float* E = cum + kMaxG * Lp;        // kWarps x 2 x Lp
  float* buf0 = E + kWarps * 2 * Lp;  // nbuf x {x (Lp x ldx), S_in (dhp x ldc)}
  float* Bs = buf0 + (nbuf - 1) * buf;  // Lp x ldc: B_s, in the last head buffer

  const int n = blockIdx.x, b = blockIdx.y;
  const int h0 = blockIdx.z * G, h1 = min(h, h0 + G);
  const int nc = l / L;
  const int64_t row0 = static_cast<int64_t>(b) * l + static_cast<int64_t>(n) * L;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t xld = static_cast<int64_t>(h) * dh;
  auto load_head = [&](int hh, float* bf) {
    load_tile_async(bf, ldx, x + (row0 * h + hh) * dh, xld, L, dh, Lp, dhp);
    load_tile_async(bf + Lp * ldx, ldc,
                    S + ((static_cast<int64_t>(b) * nc + n) * h + hh) * dh * ds, ds, dh,
                    ds, dhp, dsp);
    cp_async_commit();
  };

  load_tile_async(Cs, ldc, C + row0 * ds, ds, L, ds, Lp, dsp);
  load_tile_async(Bs, ldc, B + row0 * ds, ds, L, ds, Lp, dsp);
  cp_async_commit();
  if (nbuf == 2) load_head(h0, buf0);
  if (warp < h1 - h0)
    chunk_cumsum(dt + row0 * h + h0 + warp, h, __ldg(A + h0 + warp), dts + warp * Lp,
                 cum + warp * Lp, L, Lp, lane);
  cp_async_wait_all();
  __syncthreads();

  // C.B^T in 32 x 32 warp tiles on and below the diagonal.
  const int nt = Lp / 32;
  for (int item = warp; item < nt * nt; item += kWarps) {
    const int r0 = (item / nt) * 32, c0 = (item % nt) * 32;
    if (c0 > r0) continue;
    float acc[2][4][4] = {}, accs[2][4][4] = {};
    struct CBRaw {
      float c[2][4], b[4][2];
    };
    auto cb_load = [&](int k0, CBRaw& raw) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* c = Cs + (r0 + 16 * mi + g) * ldc + k0 + t;
        raw.c[mi][0] = c[0];
        raw.c[mi][1] = c[8 * ldc];
        raw.c[mi][2] = c[4];
        raw.c[mi][3] = c[8 * ldc + 4];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* bp = Bs + (c0 + 8 * j + g) * ldc + k0 + t;
        raw.b[j][0] = bp[0];
        raw.b[j][1] = bp[4];
      }
    };
    for (int k0 = 0; k0 < dsp; k0 += 8) {
      CBRaw raw;
      cb_load(k0, raw);
      FragA fa[2];
      fa[0].set(raw.c[0]);
      fa[1].set(raw.c[1]);
      FragB fb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) fb[j].set(raw.b[j][0], raw.b[j][1]);
#pragma unroll
      for (int part = 0; part < 3; ++part) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_part(acc[0][j], accs[0][j], fa[0], fb[j], part);
          mma_part(acc[1][j], accs[1][j], fa[1], fb[j], part);
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* o = CB + (r0 + 16 * mi + g) * ldm + c0 + 8 * j + 2 * t;
        const float* a = acc[mi][j];
        const float* c = accs[mi][j];
        *reinterpret_cast<float2*>(o) = make_float2(a[0] + c[0], a[1] + c[1]);
        *reinterpret_cast<float2*>(o + 8 * ldm) = make_float2(a[2] + c[2], a[3] + c[3]);
      }
    }
  }
  __syncthreads();  // C.B^T is formed; B is no longer read

  const int mt = Lp / 16;           // 16-row tiles of y
  const int n_groups = dhp / 32;    // 32-column groups of y
  const int items = (mt / 2) * n_groups;
  float* Ew = E + warp * 2 * Lp;
  for (int i = 0, hh = h0; hh < h1; ++i, ++hh) {
    const float* X = buf0 + (i % nbuf) * buf;
    const float* Sm = X + Lp * ldx;
    if (nbuf == 1) {
      if (i > 0) __syncthreads();  // the last head's reads of the buffer are done
      load_head(hh, buf0);
      cp_async_wait_all();
      __syncthreads();
    } else if (hh + 1 < h1) {  // the next head's x and S_in, while this one computes
      load_head(hh + 1, buf0 + ((i + 1) % 2) * buf);
    }
    const float* dw = dts + i * Lp;
    const float* cw = cum + i * Lp;

    for (int item = warp; item < items; item += kWarps) {
      const int pair = item / n_groups;
      const int p0 = (item % n_groups) * 32;
      const int rows[2] = {16 * pair, 16 * (mt - 1 - pair)};
      // Below a tile's diagonal block (s < r0 <= t) the decay factors as
      // exp(cum_t - cum_r0) exp(cum_r0 - cum_s), both <= 1: the first is
      // applied to the sum once, the second (E, per warp) to C.B^T.
      float e0[2];
      __syncwarp();
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r0 = rows[mi];
        const float c0 = r0 < L ? cw[r0] : 0.f;
        e0[mi] = r0 < L ? expf(c0) : 0.f;
        for (int s = lane; s < Lp; s += 32)
          Ew[mi * Lp + s] = (s < r0 && r0 < L) ? expf(c0 - cw[s]) : 0.f;
      }
      __syncwarp();
      // yo and ys (big and small, see mma_part) below the diagonal blocks
      // and C S_in^T, yd on the diagonal blocks
      float yo[2][4][4] = {}, ys[2][4][4] = {}, yd[2][4][4] = {};

      // M (dt x): below the diagonal blocks into yo, on them into yd, in
      // the k ranges where the two tiles' modes are fixed.
      const IntraTile it{X, dw, CB, Ew, cw, ldx, ldm, Lp, L, p0, g, t, {rows[0], rows[1]}};
      const int ra = rows[0], rb = rows[1];
      intra_range<1, 1>(it, 0, ra, yo, ys, yd);
      intra_range<2, 1>(it, ra, ra + 16, yo, ys, yd);
      intra_range<0, 1>(it, ra + 16, rb, yo, ys, yd);
      intra_range<0, 2>(it, rb, rb + 16, yo, ys, yd);
      // exp(cum_r0) C S_in^T into yo: exp(cum_t) = exp(cum_t - cum_r0) exp(cum_r0).
      struct InterRaw {
        float s[4][2], c[2][4];
      };
      auto inter_load = [&](int k0, InterRaw& raw) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* sp = Sm + (p0 + 8 * j + g) * ldc + k0 + t;
          raw.s[j][0] = sp[0];
          raw.s[j][1] = sp[4];
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const float* c = Cs + (rows[mi] + g) * ldc + k0 + t;
          raw.c[mi][0] = c[0];
          raw.c[mi][1] = c[8 * ldc];
          raw.c[mi][2] = c[4];
          raw.c[mi][3] = c[8 * ldc + 4];
        }
      };
      for (int k0 = 0; k0 < dsp; k0 += 8) {
        InterRaw raw;
        inter_load(k0, raw);
        FragB fb[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) fb[j].set(raw.s[j][0], raw.s[j][1]);
        FragA fa[2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const float av[4] = {e0[mi] * raw.c[mi][0], e0[mi] * raw.c[mi][1],
                               e0[mi] * raw.c[mi][2], e0[mi] * raw.c[mi][3]};
          fa[mi].set(av);
        }
#pragma unroll
        for (int part = 0; part < 3; ++part) {
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_part(yo[mi][j], ys[mi][j], fa[mi], fb[j], part);
          }
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = rows[mi] + g + 8 * half;
          if (r >= L) continue;
          const float f = expf(cw[r] - cw[rows[mi]]);
          float* out = y + ((row0 + r) * h + hh) * dh;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float* o = yo[mi][j] + 2 * half;
            const float* c = ys[mi][j] + 2 * half;
            const float* d = yd[mi][j] + 2 * half;
            store_pair(out, p0 + 8 * j + 2 * t, dh, f * (o[0] + c[0]) + d[0],
                       f * (o[1] + c[1]) + d[1]);
          }
        }
      }
    }
    if (nbuf == 2) {
      cp_async_wait_all();
      __syncthreads();  // the next head is in; this head's reads are done
    }
  }
}

}  // namespace

extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* A,
                            const void* B, const void* C, void* y, void* states,
                            void* decays, int b, int l, int h, int dh, int ds,
                            int chunk, void* stream) {
  if (chunk < 1 || l % chunk != 0 || dh < 1 || ds < 1 || b < 1 || h < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Lp = pad32(chunk), dhp = pad32(dh), dsp = pad32(ds);
  const int nc = l / chunk;
  const int state_buf = state_nbuf(Lp, dhp, dsp), chunk_buf = chunk_nbuf(Lp, dhp, dsp);
  const size_t state_bytes = sizeof(float) * state_floats(Lp, dhp, dsp, state_buf);
  const size_t chunk_bytes = sizeof(float) * chunk_floats(Lp, dhp, dsp, chunk_buf);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel_state,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(state_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_scan_kernel_chunk,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(chunk_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 132;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = static_cast<int64_t>(b) * nc;
  const int G_state = heads_per_block(rows, h, 2LL * sms);  // two blocks an SM
  const int G_chunk = heads_per_block(rows, h, sms);

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Bf = static_cast<const float*>(B);
  float* Sf = static_cast<float*>(states);
  float* Df = static_cast<float*>(decays);
  ssd_scan_kernel_state<<<dim3(nc, b, (h + G_state - 1) / G_state), kThreads,
                          state_bytes, s>>>(xf, dtf, Af, Bf, Sf, Df, l, h, dh, ds, chunk,
                                            G_state, Lp, dhp, dsp, state_buf);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int hds = dh * ds;
  const int64_t total = static_cast<int64_t>(b) * h * hds;
  if (hds % 4 == 0) {
    const int64_t threads = total / 4;
    ssd_scan_kernel_pass<4><<<static_cast<unsigned>((threads + kThreads - 1) / kThreads),
                              kThreads, 0, s>>>(Sf, Df, nc, h, hds, total);
  } else {
    ssd_scan_kernel_pass<1><<<static_cast<unsigned>((total + kThreads - 1) / kThreads),
                              kThreads, 0, s>>>(Sf, Df, nc, h, hds, total);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel_chunk<<<dim3(nc, b, (h + G_chunk - 1) / G_chunk), kThreads,
                          chunk_bytes, s>>>(xf, dtf, Af, Bf, static_cast<const float*>(C),
                                            Sf, static_cast<float*>(y), l, h, dh, ds,
                                            chunk, G_chunk, Lp, dhp, dsp, chunk_buf);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
