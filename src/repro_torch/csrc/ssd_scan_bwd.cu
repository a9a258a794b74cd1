// The backward of the chunked Mamba2 SSD scan, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference has no backward kernel.  It trains
// through src/repro/kernels/ssd_scan/ref.py::ssd_chunked_ref under jax.grad;
// this kernel computes that gradient on the card, so that a training step
// through ssd_scan.cu's forward never runs the plain twin.  Its plain twin is
// repro_torch/kernels/ssd_scan/ref.py::ssd_bwd_ref, which it mirrors.  Per
// batch row b and head h, chunks of L steps, cum_t = sum_{u <= t} A dt_u,
// u_s = dt_s x_s, W_ts = exp(cum_t - cum_s) for s <= t, and the state S_in
// entering each chunk, against the cotangent dy:
//
//     G_n   = sum_t exp(cum_t) dy_t C_t^T + exp(cum_L) G_{n+1}   (state adjoint)
//     du_s  = sum_t (C_t.B_s) W_ts dy_t + exp(cum_L - cum_s) G_{n+1} B_s
//     dx    = dt du,   ddt = x.du + A dlam,   dA = sum dt dlam
//     dC_t  = sum_s W_ts (dy_t.u_s) B_s + exp(cum_t) S_in^T dy_t    (summed over h)
//     dB_s  = sum_t W_ts (dy_t.u_s) C_t + exp(cum_L - cum_s) G_{n+1}^T u_s
//     dcum  = rowsum R - colsum R + dy.y_inter - u.du_inter
//             (+ <G_{n+1}, S_in(n+1)> at the chunk's last step),
//             R_ts = (C_t.B_s) W_ts (dy_t.u_s);  dlam = reverse cumsum of dcum
//
// x, dy, dx (b, l, h, dh); dt, ddt (b, l, h); A, dA (h,); B, C, dB, dC
// (b, l, ds); the S_in and G scratch (b, l / L, h, dh, ds): float32,
// contiguous.  The kernel recomputes S_in itself on the FMA units rather
// than take the forward's TF32 chunk states: at the model's decays those
// sit ~1e-4 of max|S| from float64, and dA, a sum of dt * dlam whose terms
// far exceed it, moves ~6x as much.  Every factor exp(.) is at most 1: the
// recurrences multiply by the decay, never divide by it (exp(A dt) reaches
// ~1e-7 at the decay extremes), and exp is taken only at s <= t (masked
// first: above the diagonal cum_t - cum_s > 0 can overflow).
//
// Bound: operations.  At zamba2-7b's layer (b 2, l 2048, 112 heads, dh 64,
// ds 64, chunk 128) it reads x, dy, dt, A, B and C and writes dx, ddt, dA,
// dB and dC: 360 MB, 108 us at 3.35 TB/s; its 18.9 G multiply-adds take
// 229 us as three TF32 tensor-core passes (the hi + lo split that keeps
// products float32-exact, as the forward's) and 563 us on the float32 FMA
// units.
//
// Six launches on the caller's stream, the forward's in order and then in
// reverse, and a reduction; every sum is in a fixed order (no float
// atomics), so two runs give the same bits:
//
//  1-2. ssd_bwd_kernel_outer (inc), one block per (chunk, batch row, head):
//     the chunk's cum (a serial sum in one thread, the same in every
//     launch), its decay exp(cum_L) and its state increment; then
//     ssd_bwd_kernel_pass forward: the state entering each chunk, in place;
//  3-4. ssd_bwd_kernel_outer: each chunk's local state adjoint sum_t
//     exp(cum_t) dy_t C_t^T; then ssd_bwd_kernel_pass backward: slot n
//     ends holding G_{n+1} (zero for the last chunk);
//  5. ssd_bwd_kernel_chunk, one block per (chunk, batch row, group of Gh
//     heads): the within-chunk gradients on the tensor cores; dx and ddt of
//     each head, dB and dC summed over the group's heads in head order
//     (partials (b, l, ceil(h / Gh), ds)) and dA's partial (b, l / L, h);
//  6. ssd_bwd_kernel_reduce: dB and dC summed over the groups in order, dA
//     over batch rows and chunks in order (in double, as its partials).
//
// The outer launches (1, 3) stay float32 arithmetic on the FMA units: each
// thread owns 4 x 4 outputs of the (dh x ds) sum and adds its t terms in
// order with fmaf, the products read as float4 from shared memory (16
// multiply-adds per two loads), so the states are the same bits as one
// output per thread gives.  The passes (2, 4) load eight chunks' values
// ahead of the recurrence, four elements a thread, in the recurrence's
// order.
//
// The chunk launch runs every within-chunk product as mma.sync.m16n8k8 in
// TF32, float32-exact by tf32_split.cuh's hi + lo split of both operands
// (the lo parts left for the tensor cores to truncate), the a_hi b_hi
// products summed apart from the others (big and small):
//  * C.B^T does not depend on the head: it is formed once for the group
//    (the lower triangle's 16 x 16 blocks over the warps) and kept in
//    shared memory beside C, B and each head's u, dy, S_in and G (ds <= 64);
//  * warp w owns the 16 rows 16 w .. 16 w + 15 as t (dC's rows) and as s
//    (dB's and du's rows), so every row sum is the warp's own: as t it
//    forms dy.u^T on the blocks s <= t (dh-long products), X = C.B^T W and
//    R = X (dy.u) there for rowsum R, Y = W (dy.u) as the A operand of
//    dC += Y B straight from the product's registers (the k order of an
//    8-wide step taken as columns 2t, 2t + 1, as the forward's attention
//    takes P), and dC's state part exp(cum_t) dy S_in^T; as s it forms
//    u.dy^T on the blocks t >= s, colsum R, du += X^T dy and dB += Y^T C
//    from the registers likewise, and du's and dB's state parts.  Warp w
//    walks w + 1 blocks as t and L/16 - w as s;
//  * off the diagonal blocks W factors about the block's edge into a row
//    and a column factor, both at most 1, the column's from a per-warp
//    table: exp once a row and column, not once an element;
//  * dC and dB of the group are summed in the block's own region of the
//    partials, head after head, by the threads that own them;
//  * the next head's rows, S_in and G are prefetched into L2 while this
//    head computes (shared memory holds one head's operands);
//  * ds > 64 (mamba2-130m's 128) takes the same code with one head a block
//    and C, B read through the cache (a block's shared memory holds C.B^T,
//    u, dy, S_in and G, not C and B as well), single sums.
//  Per head, dcum is the rows' two sides and x.du; one warp takes the
//  reverse cumulative sum in double (a shuffle scan over lanes of four
//  steps) for ddt and dA's partial.  L <= 128, dh <= 64 and ds <= 128 (the
//  wrapper checks: the LM configs' chunk is 128, their head dim 64).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_split.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxL = 128;   // chunk
constexpr int kMaxDh = 64;   // head dim
constexpr int kMaxDs = 128;  // state dim
constexpr int kSharedDs = 64;  // the largest ds whose C and B stay in shared memory
constexpr int kMaxG = 8;     // heads a chunk block
constexpr int kLdb = 20;     // row stride of a 16 x 16 block of C.B^T
constexpr int kNTD = kMaxDh / 8;  // n-tiles of du (8 head-dim columns each)
constexpr int kInFlight = 8;      // chunks a pass thread loads at once

__host__ __device__ __forceinline__ int pad4(int n) { return (n + 3) / 4 * 4; }
__host__ __device__ __forceinline__ int pad8(int n) { return (n + 7) / 8 * 8; }
__host__ __device__ __forceinline__ int pad16(int n) { return (n + 15) / 16 * 16; }

// Shared-memory floats of the outer launch: dt, cum and the weights of the
// chunk, the weighted vector rows (Lp x pad4(dh)) and B or C (Lp x pad4(ds)).
inline int outer_floats(int Lp, int dh, int ds) {
  return 3 * Lp + Lp * pad4(dh) + Lp * pad4(ds);
}

// Shared-memory floats of the chunk launch (mirrored by bwd_smem_bytes in
// kernels/ssd_scan/ssd_scan.py): C.B^T's lower triangle of 16 x 16 blocks
// (rows strided kLdb), u and dy of a head (Lp x (dhp + 4) each), C and B
// where ds <= 64 (Lp x (dsp + 4) each), S_in and G of a head (dhp x (dsp +
// 4) each), the head's dt and cum, the rows' two sides of dcum, x.du, the
// partial sums of <G, S>, and each warp's table of decays off its diagonal
// blocks.
inline int chunk_floats(int Lp, int dhp, int dsp, bool shared_cb) {
  const int nb = Lp / 16;
  return nb * (nb + 1) / 2 * 16 * kLdb + 2 * Lp * (dhp + 4) +
         (shared_cb ? 2 * Lp * (dsp + 4) : 0) + 2 * dhp * (dsp + 4) + 5 * Lp + kThreads +
         kWarps * Lp;
}

// dt of the chunk into dtv and its inclusive cum (one thread, in order) into
// cumv; zeros past L.  Ends with a barrier.
__device__ void chunk_cum(const float* __restrict__ dt, float a, int64_t row0, int h,
                          int hh, int L, int Lp, float* dtv, float* cumv) {
  for (int t = threadIdx.x; t < Lp; t += kThreads)
    dtv[t] = t < L ? __ldg(dt + (row0 + t) * h + hh) : 0.f;
  __syncthreads();
  if (threadIdx.x == 0) {
    float c = 0.f;
    for (int t = 0; t < L; ++t) {
      c += a * dtv[t];
      cumv[t] = c;
    }
    for (int t = L; t < Lp; ++t) cumv[t] = c;
  }
  __syncthreads();
}

// One chunk's (dh x ds) outer-product sum, by (chunk, batch row, head):
// with inc (launch 1) the state increment sum_s exp(cum_L - cum_s) dt_s x_s
// B_s^T; without (launch 3) the local state adjoint sum_t exp(cum_t) dy_t
// C_t^T.  Either writes the chunk's decay exp(cum_L) (the same value).
// Each thread sums a 4 x 4 block of outputs over t in order.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_kernel_outer(const float* __restrict__ dt, const float* __restrict__ A,
                     const float* __restrict__ mat, const float* __restrict__ vec,
                     float* __restrict__ out_all, float* __restrict__ decay, int l, int h,
                     int dh, int ds, int L, bool inc) {
  extern __shared__ __align__(16) float smem[];
  const int Lp = pad16(L), lde = pad4(dh), ldc = pad4(ds);
  float* dtv = smem;
  float* cumv = dtv + Lp;
  float* wv = cumv + Lp;       // the weight of each step
  float* Es = wv + Lp;         // Lp x lde: the weighted vector rows
  float* Cs = Es + Lp * lde;   // Lp x ldc: B_s or C_t
  const int n = blockIdx.x, bi = blockIdx.y, hh = blockIdx.z;
  const int nc = l / L;
  const int64_t row0 = static_cast<int64_t>(bi) * l + static_cast<int64_t>(n) * L;
  chunk_cum(dt, __ldg(A + hh), row0, h, hh, L, Lp, dtv, cumv);
  const float cum_last = cumv[L - 1];
  for (int t = threadIdx.x; t < L; t += kThreads)
    wv[t] = inc ? expf(cum_last - cumv[t]) * dtv[t] : expf(cumv[t]);
  __syncthreads();
  // the rows, a warp a row at a time, four columns a lane (float4 where the
  // rows allow it)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool vec4 = (dh & 3) == 0, mat4 = (ds & 3) == 0;
  for (int t = warp; t < L; t += kThreads / 32) {
    const float w = wv[t];
    const float* vrow = vec + ((row0 + t) * h + hh) * dh;
    for (int c = 4 * lane; c < lde; c += 128) {
      float4 v;
      if (vec4) {
        v = __ldg(reinterpret_cast<const float4*>(vrow + c));
      } else {
        v.x = c < dh ? __ldg(vrow + c) : 0.f;
        v.y = c + 1 < dh ? __ldg(vrow + c + 1) : 0.f;
        v.z = c + 2 < dh ? __ldg(vrow + c + 2) : 0.f;
        v.w = c + 3 < dh ? __ldg(vrow + c + 3) : 0.f;
      }
      *reinterpret_cast<float4*>(Es + t * lde + c) = make_float4(w * v.x, w * v.y, w * v.z, w * v.w);
    }
    const float* mrow = mat + (row0 + t) * ds;
    for (int c = 4 * lane; c < ldc; c += 128) {
      float4 v;
      if (mat4) {
        v = __ldg(reinterpret_cast<const float4*>(mrow + c));
      } else {
        v.x = c < ds ? __ldg(mrow + c) : 0.f;
        v.y = c + 1 < ds ? __ldg(mrow + c + 1) : 0.f;
        v.z = c + 2 < ds ? __ldg(mrow + c + 2) : 0.f;
        v.w = c + 3 < ds ? __ldg(mrow + c + 3) : 0.f;
      }
      *reinterpret_cast<float4*>(Cs + t * ldc + c) = v;
    }
  }
  __syncthreads();
  const int64_t blk = (static_cast<int64_t>(bi) * nc + n) * h + hh;
  if (threadIdx.x == 0) decay[blk] = expf(cum_last);
  float* out = out_all + blk * dh * ds;
  const int kq = ldc / 4;
  for (int q = threadIdx.x; q < (lde / 4) * kq; q += kThreads) {
    const int d0 = 4 * (q / kq), k0 = 4 * (q % kq);
    float acc[4][4] = {};
    for (int t = 0; t < L; ++t) {
      const float4 ev = *reinterpret_cast<const float4*>(Es + t * lde + d0);
      const float4 cv = *reinterpret_cast<const float4*>(Cs + t * ldc + k0);
      const float e4[4] = {ev.x, ev.y, ev.z, ev.w}, c4[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(e4[i], c4[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (d0 + i < dh && k0 + j < ds) out[(d0 + i) * ds + k0 + j] = acc[i][j];
  }
}

// The chunk-to-chunk recurrence over (b, h, dh, ds), V elements a thread,
// in place: forward, slot n ends holding the state entering chunk n
// (S_in(n + 1) = exp(cum_L) S_in(n) + inc_n); backward, slot n ends holding
// G_{n+1} (G_n = G_loc(n) + exp(cum_L) G_{n+1}, zero after the last chunk).
// Either multiplies by the decay, never divides by it.  kInFlight chunks'
// values are loaded before any is stored.
template <int V>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_kernel_pass(float* __restrict__ S, const float* __restrict__ decay, int nc, int h,
                    int hds, int64_t total, bool backward) {
  const int64_t e = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * V;
  if (e >= total) return;
  const int64_t per_b = static_cast<int64_t>(h) * hds;  // one chunk of one batch row
  const int64_t bi = e / per_b;
  const int64_t rem = e - bi * per_b;
  const int hh = static_cast<int>(rem / hds);
  float* p = S + bi * nc * per_b + rem;  // chunk n at p[n * per_b]
  const float* dec = decay + bi * nc * h + hh;  // chunk n at dec[n * h]
  float g[V] = {};
  for (int i0 = 0; i0 < nc; i0 += kInFlight) {
    float v[kInFlight][V], d[kInFlight];
#pragma unroll
    for (int i = 0; i < kInFlight; ++i) {
      if (i0 + i < nc) {
        const int n = backward ? nc - 1 - i0 - i : i0 + i;
        if constexpr (V == 4) {
          const float4 f = *reinterpret_cast<const float4*>(p + n * per_b);
          v[i][0] = f.x;
          v[i][1] = f.y;
          v[i][2] = f.z;
          v[i][3] = f.w;
        } else {
          v[i][0] = p[n * per_b];
        }
        d[i] = __ldg(dec + n * h);
      }
    }
#pragma unroll
    for (int i = 0; i < kInFlight; ++i) {
      if (i0 + i < nc) {
        const int n = backward ? nc - 1 - i0 - i : i0 + i;
        float o[V];
#pragma unroll
        for (int c = 0; c < V; ++c) {
          o[c] = g[c];
          g[c] = fmaf(d[i], g[c], v[i][c]);
        }
        if constexpr (V == 4)
          *reinterpret_cast<float4*>(p + n * per_b) = make_float4(o[0], o[1], o[2], o[3]);
        else
          p[n * per_b] = o[0];
      }
    }
  }
}

// An operand's split: hi rounded to TF32 and lo left for the tensor cores
// to truncate (split_lo_truncated: two operations a value fewer than
// split); the emulation of tests/test_torch_lm_bwd_split.py holds the
// kernel's limits with it as with split.
__device__ __forceinline__ void set_a(FragA& fa, const float (&v)[4]) {
  fa.set_lo_truncated(v);
}
__device__ __forceinline__ void set_b(FragB& fb, float v0, float v1) {
  fb.set_lo_truncated(v0, v1);
}

// The 128-byte line holding p into L2.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// m[r * ld + c] where (r, c) lies inside rows x cols, else 0 (read through
// the cache).
__device__ __forceinline__ float ld_in(const float* __restrict__ m, int ld, int r, int c,
                                       int rows, int cols) {
  return r < rows && c < cols ? __ldg(m + static_cast<int64_t>(r) * ld + c) : 0.f;
}

// Starts copying rows x cols floats (source row stride src_ld) into shared
// memory (row stride ld, a multiple of 4), zero-filled to prow x pcol:
// 16-byte copies where the source allows them, else 4.
__device__ void load_tile_async(float* dst, int ld, const float* __restrict__ src,
                                int64_t src_ld, int rows, int cols, int prow, int pcol) {
  const bool vec = ((cols | src_ld | pcol) & 3) == 0 &&
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

// Element (t, s), s <= t, of C.B^T stored as its lower triangle's 16 x 16
// blocks, block (tb, sb) at tb (tb + 1) / 2 + sb.
__device__ __forceinline__ int cb_at(int t, int s) {
  const int tb = t >> 4, sb = s >> 4;
  return ((tb * (tb + 1) / 2 + sb) * 16 + (t & 15)) * kLdb + (s & 15);
}

// The A operand of k-step k0 from rows [r0, r0 + 16) of a row-major
// matrix, row r0 + g scaled by f0 and r0 + g + 8 by f1.
__device__ __forceinline__ void frag_rows(FragA& fa, const float* m, int ld, int r0, int k0,
                                          int g, int t, float f0, float f1) {
  const float* p = m + (r0 + g) * ld + k0 + t;
  const float v[4] = {f0 * p[0], f1 * p[8 * ld], f0 * p[4], f1 * p[8 * ld + 4]};
  set_a(fa, v);
}

// The A operand of one k-step from a 16 x 8 accumulator block, its
// columns 2t and 2t + 1 taken as the step's k = t and t + 4.
__device__ __forceinline__ void frag_acc(FragA& fa, const float (&c)[4]) {
  const float v[4] = {c[0], c[2], c[1], c[3]};
  set_a(fa, v);
}

// The B operand b(k, n) = m[n][k]: columns n0 .. n0 + 7 are rows of m.
__device__ __forceinline__ void frag_cols(FragB& fb, const float* m, int ld, int n0, int k0,
                                          int g, int t) {
  const float* p = m + (n0 + g) * ld + k0 + t;
  set_b(fb, p[0], p[4]);
}

// The B operand b(k, n) = m[k][n] with k in frag_acc's order: rows k0 + 2t
// and k0 + 2t + 1.
__device__ __forceinline__ void frag_perm(FragB& fb, const float* m, int ld, int n0, int k0,
                                          int g, int t) {
  const float* p = m + (k0 + 2 * t) * ld + n0 + g;
  set_b(fb, p[0], p[ld]);
}

// out[(row0 + r) * ld + k] (+)= big + small (small where split) at this
// thread's accumulator positions, rows r0 and r1: the old values are read
// first, all of them, then written with this head's added.
template <int NT>
__device__ __forceinline__ void add_rows(float* __restrict__ out, int64_t ld, int64_t row0,
                                         int r0, int r1, int L, int ds, int nts, int t4,
                                         bool accumulate, const float (&big)[NT][4],
                                         const float (&small)[NT][4], bool split) {
  float old[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e < 2 ? r0 : r1, k = 8 * nt + 2 * t4 + (e % 2);
      old[nt][e] = accumulate && nt < nts && r < L && k < ds ? out[(row0 + r) * ld + k] : 0.f;
    }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e < 2 ? r0 : r1, k = 8 * nt + 2 * t4 + (e % 2);
      if (nt < nts && r < L && k < ds) {
        const float v = big[nt][e] + (split ? small[nt][e] : 0.f);
        out[(row0 + r) * ld + k] = accumulate ? old[nt][e] + v : v;
      }
    }
}

// C or B of the chunk: shared memory (ld = dsp + 4, zero-padded) where ds
// <= 64, else device memory (ld = ds; the wrapper takes L % 16 == 0 and
// ds % 8 == 0 there, so no read leaves the chunk's rows).
struct ChunkMat {
  const float* m;
  int ld;
};

template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_kernel_chunk(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const float* __restrict__ B,
                     const float* __restrict__ C, const float* __restrict__ dy,
                     const float* __restrict__ S_in, const float* __restrict__ Gst,
                     float* __restrict__ dx, float* __restrict__ ddt,
                     float* __restrict__ dBp, float* __restrict__ dCp,
                     float* __restrict__ dAp, int l, int h, int dh, int ds, int L, int Gh,
                     int ng) {
  constexpr bool kShared = NT * 8 <= kSharedDs;  // C and B in shared memory
  constexpr bool kSplit = kShared;               // big and small sums apart
  extern __shared__ __align__(16) float smem[];
  const int Lp = pad16(L), dhp = pad8(dh), dsp = pad8(ds);
  const int ldu = dhp + 4, ldc = dsp + 4;
  const int nb = Lp / 16;
  float* CB = smem;                 // C_t . B_s: cb_at(t, s)
  float* U = CB + nb * (nb + 1) / 2 * 16 * kLdb;  // Lp x ldu: u_s = dt_s x_s of a head
  float* DY = U + Lp * ldu;         // Lp x ldu: dy_t of a head
  float* Cs = DY + Lp * ldu;        // Lp x ldc (kShared)
  float* Bs = Cs + (kShared ? Lp * ldc : 0);
  float* Ss = Bs + (kShared ? Lp * ldc : 0);  // dhp x ldc: S_in of a head
  float* Gs = Ss + dhp * ldc;       // dhp x ldc: G_{n+1} of a head
  float* dw = Gs + dhp * ldc;       // Lp: dt of a head
  float* cw = dw + Lp;              // Lp: cum of a head
  float* dcT = cw + Lp;             // Lp: rowsum R + dy.y_inter
  float* dcS = dcT + Lp;            // Lp: -colsum R - u.du_inter
  float* ddir = dcS + Lp;           // Lp: x.du
  float* red = ddir + Lp;           // kThreads: partial sums of <G, S_next>
  // per warp: exp(cum_{16 w} - cum_s) at s < 16 w, exp(cum_t - cum_{16 w + 16})
  // at t >= 16 w + 16
  float* Ew = red + kThreads;

  const int n = blockIdx.x, bi = blockIdx.y, grp = blockIdx.z;
  const int h0 = grp * Gh, h1 = min(h, h0 + Gh);
  const int nc = l / L;
  const int64_t row0 = static_cast<int64_t>(bi) * l + static_cast<int64_t>(n) * L;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const ChunkMat Cm{kShared ? Cs : C + row0 * ds, kShared ? ldc : ds};
  const ChunkMat Bm{kShared ? Bs : B + row0 * ds, kShared ? ldc : ds};
  const int nts = dsp / 8, ntd = dhp / 8;

  if (kShared) {
    for (int e = threadIdx.x; e < Lp * dsp; e += kThreads) {
      const int t = e / dsp, k = e - t * dsp;
      const bool in = t < L && k < ds;
      Cs[t * ldc + k] = in ? __ldg(C + (row0 + t) * ds + k) : 0.f;
      Bs[t * ldc + k] = in ? __ldg(B + (row0 + t) * ds + k) : 0.f;
    }
  }
  __syncthreads();

  // C.B^T on the lower triangle's 16 x 16 blocks, round-robin over warps
  for (int item = warp; item < nb * (nb + 1) / 2; item += kWarps) {
    int tb = 0;
    while ((tb + 1) * (tb + 2) / 2 <= item) ++tb;
    const int sb = item - tb * (tb + 1) / 2;
    float cb[2][4] = {}, cs[2][4] = {};
    for (int k0 = 0; k0 < dsp; k0 += 8) {
      FragA fa;
      frag_rows(fa, Cm.m, Cm.ld, 16 * tb, k0, g, t4, 1.f, 1.f);
      FragB fb[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) frag_cols(fb[j], Bm.m, Bm.ld, 16 * sb + 8 * j, k0, g, t4);
#pragma unroll
      for (int part = 0; part < 3; ++part)
#pragma unroll
        for (int j = 0; j < 2; ++j) mma_part(cb[j], cs[j], fa, fb[j], part);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        CB[cb_at(16 * tb + g + 8 * (e / 2), 16 * sb + 8 * j + 2 * t4 + (e % 2))] =
            cb[j][e] + cs[j][e];
  }

  const int tr = 16 * warp;  // this warp's rows: t (dC) and s (du, dB)
  for (int i = 0, hh = h0; hh < h1; ++i, ++hh) {
    __syncthreads();  // C.B^T is formed; the last head's reads are done
    const int64_t blk = (static_cast<int64_t>(bi) * nc + n) * h + hh;
    const float* Sh = S_in + blk * dh * ds;
    const float* Gh_ = Gst + blk * dh * ds;
    const int64_t xld = static_cast<int64_t>(h) * dh;
    load_tile_async(DY, ldu, dy + (row0 * h + hh) * dh, xld, L, dh, Lp, dhp);
    load_tile_async(Ss, ldc, Sh, ds, dh, ds, dhp, dsp);
    load_tile_async(Gs, ldc, Gh_, ds, dh, ds, dhp, dsp);
    cp_async_commit();
    for (int t = threadIdx.x; t < Lp; t += kThreads)
      dw[t] = t < L ? __ldg(dt + (row0 + t) * h + hh) : 0.f;
    __syncthreads();
    if (threadIdx.x == 0) {  // cum in chunk_cum's order: the outer launches' bits
      const float a = __ldg(A + hh);
      float c = 0.f;
      for (int t = 0; t < L; ++t) {
        c += a * dw[t];
        cw[t] = c;
      }
      for (int t = L; t < Lp; ++t) cw[t] = c;
    }
    {  // u = dt x, four columns a thread where the rows allow it
      const int per_row = dhp / 4;
      const bool vec = (dh & 3) == 0;
      for (int q = threadIdx.x; q < Lp * per_row; q += kThreads) {
        const int t = q / per_row, c = 4 * (q - t * per_row);
        const float* xr = x + ((row0 + t) * h + hh) * dh + c;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (t < L && vec && c < dh) {
          v = __ldg(reinterpret_cast<const float4*>(xr));
        } else if (t < L) {
          v.x = c < dh ? __ldg(xr) : 0.f;
          v.y = c + 1 < dh ? __ldg(xr + 1) : 0.f;
          v.z = c + 2 < dh ? __ldg(xr + 2) : 0.f;
          v.w = c + 3 < dh ? __ldg(xr + 3) : 0.f;
        }
        const float w = dw[t];
        *reinterpret_cast<float4*>(U + t * ldu + c) =
            make_float4(w * v.x, w * v.y, w * v.z, w * v.w);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    const float cum_last = cw[L - 1];
    if (hh + 1 < h1) {  // the next head's operands into L2 behind this head's work
      const int nh = hh + 1;
      for (int q = threadIdx.x; q < 2 * L; q += kThreads) {
        const float* row = (q < L ? x : dy) + ((row0 + q % L) * h + nh) * dh;
        for (int c = 0; c < dh; c += 32) prefetch_l2(row + c);
      }
      const int64_t next = (blk + 1) * dh * ds;  // head nh of the same chunk
      for (int q = 32 * threadIdx.x; q < dh * ds; q += 32 * kThreads) {
        prefetch_l2(S_in + next + q);
        prefetch_l2(Gst + next + q);
      }
      for (int t = threadIdx.x; t < L; t += kThreads) prefetch_l2(dt + (row0 + t) * h + nh);
    }

    // Off a warp's diagonal blocks the decay factors about the block edge,
    // both factors at most 1: W_ts = exp(cum_t - cum_16w) exp(cum_16w -
    // cum_s) as t (s < 16 w <= t), exp(cum_t - cum_e) exp(cum_e - cum_s) as s
    // (s < e = 16 w + 16 <= t); the tables hold the s and t sides.
    float* ew = Ew + warp * Lp;
    if (warp < nb) {
      for (int q = lane; q < tr; q += 32) ew[q] = expf(cw[tr] - cw[q]);
      for (int q = tr + 16 + lane; q < Lp; q += 32) ew[q] = expf(cw[q] - cw[tr + 16]);
      __syncwarp();
    }

    if (warp < nb) {
      // ---- as t: dC's rows tr .. tr + 15 ----
      const int ta = tr + g, tb_ = tr + g + 8;  // this thread's rows
      const float ft[2] = {ta < L ? expf(cw[ta] - cw[tr]) : 0.f,
                           tb_ < L ? expf(cw[tb_] - cw[tr]) : 0.f};
      float db[NT][4] = {}, dsm[NT][4] = {};
      {  // the state part exp(cum_t) dy_t S_in^T first: y_inter's share of dcum
        const float e0 = ta < L ? expf(cw[ta]) : 0.f, e1 = tb_ < L ? expf(cw[tb_]) : 0.f;
        for (int k0 = 0; k0 < dhp; k0 += 8) {
          FragA fa;
          frag_rows(fa, DY, ldu, tr, k0, g, t4, e0, e1);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if (nt >= nts) continue;
            FragB fb;
            set_b(fb, Ss[(k0 + t4) * ldc + 8 * nt + g], Ss[(k0 + t4 + 4) * ldc + 8 * nt + g]);
#pragma unroll
            for (int part = 0; part < 3; ++part)
              mma_part(db[nt], kSplit ? dsm[nt] : db[nt], fa, fb, part);
          }
        }
      }
      float rs[2] = {0.f, 0.f}, dyy[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt >= nts) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = e < 2 ? ta : tb_, k = 8 * nt + 2 * t4 + (e % 2);
          const float c = kShared ? Cm.m[t * Cm.ld + k] : ld_in(Cm.m, Cm.ld, t, k, L, ds);
          dyy[e / 2] = fmaf(c, db[nt][e] + (kSplit ? dsm[nt][e] : 0.f), dyy[e / 2]);
        }
      }
      for (int sb = 0; sb <= warp; ++sb) {  // the blocks s <= t
        float ub[2][4] = {}, us[2][4] = {};  // dy.u^T
#pragma unroll 2  // two k-steps' loads ahead of their products
        for (int k0 = 0; k0 < dhp; k0 += 8) {
          FragA fa;
          frag_rows(fa, DY, ldu, tr, k0, g, t4, 1.f, 1.f);
          FragB fb[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) frag_cols(fb[j], U, ldu, 16 * sb + 8 * j, k0, g, t4);
#pragma unroll
          for (int part = 0; part < 3; ++part)
#pragma unroll
            for (int j = 0; j < 2; ++j) mma_part(ub[j], us[j], fa, fb[j], part);
        }
        float yv[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = e < 2 ? ta : tb_, s = 16 * sb + 8 * j + 2 * t4 + (e % 2);
            const float du = ub[j][e] + us[j][e];
            const float w = sb < warp ? ft[e / 2] * ew[s]
                            : (s <= t && t < L) ? expf(cw[t] - cw[s]) : 0.f;
            rs[e / 2] = fmaf(CB[cb_at(t, s)] * w, du, rs[e / 2]);
            yv[j][e] = w * du;
          }
#pragma unroll
        for (int j = 0; j < 2; ++j) {  // dC += Y B over this block's 16 s
          FragA fa;
          frag_acc(fa, yv[j]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if (nt >= nts) continue;
            FragB fb;
            frag_perm(fb, Bm.m, Bm.ld, 8 * nt, 16 * sb + 8 * j, g, t4);
#pragma unroll
            for (int part = 0; part < 3; ++part)
              mma_part(db[nt], kSplit ? dsm[nt] : db[nt], fa, fb, part);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float v = quad_sum(rs[r]) + quad_sum(dyy[r]);
        if (t4 == 0) dcT[r == 0 ? ta : tb_] = v;
      }
      // dC of the group: this head's share added in head order
      add_rows<NT>(dCp + grp * ds, ng * ds, row0, ta, tb_, L, ds, nts, t4, i > 0, db,
                   kSplit ? dsm : db, kSplit);
    }

    if (warp < nb) {
      // ---- as s: du's and dB's rows tr .. tr + 15 ----
      const int sa = tr + g, sb_ = tr + g + 8;
      const float e0 = sa < L ? expf(cum_last - cw[sa]) : 0.f;
      const float e1 = sb_ < L ? expf(cum_last - cw[sb_]) : 0.f;
      const bool off = warp + 1 < nb;  // blocks off the diagonal exist
      const float fs[2] = {off && sa < L ? expf(cw[tr + 16] - cw[sa]) : 0.f,
                           off && sb_ < L ? expf(cw[tr + 16] - cw[sb_]) : 0.f};
      float ub[kNTD][4] = {}, us[kNTD][4] = {};  // du
      float bb[NT][4] = {}, bs[NT][4] = {};      // dB
      // du's state part exp(cum_L - cum_s) B_s G^T first: u.du_inter
      for (int k0 = 0; k0 < dsp; k0 += 8) {
        FragA fa;
        if (kShared) {
          frag_rows(fa, Bm.m, Bm.ld, tr, k0, g, t4, e0, e1);
        } else {
          const float v[4] = {e0 * ld_in(Bm.m, Bm.ld, sa, k0 + t4, L, ds),
                              e1 * ld_in(Bm.m, Bm.ld, sb_, k0 + t4, L, ds),
                              e0 * ld_in(Bm.m, Bm.ld, sa, k0 + t4 + 4, L, ds),
                              e1 * ld_in(Bm.m, Bm.ld, sb_, k0 + t4 + 4, L, ds)};
          set_a(fa, v);
        }
#pragma unroll
        for (int nd = 0; nd < kNTD; ++nd) {
          if (nd >= ntd) continue;
          FragB fb;
          frag_cols(fb, Gs, ldc, 8 * nd, k0, g, t4);
#pragma unroll
          for (int part = 0; part < 3; ++part)
            mma_part(ub[nd], kSplit ? us[nd] : ub[nd], fa, fb, part);
        }
      }
      float ud[2] = {0.f, 0.f};
#pragma unroll
      for (int nd = 0; nd < kNTD; ++nd) {
        if (nd >= ntd) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = e < 2 ? sa : sb_, d = 8 * nd + 2 * t4 + (e % 2);
          ud[e / 2] = fmaf(U[s * ldu + d], ub[nd][e] + (kSplit ? us[nd][e] : 0.f), ud[e / 2]);
        }
      }
      // dB's state part exp(cum_L - cum_s) u_s G
      for (int k0 = 0; k0 < dhp; k0 += 8) {
        FragA fa;
        frag_rows(fa, U, ldu, tr, k0, g, t4, e0, e1);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt >= nts) continue;
          FragB fb;
          set_b(fb, Gs[(k0 + t4) * ldc + 8 * nt + g], Gs[(k0 + t4 + 4) * ldc + 8 * nt + g]);
#pragma unroll
          for (int part = 0; part < 3; ++part)
            mma_part(bb[nt], kSplit ? bs[nt] : bb[nt], fa, fb, part);
        }
      }
      float cs_[2] = {0.f, 0.f};
      for (int tb = warp; tb < nb; ++tb) {  // the blocks t >= s
        float vb[2][4] = {}, vs[2][4] = {};  // u.dy^T
#pragma unroll 2  // two k-steps' loads ahead of their products
        for (int k0 = 0; k0 < dhp; k0 += 8) {
          FragA fa;
          frag_rows(fa, U, ldu, tr, k0, g, t4, 1.f, 1.f);
          FragB fb[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) frag_cols(fb[j], DY, ldu, 16 * tb + 8 * j, k0, g, t4);
#pragma unroll
          for (int part = 0; part < 3; ++part)
#pragma unroll
            for (int j = 0; j < 2; ++j) mma_part(vb[j], vs[j], fa, fb[j], part);
        }
        float xv[2][4], yv[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int s = e < 2 ? sa : sb_, t = 16 * tb + 8 * j + 2 * t4 + (e % 2);
            const float du = vb[j][e] + vs[j][e];
            const float w = tb > warp ? (t < L ? fs[e / 2] * ew[t] : 0.f)
                            : (s <= t && t < L) ? expf(cw[t] - cw[s]) : 0.f;
            xv[j][e] = CB[cb_at(t, s)] * w;
            cs_[e / 2] = fmaf(xv[j][e], du, cs_[e / 2]);
            yv[j][e] = w * du;
          }
#pragma unroll
        for (int j = 0; j < 2; ++j) {  // du += X^T dy, dB += Y^T C over these 16 t
          FragA fx, fy;
          frag_acc(fx, xv[j]);
          frag_acc(fy, yv[j]);
#pragma unroll
          for (int nd = 0; nd < kNTD; ++nd) {
            if (nd >= ntd) continue;
            FragB fb;
            frag_perm(fb, DY, ldu, 8 * nd, 16 * tb + 8 * j, g, t4);
#pragma unroll
            for (int part = 0; part < 3; ++part)
              mma_part(ub[nd], kSplit ? us[nd] : ub[nd], fx, fb, part);
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if (nt >= nts) continue;
            FragB fb;
            frag_perm(fb, Cm.m, Cm.ld, 8 * nt, 16 * tb + 8 * j, g, t4);
#pragma unroll
            for (int part = 0; part < 3; ++part)
              mma_part(bb[nt], kSplit ? bs[nt] : bb[nt], fy, fb, part);
          }
        }
      }
      // dx = dt du and x.du
      float xd[2] = {0.f, 0.f};
#pragma unroll
      for (int nd = 0; nd < kNTD; ++nd) {
        if (nd >= ntd) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = e < 2 ? sa : sb_, d = 8 * nd + 2 * t4 + (e % 2);
          if (s < L && d < dh) {
            const float du = ub[nd][e] + (kSplit ? us[nd][e] : 0.f);
            const int64_t gi = ((row0 + s) * h + hh) * dh + d;
            xd[e / 2] = fmaf(__ldg(x + gi), du, xd[e / 2]);
            dx[gi] = dw[s] * du;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float c = quad_sum(cs_[r]), u = quad_sum(ud[r]), q = quad_sum(xd[r]);
        if (t4 == 0) {
          dcS[r == 0 ? sa : sb_] = -c - u;
          ddir[r == 0 ? sa : sb_] = q;
        }
      }
      add_rows<NT>(dBp + grp * ds, ng * ds, row0, sa, sb_, L, ds, nts, t4, i > 0, bb,
                   kSplit ? bs : bb, kSplit);
    }

    // <G_{n+1}, S_in(n+1)> at the chunk's last step (G is zero for the
    // last chunk)
    float part = 0.f;
    if (n + 1 < nc) {
      const float* Sn = S_in + (blk + h) * dh * ds;  // chunk n + 1, same head
      for (int e = threadIdx.x; e < dh * ds; e += kThreads)
        part = fmaf(__ldg(Gh_ + e), __ldg(Sn + e), part);
    }
    red[threadIdx.x] = part;
    __syncthreads();

    // The reverse cumulative sum of dcum, in double: ddt, and dA's partial.
    // Lane j owns steps [per j, per (j + 1)).
    if (warp == 0) {
      const float a = __ldg(A + hh);
      double last = 0.0;
      for (int q = lane; q < kThreads; q += 32) last += red[q];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) last += __shfl_xor_sync(0xffffffffu, last, off);
      const int per = (L + 31) / 32;
      const int lo = min(L, lane * per), hi = min(L, lo + per);
      double own = 0.0;  // this lane's steps' sum
      for (int t = lo; t < hi; ++t)
        own += static_cast<double>(dcT[t] + dcS[t]) + (t == L - 1 ? last : 0.0);
      double after = own;  // inclusive suffix over lanes: this lane's and the later ones'
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double up = __shfl_down_sync(0xffffffffu, after, off);
        if (lane + off < 32) after += up;
      }
      const double later = __shfl_down_sync(0xffffffffu, after, 1);
      double dlam = lane < 31 ? later : 0.0, da = 0.0;
      for (int t = hi - 1; t >= lo; --t) {
        dlam += static_cast<double>(dcT[t] + dcS[t]) + (t == L - 1 ? last : 0.0);
        ddt[(row0 + t) * h + hh] = fmaf(a, static_cast<float>(dlam), ddir[t]);
        da += static_cast<double>(dw[t]) * dlam;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) da += __shfl_xor_sync(0xffffffffu, da, off);
      if (lane == 0) dAp[blk] = static_cast<float>(da);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
ssd_bwd_kernel_reduce(const float* __restrict__ dBp, const float* __restrict__ dCp,
                      const float* __restrict__ dAp, float* __restrict__ dB,
                      float* __restrict__ dC, float* __restrict__ dA, int b, int nc, int h,
                      int ng, int ds, int64_t total) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e < total) {  // e = (b l) * ds + k
    const int64_t row = e / ds, k = e - row * ds;
    const float* pb = dBp + row * ng * ds + k;
    const float* pc = dCp + row * ng * ds + k;
    float sb = 0.f, sc = 0.f;
    for (int q = 0; q < ng; ++q) {
      sb += pb[static_cast<int64_t>(q) * ds];
      sc += pc[static_cast<int64_t>(q) * ds];
    }
    dB[e] = sb;
    dC[e] = sc;
  }
  if (e < h) {
    double sa = 0.0;
    for (int64_t r = 0; r < static_cast<int64_t>(b) * nc; ++r) sa += dAp[r * h + e];
    dA[e] = static_cast<float>(sa);
  }
}

template <int NT>
cudaError_t launch_chunk(dim3 grid, size_t bytes, cudaStream_t s, const float* x,
                         const float* dt, const float* A, const float* B, const float* C,
                         const float* dy, const float* S, const float* G, float* dx,
                         float* ddt, float* dBp, float* dCp, float* dAp, int l, int h, int dh,
                         int ds, int L, int Gh, int ng) {
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_kernel_chunk<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  ssd_bwd_kernel_chunk<NT><<<grid, kThreads, bytes, s>>>(x, dt, A, B, C, dy, S, G, dx, ddt,
                                                         dBp, dCp, dAp, l, h, dh, ds, L, Gh,
                                                         ng);
  return cudaGetLastError();
}

}  // namespace

// G: heads a chunk block (the wrapper's choice; 1 where ds > 64); dBp and
// dCp hold (b, l, ceil(h / G), ds) floats.
extern "C" int ssd_scan_bwd_f32(const void* x, const void* dt, const void* A,
                                const void* B, const void* C, const void* dy, void* dx,
                                void* ddt, void* dA, void* dB, void* dC, void* S, void* G,
                                void* decay, void* dBp, void* dCp, void* dAp, int b, int l,
                                int h, int dh, int ds, int chunk, int heads, void* stream) {
  const bool shared_cb = ds <= kSharedDs;
  if (chunk < 1 || chunk > kMaxL || l % chunk != 0 || dh < 1 || dh > kMaxDh || ds < 1 ||
      ds > kMaxDs || b < 1 || h < 1 || heads < 1 || heads > kMaxG ||
      (!shared_cb && (heads != 1 || chunk % 16 != 0 || ds % 8 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = l / chunk, Lp = pad16(chunk), ng = (h + heads - 1) / heads;
  const size_t o_bytes = sizeof(float) * outer_floats(Lp, dh, ds);
  const size_t c_bytes = sizeof(float) * chunk_floats(Lp, pad8(dh), pad8(ds), shared_cb);
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_kernel_outer,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(o_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Bf = static_cast<const float*>(B);
  const float* Cf = static_cast<const float*>(C);
  const float* dyf = static_cast<const float*>(dy);
  float* Sf = static_cast<float*>(S);
  float* Gf = static_cast<float*>(G);
  float* decf = static_cast<float*>(decay);
  const dim3 grid(nc, b, h);
  const int hds = dh * ds;
  const int64_t total = static_cast<int64_t>(b) * h * hds;
  const int V = hds % 4 == 0 ? 4 : 1;
  const unsigned pass_blocks =
      static_cast<unsigned>((total / V + kThreads - 1) / kThreads);
  auto pass = [&](float* state, bool backward) {
    if (V == 4)
      ssd_bwd_kernel_pass<4><<<pass_blocks, kThreads, 0, s>>>(state, decf, nc, h, hds, total,
                                                              backward);
    else
      ssd_bwd_kernel_pass<1><<<pass_blocks, kThreads, 0, s>>>(state, decf, nc, h, hds, total,
                                                              backward);
    return cudaGetLastError();
  };
  // 1-2: the states entering each chunk, recomputed on the FMA units
  ssd_bwd_kernel_outer<<<grid, kThreads, o_bytes, s>>>(dtf, Af, Bf, xf, Sf, decf, l, h, dh,
                                                        ds, chunk, true);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if ((err = pass(Sf, false)) != cudaSuccess) return static_cast<int>(err);
  // 3-4: the state adjoints, carried backward
  ssd_bwd_kernel_outer<<<grid, kThreads, o_bytes, s>>>(dtf, Af, Cf, dyf, Gf, decf, l, h, dh,
                                                        ds, chunk, false);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if ((err = pass(Gf, true)) != cudaSuccess) return static_cast<int>(err);
  // 5: the within-chunk gradients, a group of heads a block
  const dim3 cgrid(nc, b, ng);
  float* dxf = static_cast<float*>(dx);
  float* ddtf = static_cast<float*>(ddt);
  float* dBpf = static_cast<float*>(dBp);
  float* dCpf = static_cast<float*>(dCp);
  float* dApf = static_cast<float*>(dAp);
  err = shared_cb
            ? launch_chunk<kSharedDs / 8>(cgrid, c_bytes, s, xf, dtf, Af, Bf, Cf, dyf, Sf, Gf,
                                          dxf, ddtf, dBpf, dCpf, dApf, l, h, dh, ds, chunk,
                                          heads, ng)
            : launch_chunk<kMaxDs / 8>(cgrid, c_bytes, s, xf, dtf, Af, Bf, Cf, dyf, Sf, Gf,
                                       dxf, ddtf, dBpf, dCpf, dApf, l, h, dh, ds, chunk,
                                       heads, ng);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = static_cast<int64_t>(b) * l * ds;
  const int64_t cover = rows > h ? rows : h;
  ssd_bwd_kernel_reduce<<<static_cast<unsigned>((cover + kThreads - 1) / kThreads),
                          kThreads, 0, s>>>(
      static_cast<const float*>(dBp), static_cast<const float*>(dCp),
      static_cast<const float*>(dAp), static_cast<float*>(dB), static_cast<float*>(dC),
      static_cast<float*>(dA), b, nc, h, ng, ds, rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
