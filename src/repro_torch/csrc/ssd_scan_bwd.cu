// The backward of the chunked Mamba2 SSD scan, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference has no backward kernel.  It trains
// through src/repro/kernels/ssd_scan/ref.py::ssd_chunked_ref under jax.grad;
// this kernel computes that gradient on the card, so that a training step
// through ssd_scan.cu's forward never runs the plain twin.  Its plain twin is
// repro_torch/kernels/ssd_scan/ref.py::ssd_bwd_ref, which it mirrors.  Per
// batch row b and head h, chunks of L steps, cum_t = sum_{u <= t} A dt_u,
// u_s = dt_s x_s, W_ts = exp(cum_t - cum_s) for s <= t, and the state S_in
// entering each chunk (saved by the forward), against the cotangent dy:
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
// units, which this first SIMT kernel uses (the tensor-core products are
// later work).  It also writes and reads per-head partials of dB and dC
// (235 MB), and the chunk states and their adjoints (59 MB each).
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
//  5. ssd_bwd_kernel_chunk, one block per (chunk, batch row, head): the
//     within-chunk gradients as O(L^2) products on the float32 FMA units,
//     C.B^T W and W (dy.u) held in shared memory (L x L each), u and dy
//     beside them; dx and ddt of the head, its partials of dB and dC
//     (b, l, h, ds) and of dA (b, l / L, h);
//  6. ssd_bwd_kernel_reduce: dB and dC summed over the heads in order, dA
//     over batch rows and chunks in order (in double, as its partials).
//
// Blocks are 256 threads as a 16 x 16 grid; a thread owns rows ty + 16 i
// and columns tx + 16 j of each product.  Shared rows are strided by an odd
// number of floats (or 17), so the 16 rows a half-warp reads sit in 16
// banks.  L <= 128 and dh <= 64 (the wrapper checks: the LM configs' chunk
// is 128, their head dim 64); ds is walked in blocks of 64 columns.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxL = 128;   // chunk
constexpr int kMaxDh = 64;   // head dim
constexpr int kNI = kMaxL / 16;   // rows a thread owns in an L x L product
constexpr int kNJ = kMaxDh / 16;  // columns a thread owns in an L x dh product
constexpr int kKT = 16;           // the k-tile of the staged products
constexpr int kLdk = kKT + 1;

__host__ __device__ __forceinline__ int pad16(int n) { return (n + 15) / 16 * 16; }

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
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
__global__ void __launch_bounds__(kThreads)
ssd_bwd_kernel_outer(const float* __restrict__ dt, const float* __restrict__ A,
                     const float* __restrict__ mat, const float* __restrict__ vec,
                     float* __restrict__ out_all, float* __restrict__ decay, int l, int h,
                     int dh, int ds, int L, bool inc) {
  extern __shared__ float smem[];
  const int Lp = pad16(L), lde = dh | 1, ldc = ds | 1;
  float* dtv = smem;
  float* cumv = dtv + Lp;
  float* Es = cumv + Lp;       // Lp x lde: the weighted vector rows
  float* Cs = Es + Lp * lde;   // Lp x ldc: B_s or C_t
  const int n = blockIdx.x, bi = blockIdx.y, hh = blockIdx.z;
  const int nc = l / L;
  const int64_t row0 = static_cast<int64_t>(bi) * l + static_cast<int64_t>(n) * L;
  chunk_cum(dt, __ldg(A + hh), row0, h, hh, L, Lp, dtv, cumv);
  const float cum_last = cumv[L - 1];
  for (int e = threadIdx.x; e < L * dh; e += kThreads) {
    const int t = e / dh, d = e - t * dh;
    const float w = inc ? expf(cum_last - cumv[t]) * dtv[t] : expf(cumv[t]);
    Es[t * lde + d] = w * vec[((row0 + t) * h + hh) * dh + d];
  }
  for (int e = threadIdx.x; e < L * ds; e += kThreads) {
    const int t = e / ds, k = e - t * ds;
    Cs[t * ldc + k] = mat[(row0 + t) * ds + k];
  }
  __syncthreads();
  const int64_t blk = (static_cast<int64_t>(bi) * nc + n) * h + hh;
  if (threadIdx.x == 0) decay[blk] = expf(cum_last);
  float* out = out_all + blk * dh * ds;
  for (int e = threadIdx.x; e < dh * ds; e += kThreads) {
    const int d = e / ds, k = e - d * ds;
    float acc = 0.f;
    for (int t = 0; t < L; ++t) acc = fmaf(Es[t * lde + d], Cs[t * ldc + k], acc);
    out[e] = acc;
  }
}

// The chunk-to-chunk recurrence over (b, h, dh, ds), one thread per
// element, in place: forward, slot n ends holding the state entering chunk
// n (S_in(n + 1) = exp(cum_L) S_in(n) + inc_n); backward, slot n ends
// holding G_{n+1} (G_n = G_loc(n) + exp(cum_L) G_{n+1}, zero after the last
// chunk).  Either multiplies by the decay, never divides by it.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_kernel_pass(float* __restrict__ S, const float* __restrict__ decay, int nc, int h,
                    int hds, int64_t total, bool backward) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= total) return;
  const int64_t per_b = static_cast<int64_t>(h) * hds;  // one chunk of one batch row
  const int64_t bi = e / per_b;
  const int64_t rem = e - bi * per_b;
  const int hh = static_cast<int>(rem / hds);
  float* p = S + bi * nc * per_b + rem;  // chunk n at p[n * per_b]
  const float* dec = decay + bi * nc * h + hh;  // chunk n at dec[n * h]
  float g = 0.f;
  for (int i = 0; i < nc; ++i) {
    const int n = backward ? nc - 1 - i : i;
    const float cur = p[n * per_b];
    p[n * per_b] = g;
    g = fmaf(dec[n * h], g, cur);
  }
}

__global__ void __launch_bounds__(kThreads)
ssd_bwd_kernel_chunk(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const float* __restrict__ B,
                     const float* __restrict__ C, const float* __restrict__ dy,
                     const float* __restrict__ S_in, const float* __restrict__ G,
                     float* __restrict__ dx, float* __restrict__ ddt,
                     float* __restrict__ dBp, float* __restrict__ dCp,
                     float* __restrict__ dAp, int l, int h, int dh, int ds, int L) {
  extern __shared__ float smem[];
  const int Lp = pad16(L), ni = Lp / 16;
  const int ldu = dh | 1, ldm = Lp + 1;
  float* dtv = smem;
  float* cumv = dtv + Lp;
  float* dcum = cumv + Lp;
  float* ddir = dcum + Lp;     // x_s . du_s
  float* red = ddir + Lp;      // kThreads: a block reduction
  float* Us = red + kThreads;  // Lp x ldu: u_s = dt_s x_s
  float* DYs = Us + Lp * ldu;  // Lp x ldu: dy_t
  float* X = DYs + Lp * ldu;   // Lp x ldm: (C_t.B_s) W_ts
  float* Y = X + Lp * ldm;     // Lp x ldm: W_ts (dy_t.u_s)
  float* T = Y + Lp * ldm;     // 2 x Lp x kLdk: staged k-tiles; column partials

  const int n = blockIdx.x, bi = blockIdx.y, hh = blockIdx.z;
  const int nc = l / L;
  const int64_t row0 = static_cast<int64_t>(bi) * l + static_cast<int64_t>(n) * L;
  const int64_t blk = (static_cast<int64_t>(bi) * nc + n) * h + hh;
  const float* Sh = S_in + blk * dh * ds;
  const float* Gh = G + blk * dh * ds;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float a = __ldg(A + hh);

  chunk_cum(dt, a, row0, h, hh, L, Lp, dtv, cumv);
  for (int e = threadIdx.x; e < Lp * dh; e += kThreads) {
    const int t = e / dh, d = e - t * dh;
    const int64_t g = ((row0 + t) * h + hh) * dh + d;
    Us[t * ldu + d] = t < L ? dtv[t] * x[g] : 0.f;
    DYs[t * ldu + d] = t < L ? dy[g] : 0.f;
  }
  if (threadIdx.x < Lp) dcum[threadIdx.x] = 0.f;
  const float cum_last = cumv[L - 1];

  // 1. X = C.B^T * W, k-tiled through T
  float acc[kNI][4];
#pragma unroll
  for (int i = 0; i < kNI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  // a thread owns (t, s) = (ty + 16 i, tx + 16 j), j < ni: four columns per
  // pass, two passes when Lp > 64
  for (int jc = 0; jc < ni; jc += 4) {
#pragma unroll
    for (int i = 0; i < kNI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < ds; k0 += kKT) {
      __syncthreads();
      float* Ct = T;
      float* Bt = T + Lp * kLdk;
      for (int e = threadIdx.x; e < Lp * kKT; e += kThreads) {
        const int t = e / kKT, kk = e - t * kKT;
        const bool in = t < L && k0 + kk < ds;
        Ct[t * kLdk + kk] = in ? C[(row0 + t) * ds + k0 + kk] : 0.f;
        Bt[t * kLdk + kk] = in ? B[(row0 + t) * ds + k0 + kk] : 0.f;
      }
      __syncthreads();
      for (int kk = 0; kk < kKT; ++kk) {
        float bv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv[j] = jc + j < ni ? Bt[(tx + 16 * (jc + j)) * kLdk + kk] : 0.f;
#pragma unroll
        for (int i = 0; i < kNI; ++i) {
          if (i < ni) {
            const float cv = Ct[(ty + 16 * i) * kLdk + kk];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv, bv[j], acc[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kNI; ++i) {
      if (i >= ni) continue;
      const int t = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (jc + j >= ni) continue;
        const int s = tx + 16 * (jc + j);
        const float w = (s <= t && t < L) ? expf(cumv[t] - cumv[s]) : 0.f;
        X[t * ldm + s] = acc[i][j] * w;
      }
    }
  }
  __syncthreads();

  // 2. Y = W * (dy.u); R = X * (dy.u): its row sums into dcum, column sums
  //    through T
  float rows[kNI];
#pragma unroll
  for (int i = 0; i < kNI; ++i) rows[i] = 0.f;
  float* colp = T;  // 16 x Lp partial column sums
  for (int jc = 0; jc < ni; jc += 4) {
#pragma unroll
    for (int i = 0; i < kNI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float uv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) uv[j] = jc + j < ni ? Us[(tx + 16 * (jc + j)) * ldu + d] : 0.f;
#pragma unroll
      for (int i = 0; i < kNI; ++i) {
        if (i < ni) {
          const float yv = DYs[(ty + 16 * i) * ldu + d];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(yv, uv[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (jc + j >= ni) continue;
      const int s = tx + 16 * (jc + j);
      float col = 0.f;
#pragma unroll
      for (int i = 0; i < kNI; ++i) {
        if (i >= ni) continue;
        const int t = ty + 16 * i;
        const float w = (s <= t && t < L) ? expf(cumv[t] - cumv[s]) : 0.f;
        const float r = X[t * ldm + s] * acc[i][j];
        Y[t * ldm + s] = w * acc[i][j];
        rows[i] += r;
        col += r;
      }
      colp[ty * Lp + s] = col;
    }
  }
#pragma unroll
  for (int i = 0; i < kNI; ++i) {
    const float r = half_warp_sum(rows[i]);
    if (i < ni && tx == 0) dcum[ty + 16 * i] = r;
  }
  __syncthreads();
  if (threadIdx.x < Lp) {
    float col = 0.f;
    for (int q = 0; q < 16; ++q) col += colp[q * Lp + threadIdx.x];
    dcum[threadIdx.x] -= col;
  }

  // 3. du: the inter-chunk part exp(cum_L - cum_s) G B_s first (k-tiled),
  //    u.du_inter into dcum, then the intra-chunk part sum_t X_ts dy_t
  float du[kNI][kNJ];
#pragma unroll
  for (int i = 0; i < kNI; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) du[i][j] = 0.f;
  for (int k0 = 0; k0 < ds; k0 += kKT) {
    __syncthreads();
    float* Bt = T;
    float* Gt = T + Lp * kLdk;  // dh x kLdk
    for (int e = threadIdx.x; e < Lp * kKT; e += kThreads) {
      const int t = e / kKT, kk = e - t * kKT;
      Bt[t * kLdk + kk] = t < L && k0 + kk < ds ? B[(row0 + t) * ds + k0 + kk] : 0.f;
    }
    for (int e = threadIdx.x; e < dh * kKT; e += kThreads) {
      const int d = e / kKT, kk = e - d * kKT;
      Gt[d * kLdk + kk] = k0 + kk < ds ? Gh[d * ds + k0 + kk] : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < kKT; ++kk) {
      float gv[kNJ];
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const int d = tx + 16 * j;
        gv[j] = d < dh ? Gt[d * kLdk + kk] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kNI; ++i) {
        if (i < ni) {
          const float bv = Bt[(ty + 16 * i) * kLdk + kk];
#pragma unroll
          for (int j = 0; j < kNJ; ++j) du[i][j] = fmaf(bv, gv[j], du[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kNI; ++i) {
    const int s = ty + 16 * i;
    float q = 0.f;
    if (i < ni) {
      const float e = expf(cum_last - cumv[s]);
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const int d = tx + 16 * j;
        du[i][j] *= e;
        if (d < dh) q = fmaf(Us[s * ldu + d], du[i][j], q);
      }
    }
    q = half_warp_sum(q);
    if (i < ni && tx == 0 && s < L) dcum[s] -= q;
  }
  for (int t = 0; t < L; ++t) {
    float yv[kNJ];
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int d = tx + 16 * j;
      yv[j] = d < dh ? DYs[t * ldu + d] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kNI; ++i) {
      if (i < ni) {
        const float xv = X[t * ldm + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < kNJ; ++j) du[i][j] = fmaf(xv, yv[j], du[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kNI; ++i) {
    const int s = ty + 16 * i;
    float q = 0.f;
    if (i < ni && s < L) {
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const int d = tx + 16 * j;
        if (d < dh) {
          const int64_t g = ((row0 + s) * h + hh) * dh + d;
          q = fmaf(x[g], du[i][j], q);
          dx[g] = dtv[s] * du[i][j];
        }
      }
    }
    q = half_warp_sum(q);
    if (i < ni && tx == 0) ddir[s] = q;
  }

  // 4. dC_t = exp(cum_t) S_in^T dy_t + sum_s Y_ts B_s, and dy_t.y_inter_t
  //    into dcum; 5. dB_s = exp(cum_L - cum_s) G^T u_s + sum_t Y_ts C_t.
  //    Columns k in blocks of 64; B, C, S_in and G read through the cache.
  float dyy[kNI];
#pragma unroll
  for (int i = 0; i < kNI; ++i) dyy[i] = 0.f;
  for (int kc = 0; kc < ds; kc += 64) {
    float oc[kNI][4], ob[kNI][4];
#pragma unroll
    for (int i = 0; i < kNI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) oc[i][j] = ob[i][j] = 0.f;
    int kj[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) kj[j] = kc + tx + 16 * j;
    for (int d = 0; d < dh; ++d) {
      float sv[4], gv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sv[j] = kj[j] < ds ? __ldg(Sh + d * ds + kj[j]) : 0.f;
        gv[j] = kj[j] < ds ? __ldg(Gh + d * ds + kj[j]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kNI; ++i) {
        if (i < ni) {
          const float yv = DYs[(ty + 16 * i) * ldu + d];
          const float uv = Us[(ty + 16 * i) * ldu + d];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            oc[i][j] = fmaf(yv, sv[j], oc[i][j]);
            ob[i][j] = fmaf(uv, gv[j], ob[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kNI; ++i) {
      if (i >= ni) continue;
      const int t = ty + 16 * i;
      const float et = expf(cumv[t]), es = expf(cum_last - cumv[t]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        oc[i][j] *= et;
        ob[i][j] *= es;
        if (t < L && kj[j] < ds) dyy[i] = fmaf(C[(row0 + t) * ds + kj[j]], oc[i][j], dyy[i]);
      }
    }
    for (int s = 0; s < L; ++s) {
      float bv[4], cv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bv[j] = kj[j] < ds ? __ldg(B + (row0 + s) * ds + kj[j]) : 0.f;
        cv[j] = kj[j] < ds ? __ldg(C + (row0 + s) * ds + kj[j]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kNI; ++i) {
        if (i < ni) {
          const int r = ty + 16 * i;
          const float yts = Y[r * ldm + s];  // dC: t = r, summed over s
          const float yst = Y[s * ldm + r];  // dB: s = r, summed over t = s
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            oc[i][j] = fmaf(yts, bv[j], oc[i][j]);
            ob[i][j] = fmaf(yst, cv[j], ob[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kNI; ++i) {
      const int r = ty + 16 * i;
      if (i >= ni || r >= L) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (kj[j] < ds) {
          const int64_t g = ((row0 + r) * h + hh) * ds + kj[j];
          dCp[g] = oc[i][j];
          dBp[g] = ob[i][j];
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kNI; ++i) {
    const float v = half_warp_sum(dyy[i]);
    if (i < ni && tx == 0 && ty + 16 * i < L) dcum[ty + 16 * i] += v;
  }

  // 6. <G_{n+1}, S_in(n+1)> at the chunk's last step (G is zero for the
  //    last chunk)
  float part = 0.f;
  if (n + 1 < nc) {
    const float* Sn = S_in + (blk + h) * dh * ds;  // chunk n + 1, same head
    for (int e = threadIdx.x; e < dh * ds; e += kThreads)
      part = fmaf(Gh[e], Sn[e], part);
  }
  red[threadIdx.x] = part;
  __syncthreads();

  // 7. the reverse cumulative sum of dcum: ddt, and dA's partial.  One
  //    thread, in order, in double: dA sums dt * dlam over the chunk (and
  //    launch 4 over the chunks), terms far larger than their sum at the
  //    model's decays, where a float32 running sum loses ~1e-4 of it
  if (threadIdx.x == 0) {
    double last = 0.0;
    for (int q = 0; q < kThreads; ++q) last += red[q];
    dcum[L - 1] += static_cast<float>(last);
    double dlam = 0.0, da = 0.0;
    for (int t = L - 1; t >= 0; --t) {
      dlam += dcum[t];
      ddt[(row0 + t) * h + hh] = fmaf(a, static_cast<float>(dlam), ddir[t]);
      da += static_cast<double>(dtv[t]) * dlam;
    }
    dAp[blk] = static_cast<float>(da);
  }
}

__global__ void __launch_bounds__(kThreads)
ssd_bwd_kernel_reduce(const float* __restrict__ dBp, const float* __restrict__ dCp,
                      const float* __restrict__ dAp, float* __restrict__ dB,
                      float* __restrict__ dC, float* __restrict__ dA, int b, int nc, int h,
                      int ds, int64_t total) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e < total) {  // e = (b l) * ds + k
    const int64_t row = e / ds, k = e - row * ds;
    const float* pb = dBp + row * h * ds + k;
    const float* pc = dCp + row * h * ds + k;
    float sb = 0.f, sc = 0.f;
    for (int hh = 0; hh < h; ++hh) {
      sb += pb[static_cast<int64_t>(hh) * ds];
      sc += pc[static_cast<int64_t>(hh) * ds];
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

size_t outer_bytes(int L, int dh, int ds) {
  const int Lp = pad16(L);
  return sizeof(float) * (2 * Lp + Lp * (dh | 1) + Lp * (ds | 1));
}

size_t chunk_bytes(int L, int dh) {
  const int Lp = pad16(L);
  return sizeof(float) * (4 * Lp + kThreads + 2 * Lp * (dh | 1) + 2 * Lp * (Lp + 1) +
                          2 * Lp * kLdk);
}

}  // namespace

extern "C" int ssd_scan_bwd_f32(const void* x, const void* dt, const void* A,
                                const void* B, const void* C, const void* dy, void* dx,
                                void* ddt, void* dA, void* dB, void* dC, void* S, void* G,
                                void* decay, void* dBp, void* dCp, void* dAp, int b, int l,
                                int h, int dh, int ds, int chunk, void* stream) {
  if (chunk < 1 || chunk > kMaxL || l % chunk != 0 || dh < 1 || dh > kMaxDh || ds < 1 ||
      b < 1 || h < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = l / chunk;
  const size_t o_bytes = outer_bytes(chunk, dh, ds), c_bytes = chunk_bytes(chunk, dh);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(ssd_bwd_kernel_outer,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(o_bytes))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_bwd_kernel_chunk,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(c_bytes))) != cudaSuccess)
    return static_cast<int>(err);
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
  const unsigned pass_blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  // 1-2: the states entering each chunk, recomputed on the FMA units
  ssd_bwd_kernel_outer<<<grid, kThreads, o_bytes, s>>>(dtf, Af, Bf, xf, Sf, decf, l, h, dh,
                                                        ds, chunk, true);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_kernel_pass<<<pass_blocks, kThreads, 0, s>>>(Sf, decf, nc, h, hds, total, false);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // 3-4: the state adjoints, carried backward
  ssd_bwd_kernel_outer<<<grid, kThreads, o_bytes, s>>>(dtf, Af, Cf, dyf, Gf, decf, l, h, dh,
                                                        ds, chunk, false);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_kernel_pass<<<pass_blocks, kThreads, 0, s>>>(Gf, decf, nc, h, hds, total, true);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_kernel_chunk<<<grid, kThreads, c_bytes, s>>>(
      xf, dtf, Af, Bf, Cf, dyf, Sf, Gf, static_cast<float*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(dBp), static_cast<float*>(dCp), static_cast<float*>(dAp), l, h,
      dh, ds, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = static_cast<int64_t>(b) * l * ds;
  const int64_t cover = rows > h ? rows : h;
  ssd_bwd_kernel_reduce<<<static_cast<unsigned>((cover + kThreads - 1) / kThreads),
                          kThreads, 0, s>>>(
      static_cast<const float*>(dBp), static_cast<const float*>(dCp),
      static_cast<const float*>(dAp), static_cast<float*>(dB), static_cast<float*>(dC),
      static_cast<float*>(dA), b, nc, h, ds, rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
