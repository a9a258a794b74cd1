// The backward of causal or bidirectional GQA attention, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference has no backward kernel.  It trains
// through src/repro/kernels/flash_attention/ref.py::attention_ref under
// jax.grad; this kernel computes that gradient on the card, so that a
// training step through flash_attention.cu's forward never runs the plain
// twin.  Its plain twin is repro_torch/kernels/flash_attention/ref.py::
// attention_bwd_ref, which it mirrors:
//
//     P  = softmax(sm_scale q k^T (+ causal mask))      (recomputed, float32)
//     dV = P^T dO,   dP = dO V^T,   dS = P * (dP - rowsum(dO * O))
//     dQ = sm_scale dS K,   dK = sm_scale dS^T Q
//
// with dK and dV summed over each KV head's group of query heads.  q, out and
// dout are (b, hq, sq, d), k and v (b, hkv, sk, d), contiguous, float32 or
// bf16; dq, dk and dv are written in the inputs' type.  Causal attention
// needs sq == sk (the wrapper checks).
//
// Bound: operations.  The backward does 2.5x the forward's products
// (dV, dP, dQ, dK and one recomputation of S against the forward's S and
// PV): at zamba2-7b's shape (b 2, 32 heads, s 2048, d 112, causal) 1.5e11
// flop, 152 us on the bf16 tensor cores against ~470 MB of bytes (~140 us).
//
// Two routes, chosen by the Python wrapper from the dtype and d alone (as
// the forward's): every sum runs in a fixed order, with no float atomics,
// so two runs give the same bits.
//
// 1. wgmma (bf16, d % 8 == 0, d <= 128), three launches built on the
//    forward's wgmma skeleton: one producer warp feeds TMA tiles (128-byte
//    swizzle, mbarrier completion) into a ring of two stages, two consumer
//    warpgroups run every product on wgmma with float32 sums; setmaxnreg
//    moves registers from the producer's warpgroup (40) to the consumers
//    (232).  d pads to 128 by TMA's zero fill (128/112 of the work at
//    d = 112); rows past sk are zero-filled and masked, rows past sq carry
//    lse = +inf, so their P is 0.
//  * flash_attention_bwd_stats_wgmma, one block per (128-row q tile, b *
//    hq): S = Q K^T on wgmma over 128-key tiles, the row max and sum of
//    2^(S sm_scale log2 e) online, written as lse in base 2; and D =
//    rowsum(dO * O) of its rows.  (The forward's y stays as it is: moving
//    the statistics onto the tensor cores costs one of the eleven products
//    below and keeps the forward's routes and entry points untouched.)
//  * flash_attention_bwd_dkdv_wgmma, one block per (b * hq, 128-key
//    tile): K and V of the query head's KV head stay in shared memory while
//    the block walks the 64-row q tiles the causal mask leaves, Q, dO, lse
//    and D arriving through the ring.  Each
//    consumer owns 64 keys: S^T = K Q^T and dP^T = V dO^T are m64n64
//    products of exact bf16 operands; P = 2^(S^T sm_scale log2 e - lse) and
//    dS = P (dP - D) in registers; dV += P^T dO and dK += dS^T Q take P and
//    dS from registers as bf16 hi + lo, two m64n128 passes each (one bf16
//    rounding of P and dS, as FlashAttention's, misses the elementwise bf16
//    gate against the float32 twin ~37x: tests/test_torch_lm_bwd_split.py).
//    The dK and dV accumulators are 2 x 64 float32 registers a thread,
//    S^T and dP^T 2 x 32, then P's and dS's split operands 2 x 32.  The
//    tensor cores add each k-step into the accumulator rounding toward
//    zero, so a sum over a whole GQA group's query heads in one accumulator
//    (8 x 2048 rows at qwen3-moe-30b-a3b's group of 8) drifts by ~1e-4 of
//    its largest terms.  So a block takes one query head: (b * hq, key
//    tile); with more than one query head a KV head, its dK and dV go to
//    float32 partials (`part`) and flash_attention_bwd_group_sum adds a
//    group's partials in head order, to nearest, into the bf16 gradients.
//  * flash_attention_bwd_dq_wgmma, one block per (b * hq, 128-row q tile):
//    Q and dO stay in shared memory while the block walks the 64-key K/V
//    tiles the mask leaves; per consumer S and dP (m64n64), dS, and dQ +=
//    dS K in two passes (hi + lo); dQ is 64 registers a thread.
//  Work: 11 products of the forward's size (S three times, dP twice, dV,
//  dK, dQ two passes each), 4.4x the bound's 2.5, at 128/112 of it for the
//  padded head dim.  The grids put the longest causal walks first.
//
// 2. SIMT (float32, and bf16 with another d): three launches on the float32
//    FMA units, FlashAttention-2's backward without atomics; it recomputes
//    S three times and dP twice, 8 of the forward's products' worth:
//  * flash_attention_bwd_stats: one block per (64-row q tile, b * hq): the
//    row log-sum-exp of the scaled, masked scores (an online max and sum
//    over 64-key tiles) and D = rowsum(dO * O), into float32 scratch;
//  * flash_attention_bwd_dkdv: one block per (64-key tile, b * hkv): K and
//    V of the tile stay in shared memory while the block walks the KV
//    head's query heads in order and, for each, the q tiles the causal
//    mask leaves; per q tile it forms P and dS in shared memory and adds
//    P^T dO and dS^T Q into per-thread float32 accumulators;
//  * flash_attention_bwd_dq: one block per (64-row q tile, b * hq): Q and
//    dO stay in shared memory while the block walks the key tiles the
//    mask leaves, adding dS K into per-thread accumulators.
//  Each block is 256 threads as a 16 x 16 grid; a thread owns rows ty + 16 i
//  and columns tx + 16 j of every 64 x 64 tile, and rows ty + 16 i by
//  head-dim columns 8 tx .. 8 tx + 7 (d <= 128) of the accumulated
//  gradient.  Tiles of q, k, v and dO are held in float32, rows padded with
//  zeros to 8 columns and strided an odd number of 16-byte groups, and read
//  four or eight columns a load (float4).  exp is taken only of unmasked
//  scores (a masked P is 0 before exp is reached).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// Route 2: the float32 FMA units (float32, and bf16 with another d).

constexpr int kThreads = 256;
constexpr int kTile = 64;     // q rows and keys per tile
constexpr int kMaxD = 128;    // the largest head dim (MAX_HEAD_DIM in the wrapper)
constexpr int kCols = 8;           // head-dim columns a thread owns: 8 tx .. 8 tx + 7
constexpr int kPd = kTile + 1;     // row stride of the P and dS tiles

// Row stride of the q, k, v and dO tiles: d padded to 8 columns (zeros past
// d, so 8-column and 4-column reads never leave a row) plus 4, so that rows
// are 16-byte aligned and an odd number of 16-byte groups apart: the 16
// rows a half-warp reads as float4 fall in distinct bank groups.
__host__ __device__ __forceinline__ int row_stride(int d) { return (d + 7) / 8 * 8 + 4; }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// rows [r0, r0 + kTile) of a (rows, d) matrix into dst (kTile x ld floats),
// zero past `rows` and, to 8 columns, past d.
template <typename T>
__device__ void load_tile(float* dst, int ld, const T* __restrict__ src, int r0,
                          int rows, int d) {
  const int dp = (d + 7) / 8 * 8;
  for (int idx = threadIdx.x; idx < kTile * dp; idx += kThreads) {
    const int r = idx / dp, c = idx - r * dp;
    dst[r * ld + c] = r0 + r < rows && c < d
                          ? to_float(src[static_cast<int64_t>(r0 + r) * d + c]) : 0.f;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ void fma4(float acc[4][4], const float4 a[4], const float4 b[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
      acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
      acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
      acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
    }
}

// acc[i][j] = A[ty + 16 i] . B[tx + 16 j] over d columns (A, B: kTile x ld),
// four columns a load
__device__ __forceinline__ void tile_dot(const float* A, const float* B, int ld, int d,
                                         int ty, int tx, float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int c = 0; c < d; c += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = ld4(A + (ty + 16 * i) * ld + c);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = ld4(B + (tx + 16 * j) * ld + c);
    fma4(acc, a, b);
  }
}

// the two score-side products of a (q tile, key tile): S = Q K^T and
// dP = dO V^T
__device__ __forceinline__ void tile_dot2(const float* Q, const float* K, const float* dO,
                                          const float* V, int ld, int d, int ty, int tx,
                                          float s[4][4], float dp[4][4]) {
  tile_dot(Q, K, ld, d, ty, tx, s);
  tile_dot(dO, V, ld, d, ty, tx, dp);
}

// acc[i][0..8) += w[i] * row[8 tx .. 8 tx + 8), the row a 16-byte aligned
// float pointer
__device__ __forceinline__ void axpy8(float acc[4][kCols], const float w[4], const float* row) {
  const float4 lo = ld4(row), hi = ld4(row + 4);
  const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(w[i], v[j], acc[i][j]);
}

__device__ __forceinline__ bool unmasked(int q, int k, int sk, bool causal) {
  return k < sk && (!causal || k <= q);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_stats(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ out, const T* __restrict__ dout,
                          float* __restrict__ lse, float* __restrict__ delta, int hq,
                          int hkv, int sq, int sk, int d, float scale, bool causal) {
  extern __shared__ __align__(16) float smem[];
  const int ld = row_stride(d);
  float* Qs = smem;
  float* Ks = Qs + kTile * ld;
  const int bh = blockIdx.y, bi = bh / hq, hh = bh - bi * hq;
  const int kvh = hh / (hq / hkv);
  const int q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* qh = q + static_cast<int64_t>(bh) * sq * d;
  const T* kh = k + (static_cast<int64_t>(bi) * hkv + kvh) * sk * d;

  load_tile(Qs, ld, qh, q0, sq, d);
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  const int kend = causal ? min(sk, q0 + kTile) : sk;
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    __syncthreads();  // the last tile's reads of Ks are done
    load_tile(Ks, ld, kh, k0, sk, d);
    __syncthreads();
    float acc[4][4];
    tile_dot(Qs, Ks, ld, d, ty, tx, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = unmasked(qr, k0 + tx + 16 * j, sk, causal) ? acc[i][j] * scale
                                                              : -INFINITY;
        mx = fmaxf(mx, acc[i][j]);
      }
      // every lane of the warp takes part in both shuffles, whichever rows
      // have no key yet (m_new == -inf)
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (acc[i][j] != -INFINITY) sum += expf(acc[i][j] - m_new);
      sum = half_warp_sum(sum);
      if (m_new != -INFINITY) {
        l[i] = l[i] * expf(m[i] - m_new) + sum;
        m[i] = m_new;
      }
    }
  }
  const T* oh = out + static_cast<int64_t>(bh) * sq * d;
  const T* doh = dout + static_cast<int64_t>(bh) * sq * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty + 16 * i;
    float dsum = 0.f;
    if (qr < sq)
      for (int c = tx; c < d; c += 16) {
        const int64_t e = static_cast<int64_t>(qr) * d + c;
        dsum = fmaf(to_float(doh[e]), to_float(oh[e]), dsum);
      }
    dsum = half_warp_sum(dsum);
    if (tx == 0 && qr < sq) {
      const int64_t row = static_cast<int64_t>(bh) * sq + qr;
      lse[row] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;  // no key: every P is 0
      delta[row] = dsum;
    }
  }
}

// P and dS of one (q tile, key tile) into Ps and dSs (q rows x keys)
__device__ __forceinline__ void p_and_ds(const float* Qs, const float* Ks, const float* dOs,
                                         const float* Vs, const float* lse_s,
                                         const float* delta_s, float* Ps, float* dSs,
                                         int ld, int d, int q0, int k0, int sq, int sk,
                                         float scale, bool causal, int ty, int tx) {
  float s[4][4], dp[4][4];
  tile_dot2(Qs, Ks, dOs, Vs, ld, d, ty, tx, s, dp);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const bool keep = q0 + r < sq && unmasked(q0 + r, k0 + c, sk, causal);
      const float p = keep ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
      if (Ps != nullptr) Ps[r * kPd + c] = p;
      dSs[r * kPd + c] = p * (dp[i][j] - delta_s[r]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int hq, int hkv,
                         int sq, int sk, int d, float scale, bool causal) {
  extern __shared__ __align__(16) float smem[];
  const int ld = row_stride(d);
  float* Ks = smem;
  float* Vs = Ks + kTile * ld;
  float* Qs = Vs + kTile * ld;
  float* dOs = Qs + kTile * ld;
  float* Ps = dOs + kTile * ld;
  float* dSs = Ps + kTile * kPd;
  float* lse_s = dSs + kTile * kPd;
  float* delta_s = lse_s + kTile;
  const int bk = blockIdx.y, bi = bk / hkv, kvh = bk - bi * hkv;
  const int group = hq / hkv;
  const int k0 = blockIdx.x * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15, c0 = 8 * tx;
  const int64_t kv_off = static_cast<int64_t>(bk) * sk * d;

  load_tile(Ks, ld, k + kv_off, k0, sk, d);
  load_tile(Vs, ld, v + kv_off, k0, sk, d);
  float dk_acc[4][kCols], dv_acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int qstart = causal ? k0 : 0;  // q tiles above the key tile see none of it
  for (int g = 0; g < group; ++g) {
    const int64_t bh = static_cast<int64_t>(bi) * hq + kvh * group + g;
    const T* qh = q + bh * sq * d;
    const T* doh = dout + bh * sq * d;
    for (int q0 = qstart; q0 < sq; q0 += kTile) {
      __syncthreads();  // the last tile's reads are done
      load_tile(Qs, ld, qh, q0, sq, d);
      load_tile(dOs, ld, doh, q0, sq, d);
      if (threadIdx.x < kTile) {
        const int r = q0 + threadIdx.x;
        lse_s[threadIdx.x] = r < sq ? lse[bh * sq + r] : INFINITY;
        delta_s[threadIdx.x] = r < sq ? delta[bh * sq + r] : 0.f;
      }
      __syncthreads();
      p_and_ds(Qs, Ks, dOs, Vs, lse_s, delta_s, Ps, dSs, ld, d, q0, k0, sq, sk, scale,
               causal, ty, tx);
      __syncthreads();
      const int rows = min(kTile, sq - q0);
      if (c0 < d) {
        for (int r = 0; r < rows; ++r) {
          float p[4], ds[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            p[i] = Ps[r * kPd + ty + 16 * i];
            ds[i] = dSs[r * kPd + ty + 16 * i];
          }
          axpy8(dv_acc, p, dOs + r * ld + c0);
          axpy8(dk_acc, ds, Qs + r * ld + c0);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty + 16 * i;
    if (kr >= sk) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = c0 + j;
      if (c < d) {
        const int64_t e = kv_off + static_cast<int64_t>(kr) * d + c;
        dk[e] = from_float<T>(dk_acc[i][j] * scale);
        dv[e] = from_float<T>(dv_acc[i][j]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       T* __restrict__ dq, int hq, int hkv, int sq, int sk, int d,
                       float scale, bool causal) {
  extern __shared__ __align__(16) float smem[];
  const int ld = row_stride(d);
  float* Qs = smem;
  float* dOs = Qs + kTile * ld;
  float* Ks = dOs + kTile * ld;
  float* Vs = Ks + kTile * ld;
  float* dSs = Vs + kTile * ld;
  float* lse_s = dSs + kTile * kPd;
  float* delta_s = lse_s + kTile;
  const int bh = blockIdx.y, bi = bh / hq, hh = bh - bi * hq;
  const int kvh = hh / (hq / hkv);
  const int q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15, c0 = 8 * tx;
  const int64_t q_off = static_cast<int64_t>(bh) * sq * d;
  const int64_t kv_off = (static_cast<int64_t>(bi) * hkv + kvh) * sk * d;

  load_tile(Qs, ld, q + q_off, q0, sq, d);
  load_tile(dOs, ld, dout + q_off, q0, sq, d);
  if (threadIdx.x < kTile) {
    const int r = q0 + threadIdx.x;
    lse_s[threadIdx.x] = r < sq ? lse[static_cast<int64_t>(bh) * sq + r] : INFINITY;
    delta_s[threadIdx.x] = r < sq ? delta[static_cast<int64_t>(bh) * sq + r] : 0.f;
  }
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  const int kend = causal ? min(sk, q0 + kTile) : sk;
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    __syncthreads();  // the last tile's reads are done
    load_tile(Ks, ld, k + kv_off, k0, sk, d);
    load_tile(Vs, ld, v + kv_off, k0, sk, d);
    __syncthreads();
    p_and_ds(Qs, Ks, dOs, Vs, lse_s, delta_s, nullptr, dSs, ld, d, q0, k0, sq, sk,
             scale, causal, ty, tx);
    __syncthreads();
    const int keys = min(kTile, sk - k0);
    if (c0 < d) {
      for (int c2 = 0; c2 < keys; ++c2) {
        float ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty + 16 * i) * kPd + c2];
        axpy8(acc, ds, Ks + c2 * ld + c0);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= sq) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = c0 + j;
      if (c < d) dq[q_off + static_cast<int64_t>(qr) * d + c] = from_float<T>(acc[i][j] * scale);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           void* dq, void* dk, void* dv, void* lse, void* delta, int b, int hq, int hkv,
           int sq, int sk, int d, double sm_scale, int causal, void* stream) {
  if (b < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || sk < 1 || d < 1 || d > kMaxD ||
      (causal && sq != sk))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ld = row_stride(d);
  const size_t stats_bytes = sizeof(float) * 2 * kTile * ld;
  const size_t dkdv_bytes = sizeof(float) * (4 * kTile * ld + 2 * kTile * kPd + 2 * kTile);
  const size_t dq_bytes = sizeof(float) * (4 * kTile * ld + kTile * kPd + 2 * kTile);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(flash_attention_bwd_stats<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(stats_bytes))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(flash_attention_bwd_dkdv<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(dkdv_bytes))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(flash_attention_bwd_dq<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(dq_bytes))) != cudaSuccess)
    return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = static_cast<float>(sm_scale);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  float* lsef = static_cast<float*>(lse);
  float* deltaf = static_cast<float*>(delta);
  const unsigned q_tiles = (sq + kTile - 1) / kTile, k_tiles = (sk + kTile - 1) / kTile;
  flash_attention_bwd_stats<T><<<dim3(q_tiles, b * hq), kThreads, stats_bytes, s>>>(
      qt, kt, static_cast<const T*>(out), dot, lsef, deltaf, hq, hkv, sq, sk, d, scale,
      causal != 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  flash_attention_bwd_dkdv<T><<<dim3(k_tiles, b * hkv), kThreads, dkdv_bytes, s>>>(
      qt, kt, vt, dot, lsef, deltaf, static_cast<T*>(dk), static_cast<T*>(dv), hq, hkv,
      sq, sk, d, scale, causal != 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  flash_attention_bwd_dq<T><<<dim3(q_tiles, b * hq), kThreads, dq_bytes, s>>>(
      qt, kt, vt, dot, lsef, deltaf, static_cast<T*>(dq), hq, hkv, sq, sk, d, scale,
      causal != 0);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Route 1: wgmma on TMA-fed tiles (bf16, d % 8 == 0, d <= 128).

constexpr int kBwThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kBwOwn = 128;      // a block's own rows: keys (dkdv), q rows (stats, dq)
constexpr int kBwTile = 64;      // streamed rows: q rows (dkdv), keys (dq)
constexpr int kBwStages = 2;     // ring depth
constexpr int kBwAtoms = kMaxD / kAtomCols;               // head dim padded to 128
constexpr int kOwnBytes = kBwAtoms * kBwOwn * 128;        // one own tile
constexpr int kStreamBytes = kBwAtoms * kBwTile * 128;    // one streamed tile
constexpr int kStageBytes = 2 * kStreamBytes;  // Q and dO, K and V, or a 128-key K
constexpr int kRowStatBytes = kBwTile * 4;     // lse or D of a streamed q tile
constexpr int kOffStage = 2 * kOwnBytes;
constexpr int kOffStat = kOffStage + kBwStages * kStageBytes;
constexpr int kOffBwBar = kOffStat + kBwStages * 2 * kRowStatBytes;
constexpr int kBwNumBars = 1 + 2 * kBwStages;  // own tiles full; full, empty per stage
// + 1024: the tiles start on a 1024-byte boundary (the swizzle's period);
// mirrored by bwd_wgmma_smem_bytes in kernels/flash_attention/flash_attention.py
constexpr int kBwSmemBytes = kOffBwBar + 8 * kBwNumBars + 1024;

// The ring's shared memory: own tiles at +0 and +kOwnBytes, stage s's two
// tiles at stage(s) and stage(s) + kStreamBytes, its lse and D at stat(s).
struct BwSmem {
  uint32_t base;   // shared-window address, 1024-aligned
  uint8_t* gbase;  // the same bytes through a generic pointer
  __device__ __forceinline__ uint32_t stage(int s) const {
    return base + kOffStage + s * kStageBytes;
  }
  __device__ __forceinline__ uint32_t stat(int s) const {
    return base + kOffStat + s * 2 * kRowStatBytes;
  }
  __device__ __forceinline__ const float* stat_ptr(int s) const {
    return reinterpret_cast<const float*>(gbase + kOffStat + s * 2 * kRowStatBytes);
  }
  __device__ __forceinline__ uint32_t own_full() const { return base + kOffBwBar; }
  __device__ __forceinline__ uint32_t full(int s) const { return own_full() + 8 + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return own_full() + 8 + 8 * kBwStages + 8 * s;
  }
};

__device__ __forceinline__ BwSmem bw_smem_init(uint8_t* raw) {
  BwSmem m;
  m.base = (smem_u32(raw) + 1023) & ~1023u;
  m.gbase = raw + (m.base - smem_u32(raw));
  if (threadIdx.x == 0) {
    mbar_init(m.own_full(), 1);
    for (int s = 0; s < kBwStages; ++s) {
      mbar_init(m.full(s), 1);
      mbar_init(m.empty(s), 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return m;
}

// Rows [row, row + rows) of one head, both 64-column atoms, into dst.
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int rows, int row, int bh) {
#pragma unroll
  for (int a = 0; a < kBwAtoms; ++a)
    tma_load(dst + a * rows * 128, map, bar, a * kAtomCols, row, bh);
}

// Descriptor of k-step `step` (16 head-dim columns) of rows [r0, r0 + 64)
// of a K-major tile of `rows` rows.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int r0, int step) {
  return sw128_desc(tile + (step / 4) * rows * 128 + r0 * 128 + (step % 4) * 32, 16, 1024);
}

// d = A B^T over the padded head dim: A rows [ra, ra + 64) of a tile of
// a_rows rows, B every row of a tile as many rows as d is wide (64 for
// 32 accumulators a thread, 128 for 64), both K-major.
template <int N>
__device__ __forceinline__ void product_nt(float (&d)[N], uint32_t a, int a_rows, int ra,
                                           uint32_t b) {
  constexpr int b_rows = 2 * N;
#pragma unroll
  for (int step = 0; step < kBwAtoms * kAtomCols / 16; ++step)
    wgmma_ss(d, kmajor(a, a_rows, ra, step), kmajor(b, b_rows, 0, step), step > 0);
}

// d += X B: X (64 x 64) from registers as four k-steps, B a streamed tile of
// 64 rows read MN-major (its rows are the sum's index, its head dim d's
// columns).
__device__ __forceinline__ void product_rs(float (&d)[64], const uint32_t (&x)[4][4],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kBwTile / 16; ++kk)
    wgmma_rs(d, x[kk], sw128_desc(b + kk * 16 * 128, kBwTile * 128, 1024));
}

// A 64 x 64 accumulator as the A operands of four k-steps, split into bf16
// hi + lo.
__device__ __forceinline__ void to_operands(const float (&x)[32], uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; e += 2)
      split_bf16(x[4 * j + e], x[4 * j + e + 1], hi[j / 2][(j % 2) * 2 + e / 2],
                 lo[j / 2][(j % 2) * 2 + e / 2]);
}

__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[64], float f,
                                           int row0, int rows, int d) {
  const int lane = threadIdx.x % 32;
  const int r0 = row0 + 16 * ((threadIdx.x % 128) / 32) + lane / 4, c0 = 2 * (lane % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= rows) continue;
    __nv_bfloat16* orow = out + static_cast<int64_t>(row) * d;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + c0;
      if (col < d)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(f * acc[4 * j + 2 * r], f * acc[4 * j + 2 * r + 1]);
    }
  }
}

__global__ void __launch_bounds__(kBwThreads, 1)
flash_attention_bwd_stats_wgmma(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __nv_bfloat16* __restrict__ out,
                                const __nv_bfloat16* __restrict__ dout,
                                float* __restrict__ lse, float* __restrict__ delta, int hq,
                                int hkv, int sq, int sk, int d, int sq_pad, float scale_log2,
                                int causal) {
  extern __shared__ uint8_t smem_raw[];
  const BwSmem sm = bw_smem_init(smem_raw);
  const int bh = blockIdx.x;
  const int kv_bh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBwOwn;
  const int kv_end = causal ? min(sk, q0 + kBwOwn) : sk;
  const int n_tiles = (kv_end + kBwOwn - 1) / kBwOwn;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(sm.own_full(), kOwnBytes);
      tma_tile(sm.base, &tm_q, sm.own_full(), kBwOwn, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kBwStages;
        if (t >= kBwStages) mbar_wait(sm.empty(s), ((t / kBwStages) - 1) & 1);
        mbar_expect_tx(sm.full(s), kStageBytes);
        tma_tile(sm.stage(s), &tm_k, sm.full(s), kBwOwn, t * kBwOwn, kv_bh);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wg - 1, tid = threadIdx.x % 128, lane = tid % 32;
  const int r0 = q0 + 64 * cw + 16 * (tid / 32) + lane / 4, c0 = 2 * (lane % 4);
  {  // D = rowsum(dO * O), two threads a row
    const int row = q0 + 64 * cw + tid / 2, half = tid % 2;
    float sum = 0.f;
    if (row < sq) {
      const int64_t off = (static_cast<int64_t>(bh) * sq + row) * d;
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(out + off);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(dout + off);
      for (int p = half; p < d / 2; p += 2) {
        const float2 o = __bfloat1622float2(o2[p]), g = __bfloat1622float2(g2[p]);
        sum = fmaf(g.x, o.x, sum);
        sum = fmaf(g.y, o.y, sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) delta[static_cast<int64_t>(bh) * sq_pad + row] = sum;
  }
  float acc[64];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  mbar_wait(sm.own_full(), 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kBwStages;
    mbar_wait(sm.full(s), (t / kBwStages) & 1);
    wgmma_fence();
    fence_acc(acc);
    product_nt(acc, sm.base, kBwOwn, 64 * cw, sm.stage(s));
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(acc);
    if (tid == 0) mbar_arrive(sm.empty(s));
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] *= scale_log2;
    if (t == n_tiles - 1) {  // only the last tile holds masked keys
      const int k0 = t * kBwOwn;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + 8 * (e / 2), col = k0 + 8 * j + c0 + (e % 2);
          if (col >= sk || (causal && col > row)) acc[4 * j + e] = -INFINITY;
        }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], acc[4 * j + e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float shift = mx[r] == -INFINITY ? 0.f : mx[r];  // a row with no key yet
      l[r] *= exp2_ftz(m[r] - shift);
      m[r] = mx[r];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        l[r] += exp2_ftz(acc[4 * j + 2 * r] - shift) + exp2_ftz(acc[4 * j + 2 * r + 1] - shift);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = r0 + 8 * r;
    // rows past sq and rows with no key: every P is 0
    if (lane % 4 == 0)
      lse[static_cast<int64_t>(bh) * sq_pad + row] =
          row < sq && l[r] > 0.f ? m[r] + log2f(l[r]) : INFINITY;
  }
}

// acc's rows [row0, ...) into a (rows, d) float32 matrix, in store_rows'
// layout.
__device__ __forceinline__ void store_rows_f32(float* out, const float (&acc)[64], int row0,
                                               int rows, int d) {
  const int lane = threadIdx.x % 32;
  const int r0 = row0 + 16 * ((threadIdx.x % 128) / 32) + lane / 4, c0 = 2 * (lane % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= rows) continue;
    float* orow = out + static_cast<int64_t>(row) * d;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + c0;
      if (col < d)
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

__global__ void __launch_bounds__(kBwThreads, 1)
flash_attention_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_do,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                               float* __restrict__ part, int hq, int hkv, int sq, int sk,
                               int d, int sq_pad, float scale, float scale_log2, int causal) {
  extern __shared__ uint8_t smem_raw[];
  const BwSmem sm = bw_smem_init(smem_raw);
  const int bh = blockIdx.x, bi = bh / hq, group = hq / hkv;
  const int bk = bi * hkv + (bh - bi * hq) / group;  // the query head's KV head
  const int k0 = blockIdx.y * kBwOwn;
  const int qt0 = causal ? k0 / kBwTile : 0;  // q tiles above the key tile see none of it
  const int n_items = (sq + kBwTile - 1) / kBwTile - qt0;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(sm.own_full(), 2 * kOwnBytes);
      tma_tile(sm.base, &tm_k, sm.own_full(), kBwOwn, k0, bk);
      tma_tile(sm.base + kOwnBytes, &tm_v, sm.own_full(), kBwOwn, k0, bk);
      for (int it = 0; it < n_items; ++it) {
        const int s = it % kBwStages;
        const int q0 = (qt0 + it) * kBwTile;
        if (it >= kBwStages) mbar_wait(sm.empty(s), ((it / kBwStages) - 1) & 1);
        mbar_expect_tx(sm.full(s), kStageBytes + 2 * kRowStatBytes);
        tma_tile(sm.stage(s), &tm_q, sm.full(s), kBwTile, q0, bh);
        tma_tile(sm.stage(s) + kStreamBytes, &tm_do, sm.full(s), kBwTile, q0, bh);
        const int64_t row = static_cast<int64_t>(bh) * sq_pad + q0;
        bulk_load(sm.stat(s), lse + row, kRowStatBytes, sm.full(s));
        bulk_load(sm.stat(s) + kRowStatBytes, delta + row, kRowStatBytes, sm.full(s));
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wg - 1, tid = threadIdx.x % 128, lane = tid % 32;
  const int kc = k0 + 64 * cw;  // this consumer's keys kc .. kc + 63
  const int kr0 = kc + 16 * (tid / 32) + lane / 4, c0 = 2 * (lane % 4);
  // keys past sk, or past a q tile's row under the causal mask
  const bool ragged = kc + 64 > sk;
  float dk_acc[64], dv_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  mbar_wait(sm.own_full(), 0);
  for (int it = 0; it < n_items; ++it) {
    const int s = it % kBwStages;
    const int q0 = (qt0 + it) * kBwTile;
    mbar_wait(sm.full(s), (it / kBwStages) & 1);
    if (!(causal && q0 + kBwTile <= kc)) {  // else every key is past every row
      const uint32_t qs = sm.stage(s), dos = qs + kStreamBytes;
      float st[32], dpt[32];
      wgmma_fence();
      fence_acc(st);
      fence_acc(dpt);
      product_nt(st, sm.base, kBwOwn, 64 * cw, qs);                // S^T = K Q^T
      product_nt(dpt, sm.base + kOwnBytes, kBwOwn, 64 * cw, dos);  // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(st);
      fence_acc(dpt);
      const float* lse_s = sm.stat_ptr(s);
      const float* delta_s = lse_s + kBwTile;
      const bool mask = ragged || (causal && q0 < kc + 63);
      // P and dS straight into their split operands, two columns of lse and
      // D at a time (the operands are written before the fence: wgmma
      // reads them asynchronously until the wait)
      uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * j + c0);
        const float2 d2 = *reinterpret_cast<const float2*>(delta_s + 8 * j + c0);
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * j + c0 + (e % 2), kr = kr0 + 8 * (e / 2);
          p[e] = exp2_ftz(st[4 * j + e] * scale_log2 - (e % 2 ? l2.y : l2.x));
          if (mask && (kr >= sk || (causal && kr > q0 + qc))) p[e] = 0.f;
          ds[e] = p[e] * (dpt[4 * j + e] - (e % 2 ? d2.y : d2.x));
        }
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int op = (j % 2) * 2 + e / 2;
          split_bf16(p[e], p[e + 1], p_hi[j / 2][op], p_lo[j / 2][op]);
          split_bf16(ds[e], ds[e + 1], ds_hi[j / 2][op], ds_lo[j / 2][op]);
        }
      }
      wgmma_fence();
      fence_acc(dv_acc);
      fence_acc(dk_acc);
      product_rs(dv_acc, p_hi, dos);  // dV += P^T dO, hi then lo
      product_rs(dv_acc, p_lo, dos);
      product_rs(dk_acc, ds_hi, qs);  // dK += dS^T Q, hi then lo
      product_rs(dk_acc, ds_lo, qs);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(dv_acc);
      fence_acc(dk_acc);
    }
    if (tid == 0) mbar_arrive(sm.empty(s));
  }
  if (group == 1) {
    const int64_t kv_off = static_cast<int64_t>(bk) * sk * d;
    store_rows(dk + kv_off, dk_acc, scale, kc, sk, d);
    store_rows(dv + kv_off, dv_acc, 1.f, kc, sk, d);
  } else {  // this query head's share, unscaled: (b * hq, 2, sk, d)
    float* own = part + static_cast<int64_t>(bh) * 2 * sk * d;
    store_rows_f32(own, dk_acc, kc, sk, d);
    store_rows_f32(own + static_cast<int64_t>(sk) * d, dv_acc, kc, sk, d);
  }
}

// dK and dV of each KV head from its group's float32 partials (b * hq, 2,
// sk, d), added in query-head order to nearest, dK scaled, rounded to bf16:
// one thread per two columns of a (b * hkv, sk, d) row.
__global__ void __launch_bounds__(256)
flash_attention_bwd_group_sum(const float* __restrict__ part, __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int hq, int hkv, int sk, int d,
                              int64_t pairs, float scale) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= pairs) return;
  const int64_t per_head = static_cast<int64_t>(sk) * d / 2;  // pairs of one head's rows
  const int64_t bk = i / per_head, at = i - bk * per_head;
  const int group = hq / hkv;
  const int64_t h0 = (bk / hkv) * hq + (bk % hkv) * group;
  const float2* src = reinterpret_cast<const float2*>(part) + h0 * 2 * per_head + at;
  float2 gk = src[0], gv = src[per_head];
  for (int h = 1; h < group; ++h) {
    const float2 k2 = src[h * 2 * per_head], v2 = src[h * 2 * per_head + per_head];
    gk = make_float2(__fadd_rn(gk.x, k2.x), __fadd_rn(gk.y, k2.y));
    gv = make_float2(__fadd_rn(gv.x, v2.x), __fadd_rn(gv.y, v2.y));
  }
  reinterpret_cast<__nv_bfloat162*>(dk)[i] = __floats2bfloat162_rn(scale * gk.x, scale * gk.y);
  reinterpret_cast<__nv_bfloat162*>(dv)[i] = __floats2bfloat162_rn(gv.x, gv.y);
}

__global__ void __launch_bounds__(kBwThreads, 1)
flash_attention_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq, int hq, int hkv, int sq, int sk,
                             int d, int sq_pad, float scale, float scale_log2, int causal) {
  extern __shared__ uint8_t smem_raw[];
  const BwSmem sm = bw_smem_init(smem_raw);
  const int bh = blockIdx.x;
  const int kv_bh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBwOwn;
  const int kv_end = causal ? min(sk, q0 + kBwOwn) : sk;
  const int n_tiles = (kv_end + kBwTile - 1) / kBwTile;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(sm.own_full(), 2 * kOwnBytes);
      tma_tile(sm.base, &tm_q, sm.own_full(), kBwOwn, q0, bh);
      tma_tile(sm.base + kOwnBytes, &tm_do, sm.own_full(), kBwOwn, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kBwStages;
        if (t >= kBwStages) mbar_wait(sm.empty(s), ((t / kBwStages) - 1) & 1);
        mbar_expect_tx(sm.full(s), kStageBytes);
        tma_tile(sm.stage(s), &tm_k, sm.full(s), kBwTile, t * kBwTile, kv_bh);
        tma_tile(sm.stage(s) + kStreamBytes, &tm_v, sm.full(s), kBwTile, t * kBwTile, kv_bh);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wg - 1, tid = threadIdx.x % 128, lane = tid % 32;
  const int qc = q0 + 64 * cw;  // this consumer's rows qc .. qc + 63
  const int r0 = qc + 16 * (tid / 32) + lane / 4, c0 = 2 * (lane % 4);
  float row_lse[2], row_d[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t row = static_cast<int64_t>(bh) * sq_pad + r0 + 8 * r;
    row_lse[r] = lse[row];
    row_d[r] = delta[row];
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  mbar_wait(sm.own_full(), 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kBwStages;
    const int k0 = t * kBwTile;
    mbar_wait(sm.full(s), (t / kBwStages) & 1);
    if (!(causal && k0 > qc + 63)) {  // else every key is past every row
      const uint32_t ks = sm.stage(s), vs = ks + kStreamBytes;
      float sc[32], dp[32];
      wgmma_fence();
      fence_acc(sc);
      fence_acc(dp);
      product_nt(sc, sm.base, kBwOwn, 64 * cw, ks);              // S = Q K^T
      product_nt(dp, sm.base + kOwnBytes, kBwOwn, 64 * cw, vs);  // dP = dO V^T
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(sc);
      fence_acc(dp);
      const bool mask = k0 + kBwTile > sk || (causal && k0 + 63 > qc);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + 8 * (e / 2), key = k0 + 8 * j + c0 + (e % 2);
          float p = exp2_ftz(sc[4 * j + e] * scale_log2 - row_lse[e / 2]);
          if (mask && (key >= sk || (causal && key > row))) p = 0.f;
          dp[4 * j + e] = p * (dp[4 * j + e] - row_d[e / 2]);
        }
      uint32_t x_hi[4][4], x_lo[4][4];
      to_operands(dp, x_hi, x_lo);
      wgmma_fence();
      fence_acc(acc);
      product_rs(acc, x_hi, ks);  // dQ += dS K, hi then lo
      product_rs(acc, x_lo, ks);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(acc);
    }
    if (tid == 0) mbar_arrive(sm.empty(s));
  }
  store_rows(dq + static_cast<int64_t>(bh) * sq * d, acc, scale, qc, sq, d);
}

int launch_wgmma(const void* q, const void* k, const void* v, const void* out,
                 const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
                 void* part, int b, int hq, int hkv, int sq, int sk, int d, double sm_scale,
                 int causal, void* stream) {
  if (b < 1 || d < 8 || d > kMaxD || d % 8 != 0 || hkv < 1 || hq % hkv != 0 || sq < 1 ||
      sk < 1 || (causal && sq != sk) || (hq > hkv && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(lse) | reinterpret_cast<uintptr_t>(delta)) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);  // TMA's alignment
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap q_own, q_tile, k_own, k_tile, v_own, v_tile, do_own, do_tile;
  if (!bf16_head_map(encode, &q_own, q, b * hq, sq, d, kBwOwn) ||
      !bf16_head_map(encode, &q_tile, q, b * hq, sq, d, kBwTile) ||
      !bf16_head_map(encode, &k_own, k, b * hkv, sk, d, kBwOwn) ||
      !bf16_head_map(encode, &k_tile, k, b * hkv, sk, d, kBwTile) ||
      !bf16_head_map(encode, &v_own, v, b * hkv, sk, d, kBwOwn) ||
      !bf16_head_map(encode, &v_tile, v, b * hkv, sk, d, kBwTile) ||
      !bf16_head_map(encode, &do_own, dout, b * hq, sq, d, kBwOwn) ||
      !bf16_head_map(encode, &do_tile, dout, b * hq, sq, d, kBwTile))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(flash_attention_bwd_stats_wgmma,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kBwSmemBytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(flash_attention_bwd_dkdv_wgmma,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kBwSmemBytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(flash_attention_bwd_dq_wgmma,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kBwSmemBytes)) != cudaSuccess)
    return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int q_tiles = (sq + kBwOwn - 1) / kBwOwn, k_tiles = (sk + kBwOwn - 1) / kBwOwn;
  const int sq_pad = q_tiles * kBwOwn;  // lse and D rows a head (the wrapper's padding)
  const float scale = static_cast<float>(sm_scale);
  const float scale_log2 = static_cast<float>(sm_scale * 1.4426950408889634);
  float* lsef = static_cast<float*>(lse);
  float* deltaf = static_cast<float*>(delta);
  flash_attention_bwd_stats_wgmma<<<dim3(b * hq, q_tiles), kBwThreads, kBwSmemBytes, s>>>(
      q_own, k_own, static_cast<const __nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(dout), lsef, deltaf, hq, hkv, sq, sk, d, sq_pad,
      scale_log2, causal);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  flash_attention_bwd_dkdv_wgmma<<<dim3(b * hq, k_tiles), kBwThreads, kBwSmemBytes, s>>>(
      q_tile, k_own, v_own, do_tile, lsef, deltaf, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), static_cast<float*>(part), hq, hkv, sq, sk, d, sq_pad,
      scale, scale_log2, causal);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (hq > hkv) {
    const int64_t pairs = static_cast<int64_t>(b) * hkv * sk * d / 2;
    flash_attention_bwd_group_sum<<<static_cast<unsigned>((pairs + 255) / 256), 256, 0, s>>>(
        static_cast<const float*>(part), static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), hq, hkv, sk, d, pairs, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  flash_attention_bwd_dq_wgmma<<<dim3(b * hq, q_tiles), kBwThreads, kBwSmemBytes, s>>>(
      q_own, k_tile, v_tile, do_own, lsef, deltaf, static_cast<__nv_bfloat16*>(dq), hq, hkv,
      sq, sk, d, sq_pad, scale, scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                                       const void* out, const void* dout, void* dq,
                                       void* dk, void* dv, void* lse, void* delta, int b,
                                       int hq, int hkv, int sq, int sk, int d,
                                       double sm_scale, int causal, void* stream) {
  return launch<float>(q, k, v, out, dout, dq, dk, dv, lse, delta, b, hq, hkv, sq, sk, d,
                       sm_scale, causal, stream);
}

extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* out, const void* dout, void* dq,
                                        void* dk, void* dv, void* lse, void* delta, int b,
                                        int hq, int hkv, int sq, int sk, int d,
                                        double sm_scale, int causal, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, dout, dq, dk, dv, lse, delta, b, hq, hkv,
                               sq, sk, d, sm_scale, causal, stream);
}

// part: float32 scratch of b * hq * 2 * sk * d (each query head's share of
// dK, then of dV), used only with more than one query head a KV head.
extern "C" int flash_attention_bwd_bf16_wgmma(const void* q, const void* k, const void* v,
                                              const void* out, const void* dout, void* dq,
                                              void* dk, void* dv, void* lse, void* delta,
                                              void* part, int b, int hq, int hkv, int sq,
                                              int sk, int d, double sm_scale, int causal,
                                              void* stream) {
  return launch_wgmma(q, k, v, out, dout, dq, dk, dv, lse, delta, part, b, hq, hkv, sq, sk,
                      d, sm_scale, causal, stream);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
