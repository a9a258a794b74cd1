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
// flop, 152 us on the bf16 tensor cores against ~470 MB of bytes (~140
// us).  This first kernel runs on the float32 FMA units (a SIMT design;
// wgmma is later work), and recomputes S three times and dP twice, so it
// does 8 of the forward's products' worth: it is far from that bound.
//
// Three launches on the caller's stream, FlashAttention-2's backward
// without atomics, so that two runs give the same bits:
//
//  1. flash_attention_bwd_stats: one block per (64-row q tile, b * hq):
//     the row log-sum-exp of the scaled, masked scores (an online max and
//     sum over 64-key tiles) and D = rowsum(dO * O), into float32 scratch;
//  2. flash_attention_bwd_dkdv: one block per (64-key tile, b * hkv): K and
//     V of the tile stay in shared memory while the block walks the KV
//     head's query heads in order and, for each, the q tiles the causal
//     mask leaves; per q tile it forms P and dS in shared memory and adds
//     P^T dO and dS^T Q into per-thread float32 accumulators;
//  3. flash_attention_bwd_dq: one block per (64-row q tile, b * hq): Q and
//     dO stay in shared memory while the block walks the key tiles the
//     mask leaves, adding dS K into per-thread accumulators.
//
// Each block is 256 threads as a 16 x 16 grid; a thread owns rows
// ty + 16 i and columns tx + 16 j of every 64 x 64 tile, and rows ty + 16 i
// by head-dim columns 8 tx .. 8 tx + 7 (d <= 128) of the accumulated
// gradient.  Tiles of q, k, v and dO are held in float32, rows padded with
// zeros to 8 columns and strided an odd number of 16-byte groups, and read
// four or eight columns a load (float4): the products over d take four
// loads for 32 multiply-adds, the accumulations four for 64.  Every sum
// runs in a fixed order: no float atomics.  exp is taken only of unmasked
// scores (a masked P is 0 before exp is reached).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
