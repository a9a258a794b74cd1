// Causal or bidirectional GQA attention with an online softmax, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py::
// flash_attention (pallas_call at line 119):
//
//     o[b, h] = softmax(sm_scale * q[b, h] k[b, h / group]^T  (+ causal mask)) v[b, h / group]
//
// q is (b, hq, sq, d), k and v (b, hkv, sk, d), contiguous, float32 or
// bfloat16; o is (b, hq, sq, d) in q's type; everything inside is float32.
//
// Bound: operations.  At the LM path's shape (b 2, 32 heads, s 2048, d 112,
// bf16, causal) the work is 4*b*h*s^2*d/2 = 60 GFLOP against 117 MB of q, k,
// v and o: ~510 flops per byte, above the card's balance point, so the bound
// is the tensor cores' bf16 rate (61 us).  This kernel runs the products on
// the float32 FMA units and sits well above that bound; a wgmma/TMA
// pipeline is later work.  What its design does:
//
//  * one block per (64-row q tile, q head, batch); the q tile stays in
//    shared memory while the block walks the KV sequence in tiles of 32 rows
//    (K and V tiles in shared memory, converted to float32 on load), keeping
//    the running (m, l, acc) of each row in registers;
//  * under `causal` (sq == sk) the walk stops at the last KV tile the q tile
//    can see, the skip of the TPU kernel's fully masked blocks;
//  * the KV head of q head h is h / (hq / hkv): grouped heads read the same
//    K/V rows, which L2 keeps for the blocks of one group;
//  * 256 threads, each owning 4 rows x 2 score columns and 4 rows x up to 8
//    output columns (d <= 128), row maxima and sums by warp shuffles within
//    the 16 threads of a row group; odd shared-memory strides keep the
//    column walks free of bank conflicts; dynamic shared memory (74 KB at
//    d = 128) for three blocks per SM;
//  * any sequence length: q rows past sq are not written, KV columns past
//    sk are masked to -1e30 as the causal ones are (the TPU kernel needs
//    the lengths to divide its blocks);
//  * rows whose softmax sum is 0 divide by 1, as the TPU kernel's do.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;               // q rows per block
constexpr int kBlockK = 32;               // KV rows per tile
constexpr int kMaxD = 128;
constexpr int kRows = kBlockQ / 16;       // q rows per thread (16 row groups)
constexpr int kCols = kBlockK / 16;       // score columns per thread
constexpr int kOutCols = kMaxD / 16;      // output columns per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch casts
}

inline int odd_stride(int d) { return d % 2 == 0 ? d + 1 : d; }

inline size_t smem_bytes(int d) {
  const int ld = odd_stride(d);
  return sizeof(float) * (static_cast<size_t>(kBlockQ) * ld + kBlockK * ld +
                          kBlockK * d + kBlockQ * (kBlockK + 1));
}

// Rows [row0, row0 + rows) of an (n, d) row-major matrix into shared memory
// with leading dimension ld, as float32; rows past n are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int row0, int rows, int n, int d) {
  for (int e = threadIdx.x; e < rows * d; e += kThreads) {
    const int r = e / d;
    const int c = e - r * d;
    const int gr = row0 + r;
    dst[r * ld + c] =
        gr < n ? to_float(src[static_cast<int64_t>(gr) * d + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int hq,
                       int hkv, int sq, int sk, int d, float sm_scale,
                       int causal) {
  extern __shared__ float smem[];
  const int ld = d % 2 == 0 ? d + 1 : d;
  constexpr int pld = kBlockK + 1;
  float* qs = smem;                  // kBlockQ x ld
  float* ks = qs + kBlockQ * ld;     // kBlockK x ld
  float* vs = ks + kBlockK * ld;     // kBlockK x d
  float* ps = vs + kBlockK * d;      // kBlockQ x pld

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int h_kv = h / (hq / hkv);
  const int q0 = blockIdx.x * kBlockQ;
  const T* qh = q + (static_cast<int64_t>(b) * hq + h) * sq * d;
  const T* kh = k + (static_cast<int64_t>(b) * hkv + h_kv) * sk * d;
  const T* vh = v + (static_cast<int64_t>(b) * hkv + h_kv) * sk * d;
  T* oh = o + (static_cast<int64_t>(b) * hq + h) * sq * d;

  const int tx = threadIdx.x % 16;
  const int row_base = (threadIdx.x / 16) * kRows;  // local q rows of this thread

  load_tile(qs, ld, qh, q0, kBlockQ, sq, d);

  float m[kRows], l[kRows], acc[kRows][kOutCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) acc[i][j] = 0.f;
  }

  // Causal (sq == sk): the last key this q tile sees is q0 + kBlockQ - 1.
  const int kv_end = causal ? min(sk, q0 + kBlockQ) : sk;
  const int n_tiles = (kv_end + kBlockK - 1) / kBlockK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the last tile's reads are done; the q tile is loaded
    load_tile(ks, ld, kh, k0, kBlockK, sk, d);
    load_tile(vs, d, vh, k0, kBlockK, sk, d);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(row_base + i) * ld + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = ks[(tx + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + row_base + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * sm_scale;
        if (col >= sk || (causal && col > row)) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(row_base + i) * pld + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kOutCols; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < kBlockK; ++kk) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(row_base + i) * pld + kk];
#pragma unroll
      for (int j = 0; j < kOutCols; ++j) {
        const int c = tx + 16 * j;
        if (c < d) {
          const float vv = vs[kk * d + c];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + row_base + i;
    if (row >= sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) {
      const int c = tx + 16 * j;
      if (c < d) oh[static_cast<int64_t>(row) * d + c] = from_float<T>(acc[i][j] / li);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int b, int hq,
           int hkv, int sq, int sk, int d, double sm_scale, int causal,
           void* stream) {
  if (d < 1 || d > kMaxD || hkv < 1 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, hq, b);
  flash_attention_kernel<T><<<grid, kThreads, bytes,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, sq, sk, d,
      static_cast<float>(sm_scale), causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* o, int b, int hq, int hkv, int sq,
                                   int sk, int d, double sm_scale, int causal,
                                   void* stream) {
  return launch<float>(q, k, v, o, b, hq, hkv, sq, sk, d, sm_scale, causal,
                       stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* o, int b, int hq, int hkv, int sq,
                                    int sk, int d, double sm_scale, int causal,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, b, hq, hkv, sq, sk, d, sm_scale,
                               causal, stream);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
