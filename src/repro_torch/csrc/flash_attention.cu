// Causal or bidirectional GQA attention with an online softmax, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py::
// flash_attention (pallas_call at line 119):
//
//     o[b, h] = softmax(sm_scale * q[b, h] k[b, h / group]^T  (+ causal mask)) v[b, h / group]
//
// q is (b, hq, sq, d), k and v (b, hkv, sk, d), contiguous; o is
// (b, hq, sq, d) in q's type.  Three routes, chosen by the Python wrapper
// from the dtype and d alone.
//
// Bound: operations.  At the LM path's shape (b 2, 32 heads, s 2048, d 112,
// causal) the work is 4*b*h*d*s(s+1)/2 = 6.016e10 flop against 117 MB of q,
// k, v and o in bf16 (235 MB in float32): ~510 (~255) flops per byte, above
// the card's balance point, so the bound is the rate of the products: 61 us
// on the bf16 tensor cores, and in float32 364.6 us for three TF32
// tensor-core passes at 495 TFLOP/s (681.3 us at the 264.9 TFLOP/s that
// mma.sync alone reaches on the card), against 897.89 us on the float32 FMA
// units (67 TFLOP/s).
//
// 1. flash_attention_kernel_wgmma (bf16, d % 8 == 0, d <= 128): tensor
//    cores fed by TMA.  What its design does about the bound:
//  * one block per (128-row q tile, q head, batch row), grid (b * hq,
//    q tiles) with the q tiles walked last-first, so the causal tiles with
//    the most KV tiles start first and the short ones fill the tail;
//  * three warpgroups: one producer warp issues every load through TMA
//    (cp.async.bulk.tensor, 128-byte swizzle, mbarrier completion); two
//    consumer warpgroups own 64 q rows each; setmaxnreg moves registers
//    from the producer's warpgroup (40) to the consumers (232);
//  * shared memory holds the q tile and a ring of two K/V stages (K and V
//    with their own "full" barriers, one "empty" barrier per stage released
//    by both consumers): 160 KB;
//  * S = Q K^T is wgmma m64n128k16 with both operands in shared memory,
//    accumulating in float32 registers; the online softmax runs in those
//    registers (row max and sum over the 4 lanes that share a row, 2^x
//    on the SFU of scores pre-scaled by sm_scale * log2 e); O += P V is wgmma with P
//    from registers and V from shared memory (MN-major, transposed B);
//  * P is split into bf16 hi + lo parts, each multiplied by V (V is exact
//    in bf16): a single bf16 P (2^-9 relative) misses the elementwise bf16
//    bound against the float32 twin at rows that see a few keys, the split
//    keeps P to ~2^-17 at 1.5x the tensor-core work;
//  * head dims under 128 are padded to 128 by TMA's zero fill (columns
//    d..127 of every box read as 0): zeros in Q and K leave S exact, and
//    the extra output columns are never stored.  At d = 112 that is 128/112
//    of the bound's work;
//  * rows past sk are zero-filled too and their scores masked to -inf (a
//    zero score is not an excluded key); under `causal` (sq == sk) the walk
//    stops at the q tile's diagonal tile, the only one masked; rows past sq
//    are not stored; rows whose softmax sum is 0 divide by 1.
//
// 2. flash_attention_kernel_tf32 (float32, d <= 128): both products on the
//    TF32 tensor cores as mma.sync.m16n8k8, float32-exact by the hi + lo
//    split of tf32_split.cuh (each operand split into TF32 parts, a.b formed
//    as a_lo b_hi + a_hi b_lo + a_hi b_hi: three passes; one pass misses the
//    float32 tolerance ~50x).  What its design does about the bound:
//  * one block per (128-row q tile, q head, batch row), 8 warps of 16 q
//    rows, one block an SM, grid ordered as route 1's (the longest causal
//    walks first); under `causal` a warp skips the KV tiles past its own
//    last row;
//  * K/V tiles of 64 rows come into shared memory through cp.async in a
//    ring of two stages, so the next tile's copy runs under this tile's
//    products; one barrier a tile; with the q tile, 202 KB at d = 128;
//  * the q tile stays in shared memory (Q's fragments in registers push
//    d = 112 and 128 past 255 registers into spills); every operand is
//    split as its fragment is read, its hi part rounded to TF32 and its lo
//    part left for the tensor cores to truncate (two integer operations
//    fewer a value than rounding it: the splits, not the products, are
//    most of the instructions);
//  * the sum over the head dim (S) and over the keys (P V) takes the A
//    layout's columns t and t + 4 as columns 2t and 2t + 1 of each 8-wide
//    step: K's fragment is then one 64-bit load, and P's A fragment is S's
//    accumulator fragment as it stands (no shuffle, no shared memory);
//  * row strides of 8 (mod 32) floats for K and Q and 4 (mod 8) for V keep
//    every fragment load free of bank conflicts;
//  * S keeps its a_hi b_hi products in a sum apart from the small ones (the
//    tensor cores truncate each sum they form); the online softmax runs in
//    S's registers as in route 1 (row max and sum over 4 lanes, 2^x on the
//    SFU); O is one sum of the three passes;
//  * d is padded to a multiple of 16 (one instantiation each) with zeros in
//    shared memory; rows past sk are zero-filled and their scores masked to
//    -inf with the causal ones; rows past sq are not stored; rows whose
//    softmax sum is 0 divide by 1; rows whose byte stride is not a multiple
//    of 16 (odd d) and unaligned views take 4-byte copies.
//
// 3. flash_attention_kernel (bf16 with another d): the products on the
//    float32 FMA units out of shared memory, well above the bound:
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
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_split.cuh"
#include "tma.cuh"

namespace {

// ---------------------------------------------------------------------------
// Route 3: the float32 FMA units (bf16 with d % 8 != 0).

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;               // q rows per block
constexpr int kBlockK = 32;               // KV rows per tile
constexpr int kMaxD = 128;
constexpr int kRows = kBlockQ / 16;       // q rows per thread (16 row groups)
constexpr int kCols = kBlockK / 16;       // score columns per thread
constexpr int kOutCols = kMaxD / 16;      // output columns per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ __nv_bfloat16 from_float(float x) {
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
      if (c < d) oh[static_cast<int64_t>(row) * d + c] = from_float(acc[i][j] / li);
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


// ---------------------------------------------------------------------------
// Route 1: wgmma on TMA-fed tiles (bf16, d % 8 == 0, d <= 128).

constexpr int kWgThreads = 384;            // producer warpgroup + 2 consumers
constexpr int kWgBlockQ = 128;             // q rows per block, 64 per consumer
constexpr int kWgBlockK = 128;             // KV rows per tile
constexpr int kWgStages = 2;               // K/V ring depth
constexpr int kAtomCols = 64;              // bf16 columns of a 128-byte swizzle atom
constexpr int kAtoms = kMaxD / kAtomCols;  // head dim padded to 128
constexpr int kQBytes = kAtoms * kWgBlockQ * 128;
constexpr int kTileBytes = kAtoms * kWgBlockK * 128;  // one K or V tile
constexpr int kOffK = kQBytes;
constexpr int kOffV = kOffK + kWgStages * kTileBytes;
constexpr int kOffBar = kOffV + kWgStages * kTileBytes;
constexpr int kNumBars = 1 + 3 * kWgStages;  // q full; K full, V full, empty per stage
// + 1024: the tiles start on a 1024-byte boundary (the swizzle's period)
constexpr int kWgSmemBytes = kOffBar + 8 * kNumBars + 1024;

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (SW128).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma that owns them.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ACC64 ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
#define REGS64                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 128, float32) (+)= A (64 x 16, K-major in shared memory) *
// B (16 x 128, K-major in shared memory); d is overwritten when !accumulate.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC64
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128, float32) += A (64 x 16 bf16, the accumulator fragment layout
// packed in 4 registers) * B (16 x 128, MN-major in shared memory).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// 2^x on the SFU; results below 2^-126 flush to 0 (weights that small are
// far below what the bf16 output resolves).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Splits (x0, x1) into a bf16 pair and the bf16 pair of what it missed.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 back = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x0 - back.x, x1 - back.y);
}

__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             __nv_bfloat16* __restrict__ o, int hq, int hkv,
                             int sq, int sk, int d, float scale_log2,
                             int causal) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = base + kOffK;
  const uint32_t v_s = base + kOffV;
  const uint32_t q_full = base + kOffBar;
  const uint32_t k_full = q_full + 8;                  // + 8 * stage
  const uint32_t v_full = k_full + 8 * kWgStages;      // + 8 * stage
  const uint32_t empty = v_full + 8 * kWgStages;       // + 8 * stage

  const int bh = blockIdx.x;  // batch row * hq + q head
  const int kv_bh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWgBlockQ;
  // Causal (sq == sk): the last key this q tile sees is q0 + kWgBlockQ - 1.
  const int kv_end = causal ? min(sk, q0 + kWgBlockQ) : sk;
  const int n_tiles = (kv_end + kWgBlockK - 1) / kWgBlockK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, kQBytes);
      for (int a = 0; a < kAtoms; ++a)
        tma_load(q_s + a * kWgBlockQ * 128, &tm_q, q_full, a * kAtomCols, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kWgStages;
        if (t >= kWgStages) mbar_wait(empty + 8 * s, ((t / kWgStages) - 1) & 1);
        const uint32_t off = s * kTileBytes;
        mbar_expect_tx(k_full + 8 * s, kTileBytes);
        for (int a = 0; a < kAtoms; ++a)
          tma_load(k_s + off + a * kWgBlockK * 128, &tm_k, k_full + 8 * s,
                   a * kAtomCols, t * kWgBlockK, kv_bh);
        mbar_expect_tx(v_full + 8 * s, kTileBytes);
        for (int a = 0; a < kAtoms; ++a)
          tma_load(v_s + off + a * kWgBlockK * 128, &tm_v, v_full + 8 * s,
                   a * kAtomCols, t * kWgBlockK, kv_bh);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1;  // consumer warpgroup: q rows q0 + 64 cw ...
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    // This thread's rows of the accumulator fragments: r0 and r0 + 8; its
    // columns 8 j + c0 and 8 j + c0 + 1 for j < 16.
    const int r0 = q0 + 64 * cw + 16 * (tid / 32) + lane / 4;
    const int c0 = 2 * (lane % 4);

    float acc_s[64], acc_o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc_s[i] = acc_o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    const uint32_t q_rows = q_s + cw * 64 * 128;

    mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kWgStages;
      const uint32_t parity = (t / kWgStages) & 1;
      const uint32_t off = s * kTileBytes;

      // S = Q K^T over the padded head dim: 2 atoms x 4 steps of 16.
      mbar_wait(k_full + 8 * s, parity);
      wgmma_fence();
      fence_acc(acc_s);
#pragma unroll
      for (int a = 0; a < kAtoms; ++a)
#pragma unroll
        for (int kk = 0; kk < kAtomCols / 16; ++kk)
          wgmma_ss(acc_s,
                   sw128_desc(q_rows + a * kWgBlockQ * 128 + kk * 32, 16, 1024),
                   sw128_desc(k_s + off + a * kWgBlockK * 128 + kk * 32, 16, 1024),
                   a + kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(acc_s);

      // Online softmax in base 2.
#pragma unroll
      for (int i = 0; i < 64; ++i) acc_s[i] *= scale_log2;
      if (t == n_tiles - 1) {  // only the last tile holds masked keys
        const int k0 = t * kWgBlockK;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = r0 + 8 * (e / 2);
            const int col = k0 + 8 * j + c0 + (e % 2);
            if (col >= sk || (causal && col > row)) acc_s[4 * j + e] = -INFINITY;
          }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], acc_s[4 * j + e]);
      float alpha[2], shift[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        shift[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // a row with no key yet
        alpha[r] = exp2_ftz(m[r] - shift[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];  // this thread's part of the row sum
      }
      uint32_t p_hi[8][4], p_lo[8][4];
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const float p0 = exp2_ftz(acc_s[4 * j + e] - shift[e / 2]);
          const float p1 = exp2_ftz(acc_s[4 * j + e + 1] - shift[e / 2]);
          l[e / 2] += p0 + p1;
          // The fragment of S columns 16 kk .. 16 kk + 15 is the A operand
          // of step kk: registers {row r0 | r0 + 8} x {cols +0 | +8}.
          split_bf16(p0, p1, p_hi[j / 2][(j % 2) * 2 + e / 2],
                     p_lo[j / 2][(j % 2) * 2 + e / 2]);
        }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        acc_o[4 * j] *= alpha[0];
        acc_o[4 * j + 1] *= alpha[0];
        acc_o[4 * j + 2] *= alpha[1];
        acc_o[4 * j + 3] *= alpha[1];
      }

      // O += P V, P's hi and lo parts in turn, 8 steps of 16 keys each.
      mbar_wait(v_full + 8 * s, parity);
      wgmma_fence();
      fence_acc(acc_o);
#pragma unroll
      for (int kk = 0; kk < kWgBlockK / 16; ++kk)
        wgmma_rs(acc_o, p_hi[kk],
                 sw128_desc(v_s + off + kk * 16 * 128, kWgBlockK * 128, 1024));
#pragma unroll
      for (int kk = 0; kk < kWgBlockK / 16; ++kk)
        wgmma_rs(acc_o, p_lo[kk],
                 sw128_desc(v_s + off + kk * 16 * 128, kWgBlockK * 128, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(acc_o);
      if (tid == 0) mbar_arrive(empty + 8 * s);
    }

    float li[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      li[r] = l[r] == 0.f ? 1.f : l[r];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= sq) continue;
      __nv_bfloat16* orow = o + (static_cast<int64_t>(bh) * sq + row) * d;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 8 * j + c0;
        if (col < d)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
              acc_o[4 * j + 2 * r] / li[r], acc_o[4 * j + 2 * r + 1] / li[r]);
      }
    }
  }
}

#undef ACC8
#undef ACC64
#undef REGS64

// A (d, s, b * h) view of a contiguous (b, h, s, d) bf16 tensor, read in
// boxes of 64 columns x `rows` rows of one head, 128-byte swizzled; boxes
// past d or s read zeros.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int bh,
              int s, int d, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(s) * d * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kAtomCols),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_wgmma(const void* q, const void* k, const void* v, void* o, int b,
                 int hq, int hkv, int sq, int sk, int d, double sm_scale,
                 int causal, void* stream) {
  if (d < 8 || d > kMaxD || d % 8 != 0 || hkv < 1 || hq % hkv != 0 || sq < 1 ||
      sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);  // TMA's alignment
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(encode, &tm_q, q, b * hq, sq, d, kWgBlockQ) ||
      !make_map(encode, &tm_k, k, b * hkv, sk, d, kWgBlockK) ||
      !make_map(encode, &tm_v, v, b * hkv, sk, d, kWgBlockK))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kWgSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * hq, (sq + kWgBlockQ - 1) / kWgBlockQ);
  const double log2e = 1.4426950408889634;
  flash_attention_kernel_wgmma<<<grid, kWgThreads, kWgSmemBytes,
                                 static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), hq, hkv, sq, sk, d,
      static_cast<float>(sm_scale * log2e), causal);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Route 2: TF32 mma.sync, float32-exact by the hi + lo split (float32).

constexpr int kTfWarps = 8;
constexpr int kTfThreads = 32 * kTfWarps;
constexpr int kTfBlockQ = 16 * kTfWarps;      // q rows per block, 16 a warp
constexpr int kTfBlocksPerSM = 8 / kTfWarps;  // 8 warps an SM
constexpr int kTfBlockK = 64;                 // KV rows per tile
constexpr int kTfStages = 2;                  // K/V ring depth
constexpr bool kTfQInRegs = false;  // Q's raw fragments in registers, else the q tile
                                    // in shared memory

// Row strides (floats) of the shared tiles at the padded head dim dp (a
// multiple of 16): K's and Q's are 8 (mod 32), so the 64-bit fragment loads
// of a half-warp (rows g, columns 2t and 2t + 1) hit 32 different banks;
// V's are 4 (mod 8), so the 32-bit loads of a warp (rows 2t or 2t + 1,
// column g) do.  Mirrored by tf32_smem_bytes in flash_attention.py.
__host__ __device__ constexpr int tf_ldk(int dp) { return dp % 32 == 0 ? dp + 8 : dp + 24; }
__host__ __device__ constexpr int tf_ldv(int dp) { return dp + 4; }
__host__ __device__ constexpr int tf_smem_bytes(int dp) {
  return 4 * (kTfStages * kTfBlockK * (tf_ldk(dp) + tf_ldv(dp)) +
              (kTfQInRegs ? 0 : kTfBlockQ * tf_ldk(dp)));
}

// Fragments as split_lo_truncated splits them (the lo parts unrounded).
__device__ __forceinline__ void set_a(FragA& f, const float (&v)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_lo_truncated(v[i], f.hi[i], f.lo[i]);
}
__device__ __forceinline__ void set_b(FragB& f, float v0, float v1) {
  split_lo_truncated(v0, f.hi[0], f.lo[0]);
  split_lo_truncated(v1, f.hi[1], f.lo[1]);
}

// Starts copying rows [row0, row0 + kRows) of an (n, d) row-major float32
// matrix into shared memory (row stride ld), zero in rows past n and in
// columns d..kDp-1: 16-byte copies when `vec` (d % 4 == 0 and 16-byte
// aligned rows), else 4-byte ones.
template <int kRows, int kDp>
__device__ __forceinline__ void tf_load_tile(float* dst, int ld, const float* __restrict__ src,
                                             int row0, int n, int d, bool vec) {
  if (vec) {
    constexpr int kPer = kDp / 4;
#pragma unroll
    for (int e = threadIdx.x; e < kRows * kPer; e += kTfThreads) {
      const int r = e / kPer, c = (e % kPer) * 4;
      const bool valid = row0 + r < n && c < d;
      cp_async(dst + r * ld + c, valid ? src + static_cast<int64_t>(row0 + r) * d + c : src,
               16, valid);
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < kRows * kDp; e += kTfThreads) {
      const int r = e / kDp, c = e % kDp;
      const bool valid = row0 + r < n && c < d;
      cp_async(dst + r * ld + c, valid ? src + static_cast<int64_t>(row0 + r) * d + c : src,
               4, valid);
    }
  }
}

template <int kDp>
__global__ void __launch_bounds__(kTfThreads, kTfBlocksPerSM)
flash_attention_kernel_tf32(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ o, int hq,
                            int hkv, int sq, int sk, int d, float scale_log2, int causal,
                            int vec) {
  constexpr int kNd = kDp / 8;        // 8-column steps of the head dim
  constexpr int kNs = kTfBlockK / 8;  // 8-key steps of a KV tile
  constexpr int ldk = tf_ldk(kDp), ldv = tf_ldv(kDp);
  extern __shared__ __align__(16) float smem_tf[];
  float* ks = smem_tf;                           // stages x kTfBlockK x ldk
  float* vs = ks + kTfStages * kTfBlockK * ldk;  // stages x kTfBlockK x ldv
  float* qs = vs + kTfStages * kTfBlockK * ldv;  // kTfBlockQ x ldk, unless kTfQInRegs

  const int bh = blockIdx.x;  // batch row * hq + q head
  const int kv_bh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTfBlockQ;
  const float* qh = q + static_cast<int64_t>(bh) * sq * d;
  const float* kh = k + static_cast<int64_t>(kv_bh) * sk * d;
  const float* vh = v + static_cast<int64_t>(kv_bh) * sk * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int w0 = q0 + 16 * warp;  // this warp's rows: this thread's are w0 + g, w0 + g + 8
  // Causal (sq == sk): the last key this q tile sees is q0 + kTfBlockQ - 1,
  // the last one this warp sees w0 + 15; a warp past sq sees none.
  const int kv_end = causal ? min(sk, q0 + kTfBlockQ) : sk;
  const int n_tiles = (kv_end + kTfBlockK - 1) / kTfBlockK;
  const int warp_end = w0 >= sq ? 0 : causal ? min(sk, w0 + 16) : sk;

  auto load_kv = [&](int tile) {
    const int s = tile % kTfStages;
    tf_load_tile<kTfBlockK, kDp>(ks + s * kTfBlockK * ldk, ldk, kh, tile * kTfBlockK, sk, d,
                                 vec);
    tf_load_tile<kTfBlockK, kDp>(vs + s * kTfBlockK * ldv, ldv, vh, tile * kTfBlockK, sk, d,
                                 vec);
  };
  if constexpr (!kTfQInRegs) tf_load_tile<kTfBlockQ, kDp>(qs, ldk, qh, q0, sq, d, vec);
#pragma unroll
  for (int s = 0; s < kTfStages - 1; ++s) {
    if (s < n_tiles) load_kv(s);
    cp_async_commit();
  }

  // S sums over the head dim and P V over the keys in any order, so the A
  // layout's columns t and t + 4 are taken as columns 2t and 2t + 1 of each
  // 8-wide step: Q's A fragment of step kk is rows (g, g + 8) x columns
  // 8 kk + 2t + (0, 1), K's B fragment one 64-bit load.
  float qf[kTfQInRegs ? kNd : 1][4];
  if constexpr (kTfQInRegs) {
#pragma unroll
    for (int kk = 0; kk < kNd; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = w0 + g + 8 * (e & 1), col = 8 * kk + 2 * t + (e >> 1);
        qf[kk][e] = row < sq && col < d ? qh[static_cast<int64_t>(row) * d + col] : 0.f;
      }
  }
  auto q_frag = [&](int kk, FragA& fa) {
    if constexpr (kTfQInRegs) {
      set_a(fa, qf[kk]);
    } else {
      const float* r = qs + (16 * warp + g) * ldk + 8 * kk + 2 * t;
      const float2 a = *reinterpret_cast<const float2*>(r);
      const float2 b = *reinterpret_cast<const float2*>(r + 8 * ldk);
      const float vals[4] = {a.x, b.x, a.y, b.y};
      set_a(fa, vals);
    }
  };

  float acc[kNd][4] = {};  // O unnormalised: tile j holds columns 8j + 2t, 8j + 2t + 1
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<kTfStages - 2>();
    __syncthreads();  // this tile is in; every warp is done with the last one
    if (tile + kTfStages - 1 < n_tiles) load_kv(tile + kTfStages - 1);
    cp_async_commit();
    const int k0 = tile * kTfBlockK;
    if (k0 >= warp_end) continue;
    const float* kt = ks + (tile % kTfStages) * kTfBlockK * ldk;
    const float* vt = vs + (tile % kTfStages) * kTfBlockK * ldv;

    // S = Q K^T, the a_hi b_hi products in sb, the others in ss.
    float sb[kNs][4] = {}, ss[kNs][4] = {};
#pragma unroll
    for (int kk = 0; kk < kNd; ++kk) {
      FragA fa;
      q_frag(kk, fa);
      FragB fb[kNs];
#pragma unroll
      for (int j = 0; j < kNs; ++j) {
        const float2 kv =
            *reinterpret_cast<const float2*>(kt + (8 * j + g) * ldk + 8 * kk + 2 * t);
        set_b(fb[j], kv.x, kv.y);
      }
#pragma unroll
      for (int part = 0; part < 3; ++part)
#pragma unroll
        for (int j = 0; j < kNs; ++j) mma_part(sb[j], ss[j], fa, fb[j], part);
    }

    // Online softmax in base 2 on rows g and g + 8 (e / 2); only a tile
    // past sk or across this warp's diagonal holds masked keys.
    const bool edge = k0 + kTfBlockK > sk || (causal && k0 + kTfBlockK - 1 > w0);
#pragma unroll
    for (int j = 0; j < kNs; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = (sb[j][e] + ss[j][e]) * scale_log2;
        if (edge) {
          const int row = w0 + g + 8 * (e / 2), col = k0 + 8 * j + 2 * t + (e % 2);
          if (col >= sk || (causal && col > row)) x = -INFINITY;
        }
        sb[j][e] = x;
      }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kNs; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], sb[j][e]);
    float alpha[2], shift[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      shift[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // a row with no key yet
      alpha[r] = exp2_ftz(m[r] - shift[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];  // this thread's part of the row sum
    }
#pragma unroll
    for (int j = 0; j < kNs; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sb[j][e] = exp2_ftz(sb[j][e] - shift[e / 2]);
        l[e / 2] += sb[j][e];
      }
#pragma unroll
    for (int j = 0; j < kNd; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V.  P's A fragment of key step kk is S's sum fragment of
    // column tile kk: (g, 2t) (g + 8, 2t) (g, 2t + 1) (g + 8, 2t + 1), i.e.
    // keys 2t and 2t + 1 in the A layout's columns t and t + 4, so V's B
    // fragment is rows 2t and 2t + 1 of the step at column g.
#pragma unroll
    for (int kk = 0; kk < kNs; ++kk) {
      FragA pa;
      const float pv[4] = {sb[kk][0], sb[kk][2], sb[kk][1], sb[kk][3]};
      set_a(pa, pv);
      const float* v0 = vt + (8 * kk + 2 * t) * ldv + g;
#pragma unroll
      for (int j = 0; j < kNd; ++j) {
        FragB vb;
        set_b(vb, v0[8 * j], v0[ldv + 8 * j]);
#pragma unroll
        for (int part = 0; part < 3; ++part) mma_part(acc[j], acc[j], pa, vb, part);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float li = l[r] == 0.f ? 1.f : l[r];
    const int row = w0 + g + 8 * r;
    if (row >= sq) continue;
    float* orow = o + (static_cast<int64_t>(bh) * sq + row) * d;
#pragma unroll
    for (int j = 0; j < kNd; ++j) {
      const int col = 8 * j + 2 * t;
      const float x0 = acc[j][2 * r] / li, x1 = acc[j][2 * r + 1] / li;
      if (d % 2 == 0) {
        if (col < d) *reinterpret_cast<float2*>(orow + col) = make_float2(x0, x1);
      } else {
        if (col < d) orow[col] = x0;
        if (col + 1 < d) orow[col + 1] = x1;
      }
    }
  }
}

template <int kDp>
int launch_tf32_dp(const float* q, const float* k, const float* v, float* o, int b, int hq,
                   int hkv, int sq, int sk, int d, float scale_log2, int causal, int vec,
                   cudaStream_t stream) {
  constexpr int bytes = tf_smem_bytes(kDp);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel_tf32<kDp>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * hq, (sq + kTfBlockQ - 1) / kTfBlockQ);
  flash_attention_kernel_tf32<kDp><<<grid, kTfThreads, bytes, stream>>>(
      q, k, v, o, hq, hkv, sq, sk, d, scale_log2, causal, vec);
  return static_cast<int>(cudaGetLastError());
}

int launch_tf32(const void* q, const void* k, const void* v, void* o, int b, int hq,
                int hkv, int sq, int sk, int d, double sm_scale, int causal, void* stream) {
  if (d < 1 || d > kMaxD || hkv < 1 || hq % hkv != 0 || sq < 1 || sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = d % 4 == 0 && (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                                 reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  const float scale_log2 = static_cast<float>(sm_scale * 1.4426950408889634);
  const auto args = [&](auto launcher) {
    return launcher(static_cast<const float*>(q), static_cast<const float*>(k),
                    static_cast<const float*>(v), static_cast<float*>(o), b, hq, hkv, sq, sk,
                    d, scale_log2, causal, vec, static_cast<cudaStream_t>(stream));
  };
  switch ((d + 15) / 16) {  // the head dim padded to a multiple of 16
    case 1: return args(launch_tf32_dp<16>);
    case 2: return args(launch_tf32_dp<32>);
    case 3: return args(launch_tf32_dp<48>);
    case 4: return args(launch_tf32_dp<64>);
    case 5: return args(launch_tf32_dp<80>);
    case 6: return args(launch_tf32_dp<96>);
    case 7: return args(launch_tf32_dp<112>);
    default: return args(launch_tf32_dp<128>);
  }
}

}  // namespace

extern "C" int flash_attention_f32_tf32(const void* q, const void* k,
                                        const void* v, void* o, int b, int hq,
                                        int hkv, int sq, int sk, int d,
                                        double sm_scale, int causal, void* stream) {
  return launch_tf32(q, k, v, o, b, hq, hkv, sq, sk, d, sm_scale, causal,
                     stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* o, int b, int hq, int hkv, int sq,
                                    int sk, int d, double sm_scale, int causal,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, b, hq, hkv, sq, sk, d, sm_scale,
                               causal, stream);
}

extern "C" int flash_attention_bf16_wgmma(const void* q, const void* k,
                                          const void* v, void* o, int b, int hq,
                                          int hkv, int sq, int sk, int d,
                                          double sm_scale, int causal,
                                          void* stream) {
  return launch_wgmma(q, k, v, o, b, hq, hkv, sq, sk, d, sm_scale, causal,
                      stream);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
