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
// Bound: operations.  At the LM path's shape (b 2, l 2048, 112 heads, dh 64,
// ds 64, chunk 128) the work is ~15 GFLOP against 237 MB of x and y (a
// float32 FMA rate of 66.9 TFLOP/s: 225 us; the bytes: 71 us).  This kernel
// runs every product on the float32 FMA units out of shared memory and
// recomputes C.B^T for every head (B and C are shared by the heads), so it
// sits well above that bound.  What its design does:
//
//  * one block per (head, batch row) walks the chunks in order: the loop
//    takes the place of the TPU grid's sequential ("arbitrary") chunk axis,
//    and the (dh, ds) float32 state stays in shared memory across chunks;
//  * per chunk, dt*x, B and C are loaded once into shared memory; the
//    inclusive cumsum of A*dt is one warp's shuffle scan;
//  * the intra-chunk term is formed 16 rows of t at a time: M[t, s] =
//    (C_t . B_s) exp(cum_t - cum_s) for s <= t only.  exp is never taken
//    above the diagonal, where cum_t - cum_s > 0 can overflow to inf (the
//    TPU kernel's where(rows >= cols, exp(seg), 0) evaluates it there; a
//    masked product inf * 0 would be NaN).  Tiling t keeps shared memory
//    at 206,592 bytes for mamba2-130m's ds = 128, dh = 64, chunk 128, where a
//    whole (chunk x chunk) M would not fit beside B, C, S and dt*x;
//  * the state update reuses the dt*x buffer scaled by exp(cum_L - cum_s)
//    once y of the chunk is written;
//  * shared-memory strides are odd where threads walk a column, so the
//    walks are free of bank conflicts.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowTile = 16;  // rows t of the intra-chunk term per pass

inline int odd_stride(int n) { return n % 2 == 0 ? n + 1 : n; }

struct Layout {
  int ldb, lds;  // strides of B rows and state rows (odd)
  size_t floats;
};

inline Layout layout(int chunk, int dh, int ds) {
  Layout lay;
  lay.ldb = odd_stride(ds);
  lay.lds = odd_stride(ds);
  lay.floats = static_cast<size_t>(chunk) * dh      // dt * x
               + static_cast<size_t>(chunk) * lay.ldb  // B
               + static_cast<size_t>(chunk) * ds       // C
               + static_cast<size_t>(dh) * lay.lds     // state
               + static_cast<size_t>(kRowTile) * chunk // M tile
               + 2 * static_cast<size_t>(chunk);       // cum, dt
  return lay;
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ B,
                const float* __restrict__ C, float* __restrict__ y, int l,
                int h, int dh, int ds, int L, int ldb, int lds) {
  extern __shared__ float smem[];
  float* dx = smem;               // L x dh
  float* Bs = dx + L * dh;        // L x ldb
  float* Cs = Bs + L * ldb;       // L x ds
  float* S = Cs + L * ds;         // dh x lds
  float* M = S + dh * lds;        // kRowTile x L
  float* cum = M + kRowTile * L;  // L
  float* dts = cum + L;           // L

  const int hh = blockIdx.x;
  const int b = blockIdx.y;
  const float a = A[hh];
  const int tid = threadIdx.x;

  for (int e = tid; e < dh * ds; e += kThreads) {
    const int p = e / ds;
    S[p * lds + (e - p * ds)] = 0.f;
  }

  const int n_chunks = l / L;
  for (int c = 0; c < n_chunks; ++c) {
    const int64_t row0 = static_cast<int64_t>(b) * l + static_cast<int64_t>(c) * L;
    __syncthreads();  // the last chunk's reads of every buffer are done
    for (int s = tid; s < L; s += kThreads) dts[s] = dt[(row0 + s) * h + hh];
    for (int e = tid; e < L * ds; e += kThreads) {
      const int s = e / ds;
      const int n = e - s * ds;
      Bs[s * ldb + n] = B[(row0 + s) * ds + n];
      Cs[e] = C[(row0 + s) * ds + n];
    }
    __syncthreads();
    for (int e = tid; e < L * dh; e += kThreads) {
      const int s = e / dh;
      const int p = e - s * dh;
      dx[e] = dts[s] * x[((row0 + s) * h + hh) * dh + p];
    }
    if (tid < 32) {  // inclusive cumsum of A*dt: one warp, per-lane runs
      const int per = (L + 31) / 32;
      const int lo = min(L, tid * per);
      const int hi = min(L, lo + per);
      float run = 0.f;
      for (int s = lo; s < hi; ++s) run += a * dts[s];
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += up;
      }
      float acc = incl - run;  // the sum of the lanes before this one
      for (int s = lo; s < hi; ++s) {
        acc += a * dts[s];
        cum[s] = acc;
      }
    }
    __syncthreads();

    for (int r0 = 0; r0 < L; r0 += kRowTile) {
      const int rows = min(kRowTile, L - r0);
      for (int e = tid; e < rows * L; e += kThreads) {
        const int tr = e / L;
        const int s = e - tr * L;
        const int t = r0 + tr;
        float mv = 0.f;
        if (s <= t) {  // exp only on and below the diagonal
          float dot = 0.f;
          for (int n = 0; n < ds; ++n) dot = fmaf(Cs[t * ds + n], Bs[s * ldb + n], dot);
          mv = dot * expf(cum[t] - cum[s]);
        }
        M[e] = mv;
      }
      __syncthreads();
      for (int e = tid; e < rows * dh; e += kThreads) {
        const int tr = e / dh;
        const int p = e - tr * dh;
        const int t = r0 + tr;
        float intra = 0.f;
        for (int s = 0; s <= t; ++s) intra = fmaf(M[tr * L + s], dx[s * dh + p], intra);
        float inter = 0.f;
        for (int n = 0; n < ds; ++n) inter = fmaf(Cs[t * ds + n], S[p * lds + n], inter);
        y[((row0 + t) * h + hh) * dh + p] = intra + expf(cum[t]) * inter;
      }
      __syncthreads();  // M is rewritten by the next row tile
    }

    const float cum_last = cum[L - 1];
    for (int e = tid; e < L * dh; e += kThreads) dx[e] *= expf(cum_last - cum[e / dh]);
    __syncthreads();
    const float decay = expf(cum_last);
    for (int e = tid; e < dh * ds; e += kThreads) {
      const int p = e / ds;
      const int n = e - p * ds;
      float acc = 0.f;
      for (int s = 0; s < L; ++s) acc = fmaf(dx[s * dh + p], Bs[s * ldb + n], acc);
      S[p * lds + n] = decay * S[p * lds + n] + acc;
    }
  }
}

}  // namespace

extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* A,
                            const void* B, const void* C, void* y, int b, int l,
                            int h, int dh, int ds, int chunk, void* stream) {
  if (chunk < 1 || l % chunk != 0 || dh < 1 || ds < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay = layout(chunk, dh, ds);
  const size_t bytes = lay.floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(h, b);
  ssd_scan_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<float*>(y), l, h, dh, ds, chunk,
      lay.ldb, lay.lds);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
