// Driver-weighted increment under general noise, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sde_step/sde_step.py::
// increment_general_2d (pallas_call at line 112):
//
//     k = f*h + g@dW,   f (N, d), g (N, d, m), dW (N, m) -> k (N, d)
//
// Reversible Heun's and every Butcher/MCF stage's increment on a
// general-noise term.  The TPU kernel forms g@dW in its body with a batched
// dot on (128-row, d, m) blocks and compiles only for d % 8 == 0 and
// m % 128 == 0; here the product is formed in the kernel too, for any
// (d, m) and any N, on one of row_matvec.cuh's two routes: the row route
// (one thread per output, increment_general_<dtype>) for rows of at most
// 64 bytes, odd strides and unaligned operands, and the staged route
// (tiles of rows copied coalesced into a shared-memory ring,
// increment_general_<dtype>_staged) for the rest.
//
// Bound: bytes.  N*d*m + N*m + N*d elements read and N*d written; every
// element of g is used once at 2 flops, far below the H100's ops-per-byte
// balance, so the design is about reading g once, coalesced (row_matvec.cuh).
// Index arithmetic runs in 32 bits when N*d fits.  Each launch runs on the
// caller's stream and reports cudaGetLastError() to the Python wrapper,
// which raises on failure.
#include "row_matvec.cuh"

namespace {

template <typename T, typename I>
__global__ void __launch_bounds__(repro::kThreads)
increment_general_kernel(const T* __restrict__ f, const T* __restrict__ g,
                         const T* __restrict__ dw, T* __restrict__ out,
                         I total, I d, int m, bool packed, T h) {
  const I stride = static_cast<I>(gridDim.x) * blockDim.x;
  for (I e = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const I n = e / d;
    const T gdw = repro::row_dot(g + static_cast<int64_t>(e) * m,
                                 dw + static_cast<int64_t>(n) * m, m, packed);
    out[e] = repro::add(repro::mul(f[e], h), gdw);
  }
}

template <typename T>
int launch(const void* f, const void* g, const void* dw, void* out,
           int64_t n_rows, int d, int m, double h, void* stream) {
  if (d < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = n_rows * d;
  const bool packed = repro::rows_packed<T>(g, dw, m);
  const auto cast = [](const void* p) { return static_cast<const T*>(p); };
  const unsigned blocks = repro::blocks_for(total);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (total <= repro::kMaxIndex32) {
    increment_general_kernel<T, uint32_t><<<blocks, repro::kThreads, 0, s>>>(
        cast(f), cast(g), cast(dw), static_cast<T*>(out),
        static_cast<uint32_t>(total), static_cast<uint32_t>(d), m, packed,
        static_cast<T>(h));
  } else {
    increment_general_kernel<T, int64_t><<<blocks, repro::kThreads, 0, s>>>(
        cast(f), cast(g), cast(dw), static_cast<T*>(out), total,
        static_cast<int64_t>(d), m, packed, static_cast<T>(h));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename I>
__global__ void __launch_bounds__(repro::kStagedRows)
increment_general_kernel_staged(const __grid_constant__ CUtensorMap tm_g,
                                const __grid_constant__ CUtensorMap tm_w,
                                const T* __restrict__ f, const T* __restrict__ g,
                                const T* __restrict__ dw, T* __restrict__ out,
                                I total, I d, int m, T h) {
  repro::staged_matvec<T, I>(&tm_g, &tm_w, g, dw, total, d, m, [=](I e, T gdw) {
    out[e] = repro::add(repro::mul(f[e], h), gdw);
  });
}

template <typename T, typename I>
int launch_staged_as(const void* f, const void* g, const void* dw, void* out,
                     int64_t n_rows, int d, int m, double h, cudaStream_t s) {
  const auto kernel = increment_general_kernel_staged<T, I>;
  repro::StagedLaunch l;
  const int err = repro::staged_setup<T>(reinterpret_cast<const void*>(kernel), g,
                                         dw, n_rows, d, m, &l);
  if (err != 0) return err;
  kernel<<<l.blocks, repro::kStagedRows, l.smem, s>>>(
      l.tm_g, l.tm_w, static_cast<const T*>(f), static_cast<const T*>(g),
      static_cast<const T*>(dw), static_cast<T*>(out), static_cast<I>(n_rows * d),
      static_cast<I>(d), m, static_cast<T>(h));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_staged(const void* f, const void* g, const void* dw, void* out,
                  int64_t n_rows, int d, int m, double h, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d >= 1 && n_rows * d <= repro::kMaxIndex32)
    return launch_staged_as<T, uint32_t>(f, g, dw, out, n_rows, d, m, h, s);
  return launch_staged_as<T, int64_t>(f, g, dw, out, n_rows, d, m, h, s);
}

}  // namespace

extern "C" int increment_general_f32(const void* f, const void* g,
                                     const void* dw, void* out, int64_t n_rows,
                                     int d, int m, double h, void* stream) {
  return launch<float>(f, g, dw, out, n_rows, d, m, h, stream);
}

extern "C" int increment_general_f64(const void* f, const void* g,
                                     const void* dw, void* out, int64_t n_rows,
                                     int d, int m, double h, void* stream) {
  return launch<double>(f, g, dw, out, n_rows, d, m, h, stream);
}

extern "C" int increment_general_f32_staged(const void* f, const void* g,
                                            const void* dw, void* out,
                                            int64_t n_rows, int d, int m,
                                            double h, void* stream) {
  return launch_staged<float>(f, g, dw, out, n_rows, d, m, h, stream);
}

extern "C" int increment_general_f64_staged(const void* f, const void* g,
                                            const void* dw, void* out,
                                            int64_t n_rows, int d, int m,
                                            double h, void* stream) {
  return launch_staged<double>(f, g, dw, out, n_rows, d, m, h, stream);
}
