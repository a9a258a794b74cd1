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
// m % 128 == 0; here the product is formed in the kernel too, one thread per
// output element (row_matvec.cuh), for any (d, m) and any N.
//
// Bound: bytes.  N*d*m + N*m + N*d elements read and N*d written; every
// element of g is used once at 2 flops, far below the H100's ops-per-byte
// balance.  Index arithmetic runs in 32 bits when N*d fits.  Each launch runs
// on the caller's stream and reports cudaGetLastError() to the Python
// wrapper, which raises on failure.
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
