// Williamson 2N register update with the increment given, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/williamson2n/williamson2n.py::
// williamson2n_2d (pallas_call at line 56):
//
//     delta' = a*delta + k
//     y'     = y + b*delta'
//
// It serves the stages whose increment is formed outside the fused stage
// kernel (ODE mode and scalar noise).  Bound: bytes.  3 input streams and 2
// output streams, 5 * N * sizeof(T) bytes (20 B per float32 element) against
// 4 floating operations per element.  Design as in elementwise.cuh; a and b
// are scalar arguments (static in the reference).
#include "elementwise.cuh"

namespace {

template <typename T>
__device__ __forceinline__ void update(T delta, T k, T y, T a, T b, T& d_out,
                                       T& y_out) {
  using repro::add;
  using repro::mul;
  d_out = add(mul(a, delta), k);
  y_out = add(y, mul(b, d_out));
}

template <typename T>
__global__ void __launch_bounds__(repro::kThreads)
williamson2n_kernel(const T* __restrict__ delta, const T* __restrict__ k,
                    const T* __restrict__ y, T* __restrict__ d_out,
                    T* __restrict__ y_out, int64_t n_vec, int64_t work, T a,
                    T b) {
  using P = repro::Pack<T>;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < work; i += stride) {
    if (i < n_vec) {
      const P vd = reinterpret_cast<const P*>(delta)[i];
      const P vk = reinterpret_cast<const P*>(k)[i];
      const P vy = reinterpret_cast<const P*>(y)[i];
      P od, oy;
#pragma unroll
      for (int j = 0; j < P::kWidth; ++j) {
        update(vd.v[j], vk.v[j], vy.v[j], a, b, od.v[j], oy.v[j]);
      }
      reinterpret_cast<P*>(d_out)[i] = od;
      reinterpret_cast<P*>(y_out)[i] = oy;
    } else {
      const int64_t e = n_vec * P::kWidth + (i - n_vec);
      update(delta[e], k[e], y[e], a, b, d_out[e], y_out[e]);
    }
  }
}

template <typename T>
int launch(const void* delta, const void* k, const void* y, void* d_out,
           void* y_out, int64_t n, double a, double b, void* stream) {
  const bool all_aligned = repro::aligned16(delta) && repro::aligned16(k) &&
                           repro::aligned16(y) && repro::aligned16(d_out) &&
                           repro::aligned16(y_out);
  const auto split = repro::split_work<T>(n, all_aligned);
  williamson2n_kernel<T>
      <<<repro::blocks_for(split.work), repro::kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(delta), static_cast<const T*>(k),
          static_cast<const T*>(y), static_cast<T*>(d_out),
          static_cast<T*>(y_out), split.n_vec, split.work, static_cast<T>(a),
          static_cast<T>(b));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int williamson2n_f32(const void* delta, const void* k, const void* y,
                                void* d_out, void* y_out, int64_t n, double a,
                                double b, void* stream) {
  return launch<float>(delta, k, y, d_out, y_out, n, a, b, stream);
}

extern "C" int williamson2n_f64(const void* delta, const void* k, const void* y,
                                void* d_out, void* y_out, int64_t n, double a,
                                double b, void* stream) {
  return launch<double>(delta, k, y, d_out, y_out, n, a, b, stream);
}
