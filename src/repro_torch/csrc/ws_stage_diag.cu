// Fused Williamson 2N stage under diagonal noise, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sde_step/sde_step.py::
// ws_stage_diag_2d (pallas_call at line 144):
//
//     k      = f*h + g*dW
//     delta' = a*delta + k
//     y'     = y + b*delta'
//
// Bound: bytes.  5 input streams and 2 output streams of the state dtype,
// 7 * N * sizeof(T) bytes (28 B per float32 element) against 6 floating
// operations per element, far below the H100's ops-per-byte balance.  The
// design (16-byte packs, grid-stride loop, masked tail) is in
// elementwise.cuh.  h, a and b are scalar arguments (a and b are static in
// the reference); each launch runs on the caller's stream and reports
// cudaGetLastError() to the Python wrapper, which raises on failure.
#include "elementwise.cuh"

namespace {

template <typename T>
__device__ __forceinline__ void stage(T delta, T y, T f, T g, T dw, T h, T a,
                                      T b, T& d_out, T& y_out) {
  using repro::add;
  using repro::mul;
  const T k = add(mul(f, h), mul(g, dw));
  d_out = add(mul(a, delta), k);
  y_out = add(y, mul(b, d_out));
}

template <typename T>
__global__ void __launch_bounds__(repro::kThreads)
ws_stage_diag_kernel(const T* __restrict__ delta, const T* __restrict__ y,
                     const T* __restrict__ f, const T* __restrict__ g,
                     const T* __restrict__ dw, T* __restrict__ d_out,
                     T* __restrict__ y_out, int64_t n_vec, int64_t work, T h,
                     T a, T b) {
  using P = repro::Pack<T>;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < work; i += stride) {
    if (i < n_vec) {
      const P vd = reinterpret_cast<const P*>(delta)[i];
      const P vy = reinterpret_cast<const P*>(y)[i];
      const P vf = reinterpret_cast<const P*>(f)[i];
      const P vg = reinterpret_cast<const P*>(g)[i];
      const P vw = reinterpret_cast<const P*>(dw)[i];
      P od, oy;
#pragma unroll
      for (int j = 0; j < P::kWidth; ++j) {
        stage(vd.v[j], vy.v[j], vf.v[j], vg.v[j], vw.v[j], h, a, b, od.v[j],
              oy.v[j]);
      }
      reinterpret_cast<P*>(d_out)[i] = od;
      reinterpret_cast<P*>(y_out)[i] = oy;
    } else {
      const int64_t e = n_vec * P::kWidth + (i - n_vec);
      stage(delta[e], y[e], f[e], g[e], dw[e], h, a, b, d_out[e], y_out[e]);
    }
  }
}

template <typename T>
int launch(const void* delta, const void* y, const void* f, const void* g,
           const void* dw, void* d_out, void* y_out, int64_t n, double h,
           double a, double b, void* stream) {
  const bool all_aligned =
      repro::aligned16(delta) && repro::aligned16(y) && repro::aligned16(f) &&
      repro::aligned16(g) && repro::aligned16(dw) && repro::aligned16(d_out) &&
      repro::aligned16(y_out);
  const auto split = repro::split_work<T>(n, all_aligned);
  ws_stage_diag_kernel<T>
      <<<repro::blocks_for(split.work), repro::kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(delta), static_cast<const T*>(y),
          static_cast<const T*>(f), static_cast<const T*>(g),
          static_cast<const T*>(dw), static_cast<T*>(d_out),
          static_cast<T*>(y_out), split.n_vec, split.work, static_cast<T>(h),
          static_cast<T>(a), static_cast<T>(b));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ws_stage_diag_f32(const void* delta, const void* y,
                                 const void* f, const void* g, const void* dw,
                                 void* d_out, void* y_out, int64_t n, double h,
                                 double a, double b, void* stream) {
  return launch<float>(delta, y, f, g, dw, d_out, y_out, n, h, a, b, stream);
}

extern "C" int ws_stage_diag_f64(const void* delta, const void* y,
                                 const void* f, const void* g, const void* dw,
                                 void* d_out, void* y_out, int64_t n, double h,
                                 double a, double b, void* stream) {
  return launch<double>(delta, y, f, g, dw, d_out, y_out, n, h, a, b, stream);
}
