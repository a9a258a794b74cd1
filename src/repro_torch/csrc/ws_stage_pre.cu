// Fused Williamson 2N stage with a prediffused increment, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sde_step/sde_step.py::
// ws_stage_pre_2d (pallas_call at line 212):
//
//     k      = f*h + w        (w = g*dW, weighted once per solve)
//     delta' = a*delta + k
//     y'     = y + b*delta'
//
// every EES stage on an additive-noise term under solve()'s prediffused
// fast path.
//
// Bound: bytes.  4 input streams and 2 output streams of the state dtype,
// 6 * N * sizeof(T) bytes (24 B per float32 element) against 5 floating
// operations per element, far below the H100's ops-per-byte balance: one
// stream fewer than ws_stage_diag.  The design (16-byte packs, grid-stride
// loop, masked tail) is in elementwise.cuh; every product and sum is rounded
// on its own, so with w = g*dW the kernel gives ws_stage_diag's bits.  h, a
// and b are scalar arguments; each launch runs on the caller's stream and
// reports cudaGetLastError() to the Python wrapper, which raises on failure.
//
// A second entry per dtype (ws_stage_pre_rows_*) takes one step size per
// path, as the reference's vmapped kernel does over a realized grid: h =
// h_vec[e / row_len] for element e of a state whose rows of row_len elements
// are the paths.  Both entries run one kernel templated on where h comes
// from (elementwise.cuh's ScalarStep / PathStep), so the arithmetic is the
// same operation by operation; h is looked up per element inside the pack
// loop, as a pack may straddle two rows.  Bound: the scalar entry's bytes
// plus the h vector, (6 * N + N / row_len) * sizeof(T).
#include "elementwise.cuh"

namespace {

template <typename T>
__device__ __forceinline__ void stage(T delta, T y, T f, T w, T h, T a, T b,
                                      T& d_out, T& y_out) {
  using repro::add;
  using repro::mul;
  const T k = add(mul(f, h), w);
  d_out = add(mul(a, delta), k);
  y_out = add(y, mul(b, d_out));
}

template <typename T, typename Step>
__global__ void __launch_bounds__(repro::kThreads)
ws_stage_pre_kernel(const T* __restrict__ delta, const T* __restrict__ y,
                    const T* __restrict__ f, const T* __restrict__ w,
                    T* __restrict__ d_out, T* __restrict__ y_out,
                    int64_t n_vec, int64_t work, Step step, T a, T b) {
  using P = repro::Pack<T>;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < work; i += stride) {
    if (i < n_vec) {
      const P vd = reinterpret_cast<const P*>(delta)[i];
      const P vy = reinterpret_cast<const P*>(y)[i];
      const P vf = reinterpret_cast<const P*>(f)[i];
      const P vw = reinterpret_cast<const P*>(w)[i];
      P od, oy;
#pragma unroll
      for (int j = 0; j < P::kWidth; ++j) {
        stage(vd.v[j], vy.v[j], vf.v[j], vw.v[j], step(i * P::kWidth + j), a, b,
              od.v[j], oy.v[j]);
      }
      reinterpret_cast<P*>(d_out)[i] = od;
      reinterpret_cast<P*>(y_out)[i] = oy;
    } else {
      const int64_t e = n_vec * P::kWidth + (i - n_vec);
      stage(delta[e], y[e], f[e], w[e], step(e), a, b, d_out[e], y_out[e]);
    }
  }
}

template <typename T, typename Step>
int launch(const void* delta, const void* y, const void* f, const void* w,
           void* d_out, void* y_out, int64_t n, Step step, double a, double b,
           void* stream) {
  const bool all_aligned =
      repro::aligned16(delta) && repro::aligned16(y) && repro::aligned16(f) &&
      repro::aligned16(w) && repro::aligned16(d_out) &&
      repro::aligned16(y_out);
  const auto split = repro::split_work<T>(n, all_aligned);
  ws_stage_pre_kernel<T, Step>
      <<<repro::blocks_for(split.work), repro::kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(delta), static_cast<const T*>(y),
          static_cast<const T*>(f), static_cast<const T*>(w),
          static_cast<T*>(d_out), static_cast<T*>(y_out), split.n_vec,
          split.work, step, static_cast<T>(a), static_cast<T>(b));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ws_stage_pre_f32(const void* delta, const void* y,
                                const void* f, const void* w, void* d_out,
                                void* y_out, int64_t n, double h, double a,
                                double b, void* stream) {
  return launch<float>(delta, y, f, w, d_out, y_out, n,
                       repro::ScalarStep<float>{static_cast<float>(h)}, a, b,
                       stream);
}

extern "C" int ws_stage_pre_f64(const void* delta, const void* y,
                                const void* f, const void* w, void* d_out,
                                void* y_out, int64_t n, double h, double a,
                                double b, void* stream) {
  return launch<double>(delta, y, f, w, d_out, y_out, n,
                        repro::ScalarStep<double>{h}, a, b, stream);
}

extern "C" int ws_stage_pre_rows_f32(const void* delta, const void* y,
                                     const void* f, const void* w,
                                     const void* h_vec, void* d_out,
                                     void* y_out, int64_t n, int64_t row_len,
                                     double a, double b, void* stream) {
  return launch<float>(
      delta, y, f, w, d_out, y_out, n,
      repro::PathStep<float>{static_cast<const float*>(h_vec), row_len}, a, b,
      stream);
}

extern "C" int ws_stage_pre_rows_f64(const void* delta, const void* y,
                                     const void* f, const void* w,
                                     const void* h_vec, void* d_out,
                                     void* y_out, int64_t n, int64_t row_len,
                                     double a, double b, void* stream) {
  return launch<double>(
      delta, y, f, w, d_out, y_out, n,
      repro::PathStep<double>{static_cast<const double*>(h_vec), row_len}, a, b,
      stream);
}
