// Fused Williamson 2N stage under general noise, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sde_step/sde_step.py::
// ws_stage_general_2d (pallas_call at line 247):
//
//     k      = f*h + g@dW     g (N, d, m), dW (N, m)
//     delta' = a*delta + k    delta, y, f (N, d)
//     y'     = y + b*delta'
//
// every EES stage on a general-noise term.  The product g@dW is formed in
// the kernel, channels summed left to right, for any (d, m) and any N, on
// one of row_matvec.cuh's two routes: the row route (one thread per output,
// ws_stage_general_<dtype>) for rows of at most 64 bytes, odd strides and
// unaligned operands, and the staged route (tiles of rows copied coalesced
// into a shared-memory ring, ws_stage_general_<dtype>_staged) for the rest;
// the 2N update runs once per output after its sum.  The TPU kernel
// compiles only for d % 8 == 0 and m % 128 == 0 and pads N to 128 rows.
//
// Bound: bytes.  N*d*m + N*m + 3*N*d elements read and 2*N*d written; g
// dominates and each of its elements is used once at 2 flops, far below the
// H100's ops-per-byte balance.  Every product and sum is rounded on its own,
// as in the plain PyTorch twin.  h, a and b are scalar arguments; index
// arithmetic runs in 32 bits when N*d fits.  Each launch runs on the
// caller's stream and reports cudaGetLastError() to the Python wrapper,
// which raises on failure.
//
// A second entry per dtype and route (ws_stage_general_rows_<dtype>[_staged])
// takes one step size per path, as the reference's vmapped kernel does under
// an adaptive solve or a realized grid: h = h_vec[row / rows_per_path] for
// the row of d outputs that output e belongs to (row = e / d), looked up in
// the epilogue.  Both entries run one kernel templated on where h comes from
// (elementwise.cuh's ScalarStep / PathStep, row_matvec.cuh's visit_step), so
// the sum and the 2N update are the same operation by operation.  Bound: the
// scalar entry's bytes plus the h vector.
#include "row_matvec.cuh"

namespace {

template <typename T, typename I, typename Step>
__global__ void __launch_bounds__(repro::kThreads)
ws_stage_general_kernel(const T* __restrict__ delta, const T* __restrict__ y,
                        const T* __restrict__ f, const T* __restrict__ g,
                        const T* __restrict__ dw, T* __restrict__ d_out,
                        T* __restrict__ y_out, I total, I d, int m,
                        bool packed, Step step, T a, T b) {
  using repro::add;
  using repro::mul;
  const I stride = static_cast<I>(gridDim.x) * blockDim.x;
  for (I e = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const I n = e / d;
    const T gdw = repro::row_dot(g + static_cast<int64_t>(e) * m,
                                 dw + static_cast<int64_t>(n) * m, m, packed);
    const T k = add(mul(f[e], step(n)), gdw);
    const T d2 = add(mul(a, delta[e]), k);
    d_out[e] = d2;
    y_out[e] = add(y[e], mul(b, d2));
  }
}

template <typename T>
int launch(const void* delta, const void* y, const void* f, const void* g,
           const void* dw, void* d_out, void* y_out, int64_t n_rows, int d,
           int m, double h, const void* h_vec, int64_t rows_per_path, double a,
           double b, void* stream) {
  if (d < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = n_rows * d;
  const bool packed = repro::rows_packed<T>(g, dw, m);
  const auto cast = [](const void* p) { return static_cast<const T*>(p); };
  const unsigned blocks = repro::blocks_for(total);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (total <= repro::kMaxIndex32) {
    repro::visit_step<T, uint32_t>(h, h_vec, rows_per_path, [&](auto step) {
      ws_stage_general_kernel<T, uint32_t><<<blocks, repro::kThreads, 0, s>>>(
          cast(delta), cast(y), cast(f), cast(g), cast(dw),
          static_cast<T*>(d_out), static_cast<T*>(y_out),
          static_cast<uint32_t>(total), static_cast<uint32_t>(d), m, packed,
          step, static_cast<T>(a), static_cast<T>(b));
    });
  } else {
    repro::visit_step<T, int64_t>(h, h_vec, rows_per_path, [&](auto step) {
      ws_stage_general_kernel<T, int64_t><<<blocks, repro::kThreads, 0, s>>>(
          cast(delta), cast(y), cast(f), cast(g), cast(dw),
          static_cast<T*>(d_out), static_cast<T*>(y_out), total,
          static_cast<int64_t>(d), m, packed, step, static_cast<T>(a),
          static_cast<T>(b));
    });
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename I, typename Step>
__global__ void __launch_bounds__(repro::kStagedRows)
ws_stage_general_kernel_staged(const __grid_constant__ CUtensorMap tm_g,
                               const __grid_constant__ CUtensorMap tm_w,
                               const T* __restrict__ delta, const T* __restrict__ y,
                               const T* __restrict__ f, const T* __restrict__ g,
                               const T* __restrict__ dw, T* __restrict__ d_out,
                               T* __restrict__ y_out, I total, I d, int m, Step step,
                               T a, T b) {
  using repro::add;
  using repro::mul;
  repro::staged_matvec<T, I>(&tm_g, &tm_w, g, dw, total, d, m, [=](I e, T gdw) {
    const T k = add(mul(f[e], step(e / d)), gdw);
    const T d2 = add(mul(a, delta[e]), k);
    d_out[e] = d2;
    y_out[e] = add(y[e], mul(b, d2));
  });
}

template <typename T, typename I, typename Step>
int launch_staged_as(const void* delta, const void* y, const void* f,
                     const void* g, const void* dw, void* d_out, void* y_out,
                     int64_t n_rows, int d, int m, Step step, double a, double b,
                     cudaStream_t s) {
  const auto kernel = ws_stage_general_kernel_staged<T, I, Step>;
  repro::StagedLaunch l;
  const int err = repro::staged_setup<T>(reinterpret_cast<const void*>(kernel), g,
                                         dw, n_rows, d, m, &l);
  if (err != 0) return err;
  const auto cast = [](const void* p) { return static_cast<const T*>(p); };
  kernel<<<l.blocks, repro::kStagedRows, l.smem, s>>>(
      l.tm_g, l.tm_w, cast(delta), cast(y), cast(f), cast(g), cast(dw),
      static_cast<T*>(d_out), static_cast<T*>(y_out), static_cast<I>(n_rows * d),
      static_cast<I>(d), m, step, static_cast<T>(a), static_cast<T>(b));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_staged(const void* delta, const void* y, const void* f,
                  const void* g, const void* dw, void* d_out, void* y_out,
                  int64_t n_rows, int d, int m, double h, const void* h_vec,
                  int64_t rows_per_path, double a, double b, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  if (d >= 1 && n_rows * d <= repro::kMaxIndex32) {
    repro::visit_step<T, uint32_t>(h, h_vec, rows_per_path, [&](auto step) {
      err = launch_staged_as<T, uint32_t>(delta, y, f, g, dw, d_out, y_out, n_rows,
                                          d, m, step, a, b, s);
    });
  } else {
    repro::visit_step<T, int64_t>(h, h_vec, rows_per_path, [&](auto step) {
      err = launch_staged_as<T, int64_t>(delta, y, f, g, dw, d_out, y_out, n_rows,
                                         d, m, step, a, b, s);
    });
  }
  return err;
}

}  // namespace

extern "C" int ws_stage_general_f32(
    const void* delta, const void* y, const void* f, const void* g,
    const void* dw, void* d_out, void* y_out, int64_t n_rows, int d,
    int m, double h, double a, double b, void* stream) {
  return launch<float>(delta, y, f, g, dw, d_out, y_out, n_rows, d, m, h,
      nullptr, 0, a, b, stream);
}

extern "C" int ws_stage_general_f32_staged(
    const void* delta, const void* y, const void* f, const void* g,
    const void* dw, void* d_out, void* y_out, int64_t n_rows, int d,
    int m, double h, double a, double b, void* stream) {
  return launch_staged<float>(delta, y, f, g, dw, d_out, y_out, n_rows, d, m, h,
      nullptr, 0, a, b, stream);
}

extern "C" int ws_stage_general_f64(
    const void* delta, const void* y, const void* f, const void* g,
    const void* dw, void* d_out, void* y_out, int64_t n_rows, int d,
    int m, double h, double a, double b, void* stream) {
  return launch<double>(delta, y, f, g, dw, d_out, y_out, n_rows, d, m, h,
      nullptr, 0, a, b, stream);
}

extern "C" int ws_stage_general_f64_staged(
    const void* delta, const void* y, const void* f, const void* g,
    const void* dw, void* d_out, void* y_out, int64_t n_rows, int d,
    int m, double h, double a, double b, void* stream) {
  return launch_staged<double>(delta, y, f, g, dw, d_out, y_out, n_rows, d, m, h,
      nullptr, 0, a, b, stream);
}

extern "C" int ws_stage_general_rows_f32(
    const void* delta, const void* y, const void* f, const void* g,
    const void* dw, const void* h_vec, void* d_out, void* y_out,
    int64_t n_rows, int d, int m, int64_t rows_per_path, double a,
    double b, void* stream) {
  return launch<float>(delta, y, f, g, dw, d_out, y_out, n_rows, d, m, 0.0,
      h_vec, rows_per_path, a, b, stream);
}

extern "C" int ws_stage_general_rows_f32_staged(
    const void* delta, const void* y, const void* f, const void* g,
    const void* dw, const void* h_vec, void* d_out, void* y_out,
    int64_t n_rows, int d, int m, int64_t rows_per_path, double a,
    double b, void* stream) {
  return launch_staged<float>(delta, y, f, g, dw, d_out, y_out, n_rows, d, m, 0.0,
      h_vec, rows_per_path, a, b, stream);
}

extern "C" int ws_stage_general_rows_f64(
    const void* delta, const void* y, const void* f, const void* g,
    const void* dw, const void* h_vec, void* d_out, void* y_out,
    int64_t n_rows, int d, int m, int64_t rows_per_path, double a,
    double b, void* stream) {
  return launch<double>(delta, y, f, g, dw, d_out, y_out, n_rows, d, m, 0.0,
      h_vec, rows_per_path, a, b, stream);
}

extern "C" int ws_stage_general_rows_f64_staged(
    const void* delta, const void* y, const void* f, const void* g,
    const void* dw, const void* h_vec, void* d_out, void* y_out,
    int64_t n_rows, int d, int m, int64_t rows_per_path, double a,
    double b, void* stream) {
  return launch_staged<double>(delta, y, f, g, dw, d_out, y_out, n_rows, d, m, 0.0,
      h_vec, rows_per_path, a, b, stream);
}
