// Prediffused driver-weighted increment, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sde_step/sde_step.py::
// increment_pre_2d (pallas_call at line 85):
//
//     k = f*h + w,    w = g*dW hoisted out of the step loop
//
// the increment of Reversible Heun and every Butcher/MCF stage on an
// additive-noise term whose whole increment buffer was weighted by the
// diffusion once per solve (solve()'s prediffused fast path).
//
// Bound: bytes.  2 input streams and 1 output stream of the state dtype,
// 3 * N * sizeof(T) bytes (12 B per float32 element) against 2 floating
// operations per element, far below the H100's ops-per-byte balance: one
// stream fewer than increment_diag, which is what hoisting g*dW buys.  The
// stream (loads in flight, one-pass grid, tail in the last block, load
// hints) is stream.cuh's; the product and the sum are rounded
// one by one, as in the plain PyTorch twin.  Each launch runs on the
// caller's stream and reports cudaGetLastError() to the Python wrapper,
// which raises on failure.
#include "stream.cuh"

namespace {

template <typename T>
struct Increment {
  T h;
  __device__ __forceinline__ T operator()(const T (&x)[2]) const {
    return repro::add(repro::mul(x[0], h), x[1]);
  }
};

template <typename T, int W>
__global__ void __launch_bounds__(repro::stream::kThreads)
increment_pre_kernel(const repro::stream::Streams<T, 2> s,
                     const Increment<T> op, repro::stream::Index n_vec,
                     repro::stream::Index n) {
  repro::stream::map_block<W>(s, op, n_vec, n);
}

template <typename T>
int launch(const void* f, const void* w, void* out, int64_t n, double h,
           void* stream) {
  const repro::stream::Streams<T, 2> s{
      {static_cast<const T*>(f), static_cast<const T*>(w)},
      static_cast<T*>(out)};
  const Increment<T> op{static_cast<T>(h)};
  return repro::stream::dispatch(s, [&](auto width) {
    constexpr int W = decltype(width)::value;
    increment_pre_kernel<T, W>
        <<<repro::stream::blocks<W>(n), repro::stream::kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(s, op, n / W, n);
  });
}

}  // namespace

extern "C" int increment_pre_f32(const void* f, const void* w, void* out,
                                 int64_t n, double h, void* stream) {
  return launch<float>(f, w, out, n, h, stream);
}

extern "C" int increment_pre_f64(const void* f, const void* w, void* out,
                                 int64_t n, double h, void* stream) {
  return launch<double>(f, w, out, n, h, stream);
}
