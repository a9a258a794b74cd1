// Butcher axpy chain, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sde_step/sde_step.py::
// axpy_chain_2d (pallas_call at line 286):
//
//     out = y + sum_i c_i * inc_i,   accumulated as acc = y; acc = acc + c_i*inc_i
//
// the stage preparation and output combination of ButcherSolver (and so of
// every MCF coupling), with the coefficients known on the host.
//
// Bound: bytes.  1 + s input streams and 1 output stream of the state dtype,
// (s + 2) * N * sizeof(T) bytes against 2s floating operations per element.
// The TPU kernel takes the increments stacked into one (s, rows, 128) array;
// here they stay where they are: up to kMaxIncs increment pointers and their
// coefficients travel by value in one argument struct, so no stacked copy is
// made (it would double the bytes moved).  A longer chain is split by the
// wrapper into consecutive launches, which keeps the accumulation order.
// The design (16-byte packs, grid-stride loop, masked tail) is in
// elementwise.cuh; every product and sum is rounded on its own, as in the
// plain PyTorch twin.  Each launch runs on the caller's stream and reports
// cudaGetLastError() to the Python wrapper, which raises on failure.
#include "elementwise.cuh"

namespace {

constexpr int kMaxIncs = 8;  // MAX_INCS in kernels/sde_step/sde_step.py

template <typename T>
struct ChainArgs {
  const T* y;
  const T* incs[kMaxIncs];
  T coeffs[kMaxIncs];
  T* out;
  int s;
};

template <typename T>
__global__ void __launch_bounds__(repro::kThreads)
axpy_chain_kernel(const ChainArgs<T> p, int64_t n_vec, int64_t work) {
  using P = repro::Pack<T>;
  using repro::add;
  using repro::mul;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < work; i += stride) {
    if (i < n_vec) {
      P acc = reinterpret_cast<const P*>(p.y)[i];
#pragma unroll
      for (int k = 0; k < kMaxIncs; ++k) {
        if (k < p.s) {
          const P v = reinterpret_cast<const P*>(p.incs[k])[i];
#pragma unroll
          for (int j = 0; j < P::kWidth; ++j) {
            acc.v[j] = add(acc.v[j], mul(p.coeffs[k], v.v[j]));
          }
        }
      }
      reinterpret_cast<P*>(p.out)[i] = acc;
    } else {
      const int64_t e = n_vec * P::kWidth + (i - n_vec);
      T acc = p.y[e];
#pragma unroll
      for (int k = 0; k < kMaxIncs; ++k) {
        if (k < p.s) acc = add(acc, mul(p.coeffs[k], p.incs[k][e]));
      }
      p.out[e] = acc;
    }
  }
}

template <typename T>
int launch(const void* y, const void* const* incs, const double* coeffs,
           int s, void* out, int64_t n, void* stream) {
  if (s < 1 || s > kMaxIncs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ChainArgs<T> p{};
  p.y = static_cast<const T*>(y);
  p.out = static_cast<T*>(out);
  p.s = s;
  bool all_aligned = repro::aligned16(y) && repro::aligned16(out);
  for (int k = 0; k < s; ++k) {
    p.incs[k] = static_cast<const T*>(incs[k]);
    p.coeffs[k] = static_cast<T>(coeffs[k]);
    all_aligned = all_aligned && repro::aligned16(incs[k]);
  }
  const auto split = repro::split_work<T>(n, all_aligned);
  axpy_chain_kernel<T><<<repro::blocks_for(split.work), repro::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(p, split.n_vec,
                                                              split.work);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int axpy_chain_f32(const void* y, const void* const* incs,
                              const double* coeffs, int s, void* out,
                              int64_t n, void* stream) {
  return launch<float>(y, incs, coeffs, s, out, n, stream);
}

extern "C" int axpy_chain_f64(const void* y, const void* const* incs,
                              const double* coeffs, int s, void* out,
                              int64_t n, void* stream) {
  return launch<double>(y, incs, coeffs, s, out, n, stream);
}
