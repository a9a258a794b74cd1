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
// here they stay where they are, so no stacked copy is made (it would double
// the bytes moved).  The chain length s is a template parameter: the host
// picks the kernel built for its s (1..kMaxIncs), whose body has no
// predicate and keeps the coefficients in registers, and each s has its own
// exported entry, so the increments and coefficients travel as plain
// arguments.  A longer chain is split by the wrapper into consecutive
// launches, which keeps the accumulation order.  The stream itself (loads in
// flight, one-pass grid, tail in the last block, load hints) is
// stream.cuh's; every product and sum is rounded on its own, as in
// the plain PyTorch twin.  Each launch runs on the caller's stream and
// reports cudaGetLastError() to the Python wrapper, which raises on failure.
#include "stream.cuh"

namespace {

constexpr int kMaxIncs = 8;  // MAX_INCS in kernels/sde_step/sde_step.py

template <typename T, int S>
struct Chain {
  T c[S];
  __device__ __forceinline__ T operator()(const T (&x)[S + 1]) const {
    T acc = x[0];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      acc = repro::add(acc, repro::mul(c[k], x[k + 1]));
    }
    return acc;
  }
};

template <typename T, int S, int W>
__global__ void __launch_bounds__(repro::stream::kThreads)
axpy_chain_kernel(const repro::stream::Streams<T, S + 1> s,
                  const Chain<T, S> op, repro::stream::Index n_vec,
                  repro::stream::Index n) {
  repro::stream::map_block<W>(s, op, n_vec, n);
}

template <typename T, int S>
int launch(const void* y, const void* const (&incs)[S],
           const double (&coeffs)[S], void* out, int64_t n, void* stream) {
  static_assert(S >= 1 && S <= kMaxIncs, "chain length out of range");
  repro::stream::Streams<T, S + 1> s{};
  Chain<T, S> op{};
  s.in[0] = static_cast<const T*>(y);
  for (int k = 0; k < S; ++k) {
    s.in[k + 1] = static_cast<const T*>(incs[k]);
    op.c[k] = static_cast<T>(coeffs[k]);
  }
  s.out = static_cast<T*>(out);
  return repro::stream::dispatch(s, [&](auto width) {
    constexpr int W = decltype(width)::value;
    axpy_chain_kernel<T, S, W>
        <<<repro::stream::blocks<W>(n), repro::stream::kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(s, op, n / W, n);
  });
}

}  // namespace

// axpy_chain_<f32|f64>_s<S>(y, out, n, stream, inc_0..inc_{S-1},
// c_0..c_{S-1}): one exported entry per dtype and chain length.
#define REPRO_INCS_1 const void* i0
#define REPRO_INCS_2 REPRO_INCS_1, const void* i1
#define REPRO_INCS_3 REPRO_INCS_2, const void* i2
#define REPRO_INCS_4 REPRO_INCS_3, const void* i3
#define REPRO_INCS_5 REPRO_INCS_4, const void* i4
#define REPRO_INCS_6 REPRO_INCS_5, const void* i5
#define REPRO_INCS_7 REPRO_INCS_6, const void* i6
#define REPRO_INCS_8 REPRO_INCS_7, const void* i7
#define REPRO_COEFFS_1 double c0
#define REPRO_COEFFS_2 REPRO_COEFFS_1, double c1
#define REPRO_COEFFS_3 REPRO_COEFFS_2, double c2
#define REPRO_COEFFS_4 REPRO_COEFFS_3, double c3
#define REPRO_COEFFS_5 REPRO_COEFFS_4, double c4
#define REPRO_COEFFS_6 REPRO_COEFFS_5, double c5
#define REPRO_COEFFS_7 REPRO_COEFFS_6, double c6
#define REPRO_COEFFS_8 REPRO_COEFFS_7, double c7
#define REPRO_I_1 i0
#define REPRO_I_2 REPRO_I_1, i1
#define REPRO_I_3 REPRO_I_2, i2
#define REPRO_I_4 REPRO_I_3, i3
#define REPRO_I_5 REPRO_I_4, i4
#define REPRO_I_6 REPRO_I_5, i5
#define REPRO_I_7 REPRO_I_6, i6
#define REPRO_I_8 REPRO_I_7, i7
#define REPRO_C_1 c0
#define REPRO_C_2 REPRO_C_1, c1
#define REPRO_C_3 REPRO_C_2, c2
#define REPRO_C_4 REPRO_C_3, c3
#define REPRO_C_5 REPRO_C_4, c4
#define REPRO_C_6 REPRO_C_5, c5
#define REPRO_C_7 REPRO_C_6, c6
#define REPRO_C_8 REPRO_C_7, c7

#define REPRO_AXPY_ENTRY(SFX, T, S)                                          \
  extern "C" int axpy_chain_##SFX##_s##S(const void* y, void* out,          \
                                         int64_t n, void* stream,           \
                                         REPRO_INCS_##S, REPRO_COEFFS_##S) { \
    return launch<T, S>(y, {REPRO_I_##S}, {REPRO_C_##S}, out, n, stream);   \
  }
#define REPRO_AXPY_ENTRIES(S) \
  REPRO_AXPY_ENTRY(f32, float, S) REPRO_AXPY_ENTRY(f64, double, S)

REPRO_AXPY_ENTRIES(1)
REPRO_AXPY_ENTRIES(2)
REPRO_AXPY_ENTRIES(3)
REPRO_AXPY_ENTRIES(4)
REPRO_AXPY_ENTRIES(5)
REPRO_AXPY_ENTRIES(6)
REPRO_AXPY_ENTRIES(7)
REPRO_AXPY_ENTRIES(8)
