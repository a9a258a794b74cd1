// Driver-weighted increment under diagonal noise, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sde_step/sde_step.py::
// increment_diag_2d (pallas_call at line 65):
//
//     k = f*h + g*dW
//
// Reversible Heun forms two of these per step and every Butcher/MCF stage
// one (SDETerm.combine with use_kernels).
//
// Bound: bytes.  3 input streams and 1 output stream of the state dtype,
// 4 * N * sizeof(T) bytes (16 B per float32 element) against 3 floating
// operations per element, far below the H100's ops-per-byte balance.  The
// design (16-byte packs, grid-stride loop, masked tail) is in
// elementwise.cuh; the products and the sum are rounded one by one, as in
// the plain PyTorch twin.  Each launch runs on the caller's stream and
// reports cudaGetLastError() to the Python wrapper, which raises on failure.
#include "elementwise.cuh"

namespace {

template <typename T>
__device__ __forceinline__ T increment(T f, T g, T dw, T h) {
  return repro::add(repro::mul(f, h), repro::mul(g, dw));
}

template <typename T>
__global__ void __launch_bounds__(repro::kThreads)
increment_diag_kernel(const T* __restrict__ f, const T* __restrict__ g,
                      const T* __restrict__ dw, T* __restrict__ out,
                      int64_t n_vec, int64_t work, T h) {
  using P = repro::Pack<T>;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < work; i += stride) {
    if (i < n_vec) {
      const P vf = reinterpret_cast<const P*>(f)[i];
      const P vg = reinterpret_cast<const P*>(g)[i];
      const P vw = reinterpret_cast<const P*>(dw)[i];
      P o;
#pragma unroll
      for (int j = 0; j < P::kWidth; ++j) {
        o.v[j] = increment(vf.v[j], vg.v[j], vw.v[j], h);
      }
      reinterpret_cast<P*>(out)[i] = o;
    } else {
      const int64_t e = n_vec * P::kWidth + (i - n_vec);
      out[e] = increment(f[e], g[e], dw[e], h);
    }
  }
}

template <typename T>
int launch(const void* f, const void* g, const void* dw, void* out, int64_t n,
           double h, void* stream) {
  const bool all_aligned = repro::aligned16(f) && repro::aligned16(g) &&
                           repro::aligned16(dw) && repro::aligned16(out);
  const auto split = repro::split_work<T>(n, all_aligned);
  increment_diag_kernel<T>
      <<<repro::blocks_for(split.work), repro::kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(f), static_cast<const T*>(g),
          static_cast<const T*>(dw), static_cast<T*>(out), split.n_vec,
          split.work, static_cast<T>(h));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int increment_diag_f32(const void* f, const void* g, const void* dw,
                                  void* out, int64_t n, double h,
                                  void* stream) {
  return launch<float>(f, g, dw, out, n, h, stream);
}

extern "C" int increment_diag_f64(const void* f, const void* g, const void* dw,
                                  void* out, int64_t n, double h,
                                  void* stream) {
  return launch<double>(f, g, dw, out, n, h, stream);
}
