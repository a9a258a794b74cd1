// VJP of the fused Williamson 2N stage under diagonal noise, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sde_step/sde_step.py::
// ws_stage_diag_bwd_2d (pallas_call at line 182).  The stage
// (delta', y') = (a*delta + f*h + g*dW, y + b*delta') is linear in every
// array operand, so with common = ct_delta' + b*ct_y':
//
//     ct_delta = a*common     ct_f  = h*common
//     ct_g     = dW*common    ct_dW = g*common
//
// (ct_y = ct_y' needs no kernel; the step size carries no cotangent in the
// port, where it is a Python float of the grid.)  The reversible adjoint's
// backward sweep runs it once per replayed stage.
//
// Bound: bytes.  4 input streams and 4 output streams of the state dtype,
// 8 * N * sizeof(T) bytes (32 B per float32 element) against 6 floating
// operations per element, far below the H100's ops-per-byte balance.  The
// design (16-byte packs, grid-stride loop, masked tail) is in
// elementwise.cuh; every product and sum is rounded on its own, as in the
// plain PyTorch twin.  Each launch runs on the caller's stream and reports
// cudaGetLastError() to the Python wrapper, which raises on failure.
//
// A second entry per dtype (ws_stage_diag_bwd_rows_*) takes one step size
// per path (the replay of a step of an adaptively realized grid): h =
// h_vec[e / row_len], looked up per element because a 16-byte pack may
// straddle two rows; both entries run one kernel templated on where h comes
// from (elementwise.cuh's ScalarStep / PathStep).  Bound: (8 * N + N /
// row_len) * sizeof(T) bytes.
#include "elementwise.cuh"

namespace {

template <typename T>
__device__ __forceinline__ void stage_vjp(T ct_d2, T ct_y2, T g, T dw, T h,
                                          T a, T b, T& ct_delta, T& ct_f,
                                          T& ct_g, T& ct_dw) {
  using repro::add;
  using repro::mul;
  const T common = add(ct_d2, mul(b, ct_y2));
  ct_delta = mul(a, common);
  ct_f = mul(h, common);
  ct_g = mul(dw, common);
  ct_dw = mul(g, common);
}

template <typename T, typename Step>
__global__ void __launch_bounds__(repro::kThreads)
ws_stage_diag_bwd_kernel(const T* __restrict__ ct_d2,
                         const T* __restrict__ ct_y2, const T* __restrict__ g,
                         const T* __restrict__ dw, T* __restrict__ ct_delta,
                         T* __restrict__ ct_f, T* __restrict__ ct_g,
                         T* __restrict__ ct_dw, int64_t n_vec, int64_t work,
                         Step step, T a, T b) {
  using P = repro::Pack<T>;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < work; i += stride) {
    if (i < n_vec) {
      const P vd = reinterpret_cast<const P*>(ct_d2)[i];
      const P vy = reinterpret_cast<const P*>(ct_y2)[i];
      const P vg = reinterpret_cast<const P*>(g)[i];
      const P vw = reinterpret_cast<const P*>(dw)[i];
      P od, of, og, ow;
#pragma unroll
      for (int j = 0; j < P::kWidth; ++j) {
        stage_vjp(vd.v[j], vy.v[j], vg.v[j], vw.v[j], step(i * P::kWidth + j), a, b,
                  od.v[j], of.v[j], og.v[j], ow.v[j]);
      }
      reinterpret_cast<P*>(ct_delta)[i] = od;
      reinterpret_cast<P*>(ct_f)[i] = of;
      reinterpret_cast<P*>(ct_g)[i] = og;
      reinterpret_cast<P*>(ct_dw)[i] = ow;
    } else {
      const int64_t e = n_vec * P::kWidth + (i - n_vec);
      stage_vjp(ct_d2[e], ct_y2[e], g[e], dw[e], step(e), a, b, ct_delta[e],
                ct_f[e], ct_g[e], ct_dw[e]);
    }
  }
}

template <typename T, typename Step>
int launch(const void* ct_d2, const void* ct_y2, const void* g,
           const void* dw, void* ct_delta, void* ct_f, void* ct_g,
           void* ct_dw, int64_t n, Step step, double a, double b,
           void* stream) {
  const bool all_aligned =
      repro::aligned16(ct_d2) && repro::aligned16(ct_y2) &&
      repro::aligned16(g) && repro::aligned16(dw) &&
      repro::aligned16(ct_delta) && repro::aligned16(ct_f) &&
      repro::aligned16(ct_g) && repro::aligned16(ct_dw);
  const auto split = repro::split_work<T>(n, all_aligned);
  ws_stage_diag_bwd_kernel<T, Step>
      <<<repro::blocks_for(split.work), repro::kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(ct_d2), static_cast<const T*>(ct_y2),
          static_cast<const T*>(g), static_cast<const T*>(dw),
          static_cast<T*>(ct_delta), static_cast<T*>(ct_f),
          static_cast<T*>(ct_g), static_cast<T*>(ct_dw), split.n_vec,
          split.work, step, static_cast<T>(a), static_cast<T>(b));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ws_stage_diag_bwd_f32(const void* ct_d2, const void* ct_y2,
                                     const void* g, const void* dw,
                                     void* ct_delta, void* ct_f, void* ct_g,
                                     void* ct_dw, int64_t n, double h,
                                     double a, double b, void* stream) {
  return launch<float>(ct_d2, ct_y2, g, dw, ct_delta, ct_f, ct_g, ct_dw, n,
                       repro::ScalarStep<float>{static_cast<float>(h)}, a, b, stream);
}

extern "C" int ws_stage_diag_bwd_f64(const void* ct_d2, const void* ct_y2,
                                     const void* g, const void* dw,
                                     void* ct_delta, void* ct_f, void* ct_g,
                                     void* ct_dw, int64_t n, double h,
                                     double a, double b, void* stream) {
  return launch<double>(ct_d2, ct_y2, g, dw, ct_delta, ct_f, ct_g, ct_dw, n,
                        repro::ScalarStep<double>{h}, a, b, stream);
}

extern "C" int ws_stage_diag_bwd_rows_f32(const void* ct_d2, const void* ct_y2,
                                          const void* g, const void* dw,
                                          const void* h_vec, void* ct_delta,
                                          void* ct_f, void* ct_g, void* ct_dw,
                                          int64_t n, int64_t row_len, double a,
                                          double b, void* stream) {
  return launch<float>(ct_d2, ct_y2, g, dw, ct_delta, ct_f, ct_g, ct_dw, n,
                       repro::PathStep<float>{static_cast<const float*>(h_vec), row_len},
                       a, b, stream);
}

extern "C" int ws_stage_diag_bwd_rows_f64(const void* ct_d2, const void* ct_y2,
                                          const void* g, const void* dw,
                                          const void* h_vec, void* ct_delta,
                                          void* ct_f, void* ct_g, void* ct_dw,
                                          int64_t n, int64_t row_len, double a,
                                          double b, void* stream) {
  return launch<double>(ct_d2, ct_y2, g, dw, ct_delta, ct_f, ct_g, ct_dw, n,
                        repro::PathStep<double>{static_cast<const double*>(h_vec), row_len},
                        a, b, stream);
}
