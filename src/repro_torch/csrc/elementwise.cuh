// Shared pieces of the port's elementwise SDE-step kernels (sm_90a).
//
// Both kernels are streams over a flat state: every element of every input
// is read once and every output element written once, so on an H100 they are
// bound by HBM bandwidth (3.35 TB/s), not by arithmetic.  The design answers
// that bound with the plainest shape that reaches it:
//
//  * 16-byte loads and stores per thread (float4 / double2 packs) when every
//    pointer is 16-byte aligned, neighbouring threads on neighbouring packs;
//  * a grid-stride loop, so any element count runs with a capped grid;
//  * a masked ragged tail handled element by element in the same launch,
//    instead of padding the state to a tile as the TPU kernels do.
//
// The arithmetic uses explicitly rounded multiplies and adds (no FMA
// contraction), so each kernel repeats the rounding of its plain PyTorch twin
// operation by operation.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }

// 16 bytes of T, loaded and stored as one vector access.
template <typename T>
struct alignas(16) Pack {
  static constexpr int kWidth = 16 / sizeof(T);
  T v[kWidth];
};

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 8192;

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Work items of a launch over n elements: n_vec packs (0 when a pointer is
// unaligned) followed by the n - n_vec * width tail elements one by one.
struct Split {
  int64_t n_vec;
  int64_t work;
};

template <typename T>
inline Split split_work(int64_t n, bool all_aligned) {
  const int64_t n_vec = all_aligned ? n / Pack<T>::kWidth : 0;
  return {n_vec, n_vec + (n - n_vec * Pack<T>::kWidth)};
}

inline unsigned blocks_for(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

// The step size of item i (an element, or a row of a general-noise launch):
// one scalar for the whole launch, or one value a path read from a device
// vector, h_vec[i / per_path] for paths of per_path items each (an adaptive
// solve's per-path steps).  A kernel templated on the step runs the same
// arithmetic either way; only where h comes from differs.
template <typename T, typename I = int64_t>
struct ScalarStep {
  T h;
  __device__ __forceinline__ T operator()(I) const { return h; }
};

template <typename T, typename I = int64_t>
struct PathStep {
  const T* h_vec;
  I per_path;
  __device__ __forceinline__ T operator()(I i) const { return h_vec[i / per_path]; }
};

}  // namespace repro

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
