// The per-row matvec of the port's general-noise SDE-step kernels (sm_90a).
//
// Under general noise the diffusion of one path is a (d, m) matrix g and
// its Brownian increment an m-vector dW; the increment's noise part is
// g@dW, one d-vector per path.  One thread owns one output element (path n,
// component i) and reduces row i of that path's g against dW:
//
//     acc = g[0]*dW[0];  acc = acc + g[j]*dW[j]  for j = 1 .. m-1
//
// in that order, each product and sum rounded on its own (the plain PyTorch
// twin sums in the same order), so kernel and twin agree bitwise.
//
// Every element of g is read once and used once (2 flops per 4 bytes in
// float32), so the kernels are bound by HBM bandwidth, not by the tensor
// cores; a row of g is m contiguous values, and neighbouring threads own
// neighbouring rows, so at m = 4 (float32) each thread loads one 16-byte
// pack and a warp's loads are contiguous.  Rows are read as 16-byte packs
// whenever m is a multiple of the pack width and g and dW are 16-byte
// aligned, else element by element; the dW row of a path is shared by its d
// threads and comes from L1.  Any (d, m) and any number of paths run: the
// ragged end is masked, never padded.
#pragma once

#include "elementwise.cuh"

namespace repro {

// Launches over at most this many outputs index in 32 bits (a grid-stride
// step adds at most kMaxBlocks * kThreads, which stays below 2^32).
constexpr int64_t kMaxIndex32 = 2147483647;

template <typename T>
__device__ __forceinline__ T row_dot(const T* __restrict__ g,
                                     const T* __restrict__ w, int m,
                                     bool packed) {
  if (packed) {
    using P = Pack<T>;
    const P* gp = reinterpret_cast<const P*>(g);
    const P* wp = reinterpret_cast<const P*>(w);
    P vg = gp[0];
    P vw = wp[0];
    T acc = mul(vg.v[0], vw.v[0]);
#pragma unroll
    for (int j = 1; j < P::kWidth; ++j) acc = add(acc, mul(vg.v[j], vw.v[j]));
    for (int p = 1; p < m / P::kWidth; ++p) {
      vg = gp[p];
      vw = wp[p];
#pragma unroll
      for (int j = 0; j < P::kWidth; ++j) acc = add(acc, mul(vg.v[j], vw.v[j]));
    }
    return acc;
  }
  T acc = mul(g[0], w[0]);
  for (int j = 1; j < m; ++j) acc = add(acc, mul(g[j], w[j]));
  return acc;
}

template <typename T>
inline bool rows_packed(const void* g, const void* w, int m) {
  return m % Pack<T>::kWidth == 0 && aligned16(g) && aligned16(w);
}

}  // namespace repro
