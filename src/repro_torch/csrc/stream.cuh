// Shared pieces of the port's redesigned streaming kernels (sm_90a).
//
// A streaming kernel reads kIn arrays once and writes one: out[i] =
// op(in_0[i], ..., in_{kIn-1}[i]).  On an H100 it is bound by HBM bandwidth
// (3.35 TB/s), and at the sizes the port's paths run (4,096 to a few million
// elements) by the fixed costs around the stream: the launch, the first
// round trip to memory, the last block.  The design answers those costs:
//
//  * a thread takes kVecs 16-byte vectors of each input stream and issues
//    every load before any arithmetic.  kVecs = 1: more vectors a thread
//    (2, 4) shorten the L2-flushed time at 2^20 elements by ~0.3 us but
//    lengthen the warm time by as much, and fewer, fatter blocks leave SMs
//    idle at 4,096 elements; a stage's inputs were just written by the
//    stage before, so the warm time is the one a solver sees;
//  * one pass: block b takes the b-th tile of kThreads * kVecs vectors and
//    no block loops, so the grid is the array's tiles and nothing else;
//  * the tile test is block-uniform: every block but the last runs a body
//    with no bounds checks, and the last block takes the partial tile and
//    the ragged tail (the elements past the last whole vector);
//  * 64-bit indices (Index): 32-bit ones measured no faster;
//  * loads and stores take the default cache policy.  The next stage reads
//    the output from L2, and when the L2 is full of other dirty lines (as
//    after a flush), streaming (evict-first) or non-coherent no-allocate
//    loads leave the inputs first in line for eviction, and the warm time
//    at 2^20 elements grows with them (evict-first stores cost more still);
//  * an unaligned pointer (a view at an odd offset) drops the whole launch
//    to one-element vectors through the same body, so no pointer is ever
//    read past its alignment.
//
// benchmarks/stream_variants.py builds and times each of these choices
// against its alternative.  The arithmetic stays the kernels' own (the
// explicitly rounded mul/add of elementwise.cuh), so each equals its plain
// PyTorch twin bitwise.
#pragma once

#include <type_traits>

#include "elementwise.cuh"

namespace repro {
namespace stream {

constexpr int kThreads = 256;
constexpr int kVecs = 1;  // vectors a thread takes per input stream
using Index = int64_t;

// W elements of T, moved as one access (16 bytes when W = 16 / sizeof(T)).
template <typename T, int W>
struct alignas(sizeof(T) * W) Vec {
  T v[W];
};

// Input and output pointers of one launch.
template <typename T, int kIn>
struct Streams {
  const T* in[kIn];
  T* out;
};

template <typename T, int W>
__device__ __forceinline__ void load(const T* p, Vec<T, W>& x) {
  x = *reinterpret_cast<const Vec<T, W>*>(p);
}

template <typename T, int W>
__device__ __forceinline__ void store(T* p, const Vec<T, W>& x) {
  *reinterpret_cast<Vec<T, W>*>(p) = x;
}

// op over the W lanes of kIn vectors whose first element is element i of
// the stream.  An op that takes the element's index as well, op(e, i),
// gets it (a per-path step read from a device vector); op(e) does not.
template <typename T, int W, int kIn, typename Op>
__device__ __forceinline__ Vec<T, W> apply(const Op& op,
                                           const Vec<T, W> (&x)[kIn], Index i) {
  Vec<T, W> o;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    T e[kIn];
#pragma unroll
    for (int k = 0; k < kIn; ++k) e[k] = x[k].v[j];
    if constexpr (std::is_invocable_v<const Op&, const T (&)[kIn], Index>) {
      o.v[j] = op(e, i + j);
    } else {
      o.v[j] = op(e);
    }
  }
  return o;
}

// Tile b's share of out = op(in...) over n elements, n_vec = n / W of them in
// whole vectors: kThreads * kVecs vectors (fewer in the last tile), and in
// the last tile also the elements past the last whole vector.
template <int W, typename T, int kIn, typename Op>
__device__ __forceinline__ void map_tile(const Streams<T, kIn>& s,
                                         const Op& op, Index b, Index n_vec,
                                         Index n) {
  constexpr int U = kVecs;
  constexpr Index kTile = static_cast<Index>(kThreads) * U;
  const Index first = b * kTile;
  const Index t = static_cast<Index>(threadIdx.x);
  if (first + kTile <= n_vec) {
    Vec<T, W> x[U][kIn];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int k = 0; k < kIn; ++k) {
        load(s.in[k] + (first + u * kThreads + t) * W, x[u][k]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const Index v = first + u * kThreads + t;
      store(s.out + v * W, apply(op, x[u], v * W));
    }
  } else {
    for (Index i = first + t; i < n_vec; i += kThreads) {
      Vec<T, W> x[kIn];
#pragma unroll
      for (int k = 0; k < kIn; ++k) load(s.in[k] + i * W, x[k]);
      store(s.out + i * W, apply(op, x, i * W));
    }
  }
  if constexpr (W > 1) {
    const Index last = n_vec > 0 ? (n_vec - 1) / kTile : 0;
    const Index e = n_vec * W + t;  // at most W - 1 elements past the vectors
    if (b == last && e < n) {
      Vec<T, 1> x[kIn];
#pragma unroll
      for (int k = 0; k < kIn; ++k) load(s.in[k] + e, x[k]);
      store(s.out + e, apply(op, x, e));
    }
  }
}

// One pass: block b takes tile b.
template <int W, typename T, int kIn, typename Op>
__device__ __forceinline__ void map_block(const Streams<T, kIn>& s,
                                          const Op& op, Index n_vec, Index n) {
  map_tile<W>(s, op, static_cast<Index>(blockIdx.x), n_vec, n);
}

// Blocks of a launch over n elements in vectors of W (at least one, which
// then takes the tail alone).
template <int W>
inline unsigned blocks(int64_t n) {
  const int64_t tile = static_cast<int64_t>(kThreads) * kVecs;
  const int64_t b = (n / W + tile - 1) / tile;
  return static_cast<unsigned>(b < 1 ? 1 : b);
}

// Calls go(width) with width a std::integral_constant<int, W>: 16 bytes
// when every pointer is 16-byte aligned, else one element; go launches the
// kernel instantiated for it.  Returns cudaGetLastError().
template <typename T, int kIn, typename Go>
int dispatch(const Streams<T, kIn>& s, Go&& go) {
  bool aligned = aligned16(s.out);
  for (int k = 0; k < kIn; ++k) aligned = aligned && aligned16(s.in[k]);
  if (aligned) {
    go(std::integral_constant<int, 16 / sizeof(T)>{});
  } else {
    go(std::integral_constant<int, 1>{});
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace stream
}  // namespace repro
