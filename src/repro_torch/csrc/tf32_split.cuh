// TF32 tensor-core products made float32-exact by a hi + lo split, and the
// cp.async copies that feed them; shared by ssd_scan.cu and flash_attention.cu.
//
// mma.sync.m16n8k8 takes TF32 operands (10 mantissa bits).  Each float32
// operand v is split into TF32 parts, v = hi + lo + O(2^-22 |v|), and a product
// a.b is formed as a_lo b_hi + a_hi b_lo + a_hi b_hi, accumulated in float32:
// the dropped a_lo b_lo and the rounding of the lo parts are ~2^-22 of a.b,
// where a single TF32 pass (2^-11) would change the float32 function.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// v rounded to TF32 (its low 13 bits cleared), to nearest with ties away
// from zero as cvt.rna.tf32.f32 rounds, in two integer operations, where
// cvt.rna measured slower.
__device__ __forceinline__ uint32_t round_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo + O(2^-22 |v|), both parts TF32.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(v);
  lo = round_tf32(v - __uint_as_float(hi));
}

// v = hi + lo + O(2^-21 |v|) with hi rounded as split rounds it and lo left
// the float32 v - hi, which the tensor cores take truncated to TF32 (they
// read the top 19 bits of an operand): two operations a value fewer than
// split, at twice its error bound.
__device__ __forceinline__ void split_lo_truncated(float v, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(v);
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragments of m16n8k8 (lane = 4 g + t): A holds (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4); B holds (t, g), (t + 4, g); the sum holds
// (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(const float (&v)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split(v[i], hi[i], lo[i]);
  }
  __device__ __forceinline__ void set_lo_truncated(const float (&v)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_lo_truncated(v[i], hi[i], lo[i]);
  }
};
struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float v0, float v1) {
    split(v0, hi[0], lo[0]);
    split(v1, hi[1], lo[1]);
  }
  __device__ __forceinline__ void set_lo_truncated(float v0, float v1) {
    split_lo_truncated(v0, hi[0], lo[0]);
    split_lo_truncated(v1, hi[1], lo[1]);
  }
};
// Part `part` of big + small += a b to float32 accuracy: 0 a_lo b_hi and 1
// a_hi b_lo into small, 2 a_hi b_hi into big.  The tensor cores truncate
// each sum they form, so the error a sum gathers grows with the products
// added to it at its magnitude: big takes one product a k-step instead of
// three, and small's are 2^-10 of big's (big and small may be one sum
// where that matters less).  Callers run part 0 of every sum of a
// k-step, then part 1, then part 2, so that dependent products on one sum
// never follow each other.
__device__ __forceinline__ void mma_part(float (&big)[4], float (&small)[4], const FragA& a,
                                         const FragB& b, int part) {
  if (part == 0)
    mma(small, a.lo, b.hi[0], b.hi[1]);
  else if (part == 1)
    mma(small, a.hi, b.lo[0], b.lo[1]);
  else
    mma(big, a.hi, b.hi[0], b.hi[1]);
}

__device__ __forceinline__ void cp_async(float* dst, const float* src, int bytes,
                                         bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
                 "r"(valid ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src),
                 "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Waits until at most n of this thread's cp.async groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(n) : "memory");
}

}  // namespace
