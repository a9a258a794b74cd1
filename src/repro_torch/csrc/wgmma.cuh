// Hopper's warpgroup matrix multiply (wgmma) on bf16 operands with float32
// sums, the tensor maps that feed it bf16 head tiles through TMA, and the
// bf16 hi + lo split of float32 values taken as its register operand;
// shared by flash_attention.cu and flash_attention_bwd.cu.
//
// Accumulator fragments (m64nN): thread tid of the warpgroup holds rows
// r = 16 (tid / 32) + (tid % 32) / 4 and r + 8, columns 8 j + 2 (tid % 4)
// and + 1 for j < N / 8, as d[4 j + e]: e = 0 (r, c), 1 (r, c + 1),
// 2 (r + 8, c), 3 (r + 8, c + 1).  A register A operand (m64k16) packs the
// same rows' columns 16 kk .. 16 kk + 15 in four bf16 pairs: {r | r + 8} x
// {columns + 0 | + 8}, so an accumulator's j = 2 kk, 2 kk + 1 become step
// kk's A operand as they stand.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int kAtomCols = 64;  // bf16 columns of a 128-byte swizzle atom

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (SW128).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_ACC8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_ACC32 WG_ACC8(0), WG_ACC8(8), WG_ACC8(16), WG_ACC8(24)
#define WG_ACC64 WG_ACC32, WG_ACC8(32), WG_ACC8(40), WG_ACC8(48), WG_ACC8(56)
#define WG_REGS32                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WG_REGS64                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 128, float32) (+)= A (64 x 16, K-major in shared memory) *
// B (16 x 128, K-major in shared memory); d is overwritten when !accumulate.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC64
      : "l"(a), "l"(b), "r"(accumulate));
}

// The same with a 64-wide B: d (64 x 64).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC32
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128, float32) += A (64 x 16 bf16, the accumulator fragment layout
// packed in 4 registers) * B (16 x 128, MN-major in shared memory).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef WG_ACC8
#undef WG_ACC32
#undef WG_ACC64
#undef WG_REGS32
#undef WG_REGS64

// 2^x on the SFU; results below 2^-126 flush to 0 (weights that small are
// far below what a bf16 result resolves).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Splits (x0, x1) into a bf16 pair and the bf16 pair of what it missed.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 back = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x0 - back.x, x1 - back.y);
}

// A (d, s, b * h) view of a contiguous (b, h, s, d) bf16 tensor, read in
// boxes of 64 columns x `rows` rows of one head, 128-byte swizzled; boxes
// past d or s read zeros.
inline bool bf16_head_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int bh,
                          int s, int d, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(s) * d * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kAtomCols),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
