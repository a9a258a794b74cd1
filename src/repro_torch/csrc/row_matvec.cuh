// The per-row matvec of the port's general-noise SDE-step kernels (sm_90a).
//
// Under general noise the diffusion of one path is a (d, m) matrix g and
// its Brownian increment an m-vector dW; the increment's noise part is
// g@dW, one d-vector per path.  Viewed as (N*d, m), g has one row per
// output element (path n, component i), and that row is reduced against
// path n's dW:
//
//     acc = g[0]*dW[0];  acc = acc + g[j]*dW[j]  for j = 1 .. m-1
//
// in that order, each product and sum rounded on its own (the plain PyTorch
// twin sums in the same order), so kernel and twin agree bitwise.
//
// Every element of g is read once and used once (2 flops per 4 bytes in
// float32), so the kernels are bound by HBM bandwidth, not by arithmetic.
// g is nearly all of the bytes, and how it is read decides the time.  Two
// routes, chosen by the Python wrapper from (m, dtype, alignment):
//
//  * the row route (row_dot): one thread per output walks its own row of g
//    as 16-byte packs.  It takes rows of at most 64 bytes (the main path's
//    m = 4), rows whose stride is not a multiple of 16 bytes and unaligned
//    operands (element by element).  On wide rows it falls short: the 32
//    lanes of a warp load from 32 rows m*sizeof(T) bytes apart, each load
//    uses 16 bytes of a 32-byte sector, and with 2048 threads' rows in
//    flight the L1 evicts the other half before it is used, so g crosses
//    HBM about twice (27% of the bound at m = 128 in float32).
//
//  * the staged route (staged_matvec): a block owns a tile of kStagedRows
//    consecutive outputs, which are kStagedRows consecutive rows of g, one
//    contiguous span.  It walks m in chunks of kChunkBytes per row (32
//    floats or 16 doubles) and copies each chunk of g, with the chunk of dW
//    for the tile's paths, into a ring of kStages shared-memory stages: one
//    thread issues two TMA boxes (2-D tensor maps over g as (N*d, m) and dW
//    as (N, m), 128-byte swizzle, mbarrier completion), or, with kTmaStaging
//    off, every thread 16-byte cp.async copies into rows padded by 16 bytes.
//    Either layout puts the 16-byte reads of a quarter-warp's 8 rows on 8
//    different bank groups.  Each thread keeps its row's sum in a register
//    across the chunks and reads its row of the chunk in channel order (dW
//    as a broadcast), so the order of the sum is the row route's, whatever
//    the order of the copies; the epilogue runs once per output after its
//    last chunk.  A capped grid (the blocks resident on the card at once)
//    walks the tiles, so one tile's epilogue overlaps the next one's copies.
//    The ragged ends (N*d not a multiple of the tile, m not a multiple of
//    the chunk) are zero-filled by TMA (skipped by cp.async) and never read;
//    nothing is padded in memory.  It needs a row stride that is a multiple
//    of 16 bytes and 16-byte aligned g and dW (with TMA, N*d < 2^31).
//
// Measured on an H100 (python -m repro_torch.benchmarks.general_variants):
// the staged route reaches 83-89% of the byte bound from m = 128 on, against
// the row route's 26-33%; TMA beats cp.async by 4-6% there; 2 or 4 stages,
// 256-row tiles and one tile per block change the time by -1.5% to +5%.  The
// row route stays ahead up to 64-byte rows, where a warp's loads span at
// most 2 KB and the L1 keeps the sectors until they are used.
//
// The sum starts from -0.0, the additive identity of IEEE arithmetic
// (-0 + x == x for every x, -0 and NaN included), so starting from it and
// adding g[0]*dW[0] first is the twin's acc = g[0]*dW[0] bit for bit.
#pragma once

#include <map>
#include <mutex>
#include <tuple>

#include "elementwise.cuh"
#include "tma.cuh"

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

// Calls go(step) with the step of a launch indexing rows in I: h itself when
// h_vec is null (the scalar entries), else h_vec over paths of rows_per_path
// rows each (the per-path entries); go launches the kernel instantiated for
// it.
template <typename T, typename I, typename Go>
inline void visit_step(double h, const void* h_vec, int64_t rows_per_path, Go&& go) {
  if (h_vec == nullptr) {
    go(ScalarStep<T, I>{static_cast<T>(h)});
  } else {
    go(PathStep<T, I>{static_cast<const T*>(h_vec), static_cast<I>(rows_per_path)});
  }
}

// ---------------------------------------------------------------------------
// The staged route.

constexpr int kStagedRows = 128;     // outputs (rows of g) per tile, a thread each
constexpr int kStages = 3;           // depth of the shared-memory ring
constexpr bool kTmaStaging = true;   // TMA boxes, 128-byte swizzle (else cp.async)
constexpr bool kCappedGrid = true;   // the resident blocks walk the tiles
constexpr int kChunkBytes = 128;     // one row of a chunk
constexpr int kPieces = kChunkBytes / 16;
// A staged row's stride: cp.async pads each row by 16 bytes, TMA swizzles.
constexpr int kRowStride = kTmaStaging ? kChunkBytes : kChunkBytes + 16;

// Paths whose dW rows a tile of kStagedRows outputs can touch, at width d.
__host__ __device__ constexpr int staged_paths(int d) {
  return (kStagedRows - 1) / d + 2 < kStagedRows ? (kStagedRows - 1) / d + 2
                                                 : kStagedRows;
}

// One stage: the tile's chunk of g, then its paths' chunk of dW (rounded to
// 8 rows, so with TMA every box starts on the swizzle's 1024-byte period).
__host__ __device__ constexpr int staged_stage_bytes(int d) {
  return (kStagedRows + ((staged_paths(d) + 7) & ~7)) * kRowStride;
}

// Dynamic shared memory of a launch at width d (with TMA: the ring aligned
// to 1024 bytes, and one mbarrier a stage after it).
constexpr int staged_smem_bytes(int d) {
  return kStages * staged_stage_bytes(d) + (kTmaStaging ? 1024 + 8 * kStages : 0);
}

__device__ __forceinline__ void stage_copy16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src)
               : "memory");
}
__device__ __forceinline__ void stage_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Waits until at most n of this thread's cp.async groups are in flight.
template <int n>
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(n) : "memory");
}

// A block's walk over its (tile, chunk) items, and the ring stage (and
// its mbarrier phase) each item lands in.
template <typename I>
struct StagedCursor {
  I tile;
  int chunk;
  int stage;
  uint32_t parity;

  __device__ __forceinline__ void next(int chunks) {
    if (++chunk == chunks) {
      chunk = 0;
      tile += gridDim.x;
    }
    if (++stage == kStages) {
      stage = 0;
      parity ^= 1u;
    }
  }
};

// The staged route's body: sums g@dW for the block's tiles of outputs in
// `total` = N*d and hands each output e its sum through epi(e, sum).  A
// block of kStagedRows threads; tm_g and tm_w are read only with TMA.
template <typename T, typename I, class Epilogue>
__device__ __forceinline__ void staged_matvec(const CUtensorMap* tm_g,
                                              const CUtensorMap* tm_w,
                                              const T* __restrict__ g,
                                              const T* __restrict__ w,
                                              I total, I d, int m,
                                              Epilogue epi) {
  constexpr int kW = 16 / sizeof(T);           // values in a 16-byte piece
  constexpr int kC = kChunkBytes / sizeof(T);  // values in a chunk row
  extern __shared__ __align__(1024) unsigned char staged_smem[];
  const int tid = threadIdx.x;
  const int paths = staged_paths(static_cast<int>(d < kStagedRows ? d : kStagedRows));
  const int stage_bytes = staged_stage_bytes(static_cast<int>(d < kStagedRows ? d : kStagedRows));
  const uint32_t raw = smem_u32(staged_smem);
  const uint32_t base = kTmaStaging ? (raw + 1023) & ~1023u : raw;
  const unsigned char* const ring = staged_smem + (base - raw);
  const uint32_t bars = base + kStages * stage_bytes;
  const I n_paths = total / d;
  const I tiles = (total + kStagedRows - 1) / kStagedRows;
  const int chunks = (m + kC - 1) / kC;

  // Copies item `c` into its stage: every thread its share of the 16-byte
  // pieces (cp.async), or thread 0 two TMA boxes.
  const auto issue = [&](const StagedCursor<I>& c) {
    if (c.tile >= tiles) return;
    const I r0 = c.tile * kStagedRows;
    const I p0 = r0 / d;
    const int col = c.chunk * kC;
    const uint32_t st = base + c.stage * stage_bytes;
    if constexpr (kTmaStaging) {
      if (tid != 0) return;
      const uint32_t bar = bars + 8 * c.stage;
      mbar_expect_tx(bar, (kStagedRows + paths) * kChunkBytes);
      tma_load_2d(st, tm_g, bar, col, static_cast<int>(r0));
      tma_load_2d(st + kStagedRows * kRowStride, tm_w, bar, col, static_cast<int>(p0));
    } else {
      const int valid = min(kPieces, (m - col) / kW);  // pieces of a row here
#pragma unroll
      for (int k = 0; k < kPieces; ++k) {
        const int q = tid + k * kStagedRows;
        const int r = q / kPieces, j = q % kPieces;
        if (j < valid && r0 + r < total)
          stage_copy16(st + r * kRowStride + j * 16,
                       g + static_cast<int64_t>(r0 + r) * m + col + j * kW);
      }
      for (int q = tid; q < paths * kPieces; q += kStagedRows) {
        const int p = q / kPieces, j = q % kPieces;
        if (j < valid && p0 + p < n_paths)
          stage_copy16(st + (kStagedRows + p) * kRowStride + j * 16,
                       w + static_cast<int64_t>(p0 + p) * m + col + j * kW);
      }
    }
  };

  if constexpr (kTmaStaging) {
    if (tid == 0) {
      for (int s = 0; s < kStages; ++s) mbar_init(bars + 8 * s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }
  StagedCursor<I> fetch{static_cast<I>(blockIdx.x), 0, 0, 0u};
  StagedCursor<I> use = fetch;
  for (int s = 0; s < kStages - 1; ++s) {
    issue(fetch);
    if constexpr (!kTmaStaging) stage_commit();
    fetch.next(chunks);
  }
  T acc = static_cast<T>(-0.0);
  I e = 0;
  int lp = 0;  // the output's path, counted from the tile's first
  while (use.tile < tiles) {
    if constexpr (!kTmaStaging) stage_wait<kStages - 2>();
    // Item `use` has landed (cp.async) and every thread is done with the
    // stage the next copy overwrites.
    __syncthreads();
    issue(fetch);
    if constexpr (!kTmaStaging) stage_commit();
    fetch.next(chunks);
    if constexpr (kTmaStaging) mbar_wait(bars + 8 * use.stage, use.parity);

    if (use.chunk == 0) {
      const I r0 = use.tile * kStagedRows;
      e = r0 + tid;
      lp = e < total ? static_cast<int>(e / d - r0 / d) : 0;
    }
    const unsigned char* st = ring + use.stage * stage_bytes;
    const unsigned char* grow = st + tid * kRowStride;
    const unsigned char* wrow = st + (kStagedRows + lp) * kRowStride;
    const int valid = min(kPieces, (m - use.chunk * kC) / kW);
#pragma unroll
    for (int j = 0; j < kPieces; ++j) {
      if (j < valid) {
        // the 128-byte swizzle moves piece j of row r to piece j ^ (r % 8)
        const int jg = kTmaStaging ? j ^ (tid & 7) : j;
        const int jw = kTmaStaging ? j ^ (lp & 7) : j;
        const Pack<T> vg = *reinterpret_cast<const Pack<T>*>(grow + jg * 16);
        const Pack<T> vw = *reinterpret_cast<const Pack<T>*>(wrow + jw * 16);
#pragma unroll
        for (int k = 0; k < kW; ++k) acc = add(acc, mul(vg.v[k], vw.v[k]));
      }
    }
    if (use.chunk == chunks - 1) {
      if (e < total) epi(e, acc);
      acc = static_cast<T>(-0.0);
    }
    use.next(chunks);
  }
}

// The host side of a staged launch: grid, shared memory and (with TMA) the
// two tensor maps.
struct StagedLaunch {
  CUtensorMap tm_g;
  CUtensorMap tm_w;
  unsigned blocks;
  int smem;
};

// Blocks of `kernel` resident on the current device at `smem` bytes of
// dynamic shared memory, all SMs together; raises the kernel's shared-memory
// limit first where `smem` passes 48 KB and the limit set so far (the limit
// is the kernel's, so it is only ever raised).  Cached by (kernel, device,
// smem).
inline cudaError_t staged_resident_blocks(const void* kernel, int smem, int* blocks) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int>, int> cache;
  static std::map<std::tuple<const void*, int>, int> limit;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(kernel, dev, smem);
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *blocks = hit->second;
    return cudaSuccess;
  }
  int& set = limit[std::make_tuple(kernel, dev)];
  if (smem > 48 * 1024 && smem > set) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    set = smem;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kStagedRows, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  cache[key] = *blocks = per_sm * sms;
  return cudaSuccess;
}

// A (cols m, rows) tensor map of a contiguous row-major T matrix, read in
// boxes of one chunk (kChunkBytes) x box_rows rows, 128-byte swizzled;
// boxes past m or `rows` read zeros.
template <typename T>
inline bool staged_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                       int64_t rows, int m, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(m), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(m) * sizeof(T)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kChunkBytes / sizeof(T)),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                    : CU_TENSOR_MAP_DATA_TYPE_FLOAT64,
                2, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Checks that the staged route takes these operands (a row stride of a
// multiple of 16 bytes, g and dW 16-byte aligned; with TMA, N*d < 2^31) and
// fills in the launch of `kernel` over n_rows paths of width d.
template <typename T>
inline int staged_setup(const void* kernel, const void* g, const void* w,
                        int64_t n_rows, int d, int m, StagedLaunch* launch) {
  if (d < 1 || m < 1 || (static_cast<int64_t>(m) * sizeof(T)) % 16 != 0 ||
      !aligned16(g) || !aligned16(w))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = n_rows * d;
  if (kTmaStaging && total > kMaxIndex32) return static_cast<int>(cudaErrorInvalidValue);
  const int dt = d < kStagedRows ? d : kStagedRows;
  launch->smem = staged_smem_bytes(dt);
  int resident = 0;
  const cudaError_t err = staged_resident_blocks(kernel, launch->smem, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t blocks = (total + kStagedRows - 1) / kStagedRows;
  if (kCappedGrid && blocks > resident) blocks = resident;
  launch->blocks = static_cast<unsigned>(blocks < kMaxIndex32 ? blocks : kMaxIndex32);
  launch->tm_g = CUtensorMap{};
  launch->tm_w = CUtensorMap{};
  if (kTmaStaging) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    if (!staged_map<T>(encode, &launch->tm_g, g, total, m, kStagedRows) ||
        !staged_map<T>(encode, &launch->tm_w, w, n_rows, m, staged_paths(dt)))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace repro
