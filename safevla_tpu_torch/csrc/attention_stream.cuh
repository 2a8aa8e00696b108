// Helpers of the streaming attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): the CUDA-core designs that take any S up to 2048,
// where the resident designs' shared memory runs out.
//
// A block of 8 warps owns 64 rows of one (head, batch row), 8 a warp, staged
// in shared memory; the other side of each product streams through two-slot
// rings of 32-row tiles (one row a lane), copied by cp.async while the
// previous tile is used. Rows are kept in the IO dtype, one head wide, padded
// by one 16-byte chunk: a row is then an odd number of chunks long, so the
// eight lanes of a quarter-warp that read one 16-byte chunk each from eight
// consecutive rows hit eight different groups of banks. Products are f32
// FMAs over the head dims in ascending order, so every kernel that forms a
// logit of the same (query, key) pair gets the same bits.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace stream {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 8;
constexpr int kBlockRows = kWarps * kRowsPerWarp;  // rows a block owns
constexpr int kTileRows = 32;                      // rows of a streamed tile: one a lane

template <typename T, int DH>
struct Rows {
  static constexpr int kBytes = DH * static_cast<int>(sizeof(T));  // one head of one row
  static constexpr int kChunks = kBytes / 16;
  static constexpr int kStride = kBytes + 16;  // padded: an odd number of chunks
  // head dims a lane accumulates (lane l: dims kPer*l .. kPer*l + kPer - 1;
  // at DH = 16 lanes 16-31 accumulate none)
  static constexpr int kPer = DH >= 32 ? DH / 32 : 1;
  static constexpr int kTileBytes = kTileRows * kStride;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to the IO dtype and back: the plain version's .to(io).float()
template <typename T>
__device__ __forceinline__ float round_io(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// cp.async of rows row0 .. row0+n-1 of one head (src: the head's column 0 of
// row 0, rows `stride` elements apart) into padded rows at dst; rows >= limit
// are zero-filled (and not read). Every thread of the block takes part.
template <typename T, int DH>
__device__ __forceinline__ void load_rows(uint32_t dst, const T* src, long long stride, int row0,
                                          int n, int limit) {
  using R = Rows<T, DH>;
  for (int i = threadIdx.x; i < n * R::kChunks; i += kThreads) {
    const int r = i / R::kChunks, c = i - r * R::kChunks;
    const int row = row0 + r;
    const bool ok = row < limit;
    hopper::cp_async16(dst + r * R::kStride + c * 16,
                       src + (ok ? row : 0) * stride + c * (16 / static_cast<int>(sizeof(T))), ok);
  }
}

// a . b over one head, two padded rows in shared memory, d ascending
template <typename T, int DH>
__device__ __forceinline__ float dot_rows(const unsigned char* a, const unsigned char* b) {
  constexpr int kPerChunk = 16 / static_cast<int>(sizeof(T));
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < Rows<T, DH>::kChunks; ++c) {
    const uint4 x = *reinterpret_cast<const uint4*>(a + 16 * c);
    const uint4 y = *reinterpret_cast<const uint4*>(b + 16 * c);
    const T* xs = reinterpret_cast<const T*>(&x);
    const T* ys = reinterpret_cast<const T*>(&y);
#pragma unroll
    for (int e = 0; e < kPerChunk; ++e) acc = fmaf(to_f32(xs[e]), to_f32(ys[e]), acc);
  }
  return acc;
}

// acc[u] += w * row[d0 + u] for this lane's head dims
template <typename T, int DH>
__device__ __forceinline__ void axpy_row(float (&acc)[Rows<T, DH>::kPer], float w,
                                         const unsigned char* row, int d0) {
  const T* r = reinterpret_cast<const T*>(row) + d0;
#pragma unroll
  for (int u = 0; u < Rows<T, DH>::kPer; ++u) acc[u] = fmaf(w, to_f32(r[u]), acc[u]);
}

}  // namespace stream
