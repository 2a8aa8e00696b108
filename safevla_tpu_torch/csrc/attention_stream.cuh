// Helpers of the streaming attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): the CUDA-core designs that take any S, where the
// resident designs' shared memory runs out, and every other head dim (up to
// 256 whole, above it in slices of 256: `load_slice`).
//
// A block of 8 warps owns 64 rows of one (head, batch row), 8 a warp, staged
// in shared memory; the other side of each product streams through rings of
// 32-row tiles (one row a lane), copied by cp.async while the previous tile
// is used. Rows are kept in the IO dtype, one head wide, padded by one
// 16-byte chunk: a row is then an odd number of chunks long, so the eight
// lanes of a quarter-warp that read one 16-byte chunk each from eight
// consecutive rows hit eight different groups of banks. Products are f32
// FMAs over the head dims in ascending order, so every kernel that forms a
// logit of the same (query, key) pair gets the same bits.
//
// Head dims: each kernel is a template over a padded head dim DP (16, 32,
// 64, 128, 256) and takes the runtime head dim dh <= DP. Only the first dh
// columns of a row are copied; the columns dh..DP-1 are zeroed once when the
// kernel starts (`zero_smem`) and never written again, so the products over
// DP add exact zeros after the dh real terms: q.k and p.v are unchanged,
// bit for bit. Outputs are written for the first dh columns only.
//
// Copy width: a row's head slice is copied `width` bytes at a time, the
// widest of 16, 8, 4 and 2 that divides dh * sizeof(T) (the wrapper's
// `copy_width`; with a contiguous qkv every row start and head offset is a
// multiple of the head slice's bytes, so that one width fits every copy).
// 16, 8 and 4 bytes go by cp.async (the last two as `cp.async.ca`: `.cg`
// takes 16 only); 2 bytes (bf16 at an odd head dim) by a plain load and a
// st.shared, which the barrier before the tile's use makes visible like the
// asynchronous copies.
//
// Head-dim slices (head dims above 256, the sliced designs): a row's head
// is staged kSliceDim columns at a time (`load_slice`), the columns of a
// narrower last slice padded with zeros by the copy itself; a product over
// the whole head carries one f32 accumulator through the slices in
// ascending order (`dot_rows`' `acc`), so every kernel that forms a logit of
// the same pair still gets the same bits.

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
constexpr int kMaxHeadDim = 256;                   // the widest padded head dim
constexpr int kSliceDim = kMaxHeadDim;             // columns of a head slice (the sliced designs)
constexpr int kMaxSmem = 232448;                   // bytes of shared memory a block may use (227 KB)

template <typename T, int DP>
struct Rows {
  static constexpr int kBytes = DP * static_cast<int>(sizeof(T));  // one padded head of one row
  static constexpr int kChunks = kBytes / 16;
  static constexpr int kStride = kBytes + 16;  // padded: an odd number of chunks
  // head dims a lane accumulates (lane l: dims kPer*l .. kPer*l + kPer - 1;
  // at DP = 16 lanes 16-31 accumulate none)
  static constexpr int kPer = DP >= 32 ? DP / 32 : 1;
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

// Zeros `bytes` (a multiple of 16) of shared memory from p; every thread of
// the block takes part. The caller puts a barrier before any copy into it.
__device__ __forceinline__ void zero_smem(unsigned char* p, int bytes) {
  for (int i = 16 * static_cast<int>(threadIdx.x); i < bytes; i += 16 * kThreads)
    *reinterpret_cast<uint4*>(p + i) = make_uint4(0u, 0u, 0u, 0u);
}

// One copy of `width` bytes (16, 8, 4 or 2) from global src to shared dst;
// writes zeros instead when !ok (src is then not read by the asynchronous
// copies; the 2-byte path reads nothing either).
__device__ __forceinline__ void copy_chunk(uint32_t dst, const unsigned char* src, bool ok,
                                           int width) {
  switch (width) {
    case 16:
      hopper::cp_async16(dst, src, ok);
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
                   "r"(ok ? 8 : 0)
                   : "memory");
      break;
    case 4:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                   "r"(ok ? 4 : 0)
                   : "memory");
      break;
    default: {  // 2 bytes: cp.async has no copy this narrow
      const unsigned short v = ok ? *reinterpret_cast<const unsigned short*>(src) : 0;
      asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst), "h"(v) : "memory");
    }
  }
}

// Copies of rows row0 .. row0+n-1 of one head (src: the head's column 0 of
// row 0, rows `stride` elements apart; the first dh columns, `width` bytes a
// copy) into padded rows at dst; rows >= limit are zero-filled (and not
// read). Every thread of the block takes part.
template <typename T, int DP>
__device__ __forceinline__ void load_rows(uint32_t dst, const T* src, long long stride, int row0,
                                          int n, int limit, int dh, int width) {
  using R = Rows<T, DP>;
  const int per_row = dh * static_cast<int>(sizeof(T)) / width;
  for (int i = threadIdx.x; i < n * per_row; i += kThreads) {
    const int r = i / per_row, c = i - r * per_row;
    const int row = row0 + r;
    const bool ok = row < limit;
    const unsigned char* s = reinterpret_cast<const unsigned char*>(src + (ok ? row : 0) * stride);
    copy_chunk(dst + r * R::kStride + c * width, s + c * width, ok, width);
  }
}

// Copies of rows row0 .. row0+n-1 of one head slice (src: the slice's
// column 0 of row 0, rows `stride` elements apart; its first `cols` columns,
// `width` bytes a copy) into padded rows of DP columns at dst; the columns
// cols..DP-1 and the rows >= limit are zero-filled (and not read). Every
// thread of the block takes part.
template <typename T, int DP>
__device__ __forceinline__ void load_slice(uint32_t dst, const T* src, long long stride, int row0,
                                           int n, int limit, int cols, int width) {
  using R = Rows<T, DP>;
  const int per_row = R::kBytes / width;
  const int real = min(cols, DP) * static_cast<int>(sizeof(T));  // bytes of real columns
  for (int i = threadIdx.x; i < n * per_row; i += kThreads) {
    const int r = i / per_row, c = i - r * per_row;
    const int row = row0 + r;
    const bool ok = row < limit && c * width < real;
    const unsigned char* s =
        reinterpret_cast<const unsigned char*>(src + (row < limit ? row : 0) * stride);
    copy_chunk(dst + r * R::kStride + c * width, s + (ok ? c * width : 0), ok, width);
  }
}

// acc += a . b over 16-byte chunk c of two rows in shared memory
template <typename T>
__device__ __forceinline__ void dot_chunk(const unsigned char* a, const unsigned char* b, int c,
                                          float& acc) {
  constexpr int kPerChunk = 16 / static_cast<int>(sizeof(T));
  const uint4 x = *reinterpret_cast<const uint4*>(a + 16 * c);
  const uint4 y = *reinterpret_cast<const uint4*>(b + 16 * c);
  const T* xs = reinterpret_cast<const T*>(&x);
  const T* ys = reinterpret_cast<const T*>(&y);
#pragma unroll
  for (int e = 0; e < kPerChunk; ++e) acc = fmaf(to_f32(xs[e]), to_f32(ys[e]), acc);
}

// acc + a . b over one padded head (or head slice), two rows in shared
// memory, d ascending. With
// kFull (the forward) fully unrolled up to 16 chunks; else, and above 16
// chunks, 4 chunks at a time: fully unrolled, the backward's 30 templates and
// the 256-wide ones (32 or 64 chunks) spill registers and make the build
// several times longer. The same FMA order either way.
template <typename T, int DP, bool kFull = false>
__device__ __forceinline__ float dot_rows(const unsigned char* a, const unsigned char* b,
                                          float acc = 0.f) {
  constexpr int kChunks = Rows<T, DP>::kChunks;
  if constexpr (kFull && kChunks <= 16) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) dot_chunk<T>(a, b, c, acc);
  } else {
#pragma unroll 4
    for (int c = 0; c < kChunks; ++c) dot_chunk<T>(a, b, c, acc);
  }
  return acc;
}

// acc[u] += w * row[d0 + u] for this lane's head dims
template <typename T, int DP>
__device__ __forceinline__ void axpy_row(float (&acc)[Rows<T, DP>::kPer], float w,
                                         const unsigned char* row, int d0) {
  const T* r = reinterpret_cast<const T*>(row) + d0;
#pragma unroll
  for (int u = 0; u < Rows<T, DP>::kPer; ++u) acc[u] = fmaf(w, to_f32(r[u]), acc[u]);
}

}  // namespace stream
