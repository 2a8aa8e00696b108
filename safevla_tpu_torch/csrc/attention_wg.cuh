// The warpgroup tile walk shared by the wgmma attention kernels:
// flash_attention_fwd.cu and flash_attention_bwd.cu (the resident bf16
// designs) and exp_attn_bwd.cu (the backward's matmul-only floor). The
// instructions are hopper_wgmma.cuh's; this header holds what the three
// kernels build from them: the plane layout TMA writes, the two product
// shapes, the store of an accumulator, and the tensor maps over qkv and g.
//
// Planes. One head of one batch row, `rows` rows of DH bf16, kept in
// shared memory as kBlocks column blocks of kRowBytes a row (Dh 16, 32, 64:
// one block of 32, 64 or 128 bytes; Dh 128: two of 128), each written by
// TMA with the swizzle of its row width (hopper_wgmma.cuh). Row r of block c
// sits at c * block_bytes + r * kRowBytes, block_bytes = rows * kRowBytes. A
// TMA box is 64 rows of one block; rows past S arrive as zeros.
//
// Products, for a warpgroup and a 64-row M tile:
//   first_product:  d (64 x N) = a rows . b rows^T over the DH head dims,
//                   both K-major in shared memory (s = q.k^T, dp = g.v^T and
//                   their transposes);
//   second_product: acc (64 x DH) += A (64 x N, registers) . b rows (N x DH,
//                   MN-major: k = row, the head dims along it), the A
//                   registers packed from a first product's accumulators
//                   (p.v, ds.k, p^T.g, ds^T.q).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"
#include "hopper_wgmma.cuh"

namespace wg {

constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use on an H100
constexpr int kTile = 64;         // rows of a wgmma M tile and of a TMA box
constexpr int kBarrierBytes = 16;  // a ring slot's full and empty mbarriers

template <int DH>
struct Wg {
  static constexpr int kRowBytes = DH < 64 ? 2 * DH : 128;
  static constexpr int kBlocks = 2 * DH / kRowBytes;
  static constexpr int kAtom = 8 * kRowBytes;          // 8 rows: the descriptors' stride byte offset
  static constexpr int kStepsPerRow = kRowBytes / 32;  // 16-deep k steps in a block's row
  static constexpr int kK = DH / 16;                   // 16-deep steps over the head dims
  static constexpr int kAcc = DH / 2;                  // f32 registers of a 64 x DH accumulator
};

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }
__host__ __device__ inline int round64(int x) { return (x + 63) & ~63; }

// Rows of a plane walked in 16-row steps: round16(S), at least one tile.
__host__ __device__ inline int plane_rows(int S) {
  const int r = round16(S);
  return r < kTile ? kTile : r;
}

// First row of tile t of a plane of P rows: 64 t, the last tile pulled back
// to end at P (rows below 64 t are the tile before's).
__device__ __forceinline__ int tile_row(int t, int P) {
  const int r = t * kTile;
  return r + kTile > P ? P - kTile : r;
}

// d (64 x N) = rows [a, a + 64) . rows [b, b + N)^T over the DH head dims,
// both K-major in shared memory (a k step moves the descriptors' start 32
// bytes along a row, then to the next column block). The first step
// overwrites d.
template <int DH, int N>
__device__ __forceinline__ void first_product(float (&d)[N / 2], uint32_t a, uint32_t b,
                                              uint32_t block_bytes) {
  using W = Wg<DH>;
#pragma unroll
  for (int ks = 0; ks < W::kK; ++ks) {
    const uint32_t at = (ks / W::kStepsPerRow) * block_bytes + 32 * (ks % W::kStepsPerRow);
    hopper::Wgmma<N>::template ss<0, 0>(d, hopper::desc(a + at, 16, W::kAtom, W::kRowBytes),
                                         hopper::desc(b + at, 16, W::kAtom, W::kRowBytes), ks);
  }
}

// acc (64 x DH) += a (64 x N, A registers) . rows [b, b + N) of a plane
// (k = row, MN-major: the head dims along a row, the column blocks
// block_bytes apart; a k step is 16 rows).
template <int DH, int N>
__device__ __forceinline__ void second_product(float (&acc)[DH / 2], const uint32_t (&a)[N / 16][4],
                                               uint32_t b, uint32_t block_bytes) {
  using W = Wg<DH>;
#pragma unroll
  for (int s = 0; s < N / 16; ++s) {
    hopper::Wgmma<DH>::template rs<1>(
        acc, a[s], hopper::desc(b + 16 * s * W::kRowBytes, block_bytes, W::kAtom, W::kRowBytes), 1);
  }
}

// The A registers of a 64 x N accumulator c, element-wise f(value, row
// half) rounded to bf16 pairs: 16 columns of c (c[8s .. 8s+7]) are the
// 16-deep step s; register i holds rows g + 8 (i & 1).
template <int N, typename F>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4], const float (&c)[N / 2], F&& f) {
#pragma unroll
  for (int s = 0; s < N / 16; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[s][i] = hopper::pack_bf16(f(c[8 * s + 2 * i], i & 1), f(c[8 * s + 2 * i + 1], i & 1));
    }
  }
}

// The two bf16 values of a packed pair, as f32 (exact).
__device__ __forceinline__ float bf16_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

// Stores the rows r0 + 16 w + g (+ 8) of a warpgroup's 64 x DH accumulator
// (warp w, g = lane / 4), times `mul` and rounded to bf16 pairs, to dst (row
// 0, head column 0; rows `stride` apart); rows below lo (stored by the tile
// before) or from S on are skipped, rows from zero_from on get zeros.
template <int DH>
__device__ __forceinline__ void store_tile(__nv_bfloat16* dst, long long stride,
                                           const float (&acc)[DH / 2], float mul, int r0, int lo,
                                           int S, int zero_from, int tid) {
  const int lane = tid & 31;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 16 * (tid >> 5) + (lane >> 2) + 8 * half;
    if (r < lo || r >= S) continue;
    const bool zero = r >= zero_from;
    __nv_bfloat16* row = dst + r * stride + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      *reinterpret_cast<uint32_t*>(row + 8 * j) =
          zero ? 0u : hopper::pack_bf16(acc[4 * j + 2 * half] * mul, acc[4 * j + 2 * half + 1] * mul);
    }
  }
}

// bar.sync id, n: a named barrier among n threads (the consumer warpgroups;
// barrier 0 is __syncthreads).
__device__ __forceinline__ void named_barrier(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// After a warpgroup has seen a slot's full phase and is done with it: one
// arrival a warp on its empty barrier.
__device__ __forceinline__ void release(uint32_t empty_bar, int tid) {
  __syncwarp();
  if ((tid & 31) == 0) hopper::mbar_arrive(empty_bar);
}

// cuTensorMapEncodeTiled, from the driver through the runtime (the library
// links no libcuda); null where the driver has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                      : nullptr;
  }();
  return fn;
}

// A 4-d bf16 map (head dims, head slot, row, batch row) over `ptr`, boxes of
// one column block x 64 rows, swizzled at the block's row width, rows past S
// filled with zeros. Strides in elements.
template <int DH>
bool encode_map(CUtensorMap* map, const void* ptr, int slots_per_row, int S, int B,
                long long stride_s, long long stride_b) {
  using W = Wg<DH>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {DH, static_cast<cuuint64_t>(slots_per_row), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {2 * DH, 2 * static_cast<cuuint64_t>(stride_s),
                                 2 * static_cast<cuuint64_t>(stride_b)};
  const cuuint32_t box[4] = {W::kRowBytes / 2, 1, kTile, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = W::kRowBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : W::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                          : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The TMA loads of rows [r, r + 64) of one head slot `col` of batch row b
// to dst, the shared address of the box's first row in column block 0 (the
// blocks block_bytes apart), completing on bar.
template <int DH>
__device__ __forceinline__ void load_box(uint32_t dst, uint32_t block_bytes, const CUtensorMap* map,
                                         int col, int r, int b, uint32_t bar) {
  using W = Wg<DH>;
#pragma unroll
  for (int blk = 0; blk < W::kBlocks; ++blk) {
    hopper::tma_load_4d(dst + blk * block_bytes, map, blk * W::kRowBytes / 2, col, r, b, bar);
  }
}

// The number of SMs of the current device (0 on an error), asked once a
// device.
inline int sm_count() {
  static int counts[64] = {};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0) return 0;
  if (device >= 64) {
    int sms = 0;
    return cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) == cudaSuccess ? sms : 0;
  }
  if (counts[device] == 0 &&
      cudaDeviceGetAttribute(&counts[device], cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
    counts[device] = 0;
  }
  return counts[device];
}

}  // namespace wg
