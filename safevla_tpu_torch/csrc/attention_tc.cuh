// The tile walk of the resident bf16 attention backward, shared by
// flash_attention_bwd.cu (the attention VJP) and exp_attn_bwd.cu (its
// matmul-only floor, the same products with the softmax taken out): one
// block of 4 warps per (head, batch row), the Q, K, V and G planes of one
// head resident in shared memory (swizzled rows, hopper_mma.cuh), a warp
// owning 16 rows, its products walked over the other side's rows in chunks
// of 32 columns (four independent mma accumulators) and then of 16.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace attn_tc {

constexpr int kTcThreads = 128;  // 4 warps

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

template <int DH>
struct Tc {
  static constexpr int kChunks = DH / 8;  // 16-byte chunks a row
  static constexpr int kRowBytes = DH * 2;
  static constexpr int kK = DH / 16;      // 16-deep steps of a product over the head dims
  static constexpr int kN = DH / 8;       // 8-wide column tiles of a gradient row
};

template <int N>
struct Int {
  static constexpr int value = N;
};

// Calls body(Int<NT>(), Int<kMask>(), c0) over the columns [0, end) in
// chunks: 32 wide (NT = 4 n tiles) while the chunk lies below `full`, with no
// mask, then 16 wide (NT = 2), masked. Wider chunks give the mma chains of a
// chunk more independent accumulators.
template <typename Body>
__device__ __forceinline__ void over_chunks(int full, int end, Body&& body) {
  int c0 = 0;
  for (; c0 + 32 <= full; c0 += 32) body(Int<4>(), Int<0>(), c0);
  for (; c0 < end; c0 += 16) body(Int<2>(), Int<1>(), c0);
}

// c (16 rows x 8*NT columns, as NT n tiles) = a . bt[n0..n0+8*NT-1]^T, where
// a is held as DH/16 A fragments and bt is a swizzled plane stored n-major.
template <int DH, int NT>
__device__ __forceinline__ void product(float (&c)[NT][4], const uint32_t (&a)[Tc<DH>::kK][4],
                                        uint32_t bt, int n0, int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < Tc<DH>::kK; ++kk) {
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      uint32_t b[4];
      hopper::ldsm_x4(b, hopper::bt_addr<Tc<DH>::kChunks>(bt, n0 + 16 * jp, kk, lane));
      hopper::mma(c[2 * jp], a[kk], b[0], b[1]);
      hopper::mma(c[2 * jp + 1], a[kk], b[2], b[3]);
    }
  }
}

// acc (16 x DH) += bf16(c) (16 x 8*NT, as A fragments) . plane rows
// k0..k0+8*NT-1 (all DH columns, through ldmatrix.trans).
template <int DH, int NT>
__device__ __forceinline__ void accumulate(float (&acc)[Tc<DH>::kN][4], const float (&c)[NT][4],
                                           uint32_t plane, int k0, int lane) {
#pragma unroll
  for (int ks = 0; ks < NT / 2; ++ks) {
    uint32_t a[4];
    hopper::acc_to_a(a, c[2 * ks], c[2 * ks + 1]);
#pragma unroll
    for (int jn = 0; jn < DH / 16; ++jn) {
      uint32_t b[4];
      hopper::ldsm_x4_t(b, hopper::b_addr_t<Tc<DH>::kChunks>(plane, k0 + 16 * ks, jn, lane));
      hopper::mma(acc[2 * jn], a, b[0], b[1]);
      hopper::mma(acc[2 * jn + 1], a, b[2], b[3]);
    }
  }
}

// Stores rows r and r + 8 (r = r0 + lane / 4) of a 16 x DH accumulator,
// times `mul`, to dst (head column 0 of row 0; rows `stride` apart), rounded
// to bf16. Rows >= limit are skipped; rows >= zero_from get zeros.
template <int DH>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long stride,
                                           const float (&acc)[Tc<DH>::kN][4], float mul, int r0,
                                           int limit, int zero_from, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + (lane >> 2) + 8 * half;
    if (r >= limit) continue;
    const bool zero = r >= zero_from;
    __nv_bfloat16* row = dst + r * stride + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < Tc<DH>::kN; ++j) {
      *reinterpret_cast<uint32_t*>(row + 8 * j) =
          zero ? 0u : hopper::pack_bf16(acc[j][2 * half] * mul, acc[j][2 * half + 1] * mul);
    }
  }
}

}  // namespace attn_tc
