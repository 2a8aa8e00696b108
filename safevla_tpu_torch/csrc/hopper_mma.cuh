// Tensor-core and asynchronous-copy helpers shared by the attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu), for sm_80 and later:
// cp.async 16-byte copies, ldmatrix, and mma.sync.m16n8k16 in bf16 with f32
// accumulators.
//
// Tiles of bf16 rows of one head (C 16-byte chunks a row: C = Dh / 8, so 8
// at the head dim 64 of every path shape) live in shared memory
// XOR-swizzled: chunk c of row r sits at chunk c ^ (r & (min(C, 8) - 1)).
// At C = 8 (and 16) the eight rows that one ldmatrix phase reads (or one
// cp.async phase writes) then fall in eight different groups of four banks,
// with no padding; narrower rows (C = 2, 4) share a 128-byte line between
// rows and keep a two-way conflict.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major):  a0 (row g, k 2t..2t+1), a1 (row g+8, k 2t..),
//                            a2 (row g, k 2t+8..),   a3 (row g+8, k 2t+8..)
//   B (16 x 8, k-major):     b0 (k 2t..2t+1, n g),  b1 (k 2t+8.., n g)
//   C (16 x 8, f32):         c0 c1 (row g, n 2t, 2t+1), c2 c3 (row g+8, ...)
// So the accumulators of two neighbouring 8-column tiles of a product are,
// packed to bf16 pairs, the A fragment of a 16-deep step of the next product
// (`acc_to_a`): p goes from q.k^T into p.v without shared memory.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper {

constexpr int kRowBytes = 128;  // one 64-wide bf16 row

// Byte offset of 16-byte chunk c (0 to C-1) of row r in a swizzled tile of
// rows of C chunks.
template <int C = 8>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  constexpr int kMask = (C < 8 ? C : 8) - 1;
  return static_cast<uint32_t>(r * (16 * C) + ((c ^ (r & kMask)) << 4));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; writes zeros instead when !valid (src is
// then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Waits until at most n of this thread's committed groups are pending. n is
// clamped to 6: waiting for more groups than asked is always safe.
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n < 0 ? 0 : n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and register i receives matrix i (lane: row l / 4, cols 2(l % 4)..+1).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// The same, each matrix transposed (lane: rows 2(l % 4)..+1, col l / 4).
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a * b, bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The A fragment of one 16-deep step from the accumulators of the two 8-wide
// column tiles c0 (columns 0-7) and c1 (columns 8-15), rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// ldmatrix address of lane `lane` for the A fragment of rows r0..r0+15,
// columns 16*kk..16*kk+15 of a swizzled tile at `base`.
template <int C = 8>
__device__ __forceinline__ uint32_t a_addr(uint32_t base, int r0, int kk, int lane) {
  const int mi = lane >> 3;
  return base + swz<C>(r0 + (lane & 7) + ((mi & 1) << 3), 2 * kk + (mi >> 1));
}

// ldmatrix (non-transposed) address for the B fragments of two 8-wide n
// tiles (rows n0..n0+15 of a tile stored n-major, i.e. B^T) at k step kk:
// registers 0-1 are n tile n0, 2-3 n tile n0+8.
template <int C = 8>
__device__ __forceinline__ uint32_t bt_addr(uint32_t base, int n0, int kk, int lane) {
  const int mi = lane >> 3;
  return base + swz<C>(n0 + (lane & 7) + ((mi >> 1) << 3), 2 * kk + (mi & 1));
}

// ldmatrix.trans address for the B fragments of a tile stored k-major (rows
// k0..k0+15 are the 16 k of the step), columns 16*jn..16*jn+15: registers
// 0-1 are n tile 2*jn, 2-3 n tile 2*jn+1.
template <int C = 8>
__device__ __forceinline__ uint32_t b_addr_t(uint32_t base, int k0, int jn, int lane) {
  const int mi = lane >> 3;
  return base + swz<C>(k0 + (lane & 7) + ((mi & 1) << 3), 2 * jn + (mi >> 1));
}

// Max and sum over the four lanes that share a row of a fragment.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace hopper
