// Helpers shared by the attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu, exp_attn_bwd.cu, attention_stream.cuh), for sm_80
// and later: the 32-bit shared address of a pointer, the cp.async 16-byte
// copies of the streaming designs, bf16 rounding and packing, a one-
// instruction exp2, and the max
// and sum over the four lanes that share a row of a tensor-core accumulator
// (an mma.sync C fragment or a wgmma D tile: row g = lane / 4 holds columns
// 2 (lane % 4), + 1 of every 8).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper {

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

// Two f32 values rounded to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 2^x in one SFU instruction (ex2.approx.ftz.f32: within 2 ulp; results
// below 2^-126 flushed to 0, which moves no bf16 p of a row whose max term
// is 1 by more than 2^-126).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Max and sum over the four lanes that share a row of an accumulator.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace hopper
