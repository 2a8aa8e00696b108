// The attention backward's matmul-only floor for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tools/exp_attn_bwd.py::bwd_kernel_v at
// variant="mmonly": the five products of the attention backward with the
// softmax replaced by a scale, which measured the backward's floor on the TPU.
// Same function, same rounding points, per (batch row b, head h):
//   qkv (B, S, 3*H*Dh) with [q | k | v] on the last axis and g (B, S, H*Dh),
//   both bf16, read through strides -> dqkv (B, S, 3*H*Dh), packed the same
//   way, bf16.
//   s = q . k^T in f32, with no scale and no key mask (all S keys count);
//   pb = bf16(s * 0.001f) (an f32 multiply, then round to nearest even);
//   dv = pb^T . g and dp = g . v^T in f32; dsb = bf16(dp * 0.001f);
//   dq = dsb . k and dk = dsb^T . q in f32;
//   dqkv = [bf16(dq * scale) | bf16(dk * scale) | bf16(dv)].
// The TPU tool pads S with zero rows, which add nothing to any product: the
// function of the first S rows is this one.
//
// Design: the resident bf16 design of flash_attention_bwd.cu with the
// softmax taken out, on the same tile walk (attention_tc.cuh), so the two
// kernels differ only by the softmax recompute and the masking. One block
// of 4 warps per (head, batch row); Q, K, V and G (rows < S) arrive by
// cp.async into swizzled planes, rows S..round16(S)-1 zero-filled.
//   * Phase A, one warp per 16 query rows (g held as A fragments): over
//     every key chunk, dp = g . v^T, then dq += bf16(0.001 dp) . k, the
//     accumulators fed straight into the A fragments. The logits s feed
//     only pb, which dq does not read: phase A runs one product and one
//     accumulation a chunk (row 2's three passes run five and one).
//   * Phase B, one warp per 16 key rows (k and v held as A fragments): over
//     every query chunk, s^T = k . q^T and dp^T = v . g^T, then
//     dv += bf16(0.001 s^T) . g and dk += bf16(0.001 dp^T) . q (g and q
//     through ldmatrix.trans).
// The planes are written once, before both phases, so no barrier sits
// between them. No atomics: each gradient row is summed by one warp in a
// fixed order, so two runs give the same bits.
//
// Domain: bf16, head dims 16, 32, 64 and 128, S up to the shared memory of
// a block (4 planes of round16(S) rows: S <= 448 at head dim 64), B and H
// up to 65535. The wrapper (tools/torch_exp_attn_bwd.py::mmonly) raises on
// any other call; there is no fallback.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tc.cuh"
#include "hopper_mma.cuh"

namespace {

using namespace attn_tc;

constexpr float kMmScale = 0.001f;  // the TPU tool's stand-in for the softmax
constexpr int kMaxSmem = 232448;    // bytes of shared memory a block may use on an H100

template <int DH>
size_t mmonly_smem_bytes(int S) {
  return 4 * static_cast<size_t>(round16(S)) * Tc<DH>::kRowBytes;
}

// c *= kMmScale, each element (the bf16 rounding follows in acc_to_a).
template <int NT>
__device__ __forceinline__ void scale_chunk(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] *= kMmScale;
  }
}

template <int DH>
__global__ void __launch_bounds__(kTcThreads, 2)
    mmonly_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ g,
                  __nv_bfloat16* __restrict__ dqkv, int S, int H, long long stride_b,
                  long long stride_s, float scale) {
  using T = Tc<DH>;
  constexpr int C = T::kChunks;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int h = static_cast<int>(blockIdx.x);
  const int b = static_cast<int>(blockIdx.y);
  const int s16 = round16(S);
  const int lanes = H * DH;
  const __nv_bfloat16* base = qkv + b * stride_b + h * DH;
  const __nv_bfloat16* g_base = g + static_cast<size_t>(b) * S * lanes + h * DH;
  __nv_bfloat16* d_base = dqkv + b * stride_b + h * DH;

  const uint32_t plane = static_cast<uint32_t>(s16) * T::kRowBytes;
  const uint32_t q_s = hopper::smem_addr(smem_raw);
  const uint32_t k_s = q_s + plane;
  const uint32_t v_s = k_s + plane;
  const uint32_t g_s = v_s + plane;

  for (int i = threadIdx.x; i < s16 * C; i += kTcThreads) {
    const int r = i / C, c = i % C;
    const uint32_t off = hopper::swz<C>(r, c);
    const bool ok = r < S;
    const __nv_bfloat16* src = base + (ok ? r : 0) * stride_s + c * 8;
    hopper::cp_async16(q_s + off, src, ok);
    hopper::cp_async16(k_s + off, src + lanes, ok);
    hopper::cp_async16(v_s + off, src + 2 * lanes, ok);
    hopper::cp_async16(g_s + off, g_base + static_cast<size_t>(ok ? r : 0) * lanes + c * 8, ok);
  }
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  __syncthreads();

  // phase A: one warp per 16 query rows -> dq
  for (int r0 = 16 * warp; r0 < s16; r0 += 16 * (kTcThreads / 32)) {
    uint32_t gf[T::kK][4];
#pragma unroll
    for (int kk = 0; kk < T::kK; ++kk) hopper::ldsm_x4(gf[kk], hopper::a_addr<C>(g_s, r0, kk, lane));
    float dq[T::kN][4];
#pragma unroll
    for (int j = 0; j < T::kN; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
    over_chunks(s16, s16, [&](auto nt, auto, int k0) {
      constexpr int NT = decltype(nt)::value;
      float dp[NT][4];
      product<DH, NT>(dp, gf, v_s, k0, lane);  // dp = g . v^T
      scale_chunk<NT>(dp);
      accumulate<DH, NT>(dq, dp, k_s, k0, lane);  // dq += dsb . k
    });
    store_rows<DH>(d_base, stride_s, dq, scale, r0, S, S, lane);
  }

  // phase B: one warp per 16 key rows -> dk and dv
  for (int j0 = 16 * warp; j0 < s16; j0 += 16 * (kTcThreads / 32)) {
    uint32_t kf[T::kK][4], vf[T::kK][4];
#pragma unroll
    for (int kk = 0; kk < T::kK; ++kk) {
      hopper::ldsm_x4(kf[kk], hopper::a_addr<C>(k_s, j0, kk, lane));
      hopper::ldsm_x4(vf[kk], hopper::a_addr<C>(v_s, j0, kk, lane));
    }
    float dk[T::kN][4], dv[T::kN][4];
#pragma unroll
    for (int j = 0; j < T::kN; ++j) {
      dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
      dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
    }
    over_chunks(s16, s16, [&](auto nt, auto, int i0) {
      constexpr int NT = decltype(nt)::value;
      float st[NT][4], dpt[NT][4];
      product<DH, NT>(st, kf, q_s, i0, lane);   // s^T = k . q^T
      product<DH, NT>(dpt, vf, g_s, i0, lane);  // dp^T = v . g^T
      scale_chunk<NT>(st);
      scale_chunk<NT>(dpt);
      accumulate<DH, NT>(dv, st, g_s, i0, lane);   // dv += pb^T . g
      accumulate<DH, NT>(dk, dpt, q_s, i0, lane);  // dk += dsb^T . q
    });
    store_rows<DH>(d_base + lanes, stride_s, dk, scale, j0, S, S, lane);
    store_rows<DH>(d_base + 2 * lanes, stride_s, dv, 1.f, j0, S, S, lane);
  }
}

template <int DH>
cudaError_t launch(const void* qkv, const void* g, void* dqkv, int B, int S, int H,
                   long long stride_b, long long stride_s, float scale, cudaStream_t stream) {
  const size_t smem = mmonly_smem_bytes<DH>(S);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mmonly_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  mmonly_kernel<DH><<<dim3(H, B), kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(g),
      static_cast<__nv_bfloat16*>(dqkv), S, H, stride_b, stride_s, scale);
  return cudaGetLastError();
}

}  // namespace

// bf16 only; head_dim 16, 32, 64 or 128; 1 <= B, H <= 65535; S at most the
// shared memory of a block allows. qkv and dqkv share the strides (in
// elements) stride_b, stride_s with a contiguous last axis; g is contiguous
// (B, S, H*Dh); every row starts on a 16-byte boundary. Returns a
// cudaError_t (0 on success).
extern "C" int exp_attn_bwd_mmonly(const void* qkv, const void* g, void* dqkv, int B, int S, int H,
                                   int head_dim, long long stride_b, long long stride_s,
                                   float scale, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || S < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch<16>(qkv, g, dqkv, B, S, H, stride_b, stride_s, scale, st);
    case 32: return launch<32>(qkv, g, dqkv, B, S, H, stride_b, stride_s, scale, st);
    case 64: return launch<64>(qkv, g, dqkv, B, S, H, stride_b, stride_s, scale, st);
    case 128: return launch<128>(qkv, g, dqkv, B, S, H, stride_b, stride_s, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* exp_attn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
