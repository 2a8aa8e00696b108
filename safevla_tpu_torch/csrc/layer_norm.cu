// Row LayerNorm forward and backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels safevla_tpu/ops/layer_norm.py::_ln_fwd_kernel
// (reached through _ln_fwd / layer_norm_rows / layer_norm) and ::_ln_bwd_kernel
// (reached through _ln_bwd, the custom-VJP backward). Same function, same
// rounding points, on x viewed as (R, D) rows:
//   stats in f32 with the fast variance: mu = mean(x), var = max(0,
//   mean(x*x) - mu^2), rs = rsqrt(var + eps);
//   forward: y = (x - mu) * (rs * gamma) + beta in f32, rounded once to the
//   output dtype;
//   backward (g cast to f32 first): xhat = (x - mu) * rs, gh = g * gamma,
//   dx = rs * (gh - mean(gh) - xhat * mean(gh * xhat)) rounded to x's dtype;
//   dgamma = sum_rows g * xhat and dbeta = sum_rows g in f32, written as one
//   partial row per block ((n_blocks, D), no atomics: deterministic) and
//   summed by the wrapper, as the TPU wrapper sums its (8, D) partials.
// gamma and beta are f32. x, the output and g are bfloat16 or float32.
//
// Design (simple first): one warp per row. D is a multiple of 128 up to 1024
// (ViT-S 384, the fusion 512), so every lane holds NV = D / 128 vectors of 4
// consecutive elements (8-byte loads in bf16, 16-byte in f32; neighbouring
// lanes read neighbouring vectors). The row stays in registers between the
// statistics and the output; the sums are warp shuffles. The forward block is
// 8 warps on 8 rows. The backward block is 8 warps on 64 rows (8 each); every
// lane keeps its columns' dgamma / dbeta sums in registers over its rows, and
// the block folds its 8 warps' sums in shared memory, in a fixed order, into
// its partial row.
//
// What bounds it on an H100: bytes. The forward reads x and writes y once
// (R*D*(in + out) bytes) for ~8 flops per element; the backward reads x and g
// and writes dx (+ the partial rows) for ~20 flops per element: far below the
// ~20 flops per byte at which the f32 CUDA cores would become the limit. So
// an ideal kernel streams at the HBM rate; this one reads each element once,
// and leaves for later: more rows in flight per warp to hide the load
// latency of one row, and fusing the LayerNorm into its neighbours (the
// residual add before it, the matmul after it), which would remove whole
// passes over the activations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kFwdRowsPerBlock = kWarps;
constexpr int kBwdRowsPerWarp = 8;
constexpr int kBwdRowsPerBlock = kWarps * kBwdRowsPerWarp;
constexpr int kMaxVecs = 8;  // D <= 1024

// four consecutive elements <-> float4
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&a);
  raw.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// mu and rs of one row held as v[NV] (lane's vectors), f32 fast variance
template <int NV>
__device__ __forceinline__ void row_stats(const float4 (&v)[NV], int D, float eps, float& mu,
                                          float& rs) {
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    s += (v[k].x + v[k].y) + (v[k].z + v[k].w);
    s2 += (v[k].x * v[k].x + v[k].y * v[k].y) + (v[k].z * v[k].z + v[k].w * v[k].w);
  }
  const float inv_d = 1.f / static_cast<float>(D);
  mu = warp_sum(s) * inv_d;
  const float mu2 = warp_sum(s2) * inv_d;
  rs = rsqrtf(fmaxf(0.f, mu2 - mu * mu) + eps);
}

template <typename TX, typename TO, int NV>
__global__ void __launch_bounds__(kThreads)
    layer_norm_fwd_kernel(const TX* __restrict__ x, const float* __restrict__ gamma,
                          const float* __restrict__ beta, TO* __restrict__ out, int R, float eps) {
  constexpr int D = NV * 128;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kFwdRowsPerBlock + (threadIdx.x >> 5);
  if (row >= R) return;
  const TX* xr = x + static_cast<size_t>(row) * D;
  float4 v[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) v[k] = load4(xr + (k * 32 + lane) * 4);
  float mu, rs;
  row_stats<NV>(v, D, eps, mu, rs);
  TO* orow = out + static_cast<size_t>(row) * D;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = (k * 32 + lane) * 4;
    const float4 gm = load4(gamma + c);
    const float4 bt = load4(beta + c);
    float4 y;
    y.x = (v[k].x - mu) * (rs * gm.x) + bt.x;
    y.y = (v[k].y - mu) * (rs * gm.y) + bt.y;
    y.z = (v[k].z - mu) * (rs * gm.z) + bt.z;
    y.w = (v[k].w - mu) * (rs * gm.w) + bt.w;
    store4(orow + c, y);
  }
}

template <typename TX, typename TG, int NV>
__global__ void __launch_bounds__(kThreads)
    layer_norm_bwd_kernel(const TX* __restrict__ x, const float* __restrict__ gamma,
                          const TG* __restrict__ g, TX* __restrict__ dx,
                          float* __restrict__ dgamma_part, float* __restrict__ dbeta_part, int R,
                          float eps) {
  constexpr int D = NV * 128;
  __shared__ __align__(16) float red[kWarps][D];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float inv_d = 1.f / static_cast<float>(D);

  float4 gm[NV], dgam[NV], dbet[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    gm[k] = load4(gamma + (k * 32 + lane) * 4);
    dgam[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    dbet[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int row0 = blockIdx.x * kBwdRowsPerBlock + warp * kBwdRowsPerWarp;
  for (int i = 0; i < kBwdRowsPerWarp; ++i) {
    const int row = row0 + i;
    if (row >= R) break;
    const size_t off = static_cast<size_t>(row) * D;
    float4 xv[NV], gv[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      xv[k] = load4(x + off + (k * 32 + lane) * 4);
      gv[k] = load4(g + off + (k * 32 + lane) * 4);
    }
    float mu, rs;
    row_stats<NV>(xv, D, eps, mu, rs);
    // xv becomes xhat, gv stays g; gh = g * gamma is recomputed where used
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      xv[k].x = (xv[k].x - mu) * rs;
      xv[k].y = (xv[k].y - mu) * rs;
      xv[k].z = (xv[k].z - mu) * rs;
      xv[k].w = (xv[k].w - mu) * rs;
      const float4 gh = make_float4(gv[k].x * gm[k].x, gv[k].y * gm[k].y, gv[k].z * gm[k].z,
                                    gv[k].w * gm[k].w);
      s1 += (gh.x + gh.y) + (gh.z + gh.w);
      s2 += (gh.x * xv[k].x + gh.y * xv[k].y) + (gh.z * xv[k].z + gh.w * xv[k].w);
    }
    const float m1 = warp_sum(s1) * inv_d;
    const float m2 = warp_sum(s2) * inv_d;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = (k * 32 + lane) * 4;
      float4 d;
      d.x = rs * (gv[k].x * gm[k].x - m1 - xv[k].x * m2);
      d.y = rs * (gv[k].y * gm[k].y - m1 - xv[k].y * m2);
      d.z = rs * (gv[k].z * gm[k].z - m1 - xv[k].z * m2);
      d.w = rs * (gv[k].w * gm[k].w - m1 - xv[k].w * m2);
      store4(dx + off + c, d);
      dgam[k].x += gv[k].x * xv[k].x;
      dgam[k].y += gv[k].y * xv[k].y;
      dgam[k].z += gv[k].z * xv[k].z;
      dgam[k].w += gv[k].w * xv[k].w;
      dbet[k].x += gv[k].x;
      dbet[k].y += gv[k].y;
      dbet[k].z += gv[k].z;
      dbet[k].w += gv[k].w;
    }
  }

  // fold the 8 warps' column sums, warp 0 first: the same order every run
  float* part_rows[2] = {dgamma_part, dbeta_part};
#pragma unroll
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int k = 0; k < NV; ++k)
      *reinterpret_cast<float4*>(&red[warp][(k * 32 + lane) * 4]) = which ? dbet[k] : dgam[k];
    __syncthreads();
    for (int c = threadIdx.x; c < D; c += kThreads) {
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) acc += red[w][c];
      part_rows[which][static_cast<size_t>(blockIdx.x) * D + c] = acc;
    }
    __syncthreads();  // red is rewritten by the next pass
  }
}

template <typename TX, typename TO, int NV>
cudaError_t launch_fwd(const void* x, const void* gamma, const void* beta, void* out, int R,
                       float eps, cudaStream_t stream) {
  const int blocks = (R + kFwdRowsPerBlock - 1) / kFwdRowsPerBlock;
  layer_norm_fwd_kernel<TX, TO, NV><<<blocks, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<TO*>(out), R, eps);
  return cudaGetLastError();
}

template <typename TX, typename TG, int NV>
cudaError_t launch_bwd(const void* x, const void* gamma, const void* g, void* dx,
                       void* dgamma_part, void* dbeta_part, int R, float eps,
                       cudaStream_t stream) {
  const int blocks = (R + kBwdRowsPerBlock - 1) / kBwdRowsPerBlock;
  layer_norm_bwd_kernel<TX, TG, NV><<<blocks, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(gamma), static_cast<const TG*>(g),
      static_cast<TX*>(dx), static_cast<float*>(dgamma_part), static_cast<float*>(dbeta_part), R,
      eps);
  return cudaGetLastError();
}

// dispatch on NV = D / 128 (1..8)
#define LN_DISPATCH_NV(NVAR, CALL) \
  switch (NVAR) {                  \
    case 1: { constexpr int NV = 1; return CALL; } \
    case 2: { constexpr int NV = 2; return CALL; } \
    case 3: { constexpr int NV = 3; return CALL; } \
    case 4: { constexpr int NV = 4; return CALL; } \
    case 5: { constexpr int NV = 5; return CALL; } \
    case 6: { constexpr int NV = 6; return CALL; } \
    case 7: { constexpr int NV = 7; return CALL; } \
    case 8: { constexpr int NV = 8; return CALL; } \
    default: return cudaErrorInvalidValue;          \
  }

template <typename TX, typename TO>
cudaError_t fwd_nv(int nv, const void* x, const void* gamma, const void* beta, void* out, int R,
                   float eps, cudaStream_t st) {
  LN_DISPATCH_NV(nv, (launch_fwd<TX, TO, NV>(x, gamma, beta, out, R, eps, st)))
}

template <typename TX, typename TG>
cudaError_t bwd_nv(int nv, const void* x, const void* gamma, const void* g, void* dx, void* dgp,
                   void* dbp, int R, float eps, cudaStream_t st) {
  LN_DISPATCH_NV(nv, (launch_bwd<TX, TG, NV>(x, gamma, g, dx, dgp, dbp, R, eps, st)))
}

bool valid_shape(int R, int D) { return R >= 1 && D >= 128 && D % 128 == 0 && D / 128 <= kMaxVecs; }

}  // namespace

// dtype codes: 0 = bfloat16, 1 = float32. Every pointer is 16-byte aligned;
// x, out, g and dx are contiguous (R, D); gamma and beta are f32 (D,).
// Each returns a cudaError_t (0 on success).
extern "C" int layer_norm_fwd(const void* x, const void* gamma, const void* beta, void* out, int R,
                              int D, float eps, int x_dtype, int out_dtype, void* stream) {
  if (!valid_shape(R, D)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nv = D / 128;
  if (x_dtype == 0 && out_dtype == 0)
    return fwd_nv<__nv_bfloat16, __nv_bfloat16>(nv, x, gamma, beta, out, R, eps, st);
  if (x_dtype == 0 && out_dtype == 1)
    return fwd_nv<__nv_bfloat16, float>(nv, x, gamma, beta, out, R, eps, st);
  if (x_dtype == 1 && out_dtype == 0)
    return fwd_nv<float, __nv_bfloat16>(nv, x, gamma, beta, out, R, eps, st);
  if (x_dtype == 1 && out_dtype == 1)
    return fwd_nv<float, float>(nv, x, gamma, beta, out, R, eps, st);
  return cudaErrorInvalidValue;
}

// dgamma_part and dbeta_part are f32 (layer_norm_bwd_partial_rows(R), D)
extern "C" int layer_norm_bwd(const void* x, const void* gamma, const void* g, void* dx,
                              void* dgamma_part, void* dbeta_part, int R, int D, float eps,
                              int x_dtype, int g_dtype, void* stream) {
  if (!valid_shape(R, D)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nv = D / 128;
  if (x_dtype == 0 && g_dtype == 0)
    return bwd_nv<__nv_bfloat16, __nv_bfloat16>(nv, x, gamma, g, dx, dgamma_part, dbeta_part, R,
                                                 eps, st);
  if (x_dtype == 0 && g_dtype == 1)
    return bwd_nv<__nv_bfloat16, float>(nv, x, gamma, g, dx, dgamma_part, dbeta_part, R, eps, st);
  if (x_dtype == 1 && g_dtype == 0)
    return bwd_nv<float, __nv_bfloat16>(nv, x, gamma, g, dx, dgamma_part, dbeta_part, R, eps, st);
  if (x_dtype == 1 && g_dtype == 1)
    return bwd_nv<float, float>(nv, x, gamma, g, dx, dgamma_part, dbeta_part, R, eps, st);
  return cudaErrorInvalidValue;
}

extern "C" int layer_norm_bwd_partial_rows(int R) {
  return (R + kBwdRowsPerBlock - 1) / kBwdRowsPerBlock;
}

extern "C" const char* layer_norm_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" const char* layer_norm_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
