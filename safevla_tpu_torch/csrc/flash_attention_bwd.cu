// Packed-qkv bidirectional attention backward (the VJP) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel safevla_tpu/ops/flash_attention.py::_bwd_kernel
// (reached through _flash_attention_qkv_bwd, the custom VJP of attention_qkv).
// Same function, same rounding points, per (batch row b, head h):
//   qkv (B, S, 3*H*Dh) with [q | k | v] on the last axis and the cotangent
//   g (B, S, H*Dh), both in the IO dtype, read through strides (no split
//   copies); key_lens (B,) int32 or null -> dqkv (B, S, 3*H*Dh), packed the
//   same way, in the IO dtype.
//   s = (q . k) * 1/sqrt(Dh) in f32 over the valid keys j < key_lens[b] (the
//   TPU kernel adds -1e30 to the others, whose exp is exactly 0);
//   m = row max; e = exp(s - m); p = io(e / rowsum(e)) -- the division comes
//   BEFORE the cast to the IO dtype, unlike the forward;
//   dv_j = sum_i p_ij g_i; dp_ij = g_i . v_j; D_i = sum_j dp_ij p_ij;
//   ds_ij = p_ij (dp_ij - D_i); dsb = io(ds);
//   dq_i = io(scale * sum_j dsb_ij k_j); dk_j = io(scale * sum_i dsb_ij q_i);
//   dv_j = io(dv_j); every sum accumulated in f32. Masked key rows
//   (j >= key_lens[b]) get p = 0, so their dk and dv are exactly 0.
//
// Design (simple first, one block per (head, batch row), no atomics):
//   * Q, K, V and G of (b, h) are staged once in dynamic shared memory, each
//     row padded by one 32-bit word so that lanes reading different rows hit
//     different banks (bf16: ~110 KB at S=208). In f32 the four would take
//     ~216 KB plus the per-warp rows, over the 227 KB limit, so the f32
//     instantiation stages Q, K, V and reads G rows from global memory
//     (L2-resident). f32 serves the checks and the small reference policy.
//   * Phase 1, one warp per query row i (16 warps): lanes split the valid
//     keys; q_i, then g_i, sit in registers for s and dp; shuffles reduce m,
//     rowsum(e) and D_i; the row's p and io(ds) go to per-warp rows of shared
//     memory; then lanes split the 64 head dims (2 each) for dq_i. m, rowsum
//     and D of every row are kept in shared memory.
//   * Phase 2, after a block barrier, one warp per key row j: lanes split the
//     query rows and recompute p_ij and io(ds_ij) with k_j, then v_j, in
//     registers (the same FMA order as phase 1, so the same bits); then lanes
//     split the head dims for dv_j and dk_j.
//   Each gradient row is summed by one warp in a fixed order, so the result
//   is deterministic (two runs give the same bits).
//   * key_lens[b] must lie in [1, S]; the kernel traps otherwise (a host-side
//     check would synchronise every call).
//
// What bounds it on an H100: the work is ~10*S*kl*Dh flops per (b, h) (s, dp,
// dv, dq, dk) against 7*B*S*H*Dh IO elements (qkv and g read once, dqkv
// written once). At the update's shape (S=208, Dh=64, ~190 valid keys) that is
// ~270 flops per bf16 element, ~135 per byte: under the ~295 at which the
// bf16 tensor cores become the limit, so an ideal kernel is bound by memory.
// This one is far from it: every product runs on the CUDA cores in f32 (FMA),
// p is recomputed in both phases, and one block of 512 threads fills an SM
// (the staged operands take ~139 KB). Left for a later change: wgmma tiles for
// the five products, TMA loads, and several blocks per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;

template <typename T>
struct Io;

template <>
struct Io<__nv_bfloat16> {
  // 64 values + 2 pad = 33 words per staged row
  static constexpr int kRowStride = kHeadDim + 2;
  __device__ static float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ static void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
  __device__ static float round_io(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
};

template <>
struct Io<float> {
  // 64 values + 1 pad = 65 words per staged row
  static constexpr int kRowStride = kHeadDim + 1;
  __device__ static float2 load2(const float* p) { return make_float2(p[0], p[1]); }
  __device__ static void store2(float* p, float a, float b) {
    p[0] = a;
    p[1] = b;
  }
  __device__ static float round_io(float x) { return x; }
};

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

// Copies one 16-byte chunk from global memory into a staged row whose start
// is only 4-byte aligned (the padded stride breaks 16-byte alignment).
__device__ __forceinline__ void stage16(void* dst, const void* src) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  uint32_t* d = reinterpret_cast<uint32_t*>(dst);
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}

template <typename T>
__device__ __forceinline__ void load_row(float (&r)[kHeadDim], const T* p) {
#pragma unroll
  for (int d = 0; d < kHeadDim; d += 2) {
    const float2 t = Io<T>::load2(p + d);
    r[d] = t.x;
    r[d + 1] = t.y;
  }
}

// r . row, with d ascending: phase 1 and phase 2 both compute each product
// with this function, so p and ds agree bit for bit between them.
template <typename T>
__device__ __forceinline__ float dot_row(const float (&r)[kHeadDim], const T* row) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < kHeadDim; d += 2) {
    const float2 x = Io<T>::load2(row + d);
    acc = fmaf(r[d], x.x, acc);
    acc = fmaf(r[d + 1], x.y, acc);
  }
  return acc;
}

// bf16 stages G too; f32 reads G from global memory (see the note at the top)
template <typename T>
constexpr bool kStageG = sizeof(T) == 2;

template <typename T>
size_t smem_bytes(int S) {
  const size_t rows = (kStageG<T> ? 4 : 3) * static_cast<size_t>(S) * Io<T>::kRowStride * sizeof(T);
  return rows + (2 * static_cast<size_t>(kWarps) + 3) * S * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    attention_qkv_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ g,
                             const int* __restrict__ key_lens, T* __restrict__ dqkv, int S, int H,
                             long long stride_b, long long stride_s, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kRS = Io<T>::kRowStride;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = kHeadDim / kVec;

  const int h = static_cast<int>(blockIdx.x);
  const int b = static_cast<int>(blockIdx.y);
  const int kl = key_lens ? key_lens[b] : S;
  if (kl < 1 || kl > S) __trap();

  const size_t plane = static_cast<size_t>(S) * kRS;
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + plane;
  T* vs = ks + plane;
  T* gs = vs + plane;  // unused when !kStageG<T>
  float* prow_all = reinterpret_cast<float*>(kStageG<T> ? gs + plane : gs);
  float* drow_all = prow_all + kWarps * S;
  float* m_s = drow_all + kWarps * S;
  float* l_s = m_s + S;
  float* d_s = l_s + S;

  const int lanes = H * kHeadDim;
  const T* base = qkv + b * stride_b + h * kHeadDim;
  const T* gg = g + (static_cast<size_t>(b) * S) * lanes + h * kHeadDim;
  for (int i = threadIdx.x; i < S * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * kVec;
    const T* src = base + r * stride_s + c;
    stage16(qs + r * kRS + c, src);
    if (r < kl) {
      stage16(ks + r * kRS + c, src + lanes);
      stage16(vs + r * kRS + c, src + 2 * lanes);
    }
    if (kStageG<T>) stage16(gs + r * kRS + c, gg + static_cast<size_t>(r) * lanes + c);
  }
  const T* grows = kStageG<T> ? gs : gg;
  const long long gstride = kStageG<T> ? kRS : lanes;
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int d0 = 2 * lane;
  float* prow = prow_all + warp * S;
  float* drow = drow_all + warp * S;
  T* out_base = dqkv + b * stride_b + h * kHeadDim + d0;
  float r[kHeadDim];

  // phase 1: one warp per query row -> m, rowsum(e), D, and dq
  for (int i = warp; i < S; i += kWarps) {
    load_row<T>(r, qs + i * kRS);
    float mx = __int_as_float(0xff800000);  // -inf
    for (int j = lane; j < kl; j += 32) {
      const float s = dot_row<T>(r, ks + j * kRS) * scale;
      prow[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < kl; j += 32) {
      const float e = expf(prow[j] - mx);
      prow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    load_row<T>(r, grows + i * gstride);
    float dsum = 0.f;
    for (int j = lane; j < kl; j += 32) {
      const float p = Io<T>::round_io(prow[j] / sum);
      const float dp = dot_row<T>(r, vs + j * kRS);
      prow[j] = p;
      drow[j] = dp;
      dsum = fmaf(dp, p, dsum);
    }
    const float dsum_all = warp_sum(dsum);
    for (int j = lane; j < kl; j += 32) drow[j] = Io<T>::round_io(prow[j] * (drow[j] - dsum_all));
    __syncwarp();
    float a0 = 0.f, a1 = 0.f;
    for (int j = 0; j < kl; ++j) {
      const float ds = drow[j];
      const float2 k = Io<T>::load2(ks + j * kRS + d0);
      a0 = fmaf(ds, k.x, a0);
      a1 = fmaf(ds, k.y, a1);
    }
    Io<T>::store2(out_base + i * stride_s, a0 * scale, a1 * scale);
    if (lane == 0) {
      m_s[i] = mx;
      l_s[i] = sum;
      d_s[i] = dsum_all;
    }
    __syncwarp();  // the next row overwrites prow / drow
  }
  __syncthreads();

  // phase 2: one warp per key row -> dk and dv
  for (int j = warp; j < S; j += kWarps) {
    T* out = out_base + j * stride_s;
    if (j >= kl) {  // masked key: p = 0 for every query row
      Io<T>::store2(out + lanes, 0.f, 0.f);
      Io<T>::store2(out + 2 * lanes, 0.f, 0.f);
      continue;
    }
    load_row<T>(r, ks + j * kRS);
    for (int i = lane; i < S; i += 32) {
      const float s = dot_row<T>(r, qs + i * kRS) * scale;
      prow[i] = Io<T>::round_io(expf(s - m_s[i]) / l_s[i]);
    }
    load_row<T>(r, vs + j * kRS);
    for (int i = lane; i < S; i += 32) {
      const float dp = dot_row<T>(r, grows + i * gstride);
      drow[i] = Io<T>::round_io(prow[i] * (dp - d_s[i]));
    }
    __syncwarp();
    float k0 = 0.f, k1 = 0.f, v0 = 0.f, v1 = 0.f;
    for (int i = 0; i < S; ++i) {
      const float p = prow[i];
      const float ds = drow[i];
      const float2 gv = Io<T>::load2(grows + i * gstride + d0);
      const float2 qv = Io<T>::load2(qs + i * kRS + d0);
      v0 = fmaf(p, gv.x, v0);
      v1 = fmaf(p, gv.y, v1);
      k0 = fmaf(ds, qv.x, k0);
      k1 = fmaf(ds, qv.y, k1);
    }
    Io<T>::store2(out + lanes, k0 * scale, k1 * scale);
    Io<T>::store2(out + 2 * lanes, v0, v1);
    __syncwarp();
  }
}

template <typename T>
cudaError_t launch(const void* qkv, const void* g, const void* key_lens, void* dqkv, int B, int S,
                   int H, long long stride_b, long long stride_s, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(S);
  cudaError_t err = cudaFuncSetAttribute(attention_qkv_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B);
  attention_qkv_bwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(g), static_cast<const int*>(key_lens),
      static_cast<T*>(dqkv), S, H, stride_b, stride_s, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. qkv and dqkv share the strides (in
// elements) stride_b, stride_s with a contiguous last axis; g is contiguous
// (B, S, H*Dh); every row starts on a 16-byte boundary.
// Returns a cudaError_t (0 on success).
extern "C" int attention_qkv_bwd(const void* qkv, const void* g, const void* key_lens, void* dqkv,
                                 int B, int S, int H, int head_dim, long long stride_b,
                                 long long stride_s, float scale, int dtype, void* stream) {
  if (head_dim != kHeadDim || B < 1 || S < 1 || H < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<__nv_bfloat16>(qkv, g, key_lens, dqkv, B, S, H, stride_b, stride_s, scale, st);
  if (dtype == 1)
    return launch<float>(qkv, g, key_lens, dqkv, B, S, H, stride_b, stride_s, scale, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* attention_qkv_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
