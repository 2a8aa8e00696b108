// Packed-qkv bidirectional attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel safevla_tpu/ops/flash_attention.py::_fwd_kernel
// (reached through flash_attention_qkv). Same function, same rounding points:
//   qkv (B, S, 3*H*Dh) with [q | k | v] on the last axis (the raw in_proj /
//   timm qkv output, read through strides: no split copies), key_lens (B,)
//   int32 or null -> out (B, S, H*Dh) in the IO dtype.
//   s = (q . k) * 1/sqrt(Dh) in f32; columns >= key_lens[b] are excluded
//   (the TPU kernel adds -1e30, whose exp is exactly 0); m = row max;
//   e = exp(s - m) in f32; denom = sum(e) in f32; p = e rounded to the IO
//   dtype; out = (sum_j p_j v_j accumulated in f32) / denom, rounded to IO.
//   Query rows in the padding are computed like any other row.
//
// Design (simple first, one block per (128-query tile, head, batch row)):
//   * K_h and V_h of the valid keys of batch row b are staged once per block
//     in dynamic shared memory, each row padded by one 32-bit word so that
//     lanes reading different rows hit different banks. In f32 both would
//     not fit at S=448 (2*448*65*4 B plus the logit rows exceeds 227 KB), so
//     the f32 instantiation stages K only and reads V rows from global memory
//     (coalesced: one 256-byte row per warp step, L2-resident).
//   * One warp per query row at a time (16 warps, 8 rows each). Lanes split
//     the keys for q.k (q lives in registers, f32), store s in a per-warp row
//     of shared memory, reduce max and sum with shuffles, overwrite s with the
//     rounded p, then split the 64 head dims (2 per lane) for p.v.
//   * key_lens[b] must lie in [1, S]. The wrapper cannot check a device
//     tensor without a host synchronisation, so the kernel traps on a value
//     outside the range (the fault surfaces at the next synchronise).
//
// What bounds it on an H100: the work is 4*B*H*S^2*Dh flops against
// 2*B*S*4*H*Dh bytes (qkv read once, out written once) in bf16. At the
// serving shapes (ViT S=448, fusion S=208, Dh=64) that is S/2 = 224 and 104
// flops per byte, under the ~295 at which the bf16 tensor cores become the
// limit, so an ideal kernel is bound by memory (and, at these small sizes,
// by latency). This one
// is not near that bound: it runs q.k and p.v on the CUDA cores in f32
// (FMA), one query row per warp, and keeps one block per SM (the K/V stage
// takes ~145 KB at S=448). What it leaves on the table for a later change:
// wgmma (or mma.sync) tiles for q.k and p.v, an online softmax so that K/V
// stream through a small ring instead of being staged whole, TMA loads, and
// several blocks per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = 128;

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
  __device__ static float round_io(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
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

// bf16 stages K and V; f32 stages K only (see the note at the top)
template <typename T>
constexpr bool kStageV = sizeof(T) == 2;

template <typename T>
size_t smem_bytes(int S) {
  return (kStageV<T> ? 2 : 1) * static_cast<size_t>(S) * Io<T>::kRowStride * sizeof(T) +
         static_cast<size_t>(kWarps) * S * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    attention_qkv_fwd_kernel(const T* __restrict__ qkv, const int* __restrict__ key_lens,
                             T* __restrict__ out, int S, int H, long long stride_b,
                             long long stride_s, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kRS = Io<T>::kRowStride;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = kHeadDim / kVec;

  const int h = static_cast<int>(blockIdx.y);
  const int b = static_cast<int>(blockIdx.z);
  const int kl = key_lens ? key_lens[b] : S;
  if (kl < 1 || kl > S) __trap();

  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + static_cast<size_t>(S) * kRS;  // unused when !kStageV<T>
  float* srow_all = reinterpret_cast<float*>(kStageV<T> ? vs + static_cast<size_t>(S) * kRS : vs);

  const int lanes = H * kHeadDim;
  const T* base = qkv + b * stride_b;
  const T* kg = base + lanes + h * kHeadDim;
  const T* vg = base + 2 * lanes + h * kHeadDim;
  for (int i = threadIdx.x; i < kl * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    stage16(ks + r * kRS + c * kVec, kg + r * stride_s + c * kVec);
    if (kStageV<T>) stage16(vs + r * kRS + c * kVec, vg + r * stride_s + c * kVec);
  }
  const T* vrows = kStageV<T> ? vs : vg;
  const long long vstride = kStageV<T> ? kRS : stride_s;
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* srow = srow_all + warp * S;
  const int tile = static_cast<int>(blockIdx.x);
  const int row_end = min(S, (tile + 1) * kRowsPerBlock);
  for (int row = tile * kRowsPerBlock + warp; row < row_end; row += kWarps) {
    const T* qg = base + row * stride_s + h * kHeadDim;
    float q[kHeadDim];
#pragma unroll
    for (int d = 0; d < kHeadDim; d += 2) {
      const float2 t = Io<T>::load2(qg + d);
      q[d] = t.x;
      q[d + 1] = t.y;
    }

    // logits of this lane's keys, and the row max
    float mx = __int_as_float(0xff800000);  // -inf
    for (int j = lane; j < kl; j += 32) {
      const T* kr = ks + j * kRS;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < kHeadDim; d += 2) {
        const float2 kv = Io<T>::load2(kr + d);
        acc = fmaf(q[d], kv.x, acc);
        acc = fmaf(q[d + 1], kv.y, acc);
      }
      const float s = acc * scale;
      srow[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);

    // f32 denominator; p rounded to the IO dtype for the p.v product
    float sum = 0.f;
    for (int j = lane; j < kl; j += 32) {
      const float e = expf(srow[j] - mx);
      sum += e;
      srow[j] = Io<T>::round_io(e);
    }
    sum = warp_sum(sum);
    __syncwarp();

    const int d0 = 2 * lane;
    float a0 = 0.f, a1 = 0.f;
    for (int j = 0; j < kl; ++j) {
      const float p = srow[j];
      const float2 v = Io<T>::load2(vrows + j * vstride + d0);
      a0 = fmaf(p, v.x, a0);
      a1 = fmaf(p, v.y, a1);
    }
    T* o = out + (static_cast<size_t>(b) * S + row) * lanes + h * kHeadDim + d0;
    Io<T>::store2(o, a0 / sum, a1 / sum);
    __syncwarp();  // the next row overwrites srow
  }
}

template <typename T>
cudaError_t launch(const void* qkv, const void* key_lens, void* out, int B, int S, int H,
                   long long stride_b, long long stride_s, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(S);
  cudaError_t err = cudaFuncSetAttribute(attention_qkv_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kRowsPerBlock - 1) / kRowsPerBlock, H, B);
  attention_qkv_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const int*>(key_lens), static_cast<T*>(out), S,
      H, stride_b, stride_s, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. Strides are in elements; the last axis
// of qkv is contiguous and every row starts on a 16-byte boundary.
// Returns a cudaError_t (0 on success).
extern "C" int attention_qkv_fwd(const void* qkv, const void* key_lens, void* out, int B, int S,
                                 int H, int head_dim, long long stride_b, long long stride_s,
                                 float scale, int dtype, void* stream) {
  if (head_dim != kHeadDim || B < 1 || S < 1 || H < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<__nv_bfloat16>(qkv, key_lens, out, B, S, H, stride_b, stride_s, scale, st);
  if (dtype == 1) return launch<float>(qkv, key_lens, out, B, S, H, stride_b, stride_s, scale, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* attention_qkv_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
