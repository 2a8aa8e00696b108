// Packed-qkv bidirectional attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel safevla_tpu/ops/flash_attention.py::_fwd_kernel
// (reached through flash_attention_qkv). Same function, same rounding points:
//   qkv (B, S, 3*H*Dh) with [q | k | v] on the last axis (the raw in_proj /
//   timm qkv output, read through strides: no split copies), key_lens (B,)
//   int32 or null -> out (B, S, H*Dh) in the IO dtype.
//   s = (q . k) * 1/sqrt(Dh) in f32; columns >= key_lens[b] are excluded
//   (the TPU kernel adds -1e30, whose exp is exactly 0); m = row max over the
//   valid keys; e = exp(s - m) in f32; denom = sum(e) in f32 (of the unrounded
//   e); p = e rounded to the IO dtype; out = (sum_j p_j v_j accumulated in
//   f32) / denom, rounded to IO. Query rows in the padding are computed like
//   any other row. key_lens[b] must lie in [1, S]: the kernel traps
//   otherwise (a host-side check would synchronise every call).
//
// What bounds it on an H100: 4*S*kl*Dh flops per (b, h) for q.k and p.v
// against 2*B*S*4*H*Dh bytes (qkv read once, out written once) in bf16. At
// the path's shapes (ViT S=448, fusion S=208, Dh=64) that is S/2 = 224 and
// 104 flops per byte, under the ~295 at which the bf16 tensor cores become
// the limit: an ideal kernel is bound by memory and, at these sizes, by
// latency (a few microseconds of work per launch).
//
// The dtype picks the design (dispatch by dtype; a failed build or launch
// raises in either):
//
// bf16 (the policy's compute dtype: every launch on the main path) runs on
// the tensor cores, mma.sync.m16n8k16 with f32 accumulators (helpers in
// hopper_mma.cuh):
//   * One block of 4 warps per (64-query tile, head, batch row); each warp
//     owns 16 query rows, held as A fragments in registers for the whole
//     block. At S=448 K takes 7 tiles of 8 KB and the V ring 16 KB (Q is
//     staged in the ring's first slot before V arrives), 72 KB in all, so
//     three blocks fit on an SM; at S=208, 48 KB, four (the register cap of
//     128 a thread lets them; the f32 design below fits one block).
//   * K and V arrive in tiles of 64 keys by cp.async (16-byte chunks, one
//     commit group per tile) into XOR-swizzled rows read by ldmatrix. Tiles
//     wholly past key_lens[b] are never loaded; the rows of the last tile
//     past it are zero-filled by the copy and their columns masked to an
//     exp of exactly 0. K stays resident (both passes read it; pass 1 starts
//     once all of K has landed, with V's first two tiles in flight); V
//     streams through a two-slot ring, the next tile's copy in flight while
//     the current one is multiplied.
//   * Two passes over the key tiles keep the TPU kernel's rounding points
//     (an online softmax would round p against a running max, not the
//     row's): pass 1 runs q.k^T alone for the row max; pass 2 recomputes
//     s (the same mma sequence, so the same bits), forms e, the f32
//     denominator and p = bf16(e), and feeds p from the q.k^T accumulators
//     straight into the A fragments of p.v (no trip through shared memory).
//   * mma.sync, not wgmma: the kernel sits below the ridge (see above), its
//     tiles are small and it needs the accumulator-to-A-fragment reuse that
//     mma.sync gives; wgmma would pay off only if the measured kernel sat at
//     its operations bound.
//
// f32 (the checks and the small f32 reference policy; TF32 tensor cores
// would miss the 1e-4 tolerance) keeps the CUDA-core design of the first
// port: one block per (128-query tile, head, batch row), K of the valid keys
// staged in shared memory (rows padded by one word against bank conflicts),
// V read from global memory (L2-resident), one warp per query row (16 warps,
// 8 rows each): lanes split the keys for q.k, shuffles reduce max and sum,
// then lanes split the head dims for p.v, f32 FMAs throughout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

constexpr int kHeadDim = 64;

// ---------------------------------------------------------------- bf16 ---

constexpr int kTile = 64;         // query rows per block; keys per K / V tile
constexpr int kTcThreads = 128;   // 4 warps x 16 query rows
constexpr int kTileBytes = kTile * hopper::kRowBytes;

int tc_smem_bytes(int S) { return (2 + (S + kTile - 1) / kTile) * kTileBytes; }

// cp.async of rows row0..row0+63 of one head's 64 columns (src points at the
// head's first column of row 0) into a swizzled tile; rows >= limit are
// zero-filled. 512 chunks of 16 bytes, four per thread.
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src, int row0,
                                          int limit, long long stride_s) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = static_cast<int>(threadIdx.x) + k * kTcThreads;
    const int r = i >> 3, c = i & 7;
    const int row = row0 + r;
    const bool ok = row < limit;
    hopper::cp_async16(dst + hopper::swz(r, c), src + (ok ? row : 0) * stride_s + c * 8, ok);
  }
}

// s (16 rows x 64 keys of one tile, as 8 n tiles) = q . k^T, unscaled.
__device__ __forceinline__ void qk_tile(float (&s)[8][4], const uint32_t (&qf)[4][4],
                                        uint32_t k_tile, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      uint32_t b[4];
      hopper::ldsm_x4(b, hopper::bt_addr(k_tile, 16 * jn, kk, lane));
      hopper::mma(s[2 * jn], qf[kk], b[0], b[1]);
      hopper::mma(s[2 * jn + 1], qf[kk], b[2], b[3]);
    }
  }
}

__global__ void __launch_bounds__(kTcThreads, 4)
    attention_fwd_tc_kernel(const __nv_bfloat16* __restrict__ qkv, const int* __restrict__ key_lens,
                            __nv_bfloat16* __restrict__ out, int S, int H, long long stride_b,
                            long long stride_s, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = static_cast<int>(blockIdx.x) * kTile;
  const int h = static_cast<int>(blockIdx.y);
  const int b = static_cast<int>(blockIdx.z);
  const int kl = key_lens ? key_lens[b] : S;
  if (kl < 1 || kl > S) __trap();
  const int n_tiles = (kl + kTile - 1) / kTile;
  const int lanes = H * kHeadDim;
  const __nv_bfloat16* base = qkv + b * stride_b + h * kHeadDim;

  // shared memory: the V ring (2 tiles; Q passes through slot 0 first), then
  // K tiles 0..n_tiles-1. Commit groups: Q, K_0..K_{n-1}, V_0, V_1, ...
  const uint32_t v_ring = hopper::smem_addr(smem_raw);
  const uint32_t k_base = v_ring + 2 * kTileBytes;
  load_tile(v_ring, base, q0, S, stride_s);
  hopper::cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    load_tile(k_base + t * kTileBytes, base + lanes, t * kTile, kl, stride_s);
    hopper::cp_async_commit();
  }
  int committed = 1 + n_tiles;

  hopper::cp_async_wait_dyn(n_tiles);  // Q has landed
  __syncthreads();
  uint32_t qf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) hopper::ldsm_x4(qf[kk], hopper::a_addr(v_ring, 16 * warp, kk, lane));
  __syncthreads();  // slot 0 holds V from here
  for (int t = 0; t < 2 && t < n_tiles; ++t, ++committed) {
    load_tile(v_ring + t * kTileBytes, base + 2 * lanes, t * kTile, kl, stride_s);
    hopper::cp_async_commit();
  }

  // a warp whose 16 rows all lie past S takes part in the copies and
  // barriers only
  const bool active = q0 + 16 * warp < S;
  const int col0 = 2 * (lane & 3);

  // Logits in log2 units: exp(s - m) = exp2(s * log2(e) - m * log2(e)), so
  // each e is one FFMA and one exp2 (the f32 values agree to a few ulp).
  const float scale2 = scale * 1.4426950408889634f;

  // pass 1: the row max of the scaled logits over the valid keys
  const float neg_inf = __int_as_float(0xff800000);
  float m[2] = {neg_inf, neg_inf};  // rows lane/4 and lane/4 + 8 (log2 units)
  hopper::cp_async_wait_dyn(committed - 1 - n_tiles);  // every K tile (K_t is group 1 + t)
  __syncthreads();
  for (int t = 0; t < n_tiles; ++t) {
    if (active) {
      float s[8][4];
      qk_tile(s, qf, k_base + t * kTileBytes, lane);
      const int valid = kl - t * kTile - col0;  // columns of this tile < valid + col0 are keys
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (8 * j + (e & 1) < valid) m[e >> 1] = fmaxf(m[e >> 1], s[j][e] * scale2);
        }
      }
    }
  }
  m[0] = hopper::quad_max(m[0]);
  m[1] = hopper::quad_max(m[1]);

  // pass 2: e, the f32 denominator, p = bf16(e), and o = p . v
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float denom[2] = {0.f, 0.f};
  for (int t = 0; t < n_tiles; ++t) {
    hopper::cp_async_wait_dyn(committed - 2 - n_tiles - t);  // V_t is group 1 + n_tiles + t
    __syncthreads();
    const uint32_t v_tile = v_ring + (t & 1) * kTileBytes;
    if (active) {
      float s[8][4];
      qk_tile(s, qf, k_base + t * kTileBytes, lane);
      const int valid = kl - t * kTile - col0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = 8 * j + (e & 1) < valid ? exp2f(fmaf(s[j][e], scale2, -m[e >> 1])) : 0.f;
          denom[e >> 1] += x;
          s[j][e] = x;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pf[4];
        hopper::acc_to_a(pf, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {
          uint32_t vb[4];
          hopper::ldsm_x4_t(vb, hopper::b_addr_t(v_tile, 16 * kk, jn, lane));
          hopper::mma(o[2 * jn], pf, vb[0], vb[1]);
          hopper::mma(o[2 * jn + 1], pf, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this slot
    if (t + 2 < n_tiles) {
      load_tile(v_tile, base + 2 * lanes, (t + 2) * kTile, kl, stride_s);
      hopper::cp_async_commit();
      ++committed;
    }
  }
  if (!active) return;
  denom[0] = hopper::quad_sum(denom[0]);
  denom[1] = hopper::quad_sum(denom[1]);

  const int row = q0 + 16 * warp + (lane >> 2);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + 8 * half;
    if (r >= S) continue;
    __nv_bfloat16* o_row = out + (static_cast<size_t>(b) * S + r) * lanes + h * kHeadDim + col0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(o_row + 8 * j) =
          hopper::pack_bf16(o[j][2 * half] / denom[half], o[j][2 * half + 1] / denom[half]);
    }
  }
}

// ----------------------------------------------------------------- f32 ---

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = 128;
constexpr int kRowStride = kHeadDim + 1;  // 65 words per staged K row

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

size_t f32_smem_bytes(int S) {
  return static_cast<size_t>(S) * kRowStride * sizeof(float) +
         static_cast<size_t>(kWarps) * S * sizeof(float);
}

__global__ void __launch_bounds__(kThreads, 1)
    attention_fwd_f32_kernel(const float* __restrict__ qkv, const int* __restrict__ key_lens,
                             float* __restrict__ out, int S, int H, long long stride_b,
                             long long stride_s, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int h = static_cast<int>(blockIdx.y);
  const int b = static_cast<int>(blockIdx.z);
  const int kl = key_lens ? key_lens[b] : S;
  if (kl < 1 || kl > S) __trap();

  float* ks = reinterpret_cast<float*>(smem_raw);
  float* srow_all = ks + static_cast<size_t>(S) * kRowStride;

  const int lanes = H * kHeadDim;
  const float* base = qkv + b * stride_b;
  const float* kg = base + lanes + h * kHeadDim;
  const float* vg = base + 2 * lanes + h * kHeadDim;
  for (int i = threadIdx.x; i < kl * kHeadDim / 4; i += kThreads) {
    const int r = i / (kHeadDim / 4);
    const int c = 4 * (i - r * (kHeadDim / 4));
    const float4 v = *reinterpret_cast<const float4*>(kg + r * stride_s + c);
    float* d = ks + r * kRowStride + c;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* srow = srow_all + warp * S;
  const int tile = static_cast<int>(blockIdx.x);
  const int row_end = min(S, (tile + 1) * kRowsPerBlock);
  for (int row = tile * kRowsPerBlock + warp; row < row_end; row += kWarps) {
    const float* qg = base + row * stride_s + h * kHeadDim;
    float q[kHeadDim];
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) q[d] = qg[d];

    // logits of this lane's keys, and the row max
    float mx = __int_as_float(0xff800000);  // -inf
    for (int j = lane; j < kl; j += 32) {
      const float* kr = ks + j * kRowStride;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) acc = fmaf(q[d], kr[d], acc);
      const float s = acc * scale;
      srow[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);

    float sum = 0.f;
    for (int j = lane; j < kl; j += 32) {
      const float e = expf(srow[j] - mx);
      sum += e;
      srow[j] = e;
    }
    sum = warp_sum(sum);
    __syncwarp();

    const int d0 = 2 * lane;
    float a0 = 0.f, a1 = 0.f;
    for (int j = 0; j < kl; ++j) {
      const float p = srow[j];
      const float2 v = *reinterpret_cast<const float2*>(vg + j * stride_s + d0);
      a0 = fmaf(p, v.x, a0);
      a1 = fmaf(p, v.y, a1);
    }
    float* o = out + (static_cast<size_t>(b) * S + row) * lanes + h * kHeadDim + d0;
    o[0] = a0 / sum;
    o[1] = a1 / sum;
    __syncwarp();  // the next row overwrites srow
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

cudaError_t launch_bf16(const void* qkv, const void* key_lens, void* out, int B, int S, int H,
                        long long stride_b, long long stride_s, float scale, cudaStream_t stream) {
  const int smem = tc_smem_bytes(S);
  cudaError_t err = set_smem(attention_fwd_tc_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  attention_fwd_tc_kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const int*>(key_lens),
      static_cast<__nv_bfloat16*>(out), S, H, stride_b, stride_s, scale);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* qkv, const void* key_lens, void* out, int B, int S, int H,
                       long long stride_b, long long stride_s, float scale, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(S);
  cudaError_t err = set_smem(attention_fwd_f32_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kRowsPerBlock - 1) / kRowsPerBlock, H, B);
  attention_fwd_f32_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const int*>(key_lens), static_cast<float*>(out),
      S, H, stride_b, stride_s, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16 (tensor cores), 1 = float32 (CUDA cores). Strides are
// in elements; the last axis of qkv is contiguous and every row starts on a
// 16-byte boundary. Returns a cudaError_t (0 on success).
extern "C" int attention_qkv_fwd(const void* qkv, const void* key_lens, void* out, int B, int S,
                                 int H, int head_dim, long long stride_b, long long stride_s,
                                 float scale, int dtype, void* stream) {
  if (head_dim != kHeadDim || B < 1 || S < 1 || H < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bf16(qkv, key_lens, out, B, S, H, stride_b, stride_s, scale, st);
  if (dtype == 1) return launch_f32(qkv, key_lens, out, B, S, H, stride_b, stride_s, scale, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* attention_qkv_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
