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
// Head dims: the resident designs are templates over Dh in {16, 32, 64,
// 128}; every other head dim (the JAX kernel's domain: lanes % 128 == 0 and
// lanes % heads == 0, any Dh) runs a streaming design: up to 256 on the
// template of its padded head dim (16, 32, 64, 128 or 256) with the runtime
// Dh (attention_stream.cuh), above 256 the sliced design (the head staged
// 256 columns at a time, a block per output slice; below). Every path shape
// has Dh = 64.
//
// Batch rows and heads: a launch takes at most 65535 of each (grid.z,
// grid.y); the wrapper splits a larger call into launches over slices of
// both (`launch_slices`), offsetting the pointers to the slice's first batch
// row and passing its first head h0.
//
// What bounds it on an H100: 4*S*kl*Dh flops per (b, h) for q.k and p.v
// against 2*B*S*4*H*Dh bytes (qkv read once, out written once) in bf16. At
// the path's shapes (ViT S=448, fusion S=208, Dh=64) that is S/2 = 224 and
// 104 flops per byte, under the ~295 at which the bf16 tensor cores become
// the limit: an ideal kernel is bound by memory and, at these sizes, by
// latency (a few microseconds of work per launch).
//
// The dtype picks the resident design (dispatch by dtype; a failed build or
// launch raises in either); above the largest S a resident design takes (its
// shared memory, 227 KB a block), the wrapper launches the streaming design
// (`attention_qkv_fwd_stream`, below), a shape rule decided before the
// launch. The largest S of the resident designs (`resident_max_s` in
// ops/flash_attention.py computes the same):
//   bf16: (2 + ceil(S/64)) tiles of 64 x Dh x 2 bytes <= 227 KB:
//         Dh 16: 7104, 32: 3456, 64: 1664, 128: 768
//   f32:  S x ((Dh + 1) x 4 + 64) bytes <= 227 KB:
//         Dh 16: 1760, 32: 1185, 64: 717, 128: 400
// Above them, and at any S (offsets into qkv and out are 64-bit), the
// streaming design runs.
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
//
// Streaming (both dtypes, S above the resident limit and the head dims the
// resident designs do not take; never at a path shape): CUDA-core f32 FMAs,
// no plane of S rows resident. One block of 8
// warps per (64-query tile, head, batch row), the Q tile staged in shared
// memory, 8 rows a warp; K (pass 1) and then K and V (pass 2) stream through
// two-slot rings of 32-key tiles (attention_stream.cuh), the next tile's
// cp.async in flight while the current one is used. The TPU kernel's
// rounding points stay: pass 1 takes the row max over the valid keys, pass 2
// e = exp(s - m), the f32 denominator, p = io(e) and the f32-accumulated
// p.v (a lane a key for q.k, then p broadcast by shuffles and a lane per
// head dims for p.v).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_stream.cuh"
#include "hopper_mma.cuh"

namespace {

// ---------------------------------------------------------------- bf16 ---

constexpr int kTile = 64;         // query rows per block; keys per K / V tile
constexpr int kTcThreads = 128;   // 4 warps x 16 query rows

template <int DH>
struct Tc {
  static constexpr int kChunks = DH / 8;           // 16-byte chunks a row
  static constexpr int kTileBytes = kTile * DH * 2;
  static constexpr int kK = DH / 16;               // 16-deep steps of q.k^T
  static constexpr int kN = DH / 8;                // 8-wide column tiles of p.v
};

template <int DH>
int tc_smem_bytes(int S) { return (2 + (S + kTile - 1) / kTile) * Tc<DH>::kTileBytes; }

// cp.async of rows row0..row0+63 of one head's DH columns (src points at the
// head's first column of row 0) into a swizzled tile; rows >= limit are
// zero-filled. 64 * DH / 8 chunks of 16 bytes, DH / 16 per thread.
template <int DH>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src, int row0,
                                          int limit, long long stride_s) {
  constexpr int C = Tc<DH>::kChunks;
#pragma unroll
  for (int k = 0; k < C / 2; ++k) {
    const int i = static_cast<int>(threadIdx.x) + k * kTcThreads;
    const int r = i / C, c = i % C;
    const int row = row0 + r;
    const bool ok = row < limit;
    hopper::cp_async16(dst + hopper::swz<C>(r, c), src + (ok ? row : 0) * stride_s + c * 8, ok);
  }
}

// s (16 rows x 64 keys of one tile, as 8 n tiles) = q . k^T, unscaled.
template <int DH>
__device__ __forceinline__ void qk_tile(float (&s)[8][4], const uint32_t (&qf)[Tc<DH>::kK][4],
                                        uint32_t k_tile, int lane) {
  constexpr int C = Tc<DH>::kChunks;
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < Tc<DH>::kK; ++kk) {
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      uint32_t b[4];
      hopper::ldsm_x4(b, hopper::bt_addr<C>(k_tile, 16 * jn, kk, lane));
      hopper::mma(s[2 * jn], qf[kk], b[0], b[1]);
      hopper::mma(s[2 * jn + 1], qf[kk], b[2], b[3]);
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kTcThreads, DH <= 64 ? 4 : 2)
    attention_fwd_tc_kernel(const __nv_bfloat16* __restrict__ qkv, const int* __restrict__ key_lens,
                            __nv_bfloat16* __restrict__ out, int S, int H, int h0,
                            long long stride_b, long long stride_s, float scale) {
  using T = Tc<DH>;
  constexpr int C = T::kChunks;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = static_cast<int>(blockIdx.x) * kTile;
  const int h = h0 + static_cast<int>(blockIdx.y);
  const int b = static_cast<int>(blockIdx.z);
  const int kl = key_lens ? key_lens[b] : S;
  if (kl < 1 || kl > S) __trap();
  const int n_tiles = (kl + kTile - 1) / kTile;
  const int lanes = H * DH;
  const __nv_bfloat16* base = qkv + b * stride_b + h * DH;

  // shared memory: the V ring (2 tiles; Q passes through slot 0 first), then
  // K tiles 0..n_tiles-1. Commit groups: Q, K_0..K_{n-1}, V_0, V_1, ...
  const uint32_t v_ring = hopper::smem_addr(smem_raw);
  const uint32_t k_base = v_ring + 2 * T::kTileBytes;
  load_tile<DH>(v_ring, base, q0, S, stride_s);
  hopper::cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    load_tile<DH>(k_base + t * T::kTileBytes, base + lanes, t * kTile, kl, stride_s);
    hopper::cp_async_commit();
  }
  int committed = 1 + n_tiles;

  hopper::cp_async_wait_dyn(n_tiles);  // Q has landed
  __syncthreads();
  uint32_t qf[T::kK][4];
#pragma unroll
  for (int kk = 0; kk < T::kK; ++kk)
    hopper::ldsm_x4(qf[kk], hopper::a_addr<C>(v_ring, 16 * warp, kk, lane));
  __syncthreads();  // slot 0 holds V from here
  for (int t = 0; t < 2 && t < n_tiles; ++t, ++committed) {
    load_tile<DH>(v_ring + t * T::kTileBytes, base + 2 * lanes, t * kTile, kl, stride_s);
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
      qk_tile<DH>(s, qf, k_base + t * T::kTileBytes, lane);
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
  float o[T::kN][4];
#pragma unroll
  for (int j = 0; j < T::kN; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float denom[2] = {0.f, 0.f};
  for (int t = 0; t < n_tiles; ++t) {
    hopper::cp_async_wait_dyn(committed - 2 - n_tiles - t);  // V_t is group 1 + n_tiles + t
    __syncthreads();
    const uint32_t v_tile = v_ring + (t & 1) * T::kTileBytes;
    if (active) {
      float s[8][4];
      qk_tile<DH>(s, qf, k_base + t * T::kTileBytes, lane);
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
        for (int jn = 0; jn < DH / 16; ++jn) {
          uint32_t vb[4];
          hopper::ldsm_x4_t(vb, hopper::b_addr_t<C>(v_tile, 16 * kk, jn, lane));
          hopper::mma(o[2 * jn], pf, vb[0], vb[1]);
          hopper::mma(o[2 * jn + 1], pf, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this slot
    if (t + 2 < n_tiles) {
      load_tile<DH>(v_tile, base + 2 * lanes, (t + 2) * kTile, kl, stride_s);
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
    __nv_bfloat16* o_row = out + (static_cast<size_t>(b) * S + r) * lanes + h * DH + col0;
#pragma unroll
    for (int j = 0; j < T::kN; ++j) {
      *reinterpret_cast<uint32_t*>(o_row + 8 * j) =
          hopper::pack_bf16(o[j][2 * half] / denom[half], o[j][2 * half + 1] / denom[half]);
    }
  }
}

// ----------------------------------------------------------------- f32 ---

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = 128;

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

template <int DH>
size_t f32_smem_bytes(int S) {
  return static_cast<size_t>(S) * (DH + 1) * sizeof(float) +
         static_cast<size_t>(kWarps) * S * sizeof(float);
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    attention_fwd_f32_kernel(const float* __restrict__ qkv, const int* __restrict__ key_lens,
                             float* __restrict__ out, int S, int H, int h0, long long stride_b,
                             long long stride_s, float scale) {
  constexpr int kRowStride = DH + 1;  // words per staged K row
  constexpr int kPer = DH >= 32 ? DH / 32 : 1;  // head dims a lane accumulates in p.v
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int h = h0 + static_cast<int>(blockIdx.y);
  const int b = static_cast<int>(blockIdx.z);
  const int kl = key_lens ? key_lens[b] : S;
  if (kl < 1 || kl > S) __trap();

  float* ks = reinterpret_cast<float*>(smem_raw);
  float* srow_all = ks + static_cast<size_t>(S) * kRowStride;

  const int lanes = H * DH;
  const float* base = qkv + b * stride_b;
  const float* kg = base + lanes + h * DH;
  const float* vg = base + 2 * lanes + h * DH;
  for (int i = threadIdx.x; i < kl * DH / 4; i += kThreads) {
    const int r = i / (DH / 4);
    const int c = 4 * (i - r * (DH / 4));
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
  const int d0 = kPer * lane;
  for (int row = tile * kRowsPerBlock + warp; row < row_end; row += kWarps) {
    const float* qg = base + row * stride_s + h * DH;
    float q[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) q[d] = qg[d];

    // logits of this lane's keys, and the row max
    float mx = __int_as_float(0xff800000);  // -inf
    for (int j = lane; j < kl; j += 32) {
      const float* kr = ks + j * kRowStride;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc = fmaf(q[d], kr[d], acc);
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

    if (d0 < DH) {
      float a[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) a[u] = 0.f;
      for (int j = 0; j < kl; ++j) {
        const float p = srow[j];
        const float* v = vg + j * stride_s + d0;
#pragma unroll
        for (int u = 0; u < kPer; ++u) a[u] = fmaf(p, v[u], a[u]);
      }
      float* o = out + (static_cast<size_t>(b) * S + row) * lanes + h * DH + d0;
#pragma unroll
      for (int u = 0; u < kPer; ++u) o[u] = a[u] / sum;
    }
    __syncwarp();  // the next row overwrites srow
  }
}

// ----------------------------------------------------------- streaming ---

template <typename T, int DP>
__host__ __device__ constexpr int stream_smem_bytes() {
  // the Q tile, then the K and V rings of two 32-row tiles each
  return (stream::kBlockRows + 4 * stream::kTileRows) * stream::Rows<T, DP>::kStride;
}

template <typename T, int DP>
__global__ void __launch_bounds__(stream::kThreads)
    attention_fwd_stream_kernel(const T* __restrict__ qkv, const int* __restrict__ key_lens,
                                T* __restrict__ out, int S, int H, int h0, int dh,
                                long long stride_b, long long stride_s, float scale, int width) {
  using R = stream::Rows<T, DP>;
  constexpr int kRows = stream::kRowsPerWarp;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = static_cast<int>(blockIdx.x) * stream::kBlockRows;
  const int h = h0 + static_cast<int>(blockIdx.y);
  const int b = static_cast<int>(blockIdx.z);
  const int kl = key_lens ? key_lens[b] : S;
  if (kl < 1 || kl > S) __trap();
  const int lanes = H * dh;
  const T* base = qkv + b * stride_b + h * dh;
  const int n_tiles = (kl + stream::kTileRows - 1) / stream::kTileRows;
  if (dh < DP) {  // the pad columns dh..DP-1 of every row: zeros, never copied over
    stream::zero_smem(smem_raw, stream_smem_bytes<T, DP>());
    __syncthreads();
  }

  unsigned char* q_s = smem_raw;
  unsigned char* k_s = q_s + stream::kBlockRows * R::kStride;
  unsigned char* v_s = k_s + 2 * R::kTileBytes;
  const uint32_t q_a = hopper::smem_addr(q_s), k_a = hopper::smem_addr(k_s),
                 v_a = hopper::smem_addr(v_s);
  const unsigned char* my_q = q_s + warp * kRows * R::kStride;  // this warp's 8 query rows
  stream::load_rows<T, DP>(q_a, base, stride_s, q0, stream::kBlockRows, S, dh, width);
  hopper::cp_async_commit();

  // Tile t of K (and, when with_v, of V) into ring slot t & 1.
  auto load = [&](int t, bool with_v) {
    const int slot = (t & 1) * R::kTileBytes;
    stream::load_rows<T, DP>(k_a + slot, base + lanes, stride_s, t * stream::kTileRows,
                             stream::kTileRows, kl, dh, width);
    if (with_v)
      stream::load_rows<T, DP>(v_a + slot, base + 2 * lanes, stride_s, t * stream::kTileRows,
                               stream::kTileRows, kl, dh, width);
    hopper::cp_async_commit();
  };
  // Runs body(t, slot offset) over every key tile, the next tile's copy in
  // flight while the current one is used.
  auto over_tiles = [&](bool with_v, auto&& body) {
    load(0, with_v);
    for (int t = 0; t < n_tiles; ++t) {
      if (t + 1 < n_tiles) {
        load(t + 1, with_v);
        hopper::cp_async_wait<1>();
      } else {
        hopper::cp_async_wait<0>();
      }
      __syncthreads();
      body(t, (t & 1) * R::kTileBytes);
      __syncthreads();  // every warp is done with this slot before it is refilled
    }
  };

  // pass 1: the row max of the scaled logits over the valid keys
  float m[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) m[r] = __int_as_float(0xff800000);
  over_tiles(false, [&](int t, int slot) {
    const unsigned char* k_row = k_s + slot + lane * R::kStride;
    const bool valid = t * stream::kTileRows + lane < kl;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float s = stream::dot_rows<T, DP, true>(my_q + r * R::kStride, k_row) * scale;
      if (valid) m[r] = fmaxf(m[r], s);
    }
  });
#pragma unroll
  for (int r = 0; r < kRows; ++r) m[r] = stream::warp_max(m[r]);

  // pass 2: e, the f32 denominator, p = io(e), and o = p . v
  const int d0 = R::kPer * lane;
  const bool has_dims = d0 < DP;
  float o[kRows][R::kPer];
  float denom[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    denom[r] = 0.f;
#pragma unroll
    for (int u = 0; u < R::kPer; ++u) o[r][u] = 0.f;
  }
  over_tiles(true, [&](int t, int slot) {
    const unsigned char* k_row = k_s + slot + lane * R::kStride;
    const unsigned char* v_tile = v_s + slot;
    const bool valid = t * stream::kTileRows + lane < kl;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float s = stream::dot_rows<T, DP, true>(my_q + r * R::kStride, k_row) * scale;
      const float e = valid ? expf(s - m[r]) : 0.f;
      denom[r] += e;
      const float p = stream::round_io<T>(e);
      for (int j = 0; j < stream::kTileRows; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        if (has_dims) stream::axpy_row<T, DP>(o[r], pj, v_tile + j * R::kStride, d0);
      }
    }
  });

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float den = stream::warp_sum(denom[r]);
    const int row = q0 + warp * kRows + r;
    if (row >= S || !has_dims) continue;
    T* o_row = out + (static_cast<size_t>(b) * S + row) * lanes + h * dh + d0;
#pragma unroll
    for (int u = 0; u < R::kPer; ++u)
      if (d0 + u < dh) o_row[u] = stream::from_f32<T>(o[r][u] / den);
  }
}

// ------------------------------------------------------ head-dim sliced ---

template <typename T>
__host__ __device__ constexpr int sliced_smem_bytes() {
  // a slice of the 64 owned Q rows, a slice of a 32-row K tile and of a V tile
  return (stream::kBlockRows + 2 * stream::kTileRows) * stream::Rows<T, stream::kSliceDim>::kStride;
}

// Head dims above 256: one block of 8 warps per (64-query tile, 256-wide
// output slice, head, batch row). Each logit is accumulated over every head
// slice (Q and K staged one slice at a time), so the logit work repeats once
// per output slice; pass 2 stages only this block's slice of V.
template <typename T>
__global__ void __launch_bounds__(stream::kThreads)
    attention_fwd_sliced_kernel(const T* __restrict__ qkv, const int* __restrict__ key_lens,
                                T* __restrict__ out, int S, int H, int h0, int dh,
                                long long stride_b, long long stride_s, float scale, int width) {
  constexpr int DP = stream::kSliceDim;
  using R = stream::Rows<T, DP>;
  constexpr int kRows = stream::kRowsPerWarp;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_slices = (dh + DP - 1) / DP;
  const int q0 = static_cast<int>(blockIdx.x) / n_slices * stream::kBlockRows;
  const int os = static_cast<int>(blockIdx.x) % n_slices;  // this block's output slice
  const int h = h0 + static_cast<int>(blockIdx.y);
  const int b = static_cast<int>(blockIdx.z);
  const int kl = key_lens ? key_lens[b] : S;
  if (kl < 1 || kl > S) __trap();
  const int lanes = H * dh;
  const T* base = qkv + b * stride_b + h * dh;
  const int n_tiles = (kl + stream::kTileRows - 1) / stream::kTileRows;

  unsigned char* q_s = smem_raw;
  unsigned char* k_s = q_s + stream::kBlockRows * R::kStride;
  unsigned char* v_s = k_s + R::kTileBytes;
  const uint32_t q_a = hopper::smem_addr(q_s), k_a = hopper::smem_addr(k_s),
                 v_a = hopper::smem_addr(v_s);
  const unsigned char* my_q = q_s + warp * kRows * R::kStride;  // this warp's 8 query rows

  // s[r] = q_r . k_(lane's key) of key tile t, unscaled, over every slice in
  // ascending order: the same FMA order in both passes
  auto logits = [&](int t, float (&s)[kRows]) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    for (int c = 0; c < n_slices; ++c) {
      __syncthreads();  // every warp is done with the previous slice
      stream::load_slice<T, DP>(q_a, base + c * DP, stride_s, q0, stream::kBlockRows, S,
                                dh - c * DP, width);
      stream::load_slice<T, DP>(k_a, base + lanes + c * DP, stride_s, t * stream::kTileRows,
                                stream::kTileRows, kl, dh - c * DP, width);
      hopper::cp_async_commit();
      hopper::cp_async_wait<0>();
      __syncthreads();
      const unsigned char* k_row = k_s + lane * R::kStride;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        s[r] = stream::dot_rows<T, DP>(my_q + r * R::kStride, k_row, s[r]);
    }
  };

  // pass 1: the row max of the scaled logits over the valid keys
  float m[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) m[r] = __int_as_float(0xff800000);
  for (int t = 0; t < n_tiles; ++t) {
    float s[kRows];
    logits(t, s);
    if (t * stream::kTileRows + lane < kl) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) m[r] = fmaxf(m[r], s[r] * scale);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) m[r] = stream::warp_max(m[r]);

  // pass 2: e, the f32 denominator, p = io(e), and o = p . v over this
  // block's slice of V
  const int d0 = R::kPer * lane;  // 8 of the slice's 256 columns a lane
  float o[kRows][R::kPer];
  float denom[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    denom[r] = 0.f;
#pragma unroll
    for (int u = 0; u < R::kPer; ++u) o[r][u] = 0.f;
  }
  for (int t = 0; t < n_tiles; ++t) {
    float s[kRows];
    logits(t, s);
    __syncthreads();  // the V slot is free
    stream::load_slice<T, DP>(v_a, base + 2 * lanes + os * DP, stride_s, t * stream::kTileRows,
                              stream::kTileRows, kl, dh - os * DP, width);
    hopper::cp_async_commit();
    hopper::cp_async_wait<0>();
    __syncthreads();
    const bool valid = t * stream::kTileRows + lane < kl;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float e = valid ? expf(s[r] * scale - m[r]) : 0.f;
      denom[r] += e;
      const float p = stream::round_io<T>(e);
      for (int j = 0; j < stream::kTileRows; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        stream::axpy_row<T, DP>(o[r], pj, v_s + j * R::kStride, d0);
      }
    }
  }

  const int c0 = os * DP + d0;  // this lane's first column of the head
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float den = stream::warp_sum(denom[r]);
    const int row = q0 + warp * kRows + r;
    if (row >= S) continue;
    T* o_row = out + (static_cast<size_t>(b) * S + row) * lanes + h * dh + c0;
#pragma unroll
    for (int u = 0; u < R::kPer; ++u)
      if (c0 + u < dh) o_row[u] = stream::from_f32<T>(o[r][u] / den);
  }
}

// ------------------------------------------------------------- launches ---

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// One launch covers batch rows 0..B-1 of the pointers it is given (the
// wrapper offsets qkv, key_lens and out to a slice of at most 65535 rows)
// and heads h0..h0+nh-1 of H (at most 65535): grid.z and grid.y.
struct Args {
  const void* qkv;
  const void* key_lens;
  void* out;
  int B, S, H, h0, nh, dh;
  long long stride_b, stride_s;
  float scale;
  int width;  // bytes a copy of the streaming design: 16, 8, 4 or 2
  cudaStream_t stream;
};

template <int DH>
cudaError_t launch_bf16(const Args& a) {
  const int smem = tc_smem_bytes<DH>(a.S);
  cudaError_t err = set_smem(attention_fwd_tc_kernel<DH>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kTile - 1) / kTile, a.nh, a.B);
  attention_fwd_tc_kernel<DH><<<grid, kTcThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.qkv), static_cast<const int*>(a.key_lens),
      static_cast<__nv_bfloat16*>(a.out), a.S, a.H, a.h0, a.stride_b, a.stride_s, a.scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_f32(const Args& a) {
  const size_t smem = f32_smem_bytes<DH>(a.S);
  cudaError_t err = set_smem(attention_fwd_f32_kernel<DH>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kRowsPerBlock - 1) / kRowsPerBlock, a.nh, a.B);
  attention_fwd_f32_kernel<DH><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.qkv), static_cast<const int*>(a.key_lens),
      static_cast<float*>(a.out), a.S, a.H, a.h0, a.stride_b, a.stride_s, a.scale);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_stream(const Args& a) {
  constexpr int smem = stream_smem_bytes<T, DP>();
  static_assert(smem <= stream::kMaxSmem, "the streaming forward's tiles must fit one block");
  cudaError_t err = set_smem(attention_fwd_stream_kernel<T, DP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + stream::kBlockRows - 1) / stream::kBlockRows, a.nh, a.B);
  attention_fwd_stream_kernel<T, DP><<<grid, stream::kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.qkv), static_cast<const int*>(a.key_lens), static_cast<T*>(a.out),
      a.S, a.H, a.h0, a.dh, a.stride_b, a.stride_s, a.scale, a.width);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_sliced(const Args& a) {
  constexpr int smem = sliced_smem_bytes<T>();
  static_assert(smem <= stream::kMaxSmem, "the sliced forward's tiles must fit one block");
  cudaError_t err = set_smem(attention_fwd_sliced_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>((a.S + stream::kBlockRows - 1) / stream::kBlockRows) *
                           ((a.dh + stream::kSliceDim - 1) / stream::kSliceDim);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks), a.nh, a.B);
  attention_fwd_sliced_kernel<T><<<grid, stream::kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.qkv), static_cast<const int*>(a.key_lens), static_cast<T*>(a.out),
      a.S, a.H, a.h0, a.dh, a.stride_b, a.stride_s, a.scale, a.width);
  return cudaGetLastError();
}

// The resident design for dtype at Dh (16, 32, 64 or 128).
template <int DH>
cudaError_t launch_resident(const Args& a, int dtype) {
  if (dtype == 0) return launch_bf16<DH>(a);
  if (dtype == 1) return launch_f32<DH>(a);
  return cudaErrorInvalidValue;
}

// The streaming design for dtype at the padded head dim DP >= dh.
template <int DP>
cudaError_t launch_streaming(const Args& a, int dtype) {
  if (dtype == 0) return launch_stream<__nv_bfloat16, DP>(a);
  if (dtype == 1) return launch_stream<float, DP>(a);
  return cudaErrorInvalidValue;
}

bool valid_args(const Args& a) {
  // grid.y and grid.z take at most 65535 blocks
  return a.B >= 1 && a.S >= 1 && a.nh >= 1 && a.h0 >= 0 && a.h0 + a.nh <= a.H && a.B <= 65535 &&
         a.nh <= 65535 && a.dh >= 1;
}

}  // namespace

// dtype: 0 = bfloat16 (tensor cores), 1 = float32 (CUDA cores); head_dim
// 16, 32, 64 or 128. B batch rows from the pointers given (at most 65535),
// heads h0..h0+nh-1 (nh at most 65535) of the H whose q, k and v the rows
// pack. Strides are in elements; the last axis of qkv is contiguous and
// every row starts on a 16-byte boundary. Returns a cudaError_t (0 on
// success).
extern "C" int attention_qkv_fwd(const void* qkv, const void* key_lens, void* out, int B, int S,
                                 int H, int h0, int nh, int head_dim, long long stride_b,
                                 long long stride_s, float scale, int dtype, void* stream) {
  const Args a{qkv, key_lens, out, B, S, H, h0, nh, head_dim, stride_b, stride_s, scale, 16,
               static_cast<cudaStream_t>(stream)};
  if (!valid_args(a)) return cudaErrorInvalidValue;
  switch (head_dim) {
    case 16: return launch_resident<16>(a, dtype);
    case 32: return launch_resident<32>(a, dtype);
    case 64: return launch_resident<64>(a, dtype);
    case 128: return launch_resident<128>(a, dtype);
    default: return cudaErrorInvalidValue;
  }
}

// The streaming designs (CUDA cores, both dtypes), same arguments and
// copy_bytes, the width of its row copies (16, 8, 4, or 2 for bf16; a
// divisor of head_dim * the dtype's size): the wrapper's choice above the
// resident designs' largest S and at every head dim that they do not take.
// Up to 256 it runs the template of the padded head dim (the least of 16,
// 32, 64, 128, 256 not below head_dim); above 256 the sliced design.
extern "C" int attention_qkv_fwd_stream(const void* qkv, const void* key_lens, void* out, int B,
                                        int S, int H, int h0, int nh, int head_dim,
                                        long long stride_b, long long stride_s, float scale,
                                        int dtype, int copy_bytes, void* stream) {
  const Args a{qkv, key_lens, out, B, S, H, h0, nh, head_dim, stride_b, stride_s, scale,
               copy_bytes, static_cast<cudaStream_t>(stream)};
  const int size = dtype == 0 ? 2 : 4;
  if (!valid_args(a) || copy_bytes < size || (head_dim * size) % copy_bytes) return cudaErrorInvalidValue;
  if (head_dim <= 16) return launch_streaming<16>(a, dtype);
  if (head_dim <= 32) return launch_streaming<32>(a, dtype);
  if (head_dim <= 64) return launch_streaming<64>(a, dtype);
  if (head_dim <= 128) return launch_streaming<128>(a, dtype);
  if (head_dim <= stream::kMaxHeadDim) return launch_streaming<256>(a, dtype);
  if (dtype == 0) return launch_sliced<__nv_bfloat16>(a);
  if (dtype == 1) return launch_sliced<float>(a);
  return cudaErrorInvalidValue;
}

extern "C" const char* attention_qkv_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
