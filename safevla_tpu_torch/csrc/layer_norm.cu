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
//   dgamma = sum_rows g * xhat and dbeta = sum_rows g in f32.
// gamma and beta are f32. x, the output and g are bfloat16 or float32; D is
// any multiple of 128 (the JAX kernel's layout rule): up to 1024 (ViT-S 384,
// the fusion 512) the register designs below, above it the wide designs.
//
// What bounds it on an H100: bytes. The forward reads x and writes y once
// for ~8 flops per element, the backward reads x and g and writes dx for ~20:
// far below the ~20 flops per byte at which the f32 CUDA cores would become
// the limit. So the design keeps each element to one read and one write and
// keeps enough rows in flight to cover the HBM latency.
//
// Forward: up to one wave of blocks, one pass, a row a warp; beyond it a
// grid of one wave walks the rows in a balanced loop, a bf16 row a half-warp
// in 16-byte vectors (two rows a warp), each lane loading its next row
// before the current one reduces. An f32 row is a warp's in both, in 16-byte
// vectors. Each load instruction reads one contiguous span of a row; the
// sums are shuffles within the row's lanes. gamma and beta are read into
// registers as the kernel starts, beside the first row's x, and held for
// every row the lane takes (up to 32 columns a lane). Blocks of 8 warps.
//
// Backward: one cooperative launch. A persistent grid (at most the blocks
// that fit on the card at once, and at most one block per 8 rows) gives each
// block a fixed, contiguous share of the rows; its 8 warps take one row each
// in turn (a warp per row, 8-byte bf16 / 16-byte f32 vectors), loading the
// next row's x and g while the current one reduces, and keep their columns'
// dgamma / dbeta sums in registers. The block folds its warps in a fixed
// order into one partial row of a workspace; after a grid-wide barrier each
// block sums a slice of the columns over all partial rows, in block order,
// and writes dgamma and dbeta. No atomics: the same bits on every run.
//
// Wide designs (D above 1024, where a row no longer fits the registers of the
// lanes that hold it; on no path of the repo's configs): a block of 8 warps
// a row, rows in a grid-stride loop, and each row read again from global
// memory (L1 / L2) instead of held. The forward reads x once for the sums,
// then again for y. The backward reads x for mu and rs, x and g for mean(gh)
// and mean(gh * xhat), then x and g once more for dx; its per-block partial
// dgamma / dbeta row lives in the workspace itself (the thread that owns a
// column adds to it, rows in order), and the grid barrier and the fold are
// the register design's, so the result is as deterministic. The block sums
// go through shared memory in warp order.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxVecs = 8;  // D <= 1024: the register designs; wider rows take the wide ones
constexpr int kFwdWarps = 8;
constexpr int kFwdThreads = kFwdWarps * 32;
// lanes a bf16 row: a half-warp in the looping forward (two rows a warp, in
// 16-byte vectors), a warp in the one-pass one (below a wave of blocks a
// row's chain of dependent instructions is the kernel's time: more lanes a
// row shorten it)
constexpr int kLoopBf16Lanes = 16;
constexpr int kOnePassBf16Lanes = 32;
constexpr int kFwdMaxHeld = 32;  // gamma and beta held in registers up to this many columns a lane
constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = kBwdWarps * 32;
constexpr int kBwdMinBlocks = 2;  // backward blocks an SM: 16 warps, 32 rows in flight
constexpr int kMaxDevices = 64;

// ---- the forward's layout -------------------------------------------------------
// A row is held by L lanes: a bf16 row by kLoopBf16Lanes in the looping
// kernel and kOnePassBf16Lanes in the one-pass one, an f32 row by a warp.
// Lane l's vector k is the V columns from (k L + l) V, with V = 128 / L (8
// bf16 = 16 bytes at a half-warp) but at most 16 bytes of the wider of x and
// the output (bf16 -> f32: 4). Each load or store instruction covers one
// contiguous span of the row; D / (L V) vectors a lane.
template <typename TX, typename TO, int L>
struct FwdRow {
  static constexpr int kWide = sizeof(TX) > sizeof(TO) ? sizeof(TX) : sizeof(TO);
  static constexpr int kVec = 128 / L < 16 / kWide ? 128 / L : 16 / kWide;
  static constexpr int kWords = kVec * static_cast<int>(sizeof(TX)) / 4;  // of x, 32 bits each
  static __device__ __forceinline__ int col(int k, int l) { return (k * L + l) * kVec; }
};

template <typename TX>
constexpr int kLoopLanes = sizeof(TX) == 2 ? kLoopBf16Lanes : 32;
template <typename TX>
constexpr int kOnePassLanes = sizeof(TX) == 2 ? kOnePassBf16Lanes : 32;

// W 32-bit words (4: 16 bytes, 2: 8) from p
template <int W>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[W]) {
  if constexpr (W == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x, w[1] = v.y;
  }
}

// element i of a vector of TX held as 32-bit words, in f32
template <typename TX, int W>
__device__ __forceinline__ float vec_elem(const uint32_t (&w)[W], int i) {
  if constexpr (sizeof(TX) == 2)
    return __uint_as_float((i & 1) ? (w[i >> 1] & 0xffff0000u) : (w[i >> 1] << 16));
  else
    return __uint_as_float(w[i]);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// four consecutive f32 <-> float4, and a float4 to four elements
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
}

// N consecutive outputs (N = 4 or 8) from y: 8 bf16 as one 16-byte store,
// else float4s of 4 elements
template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&y)[N]) {
  if constexpr (N == 8)
    *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16x2(y[0], y[1]), pack_bf16x2(y[2], y[3]),
                                              pack_bf16x2(y[4], y[5]), pack_bf16x2(y[6], y[7]));
  else
    store4(p, make_float4(y[0], y[1], y[2], y[3]));
}
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&y)[N]) {
#pragma unroll
  for (int j = 0; j < N; j += 4) store4(p + j, make_float4(y[j], y[j + 1], y[j + 2], y[j + 3]));
}

// the sum over the `lanes` lanes of each row; every lane of the warp calls
// it together (the loops below keep control flow uniform over the warp), and
// the xor offsets below `lanes` keep each half-warp's sum within its half
template <int lanes>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = lanes / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename Row, typename TX, int NVEC>
__device__ __forceinline__ void load_row(const TX* row, int l, uint32_t (&v)[NVEC][Row::kWords]) {
#pragma unroll
  for (int k = 0; k < NVEC; ++k) load_words(row + Row::col(k, l), v[k]);
}

// kLoop = false: one row for each row's L lanes, a block for each
// kFwdThreads / L rows. kLoop = true: a grid of at most one wave walks the
// rows, each row's lanes loading their next row before the current one
// reduces.
template <typename TX, typename TO, int NV, int L, bool kLoop>
__global__ void __launch_bounds__(kFwdThreads)
    layer_norm_fwd_kernel(const TX* __restrict__ x, const float* __restrict__ gamma,
                          const float* __restrict__ beta, TO* __restrict__ out, int R, float eps) {
  using Row = FwdRow<TX, TO, L>;
  constexpr int VE = Row::kVec, W = Row::kWords;
  constexpr int D = NV * 128;
  constexpr int NVEC = D / (L * VE);      // vectors a lane
  constexpr int kRows = kFwdThreads / L;  // rows a block
  constexpr bool kHeld = D / L <= kFwdMaxHeld;
  const int l = threadIdx.x % L;
  const int sub = threadIdx.x / L;
  const int stride = gridDim.x * kRows;
  const float inv_d = 1.f / static_cast<float>(D);
  int base = blockIdx.x * kRows;  // < R: the grid has no empty block
  // one pass, a warp a row: a warp past the last row has nothing to do (its
  // exit is warp-uniform, so the shuffles below keep their full mask)
  if constexpr (!kLoop && L == 32) {
    if (base + sub >= R) return;
  }
  uint32_t cur[NVEC][W], nxt[NVEC][W];
  load_row<Row>(x + static_cast<size_t>(min(base + sub, R - 1)) * D, l, cur);
  // this lane's gamma and beta, read beside the first row (when they fit)
  float4 gm[kHeld ? D / L / 4 : 1], bt[kHeld ? D / L / 4 : 1];
  if constexpr (kHeld) {
#pragma unroll
    for (int k = 0; k < NVEC; ++k)
#pragma unroll
      for (int j = 0; j < VE / 4; ++j) {
        gm[k * (VE / 4) + j] = load4(gamma + Row::col(k, l) + 4 * j);
        bt[k * (VE / 4) + j] = load4(beta + Row::col(k, l) + 4 * j);
      }
  }
  while (true) {  // the same trip count for the whole block
    if constexpr (kLoop) {
      if (base + stride < R)  // the next row's loads, before this row reduces
        load_row<Row>(x + static_cast<size_t>(min(base + stride + sub, R - 1)) * D, l, nxt);
    }
    // the sums as a pairwise tree within 4 elements: a short dependency chain
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < NVEC; ++k) {
#pragma unroll
      for (int j = 0; j < VE; j += 4) {
        const float a0 = vec_elem<TX>(cur[k], j), a1 = vec_elem<TX>(cur[k], j + 1);
        const float a2 = vec_elem<TX>(cur[k], j + 2), a3 = vec_elem<TX>(cur[k], j + 3);
        s += (a0 + a1) + (a2 + a3);
        s2 += (a0 * a0 + a1 * a1) + (a2 * a2 + a3 * a3);
      }
    }
    const float mu = row_sum<L>(s) * inv_d;
    const float rs = rsqrtf(fmaxf(0.f, row_sum<L>(s2) * inv_d - mu * mu) + eps);
    const int row = base + sub;
    if (row < R) {
      TO* orow = out + static_cast<size_t>(row) * D;
#pragma unroll
      for (int k = 0; k < NVEC; ++k) {
        const int c = Row::col(k, l);
        float y[VE];
#pragma unroll
        for (int j = 0; j < VE / 4; ++j) {
          float4 g4, b4;
          if constexpr (kHeld) {
            g4 = gm[k * (VE / 4) + j], b4 = bt[k * (VE / 4) + j];
          } else {
            g4 = load4(gamma + c + 4 * j), b4 = load4(beta + c + 4 * j);
          }
          y[4 * j + 0] = (vec_elem<TX>(cur[k], 4 * j + 0) - mu) * (rs * g4.x) + b4.x;
          y[4 * j + 1] = (vec_elem<TX>(cur[k], 4 * j + 1) - mu) * (rs * g4.y) + b4.y;
          y[4 * j + 2] = (vec_elem<TX>(cur[k], 4 * j + 2) - mu) * (rs * g4.z) + b4.z;
          y[4 * j + 3] = (vec_elem<TX>(cur[k], 4 * j + 3) - mu) * (rs * g4.w) + b4.w;
        }
        store_vec<VE>(orow + c, y);
      }
    }
    if constexpr (!kLoop) {
      break;
    } else {
      base += stride;
      if (base >= R) break;
#pragma unroll
      for (int k = 0; k < NVEC; ++k)
#pragma unroll
        for (int w = 0; w < W; ++w) cur[k][w] = nxt[k][w];
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) { return row_sum<32>(x); }

// ---- the backward: a warp per row, lane l's vector k at column (k*32+l)*4 --

// four consecutive elements as loaded: 8 bytes of bf16 or 16 of f32. x and g
// are read once: streaming loads (evict first), so that they do not push dx
// and the partial rows out of L2
template <typename T>
struct Raw4;
template <>
struct Raw4<__nv_bfloat16> {
  uint2 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) { v = __ldcs(reinterpret_cast<const uint2*>(p)); }
  __device__ __forceinline__ float4 f32() const {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
};
template <>
struct Raw4<float> {
  float4 v;
  __device__ __forceinline__ void load(const float* p) { v = __ldcs(reinterpret_cast<const float4*>(p)); }
  __device__ __forceinline__ float4 f32() const { return v; }
};

// out[c] = sum over the nb partial rows (width floats each) of part[b][c], in
// block order, for this block's slice of the columns: lanes of a column
// group split the rows (a fixed order), then a fixed tree over shared memory.
// `part` was written by other blocks of this launch, before the grid barrier:
// read through L2 (__ldcg), never the non-coherent path.
__device__ void fold_partials(const float* part, int nb, int width, float* out, float* scratch) {
  const int per = (width + gridDim.x - 1) / gridDim.x;
  const int c0 = blockIdx.x * per;
  const int c1 = min(width, c0 + per);
  int lw = 0;  // log2 of the columns at once, with 4 or more row lanes each
  while ((1 << lw) < per && (1 << lw) < kBwdThreads / 4) ++lw;
  const int w = 1 << lw;
  const int lanes = kBwdThreads >> lw;
  const int cl = threadIdx.x & (w - 1), rl = threadIdx.x >> lw;
  for (int cb = c0; cb < c1; cb += w) {  // the same trip count for the whole block
    const int c = cb + cl;
    float acc = 0.f;
    if (c < c1) {
#pragma unroll 4
      for (int b = rl; b < nb; b += lanes) acc += __ldcg(part + static_cast<size_t>(b) * width + c);
    }
    scratch[threadIdx.x] = acc;
    __syncthreads();
    for (int s = lanes / 2; s > 0; s >>= 1) {
      if (rl < s) scratch[threadIdx.x] += scratch[threadIdx.x + s * w];
      __syncthreads();
    }
    if (rl == 0 && c < c1) out[c] = scratch[cl];
    __syncthreads();
  }
}

// part: (gridDim.x, 2D) f32 workspace, one row [dgamma | dbeta] a block;
// dparams: (2, D) f32, [dgamma; dbeta], written after the grid barrier (a
// cooperative launch)
template <typename TX, typename TG, int NV>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
    layer_norm_bwd_kernel(const TX* __restrict__ x, const float* __restrict__ gamma,
                          const TG* __restrict__ g, TX* __restrict__ dx, float* part,
                          float* dparams, int R, float eps) {
  constexpr int D = NV * 128;
  __shared__ __align__(16) float red[kBwdWarps][D];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float inv_d = 1.f / static_cast<float>(D);
  // this block's rows: a fixed, contiguous share of R
  const int start = static_cast<int>(static_cast<long long>(blockIdx.x) * R / gridDim.x);
  const int end = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * R / gridDim.x);

  float4 gm[NV], dgam[NV], dbet[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    gm[k] = load4(gamma + (k * 32 + lane) * 4);
    dgam[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    dbet[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  Raw4<TX> xc[NV], xn[NV];
  Raw4<TG> gc[NV], gn[NV];
  int row = start + warp;
  if (row < end) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      xc[k].load(x + static_cast<size_t>(row) * D + (k * 32 + lane) * 4);
      gc[k].load(g + static_cast<size_t>(row) * D + (k * 32 + lane) * 4);
    }
  }
  for (; row < end; row += kBwdWarps) {  // the same trip count for the whole warp
    const size_t off = static_cast<size_t>(row) * D;
    if (row + kBwdWarps < end) {  // the next row's x and g, before this row reduces
      const size_t noff = off + static_cast<size_t>(kBwdWarps) * D;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        xn[k].load(x + noff + (k * 32 + lane) * 4);
        gn[k].load(g + noff + (k * 32 + lane) * 4);
      }
    }
    float4 xv[NV], gv[NV];
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      xv[k] = xc[k].f32();
      gv[k] = gc[k].f32();
      s += (xv[k].x + xv[k].y) + (xv[k].z + xv[k].w);
      s2 += (xv[k].x * xv[k].x + xv[k].y * xv[k].y) + (xv[k].z * xv[k].z + xv[k].w * xv[k].w);
    }
    const float mu = warp_sum(s) * inv_d;
    const float rs = rsqrtf(fmaxf(0.f, warp_sum(s2) * inv_d - mu * mu) + eps);
    // xv becomes xhat, gv stays g; gh = g * gamma is recomputed where used
    float s1 = 0.f, sx = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      xv[k].x = (xv[k].x - mu) * rs;
      xv[k].y = (xv[k].y - mu) * rs;
      xv[k].z = (xv[k].z - mu) * rs;
      xv[k].w = (xv[k].w - mu) * rs;
      const float4 gh = make_float4(gv[k].x * gm[k].x, gv[k].y * gm[k].y, gv[k].z * gm[k].z,
                                    gv[k].w * gm[k].w);
      s1 += (gh.x + gh.y) + (gh.z + gh.w);
      sx += (gh.x * xv[k].x + gh.y * xv[k].y) + (gh.z * xv[k].z + gh.w * xv[k].w);
    }
    const float m1 = warp_sum(s1) * inv_d;
    const float m2 = warp_sum(sx) * inv_d;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      float4 d;
      d.x = rs * (gv[k].x * gm[k].x - m1 - xv[k].x * m2);
      d.y = rs * (gv[k].y * gm[k].y - m1 - xv[k].y * m2);
      d.z = rs * (gv[k].z * gm[k].z - m1 - xv[k].z * m2);
      d.w = rs * (gv[k].w * gm[k].w - m1 - xv[k].w * m2);
      store4(dx + off + (k * 32 + lane) * 4, d);
      dgam[k].x += gv[k].x * xv[k].x;
      dgam[k].y += gv[k].y * xv[k].y;
      dgam[k].z += gv[k].z * xv[k].z;
      dgam[k].w += gv[k].w * xv[k].w;
      dbet[k].x += gv[k].x;
      dbet[k].y += gv[k].y;
      dbet[k].z += gv[k].z;
      dbet[k].w += gv[k].w;
      xc[k] = xn[k];
      gc[k] = gn[k];
    }
  }

  // fold the 8 warps' column sums, warp 0 first (the same order every run),
  // into this block's partial row
  float* prow = part + static_cast<size_t>(blockIdx.x) * 2 * D;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int k = 0; k < NV; ++k)
      *reinterpret_cast<float4*>(&red[warp][(k * 32 + lane) * 4]) = which ? dbet[k] : dgam[k];
    __syncthreads();
    for (int c = threadIdx.x; c < D; c += kBwdThreads) {
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kBwdWarps; ++w) acc += red[w][c];
      prow[which * D + c] = acc;
    }
    __syncthreads();  // red is rewritten next
  }
  cg::this_grid().sync();  // every partial row written and visible
  fold_partials(part, gridDim.x, 2 * D, dparams, &red[0][0]);
}

// ---- the wide designs (D > 1024): a block a row, each row read again ----------

// four consecutive elements from global memory, in f32 (an ordinary load:
// the row is read again, from L1 / L2)
__device__ __forceinline__ float4 ld4f(const float* p) { return load4(p); }
__device__ __forceinline__ float4 ld4f(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// (a, b) summed over the block, the same on every thread: warp sums, then
// the warps' in warp order. `sm` holds 2 * kWideWarps floats; the leading
// barrier keeps its last use apart from this one.
constexpr int kWideWarps = 8;
constexpr int kWideThreads = kWideWarps * 32;
__device__ __forceinline__ float2 block_sum2(float a, float b, float* sm) {
  a = warp_sum(a);
  b = warp_sum(b);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    sm[threadIdx.x >> 5] = a;
    sm[kWideWarps + (threadIdx.x >> 5)] = b;
  }
  __syncthreads();
  float2 r = make_float2(0.f, 0.f);
#pragma unroll
  for (int w = 0; w < kWideWarps; ++w) {
    r.x += sm[w];
    r.y += sm[kWideWarps + w];
  }
  return r;
}

template <typename TX, typename TO>
__global__ void __launch_bounds__(kWideThreads)
    layer_norm_fwd_wide_kernel(const TX* __restrict__ x, const float* __restrict__ gamma,
                               const float* __restrict__ beta, TO* __restrict__ out, int R, int D,
                               float eps) {
  __shared__ float sm[2 * kWideWarps];
  const float inv_d = 1.f / static_cast<float>(D);
  for (int row = blockIdx.x; row < R; row += gridDim.x) {  // the same trip count for the block
    const TX* xr = x + static_cast<size_t>(row) * D;
    float s = 0.f, s2 = 0.f;
    for (int c = 4 * threadIdx.x; c < D; c += 4 * kWideThreads) {
      const float4 v = ld4f(xr + c);
      s += (v.x + v.y) + (v.z + v.w);
      s2 += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
    }
    const float2 t = block_sum2(s, s2, sm);
    const float mu = t.x * inv_d;
    const float rs = rsqrtf(fmaxf(0.f, t.y * inv_d - mu * mu) + eps);
    TO* orow = out + static_cast<size_t>(row) * D;
    for (int c = 4 * threadIdx.x; c < D; c += 4 * kWideThreads) {
      const float4 v = ld4f(xr + c), g4 = load4(gamma + c), b4 = load4(beta + c);
      store4(orow + c, make_float4((v.x - mu) * (rs * g4.x) + b4.x, (v.y - mu) * (rs * g4.y) + b4.y,
                                   (v.z - mu) * (rs * g4.z) + b4.z, (v.w - mu) * (rs * g4.w) + b4.w));
    }
  }
}

// part: (gridDim.x, 2D) f32 workspace, one row [dgamma | dbeta] a block,
// accumulated in place; dparams: (2, D) f32, written after the grid barrier
template <typename TX, typename TG>
__global__ void __launch_bounds__(kWideThreads)
    layer_norm_bwd_wide_kernel(const TX* __restrict__ x, const float* __restrict__ gamma,
                               const TG* __restrict__ g, TX* __restrict__ dx, float* part,
                               float* dparams, int R, int D, float eps) {
  __shared__ float sm[2 * kWideWarps];
  __shared__ float scratch[kBwdThreads];
  const float inv_d = 1.f / static_cast<float>(D);
  float* prow = part + static_cast<size_t>(blockIdx.x) * 2 * D;
  for (int c = 4 * threadIdx.x; c < D; c += 4 * kWideThreads) {
    store4(prow + c, make_float4(0.f, 0.f, 0.f, 0.f));
    store4(prow + D + c, make_float4(0.f, 0.f, 0.f, 0.f));
  }
  // this block's rows: a fixed, contiguous share of R
  const int start = static_cast<int>(static_cast<long long>(blockIdx.x) * R / gridDim.x);
  const int end = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * R / gridDim.x);
  for (int row = start; row < end; ++row) {
    const size_t off = static_cast<size_t>(row) * D;
    float s = 0.f, s2 = 0.f;
    for (int c = 4 * threadIdx.x; c < D; c += 4 * kWideThreads) {
      const float4 v = ld4f(x + off + c);
      s += (v.x + v.y) + (v.z + v.w);
      s2 += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
    }
    const float2 t = block_sum2(s, s2, sm);
    const float mu = t.x * inv_d;
    const float rs = rsqrtf(fmaxf(0.f, t.y * inv_d - mu * mu) + eps);
    float s1 = 0.f, sx = 0.f;
    for (int c = 4 * threadIdx.x; c < D; c += 4 * kWideThreads) {
      const float4 v = ld4f(x + off + c), gv = ld4f(g + off + c), gm = load4(gamma + c);
      const float4 xh = make_float4((v.x - mu) * rs, (v.y - mu) * rs, (v.z - mu) * rs, (v.w - mu) * rs);
      const float4 gh = make_float4(gv.x * gm.x, gv.y * gm.y, gv.z * gm.z, gv.w * gm.w);
      s1 += (gh.x + gh.y) + (gh.z + gh.w);
      sx += (gh.x * xh.x + gh.y * xh.y) + (gh.z * xh.z + gh.w * xh.w);
    }
    const float2 u = block_sum2(s1, sx, sm);
    const float m1 = u.x * inv_d, m2 = u.y * inv_d;
    for (int c = 4 * threadIdx.x; c < D; c += 4 * kWideThreads) {
      const float4 v = ld4f(x + off + c), gv = ld4f(g + off + c), gm = load4(gamma + c);
      const float4 xh = make_float4((v.x - mu) * rs, (v.y - mu) * rs, (v.z - mu) * rs, (v.w - mu) * rs);
      store4(dx + off + c, make_float4(rs * (gv.x * gm.x - m1 - xh.x * m2),
                                       rs * (gv.y * gm.y - m1 - xh.y * m2),
                                       rs * (gv.z * gm.z - m1 - xh.z * m2),
                                       rs * (gv.w * gm.w - m1 - xh.w * m2)));
      float4 dg = load4(prow + c), db = load4(prow + D + c);
      dg.x += gv.x * xh.x, dg.y += gv.y * xh.y, dg.z += gv.z * xh.z, dg.w += gv.w * xh.w;
      db.x += gv.x, db.y += gv.y, db.z += gv.z, db.w += gv.w;
      store4(prow + c, dg);
      store4(prow + D + c, db);
    }
  }
  __threadfence();
  cg::this_grid().sync();  // every partial row written and visible
  fold_partials(part, gridDim.x, 2 * D, dparams, scratch);
}

// ---- launches ----------------------------------------------------------------

// switches to `device` for the launch when it is not current, and back after
struct DeviceGuard {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceGuard(int device) {
    int cur = 0;
    err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != device) {
      err = cudaSetDevice(device);
      if (err == cudaSuccess) prev = cur;
    }
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

cudaError_t sm_count(int device, int* n) {
  static int cache[kMaxDevices];  // 0: not asked yet
  if (device >= 0 && device < kMaxDevices && cache[device] > 0) {
    *n = cache[device];
    return cudaSuccess;
  }
  const cudaError_t err = cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && device >= 0 && device < kMaxDevices) cache[device] = *n;
  return err;
}

// blocks of `kernel` that fit on one SM at once (no dynamic shared memory),
// asked once per kernel instantiation (`cache` is a static of the caller)
template <typename K>
cudaError_t blocks_per_sm(K kernel, int threads, int* cache, int* n) {
  if (*cache <= 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(cache, kernel, threads, 0);
    if (err != cudaSuccess) return err;
    if (*cache <= 0) return cudaErrorInvalidConfiguration;
  }
  *n = *cache;
  return cudaSuccess;
}

template <typename TX, typename TO, int NV>
cudaError_t launch_fwd(const void* x, const void* gamma, const void* beta, void* out, int R,
                       float eps, int device, cudaStream_t stream) {
  constexpr int L1 = kOnePassLanes<TX>, LL = kLoopLanes<TX>;
  static int one_pass_cache = 0, loop_cache = 0;
  int one_pass_per_sm = 0, loop_per_sm = 0, sms = 0;
  cudaError_t err = blocks_per_sm(layer_norm_fwd_kernel<TX, TO, NV, L1, false>, kFwdThreads,
                                  &one_pass_cache, &one_pass_per_sm);
  if (err == cudaSuccess)
    err = blocks_per_sm(layer_norm_fwd_kernel<TX, TO, NV, LL, true>, kFwdThreads, &loop_cache, &loop_per_sm);
  if (err == cudaSuccess) err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  const TX* xp = static_cast<const TX*>(x);
  const float* gp = static_cast<const float*>(gamma);
  const float* bp = static_cast<const float*>(beta);
  TO* op = static_cast<TO*>(out);
  const int blocks = (R + kFwdThreads / L1 - 1) / (kFwdThreads / L1);
  if (blocks <= one_pass_per_sm * sms) {
    layer_norm_fwd_kernel<TX, TO, NV, L1, false><<<blocks, kFwdThreads, 0, stream>>>(xp, gp, bp, op, R, eps);
  } else {  // as few trips as one wave takes, the blocks of rows spread evenly
    const int groups = (R + kFwdThreads / LL - 1) / (kFwdThreads / LL);
    const int wave = loop_per_sm * sms;
    const int trips = (groups + wave - 1) / wave;
    layer_norm_fwd_kernel<TX, TO, NV, LL, true>
        <<<(groups + trips - 1) / trips, kFwdThreads, 0, stream>>>(xp, gp, bp, op, R, eps);
  }
  return cudaGetLastError();
}

template <typename TX, typename TG, int NV>
cudaError_t bwd_max_blocks(int device, int* n) {
  static int per_sm_cache = 0;
  int per_sm = 0, sms = 0;
  cudaError_t err =
      blocks_per_sm(layer_norm_bwd_kernel<TX, TG, NV>, kBwdThreads, &per_sm_cache, &per_sm);
  if (err == cudaSuccess) err = sm_count(device, &sms);
  if (err == cudaSuccess) *n = per_sm * sms;
  return err;
}

template <typename TX, typename TG, int NV>
cudaError_t launch_bwd(const void* x, const void* gamma, const void* g, void* dx, void* part,
                       void* dparams, int R, int blocks, float eps, cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  const float* gp = static_cast<const float*>(gamma);
  const TG* gg = static_cast<const TG*>(g);
  TX* dxp = static_cast<TX*>(dx);
  float* pp = static_cast<float*>(part);
  float* op = static_cast<float*>(dparams);
  // every block must be resident at once for the grid barrier: the launch
  // refuses a grid larger than that (cudaErrorCooperativeLaunchTooLarge)
  void* args[] = {&xp, &gp, &gg, &dxp, &pp, &op, &R, &eps};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(layer_norm_bwd_kernel<TX, TG, NV>),
                                     dim3(blocks), dim3(kBwdThreads), args, 0, stream);
}

template <typename TX, typename TO>
cudaError_t launch_fwd_wide(const void* x, const void* gamma, const void* beta, void* out, int R,
                            int D, float eps, int device, cudaStream_t stream) {
  static int per_sm_cache = 0;
  int per_sm = 0, sms = 0;
  cudaError_t err =
      blocks_per_sm(layer_norm_fwd_wide_kernel<TX, TO>, kWideThreads, &per_sm_cache, &per_sm);
  if (err == cudaSuccess) err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  const int blocks = R < per_sm * sms ? R : per_sm * sms;  // at most one wave, a row a block
  layer_norm_fwd_wide_kernel<TX, TO><<<blocks, kWideThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<TO*>(out), R, D, eps);
  return cudaGetLastError();
}

template <typename TX, typename TG>
cudaError_t bwd_wide_max_blocks(int device, int* n) {
  static int per_sm_cache = 0;
  int per_sm = 0, sms = 0;
  cudaError_t err =
      blocks_per_sm(layer_norm_bwd_wide_kernel<TX, TG>, kWideThreads, &per_sm_cache, &per_sm);
  if (err == cudaSuccess) err = sm_count(device, &sms);
  if (err == cudaSuccess) *n = per_sm * sms;
  return err;
}

template <typename TX, typename TG>
cudaError_t launch_bwd_wide(const void* x, const void* gamma, const void* g, void* dx, void* part,
                            void* dparams, int R, int D, int blocks, float eps, cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  const float* gp = static_cast<const float*>(gamma);
  const TG* gg = static_cast<const TG*>(g);
  TX* dxp = static_cast<TX*>(dx);
  float* pp = static_cast<float*>(part);
  float* op = static_cast<float*>(dparams);
  void* args[] = {&xp, &gp, &gg, &dxp, &pp, &op, &R, &D, &eps};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(layer_norm_bwd_wide_kernel<TX, TG>),
                                     dim3(blocks), dim3(kWideThreads), args, 0, stream);
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

// dispatch on the (bf16 = 0, f32 = 1) codes of two dtypes
#define LN_DISPATCH_DTYPES(A, B, FN, ARGS)                                         \
  if ((A) == 0 && (B) == 0) return FN<__nv_bfloat16, __nv_bfloat16> ARGS;          \
  if ((A) == 0 && (B) == 1) return FN<__nv_bfloat16, float> ARGS;                  \
  if ((A) == 1 && (B) == 0) return FN<float, __nv_bfloat16> ARGS;                  \
  if ((A) == 1 && (B) == 1) return FN<float, float> ARGS;                          \
  return cudaErrorInvalidValue;

template <typename TX, typename TO>
cudaError_t fwd_nv(int D, const void* x, const void* gamma, const void* beta, void* out, int R,
                   float eps, int device, cudaStream_t st) {
  if (D / 128 > kMaxVecs) return launch_fwd_wide<TX, TO>(x, gamma, beta, out, R, D, eps, device, st);
  LN_DISPATCH_NV(D / 128, (launch_fwd<TX, TO, NV>(x, gamma, beta, out, R, eps, device, st)))
}

template <typename TX, typename TG>
cudaError_t bwd_nv(int D, const void* x, const void* gamma, const void* g, void* dx, void* part,
                   void* dparams, int R, int blocks, float eps, cudaStream_t st) {
  if (D / 128 > kMaxVecs)
    return launch_bwd_wide<TX, TG>(x, gamma, g, dx, part, dparams, R, D, blocks, eps, st);
  LN_DISPATCH_NV(D / 128, (launch_bwd<TX, TG, NV>(x, gamma, g, dx, part, dparams, R, blocks, eps, st)))
}

template <typename TX, typename TG>
cudaError_t max_blocks_nv(int D, int device, int* n) {
  if (D / 128 > kMaxVecs) return bwd_wide_max_blocks<TX, TG>(device, n);
  LN_DISPATCH_NV(D / 128, (bwd_max_blocks<TX, TG, NV>(device, n)))
}

bool valid_shape(int R, int D) { return R >= 1 && D >= 128 && D % 128 == 0; }

}  // namespace

// dtype codes: 0 = bfloat16, 1 = float32. Every pointer is 16-byte aligned;
// x, out, g and dx are contiguous (R, D); gamma and beta are f32 (D,).
// `device` is the index of the card that holds them and `stream` a stream of
// that card: the call makes it current for the launch if it is not, and
// restores the caller's device. Each returns a cudaError_t (0 on success).
extern "C" int layer_norm_fwd(const void* x, const void* gamma, const void* beta, void* out, int R,
                              int D, float eps, int x_dtype, int out_dtype, int device,
                              void* stream) {
  if (!valid_shape(R, D)) return cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  LN_DISPATCH_DTYPES(x_dtype, out_dtype, fwd_nv,
                     (D, x, gamma, beta, out, R, eps, device, st))
}

// part: f32 (blocks, 2D) workspace; dparams: f32 (2, D), [dgamma; dbeta].
// blocks: from 1 to layer_norm_bwd_max_blocks; every block takes a
// contiguous share of the rows. One cooperative kernel.
extern "C" int layer_norm_bwd(const void* x, const void* gamma, const void* g, void* dx, void* part,
                              void* dparams, int R, int D, int blocks, float eps, int x_dtype,
                              int g_dtype, int device, void* stream) {
  if (!valid_shape(R, D) || blocks < 1 || blocks > R) return cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  LN_DISPATCH_DTYPES(x_dtype, g_dtype, bwd_nv,
                     (D, x, gamma, g, dx, part, dparams, R, blocks, eps, st))
}

// *n = the most blocks of the backward's cooperative kernel for this D and
// these dtypes that fit on the card `device` at once
extern "C" int layer_norm_bwd_max_blocks(int D, int x_dtype, int g_dtype, int device, void* n) {
  if (!valid_shape(1, D)) return cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  LN_DISPATCH_DTYPES(x_dtype, g_dtype, max_blocks_nv, (D, device, static_cast<int*>(n)))
}

extern "C" const char* layer_norm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
