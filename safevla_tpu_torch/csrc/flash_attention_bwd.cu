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
//   (j >= key_lens[b]) get exactly zero dk and dv. key_lens[b] must lie in
//   [1, S]: the kernel traps otherwise.
//
// Streaming (both dtypes, S above the resident limit and the head dims the
// resident designs do not take; never at a path shape): CUDA-core f32 FMAs,
// no plane of S rows resident.//
// What bounds it on an H100: ~10*S*kl*Dh flops per (b, h) for the five
// products (s, dp, dv, dq, dk) against 7*B*S*H*Dh IO elements (qkv and g
// read once, dqkv written once). At the update's shape (S=208, Dh=64, ~190
// valid keys) that is ~135 flops per byte, under the ~295 at which the bf16
// tensor cores become the limit: an ideal kernel is bound by memory.
//
// The dtype picks the resident design (dispatch by dtype; a failed build or
// launch raises in either); above the largest S a resident design takes (its
// shared memory, 227 KB a block), the wrapper launches the streaming design
// (`attention_qkv_bwd_stream`, below), a shape rule decided before the
// launch. The largest S of the resident designs (`resident_max_s` in
// ops/flash_attention.py computes the same):
//   bf16: 4 planes of round16(S) rows x Dh x 2 bytes and 3 f32 statistics a
//         row <= 227 KB: Dh 16: 1648, 32: 864, 64: 432, 128: 224
//   f32:  S x (3 x (Dh + 1) x 4 + 35 x 4) bytes <= 227 KB:
//         Dh 16: 675, 32: 433, 64: 252, 128: 137
// Above them, and at any S (offsets are 64-bit), the streaming design runs.
// No design uses atomics: every
// gradient row is summed by one warp in a fixed order, so two runs give the
// same bits.
//
// bf16 (every launch on the main path) runs on the tensor cores,
// mma.sync.m16n8k16 with f32 accumulators (helpers in hopper_mma.cuh), in
// one block of 4 warps per (head, batch row) and two phases. The forward
// saves only (qkv, key_lens), so the block recomputes the softmax statistics
// itself; keeping them in shared memory between the phases needs neither a
// second kernel nor a scratch buffer in device memory.
//   * Q, G (rows < S) and K, V (rows < key_lens[b], rounded up to 16) arrive
//     by cp.async (16-byte chunks) into XOR-swizzled planes read by ldmatrix;
//     rows past S or key_lens[b] are zero-filled by the copy, and key tiles
//     wholly past key_lens[b] are never loaded. At S=208 (Dh 64) the four
//     planes and the statistics take 106 KB, so two blocks fit on an SM; S
//     is bounded by the 227 KB a block may use (524 bytes a row at Dh 64:
//     S <= 432).
//   * Phase A, one warp per 16 query rows (q and g held as A fragments):
//     pass 1 runs q.k^T for the row max m and rowsum(e) (each lane keeps the
//     max and sum of its own columns, rescaling the sum when its max grows,
//     and the row's four lanes merge them at the end; p is rounded only once
//     m and the sum are final); pass 2 recomputes s, forms
//     p = bf16(e * (1 / rowsum)) and dp = g.v^T for D; pass 3 recomputes
//     both, forms ds = p (dp - D) and feeds dsb from the accumulators
//     straight into the A fragments of dq += dsb.k. The warp writes dq, and
//     m, 1 / rowsum and D into shared memory.
//   * Phase B, after a barrier, one warp per 16 key rows (k and v held as A
//     fragments): over the query rows, s^T = k.q^T and dp^T = v.g^T, then
//     p^T and dsb^T from the phase-A statistics, which are the A fragments of
//     dv += p^T.g and dk += dsb^T.q (g and q through ldmatrix.trans). The
//     two phases may round a p differently (their sums run in another
//     order); both are the TPU kernel's function.
//   * Both phases walk their columns in chunks of 32 (four independent
//     accumulators a product, so the mma chains overlap), unmasked while the
//     chunk holds only valid keys, then in masked chunks of 16. Logits are
//     kept in log2 units (one FFMA and one exp2 an element) and p multiplies
//     by 1 / rowsum instead of dividing: both agree with the plain version's
//     exp and quotient to a few ulp of f32, far under the bf16 rounding of p.
//   * mma.sync, not wgmma: below the ridge, small tiles, and the
//     accumulator-to-A-fragment reuse above.
//
// f32 (the checks and the small f32 reference policy; TF32 tensor cores
// would miss the 1e-4 tolerance) keeps the CUDA-core design of the first
// port: one block of 16 warps per (head, batch row); Q, K and V staged in
// shared memory (rows padded by one word), G read from global memory; phase 1
// one warp per query row (lanes split the keys; shuffles reduce m, rowsum and
// D; lanes split the head dims for dq), phase 2 one warp per key row (p and
// ds recomputed with the same FMA order, so the same bits; dk and dv), f32
// FMAs throughout.
//
// Streaming (both dtypes, S above the resident limit and the head dims the
// resident designs do not take; never at a path shape): CUDA-core f32 FMAs,
// no plane of S rows resident, three kernels in
// one call, no atomics (attention_stream.cuh: blocks of 8 warps owning 64
// rows, 8 a warp, the other side streamed in two-slot rings of 32-row
// tiles):
//   1. stats, one block per 64-query tile: K streams for the row max m and
//      rowsum (each lane keeps its own keys' max and sum, rescaled when its
//      max grows, merged across the warp at the end), then K and V for
//      D = sum_j p_ij dp_ij with p = io(e / rowsum); m, rowsum and D go to a
//      (3, B, H, S) f32 scratch the wrapper allocates;
//   2. dk and dv, one block per 64-key tile: Q, G and the statistics stream;
//      a lane a query row forms p and dsb, shuffles broadcast them and a lane
//      accumulates its head dims of dv += p g and dk += dsb q; key rows past
//      key_lens[b] are written as zeros;
//   3. dq, one block per 64-query tile: K and V stream, dq += dsb k.
// Every kernel forms s with the same FMA order, so p and ds agree bit for
// bit between them. Above head dim 256 the sliced design runs the same three
// kernels on 256-wide head slices (below, "head-dim sliced").
//
// Batch rows and heads: a launch takes at most 65535 of each; the wrapper
// splits a larger call into launches over slices of both (`launch_slices`);
// the streaming designs index their statistics scratch by the launch's own
// rows and heads, (3, B, nh, S).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_stream.cuh"
#include "attention_tc.cuh"
#include "hopper_mma.cuh"

namespace {

// ---------------------------------------------------------------- bf16 ---

using namespace attn_tc;  // the tile walk (attention_tc.cuh)

template <int DH>
size_t tc_smem_bytes(int S) {
  const size_t s16 = static_cast<size_t>(round16(S));
  return 4 * s16 * Tc<DH>::kRowBytes + 3 * s16 * sizeof(float);
}

// Logits are kept in log2 units: e = exp(s - m) = exp2(s * log2(e) - m *
// log2(e)), one FFMA and one exp2 each (the f32 values agree to a few ulp).
// A finite floor instead of -inf for "no key yet" keeps every rescale finite.
constexpr float kNoMax = -1e30f;

// Phase B for one slice of 16 key rows: dk and dv over every query chunk.
// kMaskKeys: some of the slice's rows are >= key_lens[b] (valid[] says which
// of this lane's two rows are keys).
template <int DH, bool kMaskKeys>
__device__ __forceinline__ void dk_dv_slice(float (&dk)[Tc<DH>::kN][4], float (&dv)[Tc<DH>::kN][4],
                                            const uint32_t (&kf)[Tc<DH>::kK][4],
                                            const uint32_t (&vf)[Tc<DH>::kK][4], uint32_t q_s,
                                            uint32_t g_s, const float* m_s, const float* l_s,
                                            const float* d_s, int s16, const bool (&valid)[2],
                                            float scale2, int lane) {
  const int col0 = 2 * (lane & 3);
  over_chunks(s16, s16, [&](auto nt, auto, int i0) {
    constexpr int NT = decltype(nt)::value;
    float st[NT][4], dpt[NT][4];
    product<DH, NT>(st, kf, q_s, i0, lane);   // s^T = k . q^T
    product<DH, NT>(dpt, vf, g_s, i0, lane);  // dp^T = v . g^T
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int q = i0 + 8 * j + col0;
      const float2 m2 = *reinterpret_cast<const float2*>(m_s + q);
      const float2 l2 = *reinterpret_cast<const float2*>(l_s + q);
      const float2 d2 = *reinterpret_cast<const float2*>(d_s + q);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mm = (e & 1) ? m2.y : m2.x;
        const float ll = (e & 1) ? l2.y : l2.x;
        const float dd = (e & 1) ? d2.y : d2.x;
        float p = hopper::round_bf16(exp2f(fmaf(st[j][e], scale2, -mm)) * ll);
        if (kMaskKeys && !valid[e >> 1]) p = 0.f;
        dpt[j][e] = p * (dpt[j][e] - dd);
        st[j][e] = p;
      }
    }
    accumulate<DH, NT>(dv, st, g_s, i0, lane);   // dv += p^T . g
    accumulate<DH, NT>(dk, dpt, q_s, i0, lane);  // dk += dsb^T . q
  });
}

template <int DH>
__global__ void __launch_bounds__(kTcThreads, 2)
    attention_bwd_tc_kernel(const __nv_bfloat16* __restrict__ qkv,
                            const __nv_bfloat16* __restrict__ g, const int* __restrict__ key_lens,
                            __nv_bfloat16* __restrict__ dqkv, int S, int H, int h0,
                            long long stride_b, long long stride_s, float scale) {
  using T = Tc<DH>;
  constexpr int C = T::kChunks;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int h = h0 + static_cast<int>(blockIdx.x);
  const int b = static_cast<int>(blockIdx.y);
  const int kl = key_lens ? key_lens[b] : S;
  if (kl < 1 || kl > S) __trap();
  const int s16 = round16(S);
  const int nk16 = round16(kl);
  const int lanes = H * DH;
  const __nv_bfloat16* base = qkv + b * stride_b + h * DH;
  const __nv_bfloat16* g_base = g + static_cast<size_t>(b) * S * lanes + h * DH;
  __nv_bfloat16* d_base = dqkv + b * stride_b + h * DH;

  // shared memory: the Q, K, V and G planes (s16 swizzled rows each), then
  // m (log2 units), 1 / rowsum and D of every query row
  const uint32_t plane = static_cast<uint32_t>(s16) * T::kRowBytes;
  const uint32_t q_s = hopper::smem_addr(smem_raw);
  const uint32_t k_s = q_s + plane;
  const uint32_t v_s = k_s + plane;
  const uint32_t g_s = v_s + plane;
  float* m_s = reinterpret_cast<float*>(smem_raw + 4 * static_cast<size_t>(plane));
  float* l_s = m_s + s16;
  float* d_s = l_s + s16;

  for (int i = threadIdx.x; i < s16 * C; i += kTcThreads) {
    const int r = i / C, c = i % C;
    const uint32_t off = hopper::swz<C>(r, c);
    const bool q_ok = r < S;
    const int rq = q_ok ? r : 0;
    hopper::cp_async16(q_s + off, base + rq * stride_s + c * 8, q_ok);
    hopper::cp_async16(g_s + off, g_base + static_cast<size_t>(rq) * lanes + c * 8, q_ok);
    if (r < nk16) {
      const bool k_ok = r < kl;
      const __nv_bfloat16* src = base + (k_ok ? r : 0) * stride_s + c * 8;
      hopper::cp_async16(k_s + off, src + lanes, k_ok);
      hopper::cp_async16(v_s + off, src + 2 * lanes, k_ok);
    }
  }
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  __syncthreads();

  const int col0 = 2 * (lane & 3);
  const float scale2 = scale * 1.4426950408889634f;

  // phase A: one warp per 16 query rows -> m, 1 / rowsum, D and dq
  for (int r0 = 16 * warp; r0 < s16; r0 += 16 * (kTcThreads / 32)) {
    uint32_t qf[T::kK][4], gf[T::kK][4];
#pragma unroll
    for (int kk = 0; kk < T::kK; ++kk) {
      hopper::ldsm_x4(qf[kk], hopper::a_addr<C>(q_s, r0, kk, lane));
      hopper::ldsm_x4(gf[kk], hopper::a_addr<C>(g_s, r0, kk, lane));
    }

    // pass 1: the row max and rowsum(e); each lane keeps its own columns'
    // max and sum (rescaled when its max grows), merged across the 4 lanes
    // of the row at the end
    float m[2] = {kNoMax, kNoMax}, l[2] = {0.f, 0.f};
    over_chunks(kl, nk16, [&](auto nt, auto masked, int k0) {
      constexpr int NT = decltype(nt)::value;
      constexpr bool kMask = decltype(masked)::value;
      const int valid = kl - k0 - col0;  // columns 8j + (e & 1) < valid are keys
      float s[NT][4];
      product<DH, NT>(s, qf, k_s, k0, lane);
      float mn[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] *= scale2;
          if (!kMask || 8 * j + (e & 1) < valid) mn[e >> 1] = fmaxf(mn[e >> 1], s[j][e]);
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        l[hh] *= exp2f(m[hh] - mn[hh]);
        m[hh] = mn[hh];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!kMask || 8 * j + (e & 1) < valid) l[e >> 1] += exp2f(s[j][e] - m[e >> 1]);
        }
      }
    });
    // p = bf16(e * (1 / rowsum)): the f32 quotient to within an ulp
    float inv_l[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float mx = hopper::quad_max(m[hh]);
      inv_l[hh] = 1.f / hopper::quad_sum(l[hh] * exp2f(m[hh] - mx));
      m[hh] = mx;
    }

    // p of one chunk, in place of its logits
    auto probs = [&](auto nt, auto masked, auto& s, int k0) {
      constexpr int NT = decltype(nt)::value;
      constexpr bool kMask = decltype(masked)::value;
      const int valid = kl - k0 - col0;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = hopper::round_bf16(exp2f(fmaf(s[j][e], scale2, -m[e >> 1])) * inv_l[e >> 1]);
          s[j][e] = (!kMask || 8 * j + (e & 1) < valid) ? p : 0.f;
        }
      }
    };

    // pass 2: D = sum_j dp_ij p_ij
    float dsum[2] = {0.f, 0.f};
    over_chunks(kl, nk16, [&](auto nt, auto masked, int k0) {
      constexpr int NT = decltype(nt)::value;
      float s[NT][4], dp[NT][4];
      product<DH, NT>(s, qf, k_s, k0, lane);
      product<DH, NT>(dp, gf, v_s, k0, lane);
      probs(nt, masked, s, k0);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dsum[e >> 1] += dp[j][e] * s[j][e];
      }
    });
    const float D[2] = {hopper::quad_sum(dsum[0]), hopper::quad_sum(dsum[1])};

    // pass 3: ds = p (dp - D), dq += bf16(ds) . k
    float dq[T::kN][4];
#pragma unroll
    for (int j = 0; j < T::kN; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
    over_chunks(kl, nk16, [&](auto nt, auto masked, int k0) {
      constexpr int NT = decltype(nt)::value;
      float s[NT][4], dp[NT][4];
      product<DH, NT>(s, qf, k_s, k0, lane);
      product<DH, NT>(dp, gf, v_s, k0, lane);
      probs(nt, masked, s, k0);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= dp[j][e] - D[e >> 1];
      }
      accumulate<DH, NT>(dq, s, k_s, k0, lane);
    });
    store_rows<DH>(d_base, stride_s, dq, scale, r0, S, S, lane);
    if ((lane & 3) == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + (lane >> 2) + 8 * hh;
        m_s[r] = m[hh];
        l_s[r] = inv_l[hh];
        d_s[r] = D[hh];
      }
    }
  }
  __syncthreads();

  // phase B: one warp per 16 key rows -> dk and dv
  for (int j0 = 16 * warp; j0 < nk16; j0 += 16 * (kTcThreads / 32)) {
    uint32_t kf[T::kK][4], vf[T::kK][4];
#pragma unroll
    for (int kk = 0; kk < T::kK; ++kk) {
      hopper::ldsm_x4(kf[kk], hopper::a_addr<C>(k_s, j0, kk, lane));
      hopper::ldsm_x4(vf[kk], hopper::a_addr<C>(v_s, j0, kk, lane));
    }
    const bool valid[2] = {j0 + (lane >> 2) < kl, j0 + (lane >> 2) + 8 < kl};
    float dk[T::kN][4], dv[T::kN][4];
#pragma unroll
    for (int j = 0; j < T::kN; ++j) {
      dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
      dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
    }
    if (j0 + 16 <= kl)
      dk_dv_slice<DH, false>(dk, dv, kf, vf, q_s, g_s, m_s, l_s, d_s, s16, valid, scale2, lane);
    else
      dk_dv_slice<DH, true>(dk, dv, kf, vf, q_s, g_s, m_s, l_s, d_s, s16, valid, scale2, lane);
    store_rows<DH>(d_base + lanes, stride_s, dk, scale, j0, S, kl, lane);
    store_rows<DH>(d_base + 2 * lanes, stride_s, dv, 1.f, j0, S, kl, lane);
  }

  // key rows nk16..S-1 (wholly past key_lens[b]): dk = dv = 0
  for (int i = threadIdx.x; i < (S - nk16) * 2 * C; i += kTcThreads) {
    const int r = nk16 + i / (2 * C), c = i % (2 * C);
    *reinterpret_cast<uint4*>(d_base + r * stride_s + (c < C ? lanes : 2 * lanes) + (c % C) * 8) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// ----------------------------------------------------------------- f32 ---

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;

template <int DH>
__device__ __forceinline__ void stage_row(float* dst, const float* src) {
#pragma unroll
  for (int c = 0; c < DH; c += 4) {
    const float4 v = *reinterpret_cast<const float4*>(src + c);
    dst[c] = v.x;
    dst[c + 1] = v.y;
    dst[c + 2] = v.z;
    dst[c + 3] = v.w;
  }
}

template <int DH>
__device__ __forceinline__ void load_row(float (&r)[DH], const float* p) {
#pragma unroll
  for (int d = 0; d < DH; ++d) r[d] = p[d];
}

// r . row, with d ascending: phase 1 and phase 2 both compute each product
// with this function, so p and ds agree bit for bit between them.
template <int DH>
__device__ __forceinline__ float dot_row(const float (&r)[DH], const float* row) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) acc = fmaf(r[d], row[d], acc);
  return acc;
}

template <int DH>
size_t f32_smem_bytes(int S) {
  return 3 * static_cast<size_t>(S) * (DH + 1) * sizeof(float) +
         (2 * static_cast<size_t>(kWarps) + 3) * S * sizeof(float);
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ g,
                             const int* __restrict__ key_lens, float* __restrict__ dqkv, int S,
                             int H, int h0, long long stride_b, long long stride_s, float scale) {
  constexpr int kRowStride = DH + 1;            // words per staged row
  constexpr int kPer = DH >= 32 ? DH / 32 : 1;  // head dims a lane accumulates
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int h = h0 + static_cast<int>(blockIdx.x);
  const int b = static_cast<int>(blockIdx.y);
  const int kl = key_lens ? key_lens[b] : S;
  if (kl < 1 || kl > S) __trap();

  const size_t plane = static_cast<size_t>(S) * kRowStride;
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + plane;
  float* vs = ks + plane;
  float* prow_all = vs + plane;
  float* drow_all = prow_all + kWarps * S;
  float* m_s = drow_all + kWarps * S;
  float* l_s = m_s + S;
  float* d_s = l_s + S;

  const int lanes = H * DH;
  const float* base = qkv + b * stride_b + h * DH;
  const float* grows = g + (static_cast<size_t>(b) * S) * lanes + h * DH;
  for (int r = threadIdx.x; r < S; r += kThreads) {
    const float* src = base + r * stride_s;
    stage_row<DH>(qs + r * kRowStride, src);
    if (r < kl) {
      stage_row<DH>(ks + r * kRowStride, src + lanes);
      stage_row<DH>(vs + r * kRowStride, src + 2 * lanes);
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int d0 = kPer * lane;
  const bool has_dims = d0 < DH;
  float* prow = prow_all + warp * S;
  float* drow = drow_all + warp * S;
  float* out_base = dqkv + b * stride_b + h * DH + d0;
  float r[DH];

  // phase 1: one warp per query row -> m, rowsum(e), D, and dq
  for (int i = warp; i < S; i += kWarps) {
    load_row<DH>(r, qs + i * kRowStride);
    float mx = __int_as_float(0xff800000);  // -inf
    for (int j = lane; j < kl; j += 32) {
      const float s = dot_row<DH>(r, ks + j * kRowStride) * scale;
      prow[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = stream::warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < kl; j += 32) {
      const float e = expf(prow[j] - mx);
      prow[j] = e;
      sum += e;
    }
    sum = stream::warp_sum(sum);
    load_row<DH>(r, grows + i * lanes);
    float dsum = 0.f;
    for (int j = lane; j < kl; j += 32) {
      const float p = prow[j] / sum;
      const float dp = dot_row<DH>(r, vs + j * kRowStride);
      prow[j] = p;
      drow[j] = dp;
      dsum = fmaf(dp, p, dsum);
    }
    const float dsum_all = stream::warp_sum(dsum);
    for (int j = lane; j < kl; j += 32) drow[j] = prow[j] * (drow[j] - dsum_all);
    __syncwarp();
    if (has_dims) {
      float a[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) a[u] = 0.f;
      for (int j = 0; j < kl; ++j) {
        const float ds = drow[j];
#pragma unroll
        for (int u = 0; u < kPer; ++u) a[u] = fmaf(ds, ks[j * kRowStride + d0 + u], a[u]);
      }
      float* o = out_base + i * stride_s;
#pragma unroll
      for (int u = 0; u < kPer; ++u) o[u] = a[u] * scale;
    }
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
    float* out = out_base + j * stride_s;
    if (j >= kl) {  // masked key: p = 0 for every query row
      if (has_dims) {
#pragma unroll
        for (int u = 0; u < kPer; ++u) out[lanes + u] = out[2 * lanes + u] = 0.f;
      }
      continue;
    }
    load_row<DH>(r, ks + j * kRowStride);
    for (int i = lane; i < S; i += 32) {
      const float s = dot_row<DH>(r, qs + i * kRowStride) * scale;
      prow[i] = expf(s - m_s[i]) / l_s[i];
    }
    load_row<DH>(r, vs + j * kRowStride);
    for (int i = lane; i < S; i += 32) {
      const float dp = dot_row<DH>(r, grows + i * lanes);
      drow[i] = prow[i] * (dp - d_s[i]);
    }
    __syncwarp();
    if (has_dims) {
      float kk[kPer], vv[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) kk[u] = vv[u] = 0.f;
      for (int i = 0; i < S; ++i) {
        const float p = prow[i];
        const float ds = drow[i];
        const float* gr = grows + i * lanes + d0;
        const float* qr = qs + i * kRowStride + d0;
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          vv[u] = fmaf(p, gr[u], vv[u]);
          kk[u] = fmaf(ds, qr[u], kk[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        out[lanes + u] = kk[u] * scale;
        out[2 * lanes + u] = vv[u];
      }
    }
    __syncwarp();
  }
}

// ----------------------------------------------------------- streaming ---

// Slots of each ring of streamed tiles: two (the next tile's copies in
// flight while the current one is used) where the kernels' shared memory
// then fits a block, else one (the next tile is copied after the current
// one is used). One slot only at f32 and padded head dim 256: 2 x 64 owned
// rows and 2 rings of 2 x 32 rows of 1040 bytes are 266,240 bytes, above the
// 232,448 a block may use; with one slot a ring, 199,680.
template <typename T, int DP>
__host__ __device__ constexpr int stream_smem_bytes(int slots) {
  return (2 * stream::kBlockRows + 2 * slots * stream::kTileRows) * stream::Rows<T, DP>::kStride;
}
template <typename T, int DP>
constexpr int kSlots = stream_smem_bytes<T, DP>(2) <= stream::kMaxSmem ? 2 : 1;

// Where a streaming kernel's operands live: qkv and g of one (head, batch
// row), the statistics scratch (3, B, nh, S) of the launch (its batch rows
// and its nh heads h0..h0+nh-1) and dqkv.
template <typename T>
struct StreamView {
  const T* q;  // head column 0 of row 0 of q; k and v are lanes and 2 * lanes further
  const T* g;  // head column 0 of row 0 of g (rows `lanes` apart)
  T* dq;       // the same in dqkv
  float* m;    // m, rowsum and D of row 0 of this (b, h); B * nh * S apart
  int kl, lanes;
  size_t bhs;

  __device__ StreamView(const T* qkv, const T* g_all, T* dqkv, float* stats, const int* key_lens,
                        int S, int H, int h0, int dh, long long stride_b) {
    const int hl = static_cast<int>(blockIdx.y);  // the head's place in this launch
    const int h = h0 + hl;
    const int b = static_cast<int>(blockIdx.z);
    kl = key_lens ? key_lens[b] : S;
    if (kl < 1 || kl > S) __trap();
    lanes = H * dh;
    q = qkv + b * stride_b + h * dh;
    g = g_all + static_cast<size_t>(b) * S * lanes + h * dh;
    dq = dqkv ? dqkv + b * stride_b + h * dh : nullptr;
    bhs = static_cast<size_t>(gridDim.z) * gridDim.y * S;
    m = stats + (static_cast<size_t>(b) * gridDim.y + hl) * S;
  }
};

// Runs body(t, slot offset) over n tiles of 32 rows through rings of kS
// slots: with two, the next tile's copies (issued by load(t, slot offset),
// one commit group) are in flight while the current one is used; with one,
// they are issued once every warp is done with it.
template <int kS, typename Load, typename Body>
__device__ __forceinline__ void over_tiles(int n, int tile_bytes, Load&& load, Body&& body) {
  load(0, 0);
  hopper::cp_async_commit();
  for (int t = 0; t < n; ++t) {
    if (kS == 2 && t + 1 < n) {
      load(t + 1, ((t + 1) & 1) * tile_bytes);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();
    body(t, kS == 2 ? (t & 1) * tile_bytes : 0);
    __syncthreads();  // every warp is done with this slot before it is refilled
    if (kS == 1 && t + 1 < n) {
      load(t + 1, 0);
      hopper::cp_async_commit();
    }
  }
}

// The pad columns dh..DP-1 of every staged row: zeros, never copied over.
template <typename T, int DP>
__device__ __forceinline__ void zero_pad(unsigned char* smem, int dh) {
  if (dh < DP) {
    stream::zero_smem(smem, stream_smem_bytes<T, DP>(kSlots<T, DP>));
    __syncthreads();
  }
}

// 1. m, rowsum and D of 64 query rows.
template <typename T, int DP>
__global__ void __launch_bounds__(stream::kThreads)
    attention_bwd_stats_kernel(const T* __restrict__ qkv, const T* __restrict__ g_all,
                               const int* __restrict__ key_lens, float* __restrict__ stats, int S,
                               int H, int h0, int dh, long long stride_b, long long stride_s,
                               float scale, int width) {
  using R = stream::Rows<T, DP>;
  constexpr int kRows = stream::kRowsPerWarp;
  constexpr int kS = kSlots<T, DP>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const StreamView<T> v(qkv, g_all, nullptr, stats, key_lens, S, H, h0, dh, stride_b);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = static_cast<int>(blockIdx.x) * stream::kBlockRows;
  zero_pad<T, DP>(smem_raw, dh);
  unsigned char* q_s = smem_raw;
  unsigned char* g_s = q_s + stream::kBlockRows * R::kStride;
  unsigned char* k_s = g_s + stream::kBlockRows * R::kStride;
  unsigned char* v_s = k_s + kS * R::kTileBytes;
  stream::load_rows<T, DP>(hopper::smem_addr(q_s), v.q, stride_s, q0, stream::kBlockRows, S, dh,
                           width);
  stream::load_rows<T, DP>(hopper::smem_addr(g_s), v.g, v.lanes, q0, stream::kBlockRows, S, dh,
                           width);
  hopper::cp_async_commit();
  const unsigned char* my_q = q_s + warp * kRows * R::kStride;
  const unsigned char* my_g = g_s + warp * kRows * R::kStride;
  const int n_tiles = (v.kl + stream::kTileRows - 1) / stream::kTileRows;
  auto load_k = [&](int t, int slot) {
    stream::load_rows<T, DP>(hopper::smem_addr(k_s) + slot, v.q + v.lanes, stride_s,
                             t * stream::kTileRows, stream::kTileRows, v.kl, dh, width);
  };
  auto load_kv = [&](int t, int slot) {
    load_k(t, slot);
    stream::load_rows<T, DP>(hopper::smem_addr(v_s) + slot, v.q + 2 * v.lanes, stride_s,
                             t * stream::kTileRows, stream::kTileRows, v.kl, dh, width);
  };

  // K: the row max and rowsum, each lane over its own keys
  float m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = __int_as_float(0xff800000);
    l[r] = 0.f;
  }
  over_tiles<kS>(n_tiles, R::kTileBytes, load_k, [&](int t, int slot) {
    const unsigned char* k_row = k_s + slot + lane * R::kStride;
    if (t * stream::kTileRows + lane >= v.kl) return;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float s = stream::dot_rows<T, DP>(my_q + r * R::kStride, k_row) * scale;
      if (s > m[r]) {
        l[r] = l[r] * expf(m[r] - s) + 1.f;
        m[r] = s;
      } else {
        l[r] += expf(s - m[r]);
      }
    }
  });
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float mx = stream::warp_max(m[r]);
    l[r] = stream::warp_sum(l[r] * expf(m[r] - mx));  // a lane with no key: 0 * 0
    m[r] = mx;
  }

  // K and V: D = sum_j p_ij dp_ij, p = io(e / rowsum)
  float dsum[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) dsum[r] = 0.f;
  over_tiles<kS>(n_tiles, R::kTileBytes, load_kv, [&](int t, int slot) {
    const unsigned char* k_row = k_s + slot + lane * R::kStride;
    const unsigned char* v_row = v_s + slot + lane * R::kStride;
    if (t * stream::kTileRows + lane >= v.kl) return;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float s = stream::dot_rows<T, DP>(my_q + r * R::kStride, k_row) * scale;
      const float p = stream::round_io<T>(expf(s - m[r]) / l[r]);
      const float dp = stream::dot_rows<T, DP>(my_g + r * R::kStride, v_row);
      dsum[r] = fmaf(dp, p, dsum[r]);
    }
  });
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float d = stream::warp_sum(dsum[r]);
    const int row = q0 + warp * kRows + r;
    if (lane == 0 && row < S) {
      v.m[row] = m[r];
      v.m[v.bhs + row] = l[r];
      v.m[2 * v.bhs + row] = d;
    }
  }
}

// 2. dk and dv of 64 key rows.
template <typename T, int DP>
__global__ void __launch_bounds__(stream::kThreads)
    attention_bwd_dkdv_kernel(const T* __restrict__ qkv, const T* __restrict__ g_all,
                              const int* __restrict__ key_lens, const float* __restrict__ stats,
                              T* __restrict__ dqkv, int S, int H, int h0, int dh,
                              long long stride_b, long long stride_s, float scale, int width) {
  using R = stream::Rows<T, DP>;
  constexpr int kRows = stream::kRowsPerWarp;
  constexpr int kS = kSlots<T, DP>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const StreamView<T> v(qkv, g_all, dqkv, const_cast<float*>(stats), key_lens, S, H, h0, dh,
                        stride_b);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j0 = static_cast<int>(blockIdx.x) * stream::kBlockRows;
  const int d0 = R::kPer * lane;
  const bool has_dims = d0 < DP;
  if (j0 >= v.kl) {  // every key row of the tile is masked: dk = dv = 0
    for (int r = warp; r < stream::kBlockRows && j0 + r < S; r += stream::kWarps) {
      if (!has_dims) continue;
      T* row = v.dq + (j0 + r) * stride_s + d0;
#pragma unroll
      for (int u = 0; u < R::kPer; ++u)
        if (d0 + u < dh) row[v.lanes + u] = row[2 * v.lanes + u] = stream::from_f32<T>(0.f);
    }
    return;
  }
  zero_pad<T, DP>(smem_raw, dh);
  unsigned char* k_s = smem_raw;
  unsigned char* vv_s = k_s + stream::kBlockRows * R::kStride;
  unsigned char* q_s = vv_s + stream::kBlockRows * R::kStride;
  unsigned char* g_s = q_s + kS * R::kTileBytes;
  stream::load_rows<T, DP>(hopper::smem_addr(k_s), v.q + v.lanes, stride_s, j0,
                           stream::kBlockRows, v.kl, dh, width);
  stream::load_rows<T, DP>(hopper::smem_addr(vv_s), v.q + 2 * v.lanes, stride_s, j0,
                           stream::kBlockRows, v.kl, dh, width);
  hopper::cp_async_commit();
  const unsigned char* my_k = k_s + warp * kRows * R::kStride;
  const unsigned char* my_v = vv_s + warp * kRows * R::kStride;
  const int n_tiles = (S + stream::kTileRows - 1) / stream::kTileRows;
  auto load = [&](int t, int slot) {
    const int row0 = t * stream::kTileRows;
    stream::load_rows<T, DP>(hopper::smem_addr(q_s) + slot, v.q, stride_s, row0,
                             stream::kTileRows, S, dh, width);
    stream::load_rows<T, DP>(hopper::smem_addr(g_s) + slot, v.g, v.lanes, row0,
                             stream::kTileRows, S, dh, width);
  };

  float dk[kRows][R::kPer], dv[kRows][R::kPer];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int u = 0; u < R::kPer; ++u) dk[r][u] = dv[r][u] = 0.f;
  }
  over_tiles<kS>(n_tiles, R::kTileBytes, load, [&](int t, int slot) {
    const int i = t * stream::kTileRows + lane;  // this lane's query row
    const bool q_ok = i < S;
    const float mi = q_ok ? v.m[i] : 0.f;
    const float li = q_ok ? v.m[v.bhs + i] : 1.f;
    const float di = q_ok ? v.m[2 * v.bhs + i] : 0.f;
    const unsigned char* q_row = q_s + slot + lane * R::kStride;
    const unsigned char* g_row = g_s + slot + lane * R::kStride;
    const unsigned char* q_tile = q_s + slot;
    const unsigned char* g_tile = g_s + slot;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float s = stream::dot_rows<T, DP>(q_row, my_k + r * R::kStride) * scale;
      const float p = q_ok ? stream::round_io<T>(expf(s - mi) / li) : 0.f;
      const float dp = stream::dot_rows<T, DP>(g_row, my_v + r * R::kStride);
      const float dsb = stream::round_io<T>(p * (dp - di));
      for (int jq = 0; jq < stream::kTileRows; ++jq) {
        const float pj = __shfl_sync(0xffffffffu, p, jq);
        const float dj = __shfl_sync(0xffffffffu, dsb, jq);
        if (has_dims) {
          stream::axpy_row<T, DP>(dv[r], pj, g_tile + jq * R::kStride, d0);
          stream::axpy_row<T, DP>(dk[r], dj, q_tile + jq * R::kStride, d0);
        }
      }
    }
  });
  if (!has_dims) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int j = j0 + warp * kRows + r;
    if (j >= S) continue;
    const bool key = j < v.kl;  // a masked key row: exactly 0
    T* row = v.dq + j * stride_s + d0;
#pragma unroll
    for (int u = 0; u < R::kPer; ++u) {
      if (d0 + u >= dh) continue;
      row[v.lanes + u] = stream::from_f32<T>(key ? dk[r][u] * scale : 0.f);
      row[2 * v.lanes + u] = stream::from_f32<T>(key ? dv[r][u] : 0.f);
    }
  }
}

// 3. dq of 64 query rows.
template <typename T, int DP>
__global__ void __launch_bounds__(stream::kThreads)
    attention_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ g_all,
                            const int* __restrict__ key_lens, const float* __restrict__ stats,
                            T* __restrict__ dqkv, int S, int H, int h0, int dh,
                            long long stride_b, long long stride_s, float scale, int width) {
  using R = stream::Rows<T, DP>;
  constexpr int kRows = stream::kRowsPerWarp;
  constexpr int kS = kSlots<T, DP>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const StreamView<T> v(qkv, g_all, dqkv, const_cast<float*>(stats), key_lens, S, H, h0, dh,
                        stride_b);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = static_cast<int>(blockIdx.x) * stream::kBlockRows;
  const int d0 = R::kPer * lane;
  const bool has_dims = d0 < DP;
  zero_pad<T, DP>(smem_raw, dh);
  unsigned char* q_s = smem_raw;
  unsigned char* g_s = q_s + stream::kBlockRows * R::kStride;
  unsigned char* k_s = g_s + stream::kBlockRows * R::kStride;
  unsigned char* v_s = k_s + kS * R::kTileBytes;
  stream::load_rows<T, DP>(hopper::smem_addr(q_s), v.q, stride_s, q0, stream::kBlockRows, S, dh,
                           width);
  stream::load_rows<T, DP>(hopper::smem_addr(g_s), v.g, v.lanes, q0, stream::kBlockRows, S, dh,
                           width);
  hopper::cp_async_commit();
  const unsigned char* my_q = q_s + warp * kRows * R::kStride;
  const unsigned char* my_g = g_s + warp * kRows * R::kStride;
  float m[kRows], l[kRows], d[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = min(q0 + warp * kRows + r, S - 1);  // rows past S: computed, never stored
    m[r] = v.m[row];
    l[r] = v.m[v.bhs + row];
    d[r] = v.m[2 * v.bhs + row];
  }
  const int n_tiles = (v.kl + stream::kTileRows - 1) / stream::kTileRows;
  auto load = [&](int t, int slot) {
    const int row0 = t * stream::kTileRows;
    stream::load_rows<T, DP>(hopper::smem_addr(k_s) + slot, v.q + v.lanes, stride_s, row0,
                             stream::kTileRows, v.kl, dh, width);
    stream::load_rows<T, DP>(hopper::smem_addr(v_s) + slot, v.q + 2 * v.lanes, stride_s, row0,
                             stream::kTileRows, v.kl, dh, width);
  };

  float dq[kRows][R::kPer];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int u = 0; u < R::kPer; ++u) dq[r][u] = 0.f;
  }
  over_tiles<kS>(n_tiles, R::kTileBytes, load, [&](int t, int slot) {
    const bool valid = t * stream::kTileRows + lane < v.kl;
    const unsigned char* k_row = k_s + slot + lane * R::kStride;
    const unsigned char* v_row = v_s + slot + lane * R::kStride;
    const unsigned char* k_tile = k_s + slot;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float s = stream::dot_rows<T, DP>(my_q + r * R::kStride, k_row) * scale;
      const float p = valid ? stream::round_io<T>(expf(s - m[r]) / l[r]) : 0.f;
      const float dp = stream::dot_rows<T, DP>(my_g + r * R::kStride, v_row);
      const float dsb = stream::round_io<T>(p * (dp - d[r]));
      for (int j = 0; j < stream::kTileRows; ++j) {
        const float dj = __shfl_sync(0xffffffffu, dsb, j);
        if (has_dims) stream::axpy_row<T, DP>(dq[r], dj, k_tile + j * R::kStride, d0);
      }
    }
  });
  if (!has_dims) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + warp * kRows + r;
    if (row >= S) continue;
    T* out = v.dq + row * stride_s + d0;
#pragma unroll
    for (int u = 0; u < R::kPer; ++u)
      if (d0 + u < dh) out[u] = stream::from_f32<T>(dq[r][u] * scale);
  }
}

// ------------------------------------------------------ head-dim sliced ---
//
// Head dims above 256: the three kernels of the streaming design, with every
// row staged one 256-wide head slice at a time (the shared memory of one
// slice is that of the 256 template). A logit s = q.k and dp = g.v are
// accumulated over every slice in ascending order (the same FMA order in
// the three kernels, so p and ds agree bit for bit between them); the dk/dv
// and dq kernels own one output slice each (grid.x carries the slices), so
// their logit work repeats once per output slice.

constexpr int kSlice = stream::kSliceDim;

template <typename T>
__host__ __device__ constexpr int sliced_smem_bytes() {
  // two slices of 64 owned rows and two of a 32-row tile (f32: 199,680 bytes)
  return (2 * stream::kBlockRows + 2 * stream::kTileRows) * stream::Rows<T, kSlice>::kStride;
}

// Stages slice c of rows0 (64 owned rows from a0, rows a_stride apart, rows
// >= a_lim zero) into own0, of rows1 (the same) into own1, and of 32-row
// tile rows t0.. of b0 / b1 into tile0 / tile1; a null source is skipped.
// Every thread of the block takes part; returns once the copies landed.
template <typename T>
__device__ __forceinline__ void stage_slice(int c, int dh, int width, uint32_t own0,
                                            const T* a0, uint32_t own1, const T* a1,
                                            long long a_stride0, long long a_stride1, int row0,
                                            int a_lim, uint32_t tile0, const T* b0,
                                            uint32_t tile1, const T* b1, long long b_stride0,
                                            long long b_stride1, int t0, int b_lim) {
  const int cols = dh - c * kSlice;
  __syncthreads();  // every warp is done with the previous slice
  if (a0)
    stream::load_slice<T, kSlice>(own0, a0 + c * kSlice, a_stride0, row0, stream::kBlockRows,
                                  a_lim, cols, width);
  if (a1)
    stream::load_slice<T, kSlice>(own1, a1 + c * kSlice, a_stride1, row0, stream::kBlockRows,
                                  a_lim, cols, width);
  if (b0)
    stream::load_slice<T, kSlice>(tile0, b0 + c * kSlice, b_stride0, t0, stream::kTileRows, b_lim,
                                  cols, width);
  if (b1)
    stream::load_slice<T, kSlice>(tile1, b1 + c * kSlice, b_stride1, t0, stream::kTileRows, b_lim,
                                  cols, width);
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  __syncthreads();
}

// 1. m, rowsum and D of 64 query rows.
template <typename T>
__global__ void __launch_bounds__(stream::kThreads)
    attention_bwd_sliced_stats_kernel(const T* __restrict__ qkv, const T* __restrict__ g_all,
                                      const int* __restrict__ key_lens, float* __restrict__ stats,
                                      int S, int H, int h0, int dh, long long stride_b,
                                      long long stride_s, float scale, int width) {
  using R = stream::Rows<T, kSlice>;
  constexpr int kRows = stream::kRowsPerWarp;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const StreamView<T> v(qkv, g_all, nullptr, stats, key_lens, S, H, h0, dh, stride_b);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = static_cast<int>(blockIdx.x) * stream::kBlockRows;
  const int n_slices = (dh + kSlice - 1) / kSlice;
  unsigned char* q_s = smem_raw;
  unsigned char* g_s = q_s + stream::kBlockRows * R::kStride;
  unsigned char* k_s = g_s + stream::kBlockRows * R::kStride;
  unsigned char* v_s = k_s + R::kTileBytes;
  const unsigned char* my_q = q_s + warp * kRows * R::kStride;
  const unsigned char* my_g = g_s + warp * kRows * R::kStride;
  const unsigned char* k_row = k_s + lane * R::kStride;
  const unsigned char* v_row = v_s + lane * R::kStride;
  const int n_tiles = (v.kl + stream::kTileRows - 1) / stream::kTileRows;

  // s = q.k (and, with dp, dp = g.v) of this lane's key of tile t, unscaled
  auto products = [&](int t, float (&s)[kRows], float* dp) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      s[r] = 0.f;
      if (dp) dp[r] = 0.f;
    }
    for (int c = 0; c < n_slices; ++c) {
      stage_slice<T>(c, dh, width, hopper::smem_addr(q_s), v.q, hopper::smem_addr(g_s),
                     dp ? v.g : nullptr, stride_s, v.lanes, q0, S, hopper::smem_addr(k_s),
                     v.q + v.lanes, hopper::smem_addr(v_s), dp ? v.q + 2 * v.lanes : nullptr,
                     stride_s, stride_s, t * stream::kTileRows, v.kl);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        s[r] = stream::dot_rows<T, kSlice>(my_q + r * R::kStride, k_row, s[r]);
        if (dp) dp[r] = stream::dot_rows<T, kSlice>(my_g + r * R::kStride, v_row, dp[r]);
      }
    }
  };

  // the row max and rowsum, each lane over its own keys
  float m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = __int_as_float(0xff800000);
    l[r] = 0.f;
  }
  for (int t = 0; t < n_tiles; ++t) {
    float s[kRows];
    products(t, s, nullptr);
    if (t * stream::kTileRows + lane >= v.kl) continue;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float x = s[r] * scale;
      if (x > m[r]) {
        l[r] = l[r] * expf(m[r] - x) + 1.f;
        m[r] = x;
      } else {
        l[r] += expf(x - m[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float mx = stream::warp_max(m[r]);
    l[r] = stream::warp_sum(l[r] * expf(m[r] - mx));  // a lane with no key: 0 * 0
    m[r] = mx;
  }

  // D = sum_j p_ij dp_ij, p = io(e / rowsum)
  float dsum[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) dsum[r] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    float s[kRows], dp[kRows];
    products(t, s, dp);
    if (t * stream::kTileRows + lane >= v.kl) continue;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float p = stream::round_io<T>(expf(s[r] * scale - m[r]) / l[r]);
      dsum[r] = fmaf(dp[r], p, dsum[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float d = stream::warp_sum(dsum[r]);
    const int row = q0 + warp * kRows + r;
    if (lane == 0 && row < S) {
      v.m[row] = m[r];
      v.m[v.bhs + row] = l[r];
      v.m[2 * v.bhs + row] = d;
    }
  }
}

// 2. dk and dv of 64 key rows, one 256-wide output slice.
template <typename T>
__global__ void __launch_bounds__(stream::kThreads)
    attention_bwd_sliced_dkdv_kernel(const T* __restrict__ qkv, const T* __restrict__ g_all,
                                     const int* __restrict__ key_lens,
                                     const float* __restrict__ stats, T* __restrict__ dqkv, int S,
                                     int H, int h0, int dh, long long stride_b,
                                     long long stride_s, float scale, int width) {
  using R = stream::Rows<T, kSlice>;
  constexpr int kRows = stream::kRowsPerWarp;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const StreamView<T> v(qkv, g_all, dqkv, const_cast<float*>(stats), key_lens, S, H, h0, dh,
                        stride_b);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_slices = (dh + kSlice - 1) / kSlice;
  const int j0 = static_cast<int>(blockIdx.x) / n_slices * stream::kBlockRows;
  const int os = static_cast<int>(blockIdx.x) % n_slices;  // this block's output slice
  const int c0 = os * kSlice + R::kPer * lane;  // this lane's first column of the head
  if (j0 >= v.kl) {  // every key row of the tile is masked: dk = dv = 0
    for (int r = warp; r < stream::kBlockRows && j0 + r < S; r += stream::kWarps) {
      T* row = v.dq + (j0 + r) * stride_s + c0;
#pragma unroll
      for (int u = 0; u < R::kPer; ++u)
        if (c0 + u < dh) row[v.lanes + u] = row[2 * v.lanes + u] = stream::from_f32<T>(0.f);
    }
    return;
  }
  unsigned char* k_s = smem_raw;
  unsigned char* vv_s = k_s + stream::kBlockRows * R::kStride;
  unsigned char* q_s = vv_s + stream::kBlockRows * R::kStride;
  unsigned char* g_s = q_s + R::kTileBytes;
  const unsigned char* my_k = k_s + warp * kRows * R::kStride;
  const unsigned char* my_v = vv_s + warp * kRows * R::kStride;
  const unsigned char* q_row = q_s + lane * R::kStride;
  const unsigned char* g_row = g_s + lane * R::kStride;
  const int n_tiles = (S + stream::kTileRows - 1) / stream::kTileRows;

  float dk[kRows][R::kPer], dv[kRows][R::kPer];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int u = 0; u < R::kPer; ++u) dk[r][u] = dv[r][u] = 0.f;
  }
  for (int t = 0; t < n_tiles; ++t) {
    float s[kRows], dp[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.f;
    for (int c = 0; c < n_slices; ++c) {
      stage_slice<T>(c, dh, width, hopper::smem_addr(k_s), v.q + v.lanes, hopper::smem_addr(vv_s),
                     v.q + 2 * v.lanes, stride_s, stride_s, j0, v.kl, hopper::smem_addr(q_s),
                     v.q, hopper::smem_addr(g_s), v.g, stride_s, v.lanes, t * stream::kTileRows,
                     S);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        s[r] = stream::dot_rows<T, kSlice>(q_row, my_k + r * R::kStride, s[r]);
        dp[r] = stream::dot_rows<T, kSlice>(g_row, my_v + r * R::kStride, dp[r]);
      }
    }
    const int i = t * stream::kTileRows + lane;  // this lane's query row
    const bool q_ok = i < S;
    const float mi = q_ok ? v.m[i] : 0.f;
    const float li = q_ok ? v.m[v.bhs + i] : 1.f;
    const float di = q_ok ? v.m[2 * v.bhs + i] : 0.f;
    float p[kRows], dsb[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      p[r] = q_ok ? stream::round_io<T>(expf(s[r] * scale - mi) / li) : 0.f;
      dsb[r] = stream::round_io<T>(p[r] * (dp[r] - di));
    }
    // this block's slice of the tile's q and g rows
    stage_slice<T>(os, dh, width, 0, nullptr, 0, nullptr, 0, 0, 0, 0, hopper::smem_addr(q_s), v.q,
                   hopper::smem_addr(g_s), v.g, stride_s, v.lanes, t * stream::kTileRows, S);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      for (int jq = 0; jq < stream::kTileRows; ++jq) {
        const float pj = __shfl_sync(0xffffffffu, p[r], jq);
        const float dj = __shfl_sync(0xffffffffu, dsb[r], jq);
        stream::axpy_row<T, kSlice>(dv[r], pj, g_s + jq * R::kStride, R::kPer * lane);
        stream::axpy_row<T, kSlice>(dk[r], dj, q_s + jq * R::kStride, R::kPer * lane);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int j = j0 + warp * kRows + r;
    if (j >= S) continue;
    const bool key = j < v.kl;  // a masked key row: exactly 0
    T* row = v.dq + j * stride_s + c0;
#pragma unroll
    for (int u = 0; u < R::kPer; ++u) {
      if (c0 + u >= dh) continue;
      row[v.lanes + u] = stream::from_f32<T>(key ? dk[r][u] * scale : 0.f);
      row[2 * v.lanes + u] = stream::from_f32<T>(key ? dv[r][u] : 0.f);
    }
  }
}

// 3. dq of 64 query rows, one 256-wide output slice.
template <typename T>
__global__ void __launch_bounds__(stream::kThreads)
    attention_bwd_sliced_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ g_all,
                                   const int* __restrict__ key_lens,
                                   const float* __restrict__ stats, T* __restrict__ dqkv, int S,
                                   int H, int h0, int dh, long long stride_b, long long stride_s,
                                   float scale, int width) {
  using R = stream::Rows<T, kSlice>;
  constexpr int kRows = stream::kRowsPerWarp;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const StreamView<T> v(qkv, g_all, dqkv, const_cast<float*>(stats), key_lens, S, H, h0, dh,
                        stride_b);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_slices = (dh + kSlice - 1) / kSlice;
  const int q0 = static_cast<int>(blockIdx.x) / n_slices * stream::kBlockRows;
  const int os = static_cast<int>(blockIdx.x) % n_slices;
  const int c0 = os * kSlice + R::kPer * lane;
  unsigned char* q_s = smem_raw;
  unsigned char* g_s = q_s + stream::kBlockRows * R::kStride;
  unsigned char* k_s = g_s + stream::kBlockRows * R::kStride;
  unsigned char* v_s = k_s + R::kTileBytes;
  const unsigned char* my_q = q_s + warp * kRows * R::kStride;
  const unsigned char* my_g = g_s + warp * kRows * R::kStride;
  const unsigned char* k_row = k_s + lane * R::kStride;
  const unsigned char* v_row = v_s + lane * R::kStride;
  float m[kRows], l[kRows], d[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = min(q0 + warp * kRows + r, S - 1);  // rows past S: computed, never stored
    m[r] = v.m[row];
    l[r] = v.m[v.bhs + row];
    d[r] = v.m[2 * v.bhs + row];
  }
  const int n_tiles = (v.kl + stream::kTileRows - 1) / stream::kTileRows;

  float dq[kRows][R::kPer];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int u = 0; u < R::kPer; ++u) dq[r][u] = 0.f;
  }
  for (int t = 0; t < n_tiles; ++t) {
    float s[kRows], dp[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.f;
    for (int c = 0; c < n_slices; ++c) {
      stage_slice<T>(c, dh, width, hopper::smem_addr(q_s), v.q, hopper::smem_addr(g_s), v.g,
                     stride_s, v.lanes, q0, S, hopper::smem_addr(k_s), v.q + v.lanes,
                     hopper::smem_addr(v_s), v.q + 2 * v.lanes, stride_s, stride_s,
                     t * stream::kTileRows, v.kl);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        s[r] = stream::dot_rows<T, kSlice>(my_q + r * R::kStride, k_row, s[r]);
        dp[r] = stream::dot_rows<T, kSlice>(my_g + r * R::kStride, v_row, dp[r]);
      }
    }
    const bool valid = t * stream::kTileRows + lane < v.kl;
    float dsb[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float p = valid ? stream::round_io<T>(expf(s[r] * scale - m[r]) / l[r]) : 0.f;
      dsb[r] = stream::round_io<T>(p * (dp[r] - d[r]));
    }
    // this block's slice of the tile's k rows
    stage_slice<T>(os, dh, width, 0, nullptr, 0, nullptr, 0, 0, 0, 0, hopper::smem_addr(k_s),
                   v.q + v.lanes, 0, nullptr, stride_s, 0, t * stream::kTileRows, v.kl);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      for (int j = 0; j < stream::kTileRows; ++j) {
        const float dj = __shfl_sync(0xffffffffu, dsb[r], j);
        stream::axpy_row<T, kSlice>(dq[r], dj, k_s + j * R::kStride, R::kPer * lane);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + warp * kRows + r;
    if (row >= S) continue;
    T* out = v.dq + row * stride_s + c0;
#pragma unroll
    for (int u = 0; u < R::kPer; ++u)
      if (c0 + u < dh) out[u] = stream::from_f32<T>(dq[r][u] * scale);
  }
}

// ------------------------------------------------------------- launches ---

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// One launch covers batch rows 0..B-1 of the pointers it is given (the
// wrapper offsets qkv, g, key_lens and dqkv to a slice of at most 65535
// rows) and heads h0..h0+nh-1 of H (at most 65535); the streaming designs'
// stats scratch is (3, B, nh, S), the launch's own.
struct Args {
  const void* qkv;
  const void* g;
  const void* key_lens;
  void* dqkv;
  float* stats;
  int B, S, H, h0, nh, dh;
  long long stride_b, stride_s;
  float scale;
  int width;  // bytes a copy of the streaming design: 16, 8, 4 or 2
  cudaStream_t stream;
};

template <int DH>
cudaError_t launch_bf16(const Args& a) {
  const size_t smem = tc_smem_bytes<DH>(a.S);
  cudaError_t err = set_smem(attention_bwd_tc_kernel<DH>, smem);
  if (err != cudaSuccess) return err;
  attention_bwd_tc_kernel<DH><<<dim3(a.nh, a.B), kTcThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.qkv), static_cast<const __nv_bfloat16*>(a.g),
      static_cast<const int*>(a.key_lens), static_cast<__nv_bfloat16*>(a.dqkv), a.S, a.H, a.h0,
      a.stride_b, a.stride_s, a.scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_f32(const Args& a) {
  const size_t smem = f32_smem_bytes<DH>(a.S);
  cudaError_t err = set_smem(attention_bwd_f32_kernel<DH>, smem);
  if (err != cudaSuccess) return err;
  attention_bwd_f32_kernel<DH><<<dim3(a.nh, a.B), kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.qkv), static_cast<const float*>(a.g),
      static_cast<const int*>(a.key_lens), static_cast<float*>(a.dqkv), a.S, a.H, a.h0,
      a.stride_b, a.stride_s, a.scale);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_stream(const Args& a) {
  constexpr int smem = stream_smem_bytes<T, DP>(kSlots<T, DP>);
  static_assert(smem <= stream::kMaxSmem, "the streaming backward's tiles must fit one block");
  cudaError_t err = set_smem(attention_bwd_stats_kernel<T, DP>, smem);
  if (err == cudaSuccess) err = set_smem(attention_bwd_dkdv_kernel<T, DP>, smem);
  if (err == cudaSuccess) err = set_smem(attention_bwd_dq_kernel<T, DP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + stream::kBlockRows - 1) / stream::kBlockRows, a.nh, a.B);
  const T* qkv = static_cast<const T*>(a.qkv);
  const T* g = static_cast<const T*>(a.g);
  const int* kl = static_cast<const int*>(a.key_lens);
  T* dqkv = static_cast<T*>(a.dqkv);
  attention_bwd_stats_kernel<T, DP><<<grid, stream::kThreads, smem, a.stream>>>(
      qkv, g, kl, a.stats, a.S, a.H, a.h0, a.dh, a.stride_b, a.stride_s, a.scale, a.width);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attention_bwd_dkdv_kernel<T, DP><<<grid, stream::kThreads, smem, a.stream>>>(
      qkv, g, kl, a.stats, dqkv, a.S, a.H, a.h0, a.dh, a.stride_b, a.stride_s, a.scale, a.width);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attention_bwd_dq_kernel<T, DP><<<grid, stream::kThreads, smem, a.stream>>>(
      qkv, g, kl, a.stats, dqkv, a.S, a.H, a.h0, a.dh, a.stride_b, a.stride_s, a.scale, a.width);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_sliced(const Args& a) {
  constexpr int smem = sliced_smem_bytes<T>();
  static_assert(smem <= stream::kMaxSmem, "the sliced backward's tiles must fit one block");
  cudaError_t err = set_smem(attention_bwd_sliced_stats_kernel<T>, smem);
  if (err == cudaSuccess) err = set_smem(attention_bwd_sliced_dkdv_kernel<T>, smem);
  if (err == cudaSuccess) err = set_smem(attention_bwd_sliced_dq_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const long long tiles = (a.S + stream::kBlockRows - 1) / stream::kBlockRows;
  const long long blocks = tiles * ((a.dh + kSlice - 1) / kSlice);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const dim3 stats_grid(static_cast<unsigned>(tiles), a.nh, a.B);
  const dim3 grid(static_cast<unsigned>(blocks), a.nh, a.B);
  const T* qkv = static_cast<const T*>(a.qkv);
  const T* g = static_cast<const T*>(a.g);
  const int* kl = static_cast<const int*>(a.key_lens);
  T* dqkv = static_cast<T*>(a.dqkv);
  attention_bwd_sliced_stats_kernel<T><<<stats_grid, stream::kThreads, smem, a.stream>>>(
      qkv, g, kl, a.stats, a.S, a.H, a.h0, a.dh, a.stride_b, a.stride_s, a.scale, a.width);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attention_bwd_sliced_dkdv_kernel<T><<<grid, stream::kThreads, smem, a.stream>>>(
      qkv, g, kl, a.stats, dqkv, a.S, a.H, a.h0, a.dh, a.stride_b, a.stride_s, a.scale, a.width);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attention_bwd_sliced_dq_kernel<T><<<grid, stream::kThreads, smem, a.stream>>>(
      qkv, g, kl, a.stats, dqkv, a.S, a.H, a.h0, a.dh, a.stride_b, a.stride_s, a.scale, a.width);
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
// heads h0..h0+nh-1 (nh at most 65535) of the H that the rows pack. qkv and
// dqkv share the strides (in elements) stride_b, stride_s with a contiguous
// last axis; g is contiguous (B, S, H*Dh); every row starts on a 16-byte
// boundary. Returns a cudaError_t (0 on success).
extern "C" int attention_qkv_bwd(const void* qkv, const void* g, const void* key_lens, void* dqkv,
                                 int B, int S, int H, int h0, int nh, int head_dim,
                                 long long stride_b, long long stride_s, float scale, int dtype,
                                 void* stream) {
  const Args a{qkv, g, key_lens, dqkv, nullptr, B, S, H, h0, nh, head_dim, stride_b, stride_s,
               scale, 16, static_cast<cudaStream_t>(stream)};
  if (!valid_args(a)) return cudaErrorInvalidValue;
  switch (head_dim) {
    case 16: return launch_resident<16>(a, dtype);
    case 32: return launch_resident<32>(a, dtype);
    case 64: return launch_resident<64>(a, dtype);
    case 128: return launch_resident<128>(a, dtype);
    default: return cudaErrorInvalidValue;
  }
}

// The streaming designs (CUDA cores, both dtypes; three kernels), same
// arguments, `stats`, an f32 (3, B, nh, S) scratch for m, rowsum and D, and
// copy_bytes, the width of its row copies (16, 8, 4, or 2 for bf16; a
// divisor of head_dim * the dtype's size): the wrapper's choice above the
// resident designs' largest S and at every head dim that they do not take;
// up to 256 on the template of the padded head dim (the least of 16, 32,
// 64, 128, 256 not below head_dim), above 256 the sliced design.
extern "C" int attention_qkv_bwd_stream(const void* qkv, const void* g, const void* key_lens,
                                        void* dqkv, void* stats, int B, int S, int H, int h0,
                                        int nh, int head_dim, long long stride_b,
                                        long long stride_s, float scale, int dtype,
                                        int copy_bytes, void* stream) {
  const Args a{qkv, g, key_lens, dqkv, static_cast<float*>(stats), B, S, H, h0, nh, head_dim,
               stride_b, stride_s, scale, copy_bytes, static_cast<cudaStream_t>(stream)};
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

extern "C" const char* attention_qkv_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
