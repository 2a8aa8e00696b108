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
// the limit: an ideal kernel is bound by memory. Two passes at S=448 make it
// 3*S*kl*Dh*2 flops, 336 a byte: there the products come as close as the
// bytes, so both must run at the card's own rates, wgmma and TMA.
//
// The dtype picks the resident design (dispatch by dtype; a failed build or
// launch raises in either); above the largest S a resident design takes (its
// shared memory, 227 KB a block), the wrapper launches the streaming design
// (`attention_qkv_fwd_stream`, below), a shape rule decided before the
// launch. The largest S of the resident designs (`resident_max_s` in
// ops/flash_attention.py computes the same; the bf16 entry returns
// cudaErrorInvalidValue above it):
//   bf16: K of ceil(S/64) tiles of 64 x Dh x 2 bytes, two V tile slots and
//         their 3 slots' mbarriers <= 227 KB:
//         Dh 16: 7104, 32: 3456, 64: 1664, 128: 768
//   f32:  S x ((Dh + 1) x 4 + 64) bytes <= 227 KB:
//         Dh 16: 1760, 32: 1185, 64: 717, 128: 400
// Above them, and at any S (offsets into qkv and out are 64-bit), the
// streaming design runs.
//
// bf16 (the policy's compute dtype: every launch on the main path): a
// persistent, warp-specialised kernel on wgmma, TMA and mbarriers
// (hopper_wgmma.cuh; the plane layout and products of attention_wg.cuh).
//   * A unit is one (group of query tiles, head, batch row). The query
//     tiles (64 rows) of one (b, h) share its K and V, so a unit walks
//     several: its K is loaded once. Items (b, h) run from 32 (the online
//     rollout's fusion, B=4, H=8) to 9,600 (the BC step's ViT, B=1600, H=6)
//     against 132 SMs, so the host cuts each item's rounds of tiles into
//     the groups that minimise (waves of units over the SMs) x (rounds a
//     unit walks + 1 for its K), the most of them on a tie (`tile_groups`):
//     1 group at 9,600, 1,024 and 96 items (the serving ViT), 2 at 32, where
//     one group would leave 100 SMs idle, and at the SigLIP ViT's 192, whose
//     second wave one group would leave 45% full. min(#SMs, units) blocks
//     walk the units in turn.
//   * A block is one producer warpgroup and NCONS consumer warpgroups. The
//     producer's one thread (its registers lowered by setmaxnreg) loads
//     each unit's K (the tiles of the valid keys) by TMA into a ring of K
//     plane slots (two where they fit, so the next unit's K lands under this
//     one's products), then, for each round of query tiles, the V tiles into
//     a ring of up to 8 tile slots; each slot has a full and an empty
//     mbarrier. The tensor map is 4-d over qkv's real strides; rows past S
//     arrive as TMA's zero fill.
//   * Each consumer warpgroup takes one tile of a round (a last round of
//     fewer tiles leaves the others passing the V tiles on). It reads its 64
//     q rows from global memory straight into wgmma's A registers (a unit's
//     first while its K lands, each next one under the tile before's
//     softmax), s = q.k^T by wgmma (A in registers, K from shared memory,
//     K-major), masks the keys past key_lens[b] by column index in the last
//     chunk only (every earlier 64-key chunk is all keys), and p = bf16(exp(s
//     - m)) goes from the accumulators into the A registers of o += p.v (V
//     from its ring slot, MN-major): p never touches shared memory.
//   * Passes. p is rounded against the row's max over all its valid keys
//     (an online softmax, which rounds against a running max, is another
//     function), so the max comes first. At S <= 256 (Dh <= 64; S <= 128 at
//     Dh 128, whose o takes 64 registers) the logits of the whole tile row
//     fit the registers, 4 accumulators of 64 x 64: s is formed once (one
//     pass; the fusion at 208 and 240, the SigLIP ViT at 256), with 2
//     consumer warpgroups of 232 registers. Above, a tile takes two passes
//     over its key chunks: the max, then s again (the same products, so the
//     same bits) for e and o; a tile then needs ~120 registers, so 3 consumer
//     warpgroups of 152 run (Dh <= 64: the DINOv2 ViT at 448), a third more
//     tiles in flight to hide each one's waits. Keeping s of 448 keys in
//     shared memory instead (112 KB a warpgroup in f32) would leave no room
//     for K.
//   * The softmax is the kernel's CUDA-core work, one exp an element: it
//     runs in log2 units, e = exp2(s * scale * log2(e) - m) as one FFMA and
//     one `ex2.approx.ftz` (the f32 values agree with exp to a few ulp); the
//     max is taken on the raw logits and scaled once (scale > 0 keeps the
//     max element the max). The code is straight-line: a branch per
//     8-column group of masked keys measured slower than the exps it
//     skipped. The denominator sums the unrounded e in f32; out = bf16(o /
//     denom).
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_stream.cuh"
#include "attention_wg.cuh"
#include "hopper_wgmma.cuh"

namespace {

// ---------------------------------------------------------------- bf16 ---

using wg::kTile;
using wg::round64;
using wg::Wg;

// 64-key chunks of a query tile's logits held in registers at once: S up
// to 256 in one pass at head dims up to 64, 128 at 128 (whose o takes 64
// registers a thread)
template <int DH>
constexpr int kHeld = DH <= 64 ? 4 : 2;
// Consumer warpgroups a block: 2 where a tile may take one pass (232
// registers each), 3 where every tile takes two (152 each; Dh <= 64 above
// 64 kHeld keys): 2 x 128 x 232 + 128 x 40 and 3 x 128 x 152 + 128 x 40 are
// <= 65,536, with one producer warpgroup at 40.
template <int DH>
int consumers_at(int S) {
  return DH <= 64 && S > kTile * kHeld<DH> ? 3 : 2;
}
template <int NCONS>
constexpr int kConsumerRegs = NCONS == 2 ? 232 : 152;
constexpr int kProducerRegs = 40;
constexpr int kMaxKSlots = 2;  // K plane slots of the ring
constexpr int kMaxVSlots = 8;  // V tile slots of the ring

// Shared memory of a block at S: K plane slots (round64(S) rows each), V
// tile slots (64 rows), then each slot's full and empty mbarriers.
template <int DH>
size_t fwd_smem_bytes(int S, int kslots, int vslots) {
  const size_t tile = static_cast<size_t>(kTile) * 2 * DH;
  return kslots * (round64(S) / kTile * tile + wg::kBarrierBytes) + vslots * (tile + wg::kBarrierBytes);
}

// The ring at S: two K slots where they fit beside four V slots (the next
// unit's K lands while this one's is used), else one; as many V slots as
// then fit, up to 8. False where one K slot and two V slots do not fit:
// above the design's largest S (`resident_max_s` in ops/flash_attention.py
// computes the same).
template <int DH>
bool fwd_ring(int S, int& kslots, int& vslots) {
  if (fwd_smem_bytes<DH>(S, 1, 2) > wg::kMaxSmem) return false;
  kslots = fwd_smem_bytes<DH>(S, kMaxKSlots, 4) <= wg::kMaxSmem ? kMaxKSlots : 1;
  vslots = 2;
  while (vslots < kMaxVSlots && fwd_smem_bytes<DH>(S, kslots, vslots + 1) <= wg::kMaxSmem) ++vslots;
  return true;
}

// A consumer warpgroup's state for its query tiles.
template <int DH>
struct FwdTile {
  using W = Wg<DH>;
  uint32_t qa[W::kK][4];  // the tile's q rows: the A registers of q.k^T
  float o[W::kAcc];       // sum_j p_ij v_j (f32)
  float m[2], l[2];       // row max (log2 units) and denominator of rows g, g + 8
  uint32_t k_s, k_block;  // the K plane (row 0) and its column blocks apart
  uint32_t v_base, v_full, v_empty, v_tile, v_block;
  uint32_t nv;                   // V tiles consumed so far (the ring's position)
  const __nv_bfloat16* next_q;  // the q rows of this warpgroup's next tile of the unit, or null
  long long stride_s;
  int vslots, kl, col0, tid, S;
  float scale2;

  // qa = q rows `row` and `row` + 8 (head dims 16 kk + col0, + 8), zeros past
  // S, from global memory straight into wgmma's A registers.
  __device__ __forceinline__ void load_q(const __nv_bfloat16* q, int row) {
#pragma unroll
    for (int kk = 0; kk < W::kK; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = row + 8 * (i & 1);
        qa[kk][i] = r < S ? __ldg(reinterpret_cast<const unsigned int*>(q + r * stride_s + 16 * kk + 8 * (i >> 1)))
                          : 0u;
      }
    }
  }

  // s (64 x 64) = q . k^T over the keys [64 c, 64 c + 64) (A in registers,
  // B = K rows K-major); the first step overwrites s.
  __device__ __forceinline__ void logits(float (&s)[32], int c) const {
#pragma unroll
    for (int ks = 0; ks < W::kK; ++ks) {
      const uint32_t at = (ks / W::kStepsPerRow) * k_block + 32 * (ks % W::kStepsPerRow);
      hopper::Wgmma<64>::template rs<0>(
          s, qa[ks], hopper::desc(k_s + c * kTile * W::kRowBytes + at, 16, W::kAtom, W::kRowBytes), ks);
    }
  }

  // Whether element i of chunk c is a valid key; a chunk before the last
  // holds valid keys only (kMask false).
  template <bool kMask>
  __device__ __forceinline__ bool valid(int c, int i) const {
    return !kMask || kTile * c + 8 * (i >> 2) + col0 + (i & 1) < kl;
  }

  // The row max of the raw logits over the valid keys of chunk c (scaled to
  // log2 units once the rows' maxima are merged: scaling by scale2 > 0 keeps
  // the max element the max).
  template <bool kMask>
  __device__ __forceinline__ void max_of(const float (&s)[32], int c) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (valid<kMask>(c, i)) m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], s[i]);
    }
  }

  __device__ __forceinline__ void merge_max() {
#pragma unroll
    for (int h = 0; h < 2; ++h) m[h] = hopper::quad_max(m[h]) * scale2;
  }

  // e = exp(s - m) over the valid keys (0 past them), summed into l, then
  // o += bf16(e) . v over V tile c of the ring (waited for, then released).
  template <bool kMask>
  __device__ __forceinline__ void accumulate(float (&s)[32], int c) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const float x = valid<kMask>(c, i) ? hopper::exp2_ftz(fmaf(s[i], scale2, -m[h])) : 0.f;
      l[h] += x;
      s[i] = x;
    }
    uint32_t pa[4][4];
    wg::pack_a<64>(pa, s, [](float x, int) { return x; });
    const uint32_t slot = nv % vslots, v_s = v_base + slot * v_tile;
    hopper::mbar_wait(v_full + 8 * slot, (nv / vslots) & 1);
    hopper::fence_operands(o);
    hopper::wgmma_fence();
    wg::second_product<DH, 64>(o, pa, v_s, v_block);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(o);
    wg::release(v_empty + 8 * slot, tid);
    ++nv;
  }

  // The next tile's q rows, once this tile's last q.k^T has completed: in
  // flight under its softmax and p.v.
  __device__ __forceinline__ void prefetch_q(int next_row) {
    if (next_q != nullptr) load_q(next_q, next_row);
  }

  // One pass: the logits of all NC chunks held at once.
  template <int NC>
  __device__ __forceinline__ void one_pass(int next_row) {
    float s[NC][32];
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c) logits(s[c], c);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NC; ++c) hopper::fence_operands(s[c]);
    prefetch_q(next_row);
#pragma unroll
    for (int c = 0; c < NC - 1; ++c) max_of<false>(s[c], c);
    max_of<true>(s[NC - 1], NC - 1);
    merge_max();
#pragma unroll
    for (int c = 0; c < NC - 1; ++c) accumulate<false>(s[c], c);
    accumulate<true>(s[NC - 1], NC - 1);
  }

  // one_pass<nc> for nc <= NC
  template <int NC>
  __device__ __forceinline__ void held(int nc, int next_row) {
    if (nc == NC) {
      one_pass<NC>(next_row);
    } else if constexpr (NC > 1) {
      held<NC - 1>(nc, next_row);
    }
  }

  // Two passes: the max over every chunk's logits, then each chunk's
  // logits again (the same products, so the same bits) for e and o.
  __device__ __forceinline__ void two_pass(int nc, int next_row) {
    for (int c = 0; c < nc; ++c) {
      float s[32];
      hopper::wgmma_fence();
      logits(s, c);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(s);
      if (c + 1 < nc) {
        max_of<false>(s, c);
      } else {
        max_of<true>(s, c);
      }
    }
    merge_max();
    for (int c = 0; c < nc; ++c) {
      float s[32];
      hopper::wgmma_fence();
      logits(s, c);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(s);
      if (c + 1 < nc) {
        accumulate<false>(s, c);
      } else {
        prefetch_q(next_row);
        accumulate<true>(s, c);
      }
    }
  }
};

// A unit is one (tile group, head, batch row): the block loads the item's
// K once and its NCONS consumer warpgroups walk the group's query tiles in
// rounds, warpgroup w taking tile NCONS r + w of round r.
template <int DH, int NCONS>
__global__ void __launch_bounds__(128 * (NCONS + 1), 1)
    attention_fwd_wg_kernel(const __grid_constant__ CUtensorMap qkv_map, const __nv_bfloat16* __restrict__ qkv,
                            const int* __restrict__ key_lens, __nv_bfloat16* __restrict__ out, int S, int H,
                            int h0, int nh, long long units, int groups, long long stride_b,
                            long long stride_s, float scale, int kslots, int vslots) {
  using W = Wg<DH>;
  extern __shared__ __align__(1024) unsigned char ring_smem[];
  const int pk = round64(S), T = pk / kTile, rounds = (T + NCONS - 1) / NCONS;
  const uint32_t k_block = static_cast<uint32_t>(pk) * W::kRowBytes;
  const uint32_t k_plane = W::kBlocks * k_block;
  const uint32_t v_block = kTile * W::kRowBytes;
  const uint32_t v_tile = W::kBlocks * v_block;
  const uint32_t base = hopper::smem_addr(ring_smem);
  const uint32_t v_base = base + kslots * k_plane;
  const uint32_t k_full = v_base + vslots * v_tile;  // slot i's barriers 8 i further
  const uint32_t k_empty = k_full + 8 * kslots;
  const uint32_t v_full = k_empty + 8 * kslots;
  const uint32_t v_empty = v_full + 8 * vslots;
  if (threadIdx.x == 0) {
    if (base & 1023) __trap();  // the swizzle atoms need 1024-byte aligned slots
    for (int i = 0; i < kslots; ++i) {
      hopper::mbar_init(k_full + 8 * i, 1);
      hopper::mbar_init(k_empty + 8 * i, 4 * NCONS);  // one arrival a consumer warp
    }
    for (int i = 0; i < vslots; ++i) {
      hopper::mbar_init(v_full + 8 * i, 1);
      hopper::mbar_init(v_empty + 8 * i, 4 * NCONS);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
  const int lanes = H * DH;

  if (threadIdx.x / 128 == NCONS) {
    // producer: one thread loads each unit's K (the valid keys' tiles) and,
    // for each round of query tiles, its V tiles
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 128 * NCONS) {
      uint32_t nk = 0, nv = 0;
      for (long long u = blockIdx.x; u < units; u += gridDim.x, ++nk) {
        const long long item = u / groups;
        const int grp = static_cast<int>(u % groups);
        const int b = static_cast<int>(item / nh), h = h0 + static_cast<int>(item % nh);
        const int kl = key_lens ? min(max(key_lens[b], 1), S) : S;  // the consumers trap on a bad one
        const int nc = (kl + kTile - 1) / kTile;
        const uint32_t ks = nk % kslots, k_at = base + ks * k_plane;
        hopper::mbar_wait(k_empty + 8 * ks, ((nk / kslots) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(k_full + 8 * ks, nc * v_tile);
        for (int c = 0; c < nc; ++c) {
          wg::load_box<DH>(k_at + c * v_block, k_block, &qkv_map, H + h, kTile * c, b, k_full + 8 * ks);
        }
        const int r1 = rounds * (grp + 1) / groups;
        for (int r = rounds * grp / groups; r < r1; ++r) {
          for (int c = 0; c < nc; ++c, ++nv) {
            const uint32_t vs = nv % vslots;
            hopper::mbar_wait(v_empty + 8 * vs, ((nv / vslots) & 1) ^ 1);
            hopper::mbar_arrive_expect_tx(v_full + 8 * vs, v_tile);
            wg::load_box<DH>(v_base + vs * v_tile, v_block, &qkv_map, 2 * H + h, kTile * c, b, v_full + 8 * vs);
          }
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<kConsumerRegs<NCONS>>();
    const int w = threadIdx.x / 128, tid = threadIdx.x % 128, lane = tid & 31;
    const int row_in = 16 * (tid >> 5) + (lane >> 2);  // this thread's first row of a tile
    uint32_t nk = 0;
    FwdTile<DH> f;
    f.k_block = k_block;
    f.v_base = v_base;
    f.v_full = v_full;
    f.v_empty = v_empty;
    f.v_tile = v_tile;
    f.v_block = v_block;
    f.nv = 0;
    f.stride_s = stride_s;
    f.vslots = vslots;
    f.col0 = 2 * (lane & 3);
    f.tid = tid;
    f.S = S;
    f.scale2 = scale * 1.4426950408889634f;  // logits in log2 units: e = exp2(s scale2 - m)
    for (long long u = blockIdx.x; u < units; u += gridDim.x, ++nk) {
      const long long item = u / groups;
      const int grp = static_cast<int>(u % groups);
      const int b = static_cast<int>(item / nh), h = h0 + static_cast<int>(item % nh);
      f.kl = key_lens ? key_lens[b] : S;
      if (f.kl < 1 || f.kl > S) __trap();
      const int nc = (f.kl + kTile - 1) / kTile;
      const __nv_bfloat16* q = qkv + b * stride_b + h * DH + f.col0;
      const int r0 = rounds * grp / groups, r1 = rounds * (grp + 1) / groups;
      // the unit's first q rows are in flight while its K lands
      if (NCONS * r0 + w < T) f.load_q(q, kTile * (NCONS * r0 + w) + row_in);
      const uint32_t ks = nk % kslots;
      f.k_s = base + ks * k_plane;
      hopper::mbar_wait(k_full + 8 * ks, (nk / kslots) & 1);
      for (int r = r0; r < r1; ++r) {
        const int t = NCONS * r + w;
        if (t >= T) {  // a last round of fewer tiles: pass its V tiles on
          for (int c = 0; c < nc; ++c, ++f.nv) {
            const uint32_t vs = f.nv % vslots;
            hopper::mbar_wait(v_full + 8 * vs, (f.nv / vslots) & 1);
            wg::release(v_empty + 8 * vs, tid);
          }
          continue;
        }
        const int next_t = t + NCONS;
        f.next_q = r + 1 < r1 && next_t < T ? q : nullptr;
#pragma unroll
        for (int i = 0; i < W::kAcc; ++i) f.o[i] = 0.f;
        const float neg_inf = __int_as_float(0xff800000);
        f.m[0] = f.m[1] = neg_inf;
        f.l[0] = f.l[1] = 0.f;
        if constexpr (NCONS == 2) {
          if (nc <= kHeld<DH>) {
            f.template held<kHeld<DH>>(nc, kTile * next_t + row_in);
          } else {
            f.two_pass(nc, kTile * next_t + row_in);
          }
        } else {
          f.two_pass(nc, kTile * next_t + row_in);
        }
        const float den[2] = {hopper::quad_sum(f.l[0]), hopper::quad_sum(f.l[1])};
        const int row = kTile * t + row_in;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int rr = row + 8 * half;
          if (rr >= S) continue;
          __nv_bfloat16* o_row = out + (static_cast<size_t>(b) * S + rr) * lanes + h * DH + f.col0;
#pragma unroll
          for (int j = 0; j < DH / 8; ++j) {
            *reinterpret_cast<uint32_t*>(o_row + 8 * j) =
                hopper::pack_bf16(f.o[4 * j + 2 * half] / den[half], f.o[4 * j + 2 * half + 1] / den[half]);
          }
        }
      }
      wg::release(k_empty + 8 * ks, tid);
    }
  }
}

// Tile groups an item is cut into: those that minimise (waves of units over
// the SMs) x (rounds of query tiles a unit walks + 1, its K's load), the
// most of them on a tie (a fuller last wave), so the small calls still
// spread over the card and the large ones load each K once.
inline int tile_groups(long long items, int rounds, int sms) {
  int best = 1;
  long long best_cost = -1;
  for (int g = 1; g <= rounds; ++g) {
    const long long cost = (items * g + sms - 1) / sms * ((rounds + g - 1) / g + 1);
    if (best_cost < 0 || cost <= best_cost) {
      best = g;
      best_cost = cost;
    }
  }
  return best;
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

template <int DH, int NCONS>
cudaError_t launch_wg(const Args& a, const CUtensorMap& map, int kslots, int vslots, int sms) {
  const size_t smem = fwd_smem_bytes<DH>(a.S, kslots, vslots);
  const cudaError_t err = set_smem(attention_fwd_wg_kernel<DH, NCONS>, smem);
  if (err != cudaSuccess) return err;
  const long long items = static_cast<long long>(a.B) * a.nh;
  const int groups = tile_groups(items, (round64(a.S) / kTile + NCONS - 1) / NCONS, sms);
  const long long units = items * groups;
  const int grid = static_cast<int>(units < sms ? units : sms);
  attention_fwd_wg_kernel<DH, NCONS><<<grid, 128 * (NCONS + 1), smem, a.stream>>>(
      map, static_cast<const __nv_bfloat16*>(a.qkv), static_cast<const int*>(a.key_lens),
      static_cast<__nv_bfloat16*>(a.out), a.S, a.H, a.h0, a.nh, units, groups, a.stride_b, a.stride_s, a.scale,
      kslots, vslots);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_bf16(const Args& a) {
  int kslots = 0, vslots = 0;
  if (!fwd_ring<DH>(a.S, kslots, vslots)) return cudaErrorInvalidValue;  // above the resident limit
  CUtensorMap map;
  if (!wg::encode_map<DH>(&map, a.qkv, 3 * a.H, a.S, a.B, a.stride_s, a.stride_b)) return cudaErrorInvalidValue;
  const int sms = wg::sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  if constexpr (DH <= 64) {
    if (consumers_at<DH>(a.S) == 3) return launch_wg<DH, 3>(a, map, kslots, vslots, sms);
  }
  return launch_wg<DH, 2>(a, map, kslots, vslots, sms);
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
