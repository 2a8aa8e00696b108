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
// Bound: at the tool's shape (B=384, S=201, H=8, Dh=64) the call moves 553 MB
// (0.165 ms at 3.35 TB/s) for 79.4 GFLOP (0.080 ms at the bf16 peak): bytes,
// with the flops close behind. So the loads stay in flight under the
// products, and the products run on wgmma, the tensor cores' full-rate path.
//
// Design: warp-specialised and persistent, on wgmma, TMA and mbarriers
// (hopper_wgmma.cuh; the plane layout and products of attention_wg.cuh,
// shared with the attention forward and backward).
//   * An item is one (batch row, head). min(#SMs, B*H) blocks each walk the
//     items blockIdx.x, + gridDim.x, ... (heads of a batch row side by side).
//   * A block is 4 warpgroups. One thread of the producer warpgroup (its
//     registers lowered by setmaxnreg) loads each item's planes G, V, K, Q
//     in that order by TMA into a ring of plane slots in shared memory, each
//     slot with a full and an empty mbarrier. The tensor maps are 4-d over
//     qkv's and g's real strides (head dims, head slot, row, batch row); a
//     box is 64 rows of one column block (Dh 16, 32, 64: all head dims, 32,
//     64 or 128 bytes a row; Dh 128: two blocks of 64), swizzled at its row's
//     width; rows past S arrive as TMA's zero fill. A plane is P = max(64,
//     round16(S)) rows; its last box starts at row P - 64, overlapping the
//     one before, so no box writes past its plane. The ring holds as many
//     planes as fit, up to 8 (two items at S <= 224 and Dh 64; 7 planes at
//     S=240; 4 at the largest S), so the next item's planes land while this
//     one's are multiplied.
//   * Three consumer warpgroups share an item's 3T units (T = P / 64 tiles,
//     the boxes' row starts; a row is stored by the first tile that holds
//     it), dealt in turn, so each takes T. A unit walks one 64-row tile over
//     the item's columns (R = round16(S)) in chunks of 128 (64 at Dh 128),
//     then 64, then the 16, 32 or 48 left:
//       first:  c = tile . b1[chunk]^T (wgmma, A and B from shared memory by
//               descriptor, both K-major);
//       second: acc += bf16(0.001 c) . b2[chunk] (wgmma, A in registers,
//               packed from c's accumulators; B MN-major).
//     dq: the tile's G rows (a query tile), b1 = V, b2 = K (dp, dsb);
//     dv: the tile's K rows (a key tile),   b1 = Q, b2 = G (s^T, pb^T);
//     dk: the tile's V rows (a key tile),   b1 = G, b2 = Q (dp^T, dsb^T).
//     The three share no operand but the planes, so phase B's two halves run
//     as separate units, each with one accumulator; dp is formed twice (once
//     a side), as in the walk this replaces.
//   * A warpgroup waits on the full barriers of G, V and K before its first
//     unit and on Q's before its first dv or dk unit (or the item's end),
//     then arrives on all four empty barriers (one arrival a warp). Within a
//     chunk it waits for its first products before packing them and for its
//     second products before the next chunk; the other two warpgroups'
//     products cover those waits.
//   * No atomics: each gradient row is summed by one warpgroup in a fixed
//     order (chunk by chunk, k step by k step), so two runs give the same
//     bits. Gradient rows go from the accumulators to global memory as bf16
//     pairs.
//
// Domain: bf16, head dims 16, 32, 64 and 128, S up to the shared memory of
// a block (4 plane slots: S <= 448 at head dim 64), B and H up to 65535. The
// wrapper (tools/torch_exp_attn_bwd.py::mmonly) raises on any other call;
// there is no fallback.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_wg.cuh"
#include "hopper_wgmma.cuh"

namespace {

using wg::first_product;
using wg::kTile;
using wg::plane_rows;
using wg::round16;
using wg::second_product;
using wg::tile_row;
using wg::Wg;

constexpr float kMmScale = 0.001f;  // the TPU tool's stand-in for the softmax
constexpr int kMaxSmem = wg::kMaxSmem;

constexpr int kConsumers = 3;                     // consumer warpgroups a block
constexpr int kThreads = 128 * (kConsumers + 1);  // and one producer warpgroup
constexpr int kPlanes = 4;                        // G, V, K, Q: an item's planes, in load order
constexpr int kMaxSlots = 2 * kPlanes;            // plane slots of the ring: two items
constexpr int kBarrierBytes = wg::kBarrierBytes;  // a slot's full and empty mbarriers
constexpr int kConsumerRegs = 152;                // 3 x 128 x 152 + 128 x 40 <= 65,536
constexpr int kProducerRegs = 40;

// The widest column chunk a unit's registers hold at head dim DH.
template <int DH>
constexpr int kChunk = DH <= 64 ? 128 : 64;

// One unit: the 64 rows of `tile` walked over the columns, chunk by chunk,
// c = tile . b1[chunk]^T, then acc += bf16(0.001 c) . b2[chunk].
template <int DH>
struct Unit {
  float acc[DH / 2];
  uint32_t tile, b1, b2;  // the tile's first row; b1 and b2 at row 0
  uint32_t block_bytes;   // a plane's column blocks apart

  // One chunk of N columns from c0: its first products, their bf16 operands
  // packed, its second products, each group waited for before the next.
  template <int N>
  __device__ __forceinline__ void chunk(int c0) {
    float c[N / 2];
    uint32_t a[N / 16][4];
    const uint32_t at = c0 * Wg<DH>::kRowBytes;
    hopper::wgmma_fence();
    first_product<DH, N>(c, tile, b1 + at, block_bytes);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(c);
    wg::pack_a<N>(a, c, [](float x, int) { return x * kMmScale; });
    hopper::fence_operands(acc);
    hopper::wgmma_fence();
    second_product<DH, N>(acc, a, b2 + at, block_bytes);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(acc);
  }

  // The columns [0, R), R a multiple of 16: chunks of kChunk, then one of
  // 64, then the 16, 32 or 48 left.
  __device__ __forceinline__ void walk(int R) {
    constexpr int kC = kChunk<DH>;
    int c0 = 0;
    for (; c0 + kC <= R; c0 += kC) chunk<kC>(c0);
    if (kC > kTile && c0 + kTile <= R) {
      chunk<kTile>(c0);
      c0 += kTile;
    }
    switch (R - c0) {
      case 16: chunk<16>(c0); break;
      case 32: chunk<32>(c0); break;
      case 48: chunk<48>(c0); break;
      default: break;
    }
  }
};

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    mmonly_kernel(const __grid_constant__ CUtensorMap qkv_map, const __grid_constant__ CUtensorMap g_map,
                  __nv_bfloat16* __restrict__ dqkv, int S, int H, long long items, long long stride_b,
                  long long stride_s, float scale, int slots) {
  using W = Wg<DH>;
  extern __shared__ __align__(1024) unsigned char ring_smem[];
  const int P = plane_rows(S), T = (P + kTile - 1) / kTile, R = round16(S);
  const uint32_t block_bytes = static_cast<uint32_t>(P) * W::kRowBytes;
  const uint32_t plane = W::kBlocks * block_bytes;
  const uint32_t base = hopper::smem_addr(ring_smem);
  const uint32_t full = base + slots * plane;  // slot i's barriers at full + 8 i, empty + 8 i
  const uint32_t empty = full + 8 * slots;
  if (threadIdx.x == 0) {
    if (base & 1023) __trap();  // the swizzle atoms need 1024-byte aligned slots
    for (int i = 0; i < slots; ++i) {
      hopper::mbar_init(full + 8 * i, 1);
      hopper::mbar_init(empty + 8 * i, 4 * kConsumers);  // one arrival a consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int role = threadIdx.x / 128;  // the warpgroup
  if (role == kConsumers) {
    // producer: one thread walks the items' planes through the ring
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 128 * kConsumers) {
      uint32_t n = 0;  // planes issued so far
      for (long long it = blockIdx.x; it < items; it += gridDim.x) {
        const int b = static_cast<int>(it / H), h = static_cast<int>(it % H);
        for (int p = 0; p < kPlanes; ++p, ++n) {
          const uint32_t slot = n % slots, at = base + slot * plane;
          hopper::mbar_wait(empty + 8 * slot, ((n / slots) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(full + 8 * slot, T * kTile * 2 * DH);
          // G (g's head h), then V, K, Q (qkv's head slots 2H + h, H + h, h)
          const CUtensorMap* map = p == 0 ? &g_map : &qkv_map;
          const int col = p == 0 ? h : (3 - p) * H + h;
          for (int t = 0; t < T; ++t) {
            const int r = tile_row(t, P);
            wg::load_box<DH>(at + r * W::kRowBytes, block_bytes, map, col, r, b, full + 8 * slot);
          }
        }
      }
    }
  } else {
    // consumers: a warpgroup takes every kConsumers-th unit of each item
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int tid = threadIdx.x % 128;
    const int lanes = H * DH;
    uint32_t n = 0;  // planes consumed so far
    for (long long it = blockIdx.x; it < items; it += gridDim.x, n += kPlanes) {
      const int b = static_cast<int>(it / H), h = static_cast<int>(it % H);
      uint32_t slot[kPlanes], parity[kPlanes], at[kPlanes];
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) {
        slot[p] = (n + p) % slots;
        parity[p] = ((n + p) / slots) & 1;
        at[p] = base + slot[p] * plane;
      }
      const uint32_t g_s = at[0], v_s = at[1], k_s = at[2], q_s = at[3];
      __nv_bfloat16* d_base = dqkv + b * stride_b + h * DH;
#pragma unroll
      for (int p = 0; p < 3; ++p) hopper::mbar_wait(full + 8 * slot[p], parity[p]);
      bool q_ready = false;
      for (int u = role; u < 3 * T; u += kConsumers) {
        const int kind = u / T, t = u % T, r0 = tile_row(t, P);  // kind 0: dq, 1: dv, 2: dk
        if (kind > 0 && !q_ready) {
          hopper::mbar_wait(full + 8 * slot[3], parity[3]);
          q_ready = true;
        }
        Unit<DH> un;
#pragma unroll
        for (int i = 0; i < W::kAcc; ++i) un.acc[i] = 0.f;
        un.tile = (kind == 0 ? g_s : kind == 1 ? k_s : v_s) + r0 * W::kRowBytes;
        un.b1 = kind == 0 ? v_s : kind == 1 ? q_s : g_s;
        un.b2 = kind == 0 ? k_s : kind == 1 ? g_s : q_s;
        un.block_bytes = block_bytes;
        un.walk(R);
        wg::store_tile<DH>(d_base + (kind == 0 ? 0 : kind == 1 ? 2 * lanes : lanes), stride_s, un.acc,
                       kind == 1 ? 1.f : scale, r0, t * kTile, S, S, tid);
      }
      // every plane's full phase is seen before its empty arrival, so no
      // arrival can count towards a slot's earlier use
      if (!q_ready) hopper::mbar_wait(full + 8 * slot[3], parity[3]);
      __syncwarp();
      if ((tid & 31) == 0) {
#pragma unroll
        for (int p = 0; p < kPlanes; ++p) hopper::mbar_arrive(empty + 8 * slot[p]);
      }
    }
  }
}

template <int DH>
cudaError_t launch(const void* qkv, const void* g, void* dqkv, int B, int S, int H, long long stride_b,
                   long long stride_s, float scale, cudaStream_t stream) {
  const size_t plane = static_cast<size_t>(plane_rows(S)) * 2 * DH;
  const size_t fit = kMaxSmem / (plane + kBarrierBytes);
  const int slots = static_cast<int>(fit < kMaxSlots ? fit : kMaxSlots);
  if (slots < kPlanes) return cudaErrorInvalidValue;
  const size_t smem = slots * (plane + kBarrierBytes);
  CUtensorMap qkv_map, g_map;
  if (!wg::encode_map<DH>(&qkv_map, qkv, 3 * H, S, B, stride_s, stride_b) ||
      !wg::encode_map<DH>(&g_map, g, H, S, B, static_cast<long long>(H) * DH,
                      static_cast<long long>(S) * H * DH)) {
    return cudaErrorInvalidValue;
  }
  const int sms = wg::sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  const cudaError_t err = cudaFuncSetAttribute(mmonly_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long items = static_cast<long long>(B) * H;
  const int grid = static_cast<int>(items < sms ? items : sms);
  mmonly_kernel<DH><<<grid, kThreads, smem, stream>>>(qkv_map, g_map, static_cast<__nv_bfloat16*>(dqkv),
                                                      S, H, items, stride_b, stride_s, scale, slots);
  return cudaGetLastError();
}

}  // namespace

// bf16 only; head_dim 16, 32, 64 or 128; 1 <= B, H <= 65535; S at most the
// shared memory of a block allows (4 plane slots). qkv and dqkv share the
// strides (in elements) stride_b, stride_s with a contiguous last axis; g is
// contiguous (B, S, H*Dh); every row starts on a 16-byte boundary. Returns a
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
