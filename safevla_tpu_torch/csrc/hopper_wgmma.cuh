// Hopper (sm_90a) building blocks of a warp-specialised kernel: wgmma
// (warpgroup matrix multiply), its shared-memory matrix descriptors, the
// mbarrier operations, the TMA tile load and setmaxnreg. Every helper is one
// PTX instruction (or a short fixed sequence), named in its comment; none
// allocates shared memory or knows a kernel's shapes. Shared addresses are
// 32-bit (`hopper::smem_addr`, hopper_mma.cuh). exp_attn_bwd.cu's
// matmul-only backward is its first user.
//
// Shared-memory tiles. A tile is a stack of rows of W bytes, W = 32, 64 or
// 128 (16, 32 or 64 bf16), written by TMA with the swizzle of the same width
// (CU_TENSOR_MAP_SWIZZLE_32B / 64B / 128B): inside each group of 8 rows
// (8 W bytes, the swizzle atom), 16-byte chunk c of row r sits at chunk
// c ^ ((r * W / 128) & (W / 16 - 1)), i.e. the shared address bits [4, 4 +
// log2(W/16)) are XORed with bits [7, ...). The hardware applies the same
// rule to the address wgmma reads, so a tile's base must be aligned to its
// atom (8 W bytes; 1024 covers every width) and a descriptor may start at
// any 16-row boundary of it, or 32 bytes into a row (the next 16 K values).
//
// wgmma.mma_async.sync.aligned.m64nNk16.f32.bf16.bf16: a warpgroup (4 warps,
// 128 threads, warp w owning rows 16w..16w+15) computes D (64 x N, f32) =
// A (64 x 16) . B (16 x N) + D. g = lane / 4, t = lane % 4:
//   D registers (N / 2 floats a thread): d[4j + 0, 1] = (row 16w + g, cols
//     8j + 2t, 8j + 2t + 1), d[4j + 2, 3] = (row 16w + g + 8, the same cols),
//     j = 0 .. N/8 - 1: the mma.sync m16n8 C layout, N/8 tiles side by side.
//   A in registers (4 x 32 bits, bf16 pairs, lo = the lower k): a0 = (row
//     16w + g, k 2t..2t+1), a1 = (row + 8, k 2t..), a2 = (row, k 2t+8..),
//     a3 = (row + 8, k 2t+8..): the mma.sync m16n8k16 A layout, so the D
//     registers of 16 columns (d[8s .. 8s+7]), rounded to bf16 pairs, are the
//     A registers of the 16-deep step s of a next product (`acc_to_a`).
//   A or B in shared memory: a 64-bit descriptor (`desc`). A matrix wider
//   than 128 bytes a row is kept as column blocks of 128-byte rows.
//     K-major (transpose flag 0): rows are M (or N), K contiguous in a row;
//       a K step of 16 adds 32 bytes to the start (past a block's row: the
//       next block's first row); SBO = 8 rows (8 W bytes).
//     MN-major (transpose flag 1, B only here): rows are K, N contiguous in
//       a row; a K step of 16 adds 16 rows; SBO = 8 rows (8 W bytes), LBO =
//       the stride between column blocks along N (unused at N = W / 2).
// A wgmma runs asynchronously: `wgmma_fence` before the first one whose
// registers were written by ordinary instructions, `wgmma_commit` to close a
// group, `wgmma_wait<n>` before reading D (or reusing the A registers) of
// any but the n newest groups; `fence_operands` keeps the compiler from
// moving a register's ordinary use across these.

#pragma once

#include <cuda.h>
#include <stdint.h>

namespace hopper {

// A shared-memory matrix descriptor: start address >> 4 in bits [0, 14),
// leading byte offset >> 4 in [16, 30), stride byte offset >> 4 in [32, 46),
// base offset 0 (bits [49, 52): every start lies on an atom's row 0 phase),
// layout in [62, 64): 1 = 128-byte swizzle, 2 = 64-byte, 3 = 32-byte.
__device__ __forceinline__ uint64_t desc(uint32_t smem_addr, uint32_t lbo_bytes, uint32_t sbo_bytes,
                                         int swizzle_bytes) {
  const uint64_t layout = swizzle_bytes == 128 ? 1 : swizzle_bytes == 64 ? 2 : 3;
  return static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo_bytes & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo_bytes & 0x3FFFF) >> 4) << 32) | (layout << 62);
}

// wgmma.fence.sync.aligned: orders this warpgroup's earlier register and
// shared-memory writes before the wgmmas that follow.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// wgmma.commit_group.sync.aligned: the wgmmas issued since the last commit
// form one group.
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wgmma.wait_group.sync.aligned N: waits until at most N groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// An empty asm that reads and writes each x[i]: the compiler keeps their
// ordinary uses on their side of the wgmma fence / wait asm around it.
template <int N>
__device__ __forceinline__ void fence_operands(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

// Wgmma<N>::ss<kTransA, kTransB>(d, a_desc, b_desc, scale_d): d = A . B
// (+ d if scale_d), A and B in shared memory;
// Wgmma<N>::rs<kTransB>(d, a, b_desc, scale_d): A in registers.
// N = 16, 32, 48, 64 and 128 (every width exp_attn_bwd.cu issues).
//   wgmma.mma_async.sync.aligned.m64nNk16.f32.bf16.bf16 {d..}, a-desc | {a0..a3},
//       b-desc, p (scale-d), 1, 1 (scale-a, scale-b), [trans-a,] trans-b;
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  template <int kTransA, int kTransB>
  __device__ __forceinline__ static void ss(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, %11, %12;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
  }
  template <int kTransB>
  __device__ __forceinline__ static void rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(kTransB));
  }
};

template <>
struct Wgmma<32> {
  template <int kTransA, int kTransB>
  __device__ __forceinline__ static void ss(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
  }
  template <int kTransB>
  __device__ __forceinline__ static void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(kTransB));
  }
};

template <>
struct Wgmma<48> {
  template <int kTransA, int kTransB>
  __device__ __forceinline__ static void ss(float (&d)[24], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
        "%24, %25, p, 1, 1, %27, %28;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(a), "l"(b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
  }
  template <int kTransB>
  __device__ __forceinline__ static void rs(float (&d)[24], const uint32_t (&a)[4], uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p, 1, 1, %30;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(kTransB));
  }
};

template <>
struct Wgmma<64> {
  template <int kTransA, int kTransB>
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
  }
  template <int kTransB>
  __device__ __forceinline__ static void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(kTransB));
  }
};


template <>
struct Wgmma<128> {
  template <int kTransA, int kTransB>
  __device__ __forceinline__ static void ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
  }
  template <int kTransB>
  __device__ __forceinline__ static void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(kTransB));
  }
};

// mbarrier.init.shared::cta.b64 [bar], count (one thread; then
// `mbar_init_fence` and a block barrier before any other use).
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// fence.mbarrier_init.release.cluster: makes the inits visible to the
// async proxy (TMA's completions).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// mbarrier.arrive.shared::cta.b64 _, [bar]: one arrival.
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// mbarrier.arrive.expect_tx.shared::cta.b64 _, [bar], bytes: one arrival,
// and the phase also waits for `bytes` of asynchronous copies to land.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// mbarrier.try_wait.parity.shared::cta.b64: whether the phase of parity
// `parity` has completed. A fresh barrier is in phase 0, and the phase
// before it (parity 1) counts as completed: a producer's first wait on an
// empty slot (parity 1) passes at once.
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Spins on `mbar_try_wait`; traps (a launch error, not a hung card) when
// the phase has not completed within kWaitLimitNs of %globaltimer: no wait
// of a working pipeline comes near it.
constexpr unsigned long long kWaitLimitNs = 10000000000ull;  // 10 s

__device__ __forceinline__ unsigned long long global_timer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = global_timer_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_timer_ns() - t0 > kWaitLimitNs) __trap();
  }
}

// cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes
// [dst], [map, {c0, c1, c2, c3}], [bar]: one thread asks TMA for the box of
// `map` at element coordinates (c0 innermost); out-of-bounds elements land
// as zeros; the box's bytes count against bar's expected transactions.
// `map` is the address of a __grid_constant__ CUtensorMap parameter.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// setmaxnreg.{inc,dec}.sync.aligned.u32 N: every warp of a warpgroup moves
// its register budget to N (24..256, a multiple of 8), so a producer
// warpgroup hands its registers to the consumers. Each role's code must not
// rejoin the other's after it.
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

}  // namespace hopper
