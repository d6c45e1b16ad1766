// Hopper (sm_90a) building blocks of the warp-specialised bf16 flash forward
// (csrc/flash_fwd.cu, K1): TMA tile loads, mbarriers, wgmma and its shared
// memory descriptors, register reallocation.  Everything here exists only on
// sm_90a; nvcc must be given -gencode arch=compute_90a,code=sm_90a.
//
// * Tiles: a (rows, 64) bf16 box, 128 bytes a row, written by TMA with
//   CU_TENSOR_MAP_SWIZZLE_128B into a 1024-byte-aligned region: the 16-byte
//   chunk c of row r lands at chunk position c ^ (r & 7).  A D = 128 tile is
//   two such regions, columns 0..63 then 64..127 (`sw128_off`).
// * Descriptors (`sw128_desc`): start address >> 4 in bits 0..13, the
//   leading byte offset >> 4 in 16..29, the stride byte offset >> 4 in
//   32..45, layout 1 (128-byte swizzle) in bits 62..63.  The swizzle is a
//   function of the address bits, so every region must sit on 1024 bytes.
//   - K-major operand (the reduction dimension contiguous: Q, and K in
//     S = Q K^T): SBO = 1024 bytes from one 8-row group to the next; LBO is
//     not read (1 by convention).  Step k16 of the reduction starts 32 bytes
//     further into the same 128-byte rows (the swizzle phase stays the
//     region's), and the next 64 columns are the next region.
//   - MN-major operand (the output columns contiguous: V in O = P V, with
//     imm-trans-b = 1): SBO = 1024 bytes from one group of 8 reduction rows
//     (keys) to the next, LBO = the byte distance from one 64-column region
//     to the next; step k16 starts 16 rows = 2048 bytes further on.
//   A wrong field gives wrong numbers, never an error: flash_fwd.cu's bf16
//   path is held against its plain version on the card for that reason.
// * wgmma fragments (PTX ISA, "wgmma.mma_async" for .bf16 with .f32
//   accumulators): warp w of the warpgroup holds rows 16 w .. 16 w + 15 of
//   the 64-row tile, in mma.m16n8k16's layout: lane = 4 g + t holds, for
//   each n8 column tile j, d[j][0..1] = row g, cols 8 j + 2 t, + 1 and
//   d[j][2..3] = row g + 8.  The A fragment of a register operand (16 rows x
//   16 reduction columns) is mma_bf16.cuh's `split_a` layout, so the
//   accumulators of S over keys 16 kk .. 16 kk + 15 (tiles 2 kk, 2 kk + 1)
//   are the A fragment of P over those keys without a shuffle.
// * Order (PTX ISA): `wgmma_fence` after any register write that a wgmma
//   reads (its accumulators, or a register A) and before the wgmma;
//   `wgmma_commit` closes a group; `wgmma_wait<0>` waits for it.  Between
//   issue and wait no instruction may touch those accumulators.
// * mbarriers: a wait passes once the phase of the given parity has
//   completed.  A wrong parity waits for ever: the kernel hangs.  (A
//   __trap() after many polls would turn that into an error, but its path
//   costs ptxas registers: with it the D = 128 consumer spilled.)
#pragma once

#include <cuda.h>
#include <stdint.h>

namespace wgmma_bf16 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element offset of (row, col) in a tile of `rows` rows stored as D / 64
// swizzled 128-byte-row regions of `rows` rows each.
__device__ __forceinline__ int sw128_off(int rows, int row, int col) {
  return (col >> 6) * rows * 64 + row * 64 +
         ((((col & 63) >> 3) ^ row) & 7) * 8 + (col & 7);
}

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrive once and expect `bytes` more from TMA in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA ------------------------------------------------------------------

// Box (c0, c1, c2) of a 3-D tensor map into shared memory; completion is
// reported to `bar` as transaction bytes (the whole box, out-of-range
// elements zero-filled and counted too).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// ---- warp specialisation --------------------------------------------------

// Every warp of the warpgroup must execute these, with the same count, a
// multiple of 8 in [24, 256].
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// A barrier among the `count` threads that name `id` (1..15; 0 is
// __syncthreads): `named_sync` waits there, `named_arrive` counts itself
// in and goes on.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- wgmma ----------------------------------------------------------------

__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t((saddr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous window of a wgmma (as CUTLASS's warpgroup_fence_operand).
template <int J>
__device__ __forceinline__ void fence_acc(float (&d)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// (x0, x1) as two packed bf16 pairs by truncation: hi = the top 16 bits of
// x, lo = the top 16 bits of x - hi (exact in fp32), so hi + lo carries x
// to within 2^-14 |x| (one bf16 rounding: 2^-9).  Byte permutes, a mask
// and a subtraction: no conversion instruction, which would share the
// slow pipe with the softmax's ex2.
__device__ __forceinline__ void split_trunc_bf16x2(float x0, float x1,
                                                   uint32_t& hi,
                                                   uint32_t& lo) {
  const uint32_t u0 = __float_as_uint(x0), u1 = __float_as_uint(x1);
  hi = __byte_perm(u0, u1, 0x7632);  // x0's top half low, x1's high
  const float l0 = x0 - __uint_as_float(u0 & 0xffff0000u);
  const float l1 = x1 - __uint_as_float(u1 & 0xffff0000u);
  lo = __byte_perm(__float_as_uint(l0), __float_as_uint(l1), 0x7632);
}

// The A fragments (hi and lo) of a 16 x 16 block from the accumulators of
// two n8 tiles, as mma_bf16.cuh's split_a lays them out, split by
// truncation.
__device__ __forceinline__ void split_a_trunc(const float (&c0)[4],
                                              const float (&c1)[4],
                                              uint32_t (&hi)[4],
                                              uint32_t (&lo)[4]) {
  split_trunc_bf16x2(c0[0], c0[1], hi[0], lo[0]);
  split_trunc_bf16x2(c0[2], c0[3], hi[1], lo[1]);
  split_trunc_bf16x2(c1[0], c1[1], hi[2], lo[2]);
  split_trunc_bf16x2(c1[2], c1[3], hi[3], lo[3]);
}

#define MX_ACC4(d, j) \
  "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
#define MX_ACC32(d)                                                         \
  MX_ACC4(d, 0), MX_ACC4(d, 1), MX_ACC4(d, 2), MX_ACC4(d, 3), MX_ACC4(d, 4), \
      MX_ACC4(d, 5), MX_ACC4(d, 6), MX_ACC4(d, 7)
#define MX_ACC64(d)                                                  \
  MX_ACC32(d), MX_ACC4(d, 8), MX_ACC4(d, 9), MX_ACC4(d, 10),         \
      MX_ACC4(d, 11), MX_ACC4(d, 12), MX_ACC4(d, 13), MX_ACC4(d, 14), \
      MX_ACC4(d, 15)

#define MX_REGS32                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "  \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "   \
  "%26, %27, %28, %29, %30, %31}"
#define MX_REGS64                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "  \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "   \
  "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "   \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "   \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "   \
  "%62, %63}"

// d (64 x 128, fp32) = [d +] A B: A (64 x 16) and B (16 x 128) both
// K-major in shared memory; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[16][4], uint64_t da,
                                              uint64_t db, uint32_t scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " MX_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : MX_ACC64(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, fp32) += A B: A (64 x 16) in registers, B (16 x 64) MN-major
// in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MX_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : MX_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, fp32) += A B: A (64 x 16) in registers, B (16 x 128)
// MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " MX_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : MX_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
struct RsWgmma;
template <>
struct RsWgmma<64> {
  static __device__ __forceinline__ void run(float (&d)[8][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    wgmma_rs_n64(d, a, db);
  }
};
template <>
struct RsWgmma<128> {
  static __device__ __forceinline__ void run(float (&d)[16][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    wgmma_rs_n128(d, a, db);
  }
};

#undef MX_REGS32
#undef MX_REGS64
#undef MX_ACC4
#undef MX_ACC32
#undef MX_ACC64

}  // namespace wgmma_bf16
