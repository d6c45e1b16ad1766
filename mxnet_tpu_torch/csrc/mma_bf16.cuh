// Tensor-core building blocks for the bf16 flash-attention kernels on Hopper
// (sm_90a), shared by csrc/flash_fwd.cu (K1) and csrc/flash_bwd.cu (K2, K3).
//
// * Shared tiles are row-major R x D bf16 (D in {64, 128}) whose 16-byte
//   chunks are XOR-swizzled by row & 7 (`swz`): the eight row addresses of
//   one ldmatrix phase, and the eight 16-byte writes of one cp.async phase,
//   then fall on eight different bank groups.
// * `cp_async_tile` fills such a tile (or, given another layout, the fp32
//   tiles of csrc/flash_bwd.cu) with 16-byte cp.async copies; rows past the
//   tensor's end are zero-filled (source size 0), so a ragged edge reads 0.
// * `ldsm_*` load mma fragments with ldmatrix; `mma` is
//   mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32.
// * `split_a` turns the fp32 accumulators of one 16 x 16 product block into
//   the A fragments of the next product, each value x carried as two bf16
//   values hi = bf16(x), lo = bf16(x - hi) (about 16 significant bits).  One
//   rounding to bf16 (8 bits) makes a row of P or dS that sees few keys,
//   whose weighted sum cancels, miss the fp32 reference by more than the
//   bf16 rule allows; two products, hi and lo, keep the sum within it.
//
// Fragment layouts (PTX ISA, "mma.m16n8k16" for .bf16): lane = 4 g + t.
// A (16 x 16): a[0] = row g, cols 2t..2t+1; a[1] = row g + 8, same cols;
//   a[2], a[3] = the same rows at cols + 8.
// B (16 x 8, k x n): b[0] = k 2t..2t+1, col g; b[1] = k + 8.
// C (16 x 8, fp32): c[0..1] = row g, cols 2t..2t+1; c[2..3] = row g + 8.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_bf16 {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element offset of (row, col) in a swizzled R x D tile.
template <int D>
__device__ __forceinline__ int swz(int row, int col) {
  return row * D + ((((col >> 3) ^ row) & 7) | ((col >> 3) & ~7)) * 8 +
         (col & 7);
}

// 16 bytes from global to shared, or 16 zero bytes when !pred (nothing is
// read from `src`, which must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The swizzled tile layout above, as a layout argument of `cp_async_tile`.
struct Swizzled {
  template <int D>
  static __device__ __forceinline__ int at(int row, int col) {
    return swz<D>(row, col);
  }
};

// Rows [row0, row0 + R) of a (rows, D) tensor of T into an R x D tile laid
// out by Layout (Layout::at<D>(row, col) is an element's offset), NT
// threads issuing one 16-byte copy each per step; rows at or past `rows`
// are zero-filled.
template <int R, int D, int NT, typename Layout = Swizzled, typename T>
__device__ __forceinline__ void cp_async_tile(T* dst, const T* src,
                                              int row0, int rows, int tid) {
  constexpr int kPer = 16 / sizeof(T);  // elements a copy
  constexpr int kChunks = D / kPer;
  static_assert((R * kChunks) % NT == 0, "tile not a multiple of a step");
#pragma unroll
  for (int j = 0; j < R * kChunks / NT; ++j) {
    const int i = tid + j * NT;
    const int r = i / kChunks, c = i % kChunks;
    const int gr = row0 + r;
    const bool in = gr < rows;
    cp_async16(dst + Layout::template at<D>(r, c * kPer),
               src + size_t(in ? gr : 0) * D + c * kPer, in);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The A fragment of rows m0 .. m0 + 15, cols k0 .. k0 + 15 of a swizzled
// row-major tile (rows are the product's rows, cols its reduction).
template <int D>
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const bf16* tile,
                                       int m0, int k0, int lane) {
  ldsm_x4(a, tile + swz<D>(m0 + (lane & 15), k0 + ((lane >> 4) << 3)));
}

// B fragments of two n8 tiles (n0 .. n0 + 7 in b[0..1], n0 + 8 .. in
// b[2..3]) over k0 .. k0 + 15, from a tile stored n-major: row n, col k
// (K in S = Q K^T).
template <int D>
__device__ __forceinline__ void ldsm_b_nk(uint32_t (&b)[4], const bf16* tile,
                                          int n0, int k0, int lane) {
  ldsm_x4(b, tile + swz<D>(n0 + (lane & 7) + ((lane >> 4) << 3),
                           k0 + (((lane >> 3) & 1) << 3)));
}

// The same two B fragments from a tile stored k-major: row k, col n (V in
// O = P V), through ldmatrix.trans.
template <int D>
__device__ __forceinline__ void ldsm_b_kn(uint32_t (&b)[4], const bf16* tile,
                                          int n0, int k0, int lane) {
  ldsm_x4_trans(b, tile + swz<D>(k0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                 n0 + ((lane >> 4) << 3)));
}

// d += a b on the tensor cores: 16 x 16 bf16 by 16 x 8 bf16, fp32 sums.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x0, x1) as hi = bf16(x), lo = bf16(x - hi), each a packed pair.
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16x2(x0 - hf.x, x1 - hf.y);
}

// The A fragments (hi and lo) of a 16 x 16 block whose columns 0..7 are the
// accumulators c0 of one n8 tile and columns 8..15 those of the next, c1:
// the FA2 register reuse, with no trip through shared memory.
__device__ __forceinline__ void split_a(const float (&c0)[4],
                                        const float (&c1)[4],
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_bf16x2(c0[0], c0[1], hi[0], lo[0]);
  split_bf16x2(c0[2], c0[3], hi[1], lo[1]);
  split_bf16x2(c1[0], c1[1], hi[2], lo[2]);
  split_bf16x2(c1[2], c1[3], hi[3], lo[3]);
}

// 2^x on the special-function unit (ex2.approx, ~2 ulp); results below
// 2^-126 flush to 0, and 2^-inf = 0.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Sum of the four lanes of a quad (the lanes that share a row g).
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// Rows [row0, row0 + 16) of a swizzled tile to a (rows, D) bf16 tensor with
// 16-byte stores, one warp; rows at or past `rows` are not written.
template <int D>
__device__ __forceinline__ void store_rows16(bf16* dst, const bf16* tile,
                                             int tile_row0, int row0,
                                             int rows, int lane) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int j = 0; j < 16 * kChunks / 32; ++j) {
    const int i = lane + 32 * j;
    const int r = i / kChunks, c = i % kChunks;
    if (row0 + r < rows)
      *reinterpret_cast<uint4*>(dst + size_t(row0 + r) * D + c * 8) =
          *reinterpret_cast<const uint4*>(tile +
                                          swz<D>(tile_row0 + r, c * 8));
  }
}

// Accumulators of a warp's 16 rows (D / 8 n8 tiles), times `mul` and rounded
// to bf16, into rows tile_row0 .. + 15 of a swizzled tile.
template <int D>
__device__ __forceinline__ void acc_to_tile(bf16* tile, int tile_row0,
                                           const float (&acc)[D / 8][4],
                                           float mul0, float mul1, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(tile + swz<D>(tile_row0 + g, 8 * n + 2 * t)) =
        pack_bf16x2(acc[n][0] * mul0, acc[n][1] * mul0);
    *reinterpret_cast<uint32_t*>(tile +
                                 swz<D>(tile_row0 + g + 8, 8 * n + 2 * t)) =
        pack_bf16x2(acc[n][2] * mul1, acc[n][3] * mul1);
  }
}

}  // namespace mma_bf16
