// Tensor-core building blocks for the fp32 flash-attention kernels on Hopper
// (sm_90a), as three TF32 products a product (3xTF32), shared by
// csrc/flash_fwd.cu (K1) and csrc/flash_bwd.cu (K2, K3).
//
// Why three products.  The fp32 kernels must meet the plain version to 1e-4
// + 1e-4 |ref|.  One TF32 product (10 mantissa bits) does not: on randn
// inputs at T = 512 it puts the backward's dQ, dK and dV past the limit,
// and the forward's O by 2-16 times (tests/test_torch_attention_tf32.py pins
// both cases).  So each operand x enters as two TF32 values hi and lo, and
// every product is three mma: a_lo b_hi, then a_hi b_lo, then a_hi b_hi,
// the small terms first, as CUTLASS's OpMultiplyAddFastF32 orders them;
// a_lo b_lo is below the rule.  The tensor core reads the top 19 bits of a
// register and ignores the low 13, so hi is x itself (read as x truncated to
// TF32) and lo = x - trunc(x), read truncated: two instructions a value.
// Rounding both halves with cvt.rna.tf32.f32, which compiles to a sequence
// of integer and compare instructions, left the kernels issuing more
// conversion than tensor instructions, and they ran markedly slower.  hi +
// lo keeps x within 2^-20 |x|.
//
// * Tiles stay fp32 in shared memory at a row stride of D + 4 floats
//   (`Padded`), filled by 16-byte cp.async copies (`load_tile`).
// * Every fragment is split as it is loaded: A and n-major B fragments by
//   ldmatrix (b16 pairs carry one 32-bit word each; `ldsm_a`, `ldsm_b_nk`),
//   MN-major B fragments by scalar loads (`mma3_cb`).
// * The A fragment of an operand held in m16n8 accumulators (P, dS) comes
//   from registers: an accumulator holds columns (2t, 2t + 1) where
//   m16n8k8's A fragment wants (t, t + 4), so the k index is permuted
//   instead (k-slot t <- column 2t, k-slot t + 4 <- column 2t + 1) and the
//   matching MN-major B fragment reads rows 2t and 2t + 1.
// * The stride puts those reads and the ldmatrix phases on 32 distinct
//   banks and makes every fragment offset an immediate (an XOR swizzle cost
//   an address computation a fragment).
//
// Fragment layouts (PTX ISA, "mma.m16n8k8" for .tf32): lane = 4 g + t.
// A (16 x 8): a[0] = (g, t), a[1] = (g + 8, t), a[2] = (g, t + 4), a[3] =
//   (g + 8, t + 4).  B (8 x 8, k x n): b[0] = (t, g), b[1] = (t + 4, g).
// C (16 x 8, fp32): c[0..1] = row g, cols 2t..2t+1; c[2..3] = row g + 8.
#pragma once

#include <stdint.h>

#include "mma_bf16.cuh"

namespace tf32 {

// Threads of every fp32 flash kernel: four warps, 16 rows each.
constexpr int kThreads = 128;

// The layout of the fp32 tiles: row-major R x D at a row stride of D + 4
// floats.  The stride puts row r at bank 4r (mod 32): one ldmatrix phase (8
// rows, one 16-byte chunk each) and the scalar reads of an MN-major B
// fragment (rows 2t and 2t + 1 of an 8-row group, columns g) then hit 32
// distinct banks, and every fragment offset is an immediate.
struct Padded {
  template <int D>
  static __device__ __forceinline__ int at(int row, int col) {
    return row * (D + 4) + col;
  }
};

// Rows [row0, row0 + R) of a (rows, D) fp32 tensor into an R x D tile of
// this layout, by the block's 16-byte cp.async copies.
template <int R, int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int rows, int tid) {
  mma_bf16::cp_async_tile<R, D, kThreads, Padded>(dst, src, row0, rows, tid);
}

// The A fragment (fp32 bits) of rows m0 .. m0 + 15, cols k0 .. k0 + 7 of a
// row-major tile: a[0] = (g, t), a[1] = (g + 8, t), a[2] = (g, t + 4), a[3]
// = (g + 8, t + 4).  ldmatrix (b16) reads each 8 x 4 fp32 block as an 8 x 8
// block of b16 pairs: thread 4g + t receives word t of row g.
template <int D>
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const float* tile,
                                       int m0, int k0, int lane) {
  mma_bf16::ldsm_x4(a, reinterpret_cast<const mma_bf16::bf16*>(
                           tile + Padded::at<D>(m0 + (lane & 15),
                                                k0 + ((lane >> 4) << 2))));
}

// B fragments of two n8 tiles (n0 .. n0 + 7 in b[0..1], n0 + 8 .. in
// b[2..3]) over k0 .. k0 + 7, from a tile stored n-major (row n, col k):
// b[0] = (k t, n g), b[1] = (k t + 4, n g).
template <int D>
__device__ __forceinline__ void ldsm_b_nk(uint32_t (&b)[4], const float* tile,
                                          int n0, int k0, int lane) {
  mma_bf16::ldsm_x4(b, reinterpret_cast<const mma_bf16::bf16*>(
                           tile + Padded::at<D>(
                                      n0 + (lane & 7) + ((lane >> 4) << 3),
                                      k0 + (((lane >> 3) & 1) << 2))));
}

// x as the two TF32 operands hi and lo.  The tensor core reads the top 19
// bits of a register (sign, exponent, 10 mantissa bits) and ignores the
// low 13, so x itself serves as hi, read as x truncated to TF32, and lo =
// x - trunc(x) (exact in fp32, about 13 bits) is read truncated to its top
// 11 significant bits: hi + lo keeps 21 bits of x, within 2^-20 |x|.  Two
// instructions, where a rounding conversion (cvt.rna.tf32.f32) compiles to
// several, and NaN stays NaN.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}

template <int N>
__device__ __forceinline__ void split_bits(const uint32_t (&x)[N],
                                           uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split(__uint_as_float(x[i]), hi[i], lo[i]);
}

// d += a b on the tensor cores: 16 x 8 TF32 by 8 x 8 TF32, fp32 sums.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b with both as hi + lo: a_lo b_hi, a_hi b_lo, then a_hi b_hi.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma(d, al, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

// acc[j] += A B^T for rows m0 .. m0 + 15 of tile `a` against rows 0 ..
// 8N - 1 of tile `b` (the n8 tile j = rows 8j ..), reducing over their D
// columns: S = Q K^T in K1 and K2, dP = dO V^T in K2, S^T = K Q^T and dP^T
// = V dO^T in K3.
template <int D, int N>
__device__ __forceinline__ void mma3_abt(float (&acc)[N][4], const float* a,
                                         int m0, const float* b, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t x[4], ah[4], al[4];
    ldsm_a<D>(x, a, m0, 8 * kk, lane);
    split_bits(x, ah, al);
#pragma unroll
    for (int np = 0; np < N / 2; ++np) {
      uint32_t y[4], bh[4], bl[4];
      ldsm_b_nk<D>(y, b, 16 * np, 8 * kk, lane);
      split_bits(y, bh, bl);
      mma3(acc[2 * np], ah, al, bh[0], bh[1], bl[0], bl[1]);
      mma3(acc[2 * np + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
    }
  }
}

// acc[n] += C B, where C (16 x 8K) is held as the accumulators c of K m16n8
// tiles (P or dS) and B is rows 0 .. 8K - 1 of a k-major tile `b` (row k,
// col n; all D columns): O += P V in K1, dQ += dS K in K2, dV += P^T dO and
// dK += dS^T Q in K3.  m16n8k8's A fragment wants columns (t, t + 4), where
// an accumulator holds (2t, 2t + 1), so the k index is permuted: k-slot t
// <- column 2t, k-slot t + 4 <- column 2t + 1, and the B fragment reads
// rows 2t and 2t + 1 by scalar loads.
//
// Each n8 tile's product over the 8K rows goes into a fresh zeroed
// fragment, which then enters acc by a CUDA-core add.  The tensor core's
// fp32 sum does not round to nearest: each mma moves the accumulator a
// fraction of an ulp toward zero, the same way every time, so a sum carried
// in the mma accumulators through a whole row of 3 K mma a tile drifts by
// a share that grows with the number of tiles.  At T = 16384 the fp32 dK
// and dV of K3 came out 1.8e-4 x max|ref| from float64 (and K1's O, not
// causal, 1.2e-4), twice their values at T = 8192, while the plain fp32
// composition stayed near 3e-6 (chip_smoke.py's phase_long_fp32).  The
// chain in the tensor core is now 3 K mma long, whatever T is, and the
// add of a tile's part rounds to nearest.  c's hi halves are c itself; its
// lo halves are split once, before the n loop.
template <int D, int K>
__device__ __forceinline__ void mma3_cb(float (&acc)[D / 8][4],
                                        const float (&c)[K][4],
                                        const float* b, int g, int t) {
  uint32_t ah[K][4], al[K][4];
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    split(c[kk][0], ah[kk][0], al[kk][0]);
    split(c[kk][2], ah[kk][1], al[kk][1]);
    split(c[kk][1], ah[kk][2], al[kk][2]);
    split(c[kk][3], ah[kk][3], al[kk][3]);
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      const float* row = b + Padded::at<D>(8 * kk + 2 * t, g);
      uint32_t bh[2], bl[2];
      split(row[8 * n], bh[0], bl[0]);
      split(row[D + 4 + 8 * n], bh[1], bl[1]);
      mma3(part, ah[kk], al[kk], bh[0], bh[1], bl[0], bl[1]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[e];
  }
}

// Accumulators of a warp's 16 rows (D / 8 n8 tiles) to rows row0 + g (times
// mul0) and row0 + g + 8 (times mul1) of a (rows, D) fp32 tensor, 8 bytes a
// store (a quad writes 32 contiguous bytes of a row); rows at or past `rows`
// are not written.
template <int D>
__device__ __forceinline__ void store_acc(float* dst, int row0, int rows,
                                          const float (&acc)[D / 8][4],
                                          float mul0, float mul1, int g,
                                          int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + 8 * i;
    if (r >= rows) continue;
    const float mul = i ? mul1 : mul0;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(dst + size_t(r) * D + 8 * n + 2 * t) =
          make_float2(acc[n][2 * i] * mul, acc[n][2 * i + 1] * mul);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

}  // namespace tf32
