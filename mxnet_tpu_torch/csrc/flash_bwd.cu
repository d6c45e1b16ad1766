// Flash-attention backward for Hopper (sm_90a), fp32 or bf16 inputs, D in {64, 128}.
//
// Replaces: mxnet_tpu/ops/attention.py `_flash_bwd_dq_kernel` (K2) and
// `_flash_bwd_dkv_kernel` (K3), both launched by `_flash_bwd` through
// `pl.pallas_call`.  Same functions, recomputing the probabilities from the
// forward's log-sum-exp so the T x T matrices never reach device memory:
//     S     = scale * Q K^T           [causal: q_pos >= k_pos, top-left]
//     P     = exp(S - LSE)            (0 where masked, or where S or the
//                                      LSE is not finite)
//     dP    = dO V^T
//     delta = rowsum(dO * O)          (recomputed here, per query row)
//     dS    = P * (dP - delta)
//     dQ    = scale * dS K            (K2)
//     dK    = scale * dS^T Q,  dV = P^T dO   (K3)
//
// Design.  The TPU grid is sequential; here blocks run in parallel, so each
// kernel owns its output tile and loops over the other operand's tiles inside
// the block, as K1 (csrc/flash_fwd.cu) does.  The two-kernel split of the
// reference is kept: K2 owns a 64-row query tile and accumulates dQ, K3 owns a
// 64-row key tile and accumulates dK and dV, so no block ever adds into
// another's output.  There are no atomics and the summation order is fixed:
// two launches on the same inputs give bitwise-equal results.  Both input
// types run on the tensor cores with mma.sync, in one structure: 128
// threads, warp w owns rows 16w .. 16w+15 of the block's tile; the tile the
// block owns stays in shared memory and the other operand's tiles stream
// through a two-stage ring of 16-byte cp.async copies, so tile i+1 loads
// while tile i is computed.  S and dP (S^T and dP^T in K3) are products of
// two shared tiles; P and dS (P^T, dS^T) are made in their accumulators and
// enter the next product from registers as A fragments, so they never reach
// shared memory and no barrier separates the products.  Probabilities are
// exp2(scale * log2e * S - log2e * LSE) in fp32.  Keys past Tk and rows past
// Tq load as zero and get P = 0 before any product, and rows past the end
// are not written; the element mask runs only on ragged and causal-diagonal
// tiles; causal tiles that no (q, k) pair of the tile can see are skipped.
// Per input type:
//
// bfloat16 (helpers in mma_bf16.cuh): m16n8k16 on XOR-swizzled bf16 tiles;
// P and dS enter their products as hi + lo bf16 pairs (mma_bf16.cuh says
// why one rounding is not enough).
//
// float32 (helpers in mma_tf32.cuh, namespace tf32, shared with K1's fp32
// kernel): m16n8k8 on TF32 operands, as a 3xTF32 split (mma_tf32.cuh says
// why one TF32 product misses the 1e-4 rule and how x splits into hi + lo);
// tiles stay fp32 in shared memory at a row stride of D + 4 floats.  S, dP,
// P, dS, delta and the outputs stay fp32; delta and the softmax are FMAs on
// the CUDA cores.  Outputs leave the accumulators as 8-byte stores (a quad
// writes 32 contiguous bytes of a row).  Shared memory: K2 holds Q and dO
// (64 rows) and a ring of 32-key K and V tiles, 69,632 bytes at D = 64
// (three blocks an SM) and 135,168 at D = 128; K3 holds K and V (64 rows)
// and a ring of 16-query Q, dO and O tiles, 61,056 bytes at D = 64 (three
// blocks an SM) and 118,400 at D = 128.  Why not wgmma: its .tf32 form needs
// both operands K-major in shared memory and has no transpose, and three B
// operands here are MN-major (K in dQ = dS K, dO in dV = P^T dO, Q in dK =
// dS^T Q); they would need a transposed copy of each streamed tile first.
// That is later work.  At BERT-base's training shape (B*H = 192, T = 512, D
// = 64) K2 needs 19.3 GFLOP (S, dP, dQ: 6 D a (q, k) pair) and K3 25.8 (S,
// dP, dV, dK: 8 D), 58 and 77 GFLOP issued as three TF32 products: 0.117 and
// 0.156 ms at 495 TFLOP/s, against 151 and 177 MB of inputs and outputs,
// 0.045 and 0.053 ms at 3.35 TB/s.  Operations bound both, so the design
// keeps the tensor cores fed: no trip of P or dS through shared memory, few
// instructions beside each mma, loads in flight under the products, and
// three blocks an SM to hide mma.sync latency.  Each kernel's note is at it
// below.
//
// Interface: plain C, loaded with ctypes.  Pointers and the stream are void*;
// each entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kTile = 64;  // query rows of K2's tile, key rows of K3's

// ---------------------------------------------------------------------------
// K3 in bfloat16: tensor cores
// ---------------------------------------------------------------------------
//
// Warp w owns key rows 16w .. 16w+15 of the block's 64-row key tile, which
// stays in shared memory with the V tile.  Query tiles of BQ rows (64 at D =
// 64, 32 at D = 128) stream Q, dO and O through the ring.  Per query tile:
// delta = rowsum(dO * O) and the LSE of its rows into shared memory; then
// per slice of 32 queries (the dK and dV accumulators take D registers a
// thread, 128 at D = 128, so the S^T and dP^T tiles stay small): S^T = K Q^T
// and dP^T = V dO^T (all four operands by ldmatrix); P^T = exp(scale S^T -
// LSE) and dS^T = P^T (dP^T - delta) in the accumulators; then dV += P^T dO
// and dK += dS^T Q, P^T and dS^T taken from registers (hi + lo bf16, as in
// K1) and dO and Q by ldmatrix.trans.  dK is scaled once on store; dK and dV
// are staged through the warp's rows of the K and V tiles for 16-byte
// stores.  At the training shape K3 moves 88 MB and needs 25.8 GFLOP (38.7
// GFLOP issued with the hi/lo products): 0.026 ms at 3.35 TB/s against 0.026
// ms (0.039 ms) at 989 TFLOP/s.

constexpr int kTcThreads = 128;  // four warps, 16 rows each
constexpr float kLog2e = 1.4426950408889634f;

// query rows of K3's streamed tiles (64 at D = 64; 32 at D = 128, where the
// ring of three D-wide tiles would otherwise leave room for one block an SM);
// each is computed in slices of 32 queries, so S^T and dP^T take 32
// registers a thread beside the 2 * D / 2 of dK and dV
__host__ __device__ constexpr int dkv_tile_q(int d) { return d == 64 ? 64 : 32; }

// K3's per-query-tile prologue, in both input types, once each of the kPer
// threads of query row r (tid = kPer r + part) has summed dO * O over its
// share of the row: delta and the LSE (log2 units) of the row into shared
// memory, and whether the tile may skip the element mask.  The mask is
// needed only where keys pass Tk, rows pass Tq or saw no key, or a (q, k)
// pair of the tile lies above the diagonal.  A barrier of the whole block.
template <int kPer>
__device__ __forceinline__ bool dkv_tile_stats(float sum, int r, int part,
                                               const float* lseb, int q0,
                                               int tq, int k0, int tk,
                                               int causal, float* lse_s,
                                               float* delta_s) {
#pragma unroll
  for (int off = 1; off < kPer; off <<= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  float lse2 = -INFINITY;
  if (part == 0) {
    delta_s[r] = sum;
    lse2 = q0 + r < tq ? lseb[q0 + r] * kLog2e : -INFINITY;
    lse_s[r] = lse2;
  }
  return __syncthreads_and(part != 0 || isfinite(lse2)) &&
         k0 + kTile <= tk && (!causal || q0 + 1 >= k0 + kTile);
}

template <int D>
constexpr size_t dkv_bf16_smem_bytes() {
  // K and V tiles, a two-stage ring of Q, dO and O tiles (bf16), and the LSE
  // and delta of the current query tile (fp32)
  return sizeof(__nv_bfloat16) *
             (size_t(2) * kTile * D + size_t(6) * dkv_tile_q(D) * D) +
         sizeof(float) * 2 * dkv_tile_q(D);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, D == 64 ? 3 : 1)
flash_bwd_dkv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ o,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int tq, int tk,
                          float scale, int causal) {
  using namespace mma_bf16;
  constexpr int BQ = dkv_tile_q(D);
  constexpr int kSub = 32;
  constexpr int kQElems = BQ * D;
  extern __shared__ uint4 smem_tc[];
  bf16* ks = reinterpret_cast<bf16*>(smem_tc);
  bf16* vs = ks + kTile * D;
  bf16* ring = vs + kTile * D;  // stage s: Q, dO, O at ring + (3s + i) kQElems
  float* lse_s = reinterpret_cast<float*>(ring + 6 * kQElems);
  float* delta_s = lse_s + BQ;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qb = q + size_t(bh) * tq * D;
  const bf16* ob = o + size_t(bh) * tq * D;
  const bf16* dob = dout + size_t(bh) * tq * D;
  const float* lseb = lse + size_t(bh) * tq;

  // causal: query rows before k0 see no key of this tile (the reference's
  // qb_start); BQ divides 64, so the first query tile starts at k0
  const int num_qt = (tq + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;
  cp_async_tile<kTile, D, kTcThreads>(ks, k + size_t(bh) * tk * D, k0, tk, tid);
  cp_async_tile<kTile, D, kTcThreads>(vs, v + size_t(bh) * tk * D, k0, tk, tid);
  if (qt0 < num_qt) {
    cp_async_tile<BQ, D, kTcThreads>(ring, qb, qt0 * BQ, tq, tid);
    cp_async_tile<BQ, D, kTcThreads>(ring + kQElems, dob, qt0 * BQ, tq, tid);
    cp_async_tile<BQ, D, kTcThreads>(ring + 2 * kQElems, ob, qt0 * BQ, tq, tid);
  }
  cp_async_commit();

  float adk[D / 8][4], adv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;
  const float sl2 = scale * kLog2e;
  const int kr0 = k0 + 16 * warp + g;  // this thread's key rows: kr0, kr0 + 8

  for (int qt = qt0; qt < num_qt; ++qt) {
    const int q0 = qt * BQ;
    const int stage = (qt - qt0) & 1;
    if (qt + 1 < num_qt) {
      bf16* nxt = ring + 3 * (stage ^ 1) * kQElems;
      cp_async_tile<BQ, D, kTcThreads>(nxt, qb, q0 + BQ, tq, tid);
      cp_async_tile<BQ, D, kTcThreads>(nxt + kQElems, dob, q0 + BQ, tq, tid);
      cp_async_tile<BQ, D, kTcThreads>(nxt + 2 * kQElems, ob, q0 + BQ, tq, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile qt (and K, V) has landed
    __syncthreads();
    const bf16* qst = ring + 3 * stage * kQElems;
    const bf16* dost = qst + kQElems;
    const bf16* ost = dost + kQElems;
    bool full;
    {
      // delta and LSE (log2 units) of the tile's BQ rows, kPer threads a row
      constexpr int kPer = kTcThreads / BQ;
      const int r = tid / kPer, part = tid % kPer;
      float sum = 0.f;
#pragma unroll
      for (int c = part; c < D / 8; c += kPer) {
        const uint4 a = *reinterpret_cast<const uint4*>(dost + swz<D>(r, 8 * c));
        const uint4 b = *reinterpret_cast<const uint4*>(ost + swz<D>(r, 8 * c));
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float2 x = __bfloat1622float2(a2[h]);
          const float2 y = __bfloat1622float2(b2[h]);
          sum = fmaf(x.x, y.x, sum);
          sum = fmaf(x.y, y.y, sum);
        }
      }
      full = dkv_tile_stats<kPer>(sum, r, part, lseb, q0, tq, k0, tk, causal,
                                  lse_s, delta_s);
    }

    // the tile's queries in slices of kSub, one slice's S^T and dP^T in
    // registers at a time
#pragma unroll 1
    for (int c0 = 0; c0 < BQ; c0 += kSub) {
      // S^T = K Q^T and dP^T = V dO^T: 16 key rows x kSub queries each
      float s[kSub / 8][4], dp[kSub / 8][4];
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        ldsm_a<D>(ka, ks, 16 * warp, 16 * kk, lane);
        ldsm_a<D>(va, vs, 16 * warp, 16 * kk, lane);
#pragma unroll
        for (int np = 0; np < kSub / 16; ++np) {
          uint32_t b[4];
          ldsm_b_nk<D>(b, qst, c0 + 16 * np, 16 * kk, lane);
          mma(s[2 * np], ka, b[0], b[1]);
          mma(s[2 * np + 1], ka, b[2], b[3]);
          ldsm_b_nk<D>(b, dost, c0 + 16 * np, 16 * kk, lane);
          mma(dp[2 * np], va, b[0], b[1]);
          mma(dp[2 * np + 1], va, b[2], b[3]);
        }
      }

      // P^T = exp(scale S^T - LSE) with the mask and the isfinite guards
      // (keys past Tk, rows past Tq and rows that saw no key give 0 before
      // any product, and so does a score that is not finite, as in the
      // reference: x below is finite only where S^T and the LSE are), and
      // dS^T = P^T (dP^T - delta), in place
      const auto probs = [&](bool mask) {
#pragma unroll
        for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = c0 + 8 * j + 2 * t + (e & 1);
            const int kr = kr0 + 8 * (e >> 1);
            const float x = s[j][e] * sl2 - lse_s[c];
            const bool ok =
                (!mask || (kr < tk && (!causal || q0 + c >= kr))) &&
                isfinite(x);
            const float p = ok ? exp2_ftz(x) : 0.f;
            s[j][e] = p;
            dp[j][e] = p * (dp[j][e] - delta_s[c]);
          }
      };
      if (full)
        probs(false);
      else
        probs(true);

      // dV += P^T dO and dK += dS^T Q: P^T and dS^T (hi and lo) from the
      // accumulators, dO and Q by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
        uint32_t ph[4], pl[4], dh[4], dl[4];
        split_a(s[2 * kk], s[2 * kk + 1], ph, pl);
        split_a(dp[2 * kk], dp[2 * kk + 1], dh, dl);
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t b[4];
          ldsm_b_kn<D>(b, dost, 16 * np, c0 + 16 * kk, lane);
          mma(adv[2 * np], ph, b[0], b[1]);
          mma(adv[2 * np + 1], ph, b[2], b[3]);
          mma(adv[2 * np], pl, b[0], b[1]);
          mma(adv[2 * np + 1], pl, b[2], b[3]);
          ldsm_b_kn<D>(b, qst, 16 * np, c0 + 16 * kk, lane);
          mma(adk[2 * np], dh, b[0], b[1]);
          mma(adk[2 * np + 1], dh, b[2], b[3]);
          mma(adk[2 * np], dl, b[0], b[1]);
          mma(adk[2 * np + 1], dl, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }
  cp_async_wait<0>();
  __syncthreads();

  // dK (scaled once) and dV through this warp's rows of the K and V tiles
  acc_to_tile<D>(ks, 16 * warp, adk, scale, scale, lane);
  acc_to_tile<D>(vs, 16 * warp, adv, 1.f, 1.f, lane);
  __syncwarp();
  store_rows16<D>(dk + size_t(bh) * tk * D, ks, 16 * warp, k0 + 16 * warp, tk,
                  lane);
  store_rows16<D>(dv + size_t(bh) * tk * D, vs, 16 * warp, k0 + 16 * warp, tk,
                  lane);
}

template <int D>
cudaError_t launch_dkv_bf16(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse,
                            void* dk, void* dv, int bh, int tq, int tk,
                            float scale, int causal, cudaStream_t stream) {
  const size_t smem = dkv_bf16_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_bf16_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tk + kTile - 1) / kTile);
  flash_bwd_dkv_bf16_kernel<D><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), tq, tk,
      scale, causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K2 in bfloat16: tensor cores
// ---------------------------------------------------------------------------
//
// Replaces `_flash_bwd_dq_kernel` (mxnet_tpu/ops/attention.py): dQ = scale *
// dS K with dS = P (dO V^T - delta), delta = rowsum(dO * O).  Warp w owns
// query rows 16w .. 16w+15 of the block's 64-row query tile; the Q and dO
// tiles stay in shared memory for the whole block and 64-row K and V tiles
// stream through the ring.  O is read once, from device memory, for delta
// (fp32 sums of the bf16 values, four lanes a row); each thread keeps the
// LSE (log2 units) and delta of its rows g and g + 8 in registers.  Per key
// tile, per slice of kSub keys (64 at D = 64; 32 at D = 128, where dQ alone
// takes 64 registers a thread): S = Q K^T and dP = dO V^T, Q and dO as A
// fragments and K and V n-major (all by ldmatrix); P = exp2(scale log2e S -
// log2e LSE) and dS = P (dP - delta) in the dP accumulators, in place; then
// dQ += dS K with dS (hi and lo) from registers and K by ldmatrix.trans: dS
// never reaches shared memory and no barrier separates the products.  A row
// past Tq or with a non-finite LSE takes LSE = +inf, so its P is 2^-inf = 0
// on every tile without a mask.  dQ is scaled once on store and staged
// through the warp's rows of the Q tile for 16-byte stores.
//
// What bounds it: at the training shape (B*H = 192, T = 512, D = 64) K2
// reads Q, K, V, O, dO and the LSE and writes dQ, 76 MB, 0.0227 ms at 3.35
// TB/s; it needs 19.3 GFLOP (25.8 GFLOP issued with the hi/lo product),
// 0.020 ms (0.026 ms) at 989 TFLOP/s.  Bytes and tensor-core time are that
// close, so what the design does is keep the next K/V tile's load in flight
// under the current tile's products, and S, dP and dS in registers.

// keys per slice of a key tile: one slice's S and dP stay in registers
// (kSub / 2 each a thread) beside dQ (D / 2)
__host__ __device__ constexpr int dq_slice_k(int d) { return d == 64 ? 64 : 32; }

template <int D>
constexpr size_t dq_bf16_smem_bytes() {
  // the Q and dO tiles and a two-stage ring of K and V tiles, all bf16
  return sizeof(__nv_bfloat16) * size_t(6) * kTile * D;
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, D == 64 ? 3 : 1)
flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ o,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         __nv_bfloat16* __restrict__ dq, int tq, int tk,
                         float scale, int causal) {
  using namespace mma_bf16;
  constexpr int kSub = dq_slice_k(D);
  constexpr int kTileElems = kTile * D;
  constexpr int kRowChunks = D / 32;  // 16-byte chunks of a row per lane
  extern __shared__ uint4 smem_tc[];
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* dos = qs + kTileElems;
  bf16* ks = dos + kTileElems;  // stage s at ks + s * kTileElems
  bf16* vs = ks + 2 * kTileElems;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* kb = k + size_t(bh) * tk * D;
  const bf16* vb = v + size_t(bh) * tk * D;
  const bf16* ob = o + size_t(bh) * tq * D;

  // causal: the diagonal tile is the last one a query tile sees
  int num_kt = (tk + kTile - 1) / kTile;
  if (causal) num_kt = min(num_kt, (q0 + kTile + kTile - 1) / kTile);

  cp_async_tile<kTile, D, kTcThreads>(qs, q + size_t(bh) * tq * D, q0, tq,
                                      tid);
  cp_async_tile<kTile, D, kTcThreads>(dos, dout + size_t(bh) * tq * D, q0,
                                      tq, tid);
  cp_async_commit();
  if (num_kt > 0) {
    cp_async_tile<kTile, D, kTcThreads>(ks, kb, 0, tk, tid);
    cp_async_tile<kTile, D, kTcThreads>(vs, vb, 0, tk, tid);
  }
  cp_async_commit();

  // this thread's rows of the tile: rt and rt + 8; lane t of the quad takes
  // chunks t, t + 4, ... of each, O straight from device memory
  const int rt = 16 * warp + g;
  uint4 ov[2][kRowChunks];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qr = q0 + rt + 8 * i;
#pragma unroll
    for (int c = 0; c < kRowChunks; ++c)
      ov[i][c] = qr < tq ? *reinterpret_cast<const uint4*>(
                               ob + size_t(qr) * D + 8 * (t + 4 * c))
                         : make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_wait<1>();  // Q and dO have landed
  __syncthreads();

  float delta[2], lse2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rt + 8 * i;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kRowChunks; ++c) {
      const uint4 a =
          *reinterpret_cast<const uint4*>(dos + swz<D>(r, 8 * (t + 4 * c)));
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* b2 =
          reinterpret_cast<const __nv_bfloat162*>(&ov[i][c]);
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float2 x = __bfloat1622float2(a2[h]);
        const float2 y = __bfloat1622float2(b2[h]);
        sum = fmaf(x.x, y.x, sum);
        sum = fmaf(x.y, y.y, sum);
      }
    }
    delta[i] = quad_sum(sum);
    const float l = q0 + r < tq ? lse[size_t(bh) * tq + q0 + r] : -INFINITY;
    lse2[i] = isfinite(l) ? l * kLog2e : INFINITY;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float sl2 = scale * kLog2e;
  const int wq0 = q0 + 16 * warp;  // this warp's first query row

  for (int kt = 0; kt < num_kt; ++kt) {
    const int k0 = kt * kTile;
    if (kt + 1 < num_kt) {
      const int nxt = ((kt + 1) & 1) * kTileElems;
      cp_async_tile<kTile, D, kTcThreads>(ks + nxt, kb, k0 + kTile, tk, tid);
      cp_async_tile<kTile, D, kTcThreads>(vs + nxt, vb, k0 + kTile, tk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile kt has landed
    __syncthreads();
    const bf16* kst = ks + (kt & 1) * kTileElems;
    const bf16* vst = vs + (kt & 1) * kTileElems;

#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += kSub) {
      const int kc0 = k0 + c0;

      // S = Q K^T and dP = dO V^T: 16 rows x kSub keys each
      float s[kSub / 8][4], dp[kSub / 8][4];
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qa[4], da[4];
        ldsm_a<D>(qa, qs, 16 * warp, 16 * kk, lane);
        ldsm_a<D>(da, dos, 16 * warp, 16 * kk, lane);
#pragma unroll
        for (int np = 0; np < kSub / 16; ++np) {
          uint32_t b[4];
          ldsm_b_nk<D>(b, kst, c0 + 16 * np, 16 * kk, lane);
          mma(s[2 * np], qa, b[0], b[1]);
          mma(s[2 * np + 1], qa, b[2], b[3]);
          ldsm_b_nk<D>(b, vst, c0 + 16 * np, 16 * kk, lane);
          mma(dp[2 * np], da, b[0], b[1]);
          mma(dp[2 * np + 1], da, b[2], b[3]);
        }
      }

      // dS = P (dP - delta) in place, P = 0 where keys pass Tk or lie
      // right of the diagonal (only the ragged and diagonal slices mask)
      // and, as in the reference, where the score is not finite
      const auto grads = [&](bool mask) {
#pragma unroll
        for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kc = kc0 + 8 * j + 2 * t + (e & 1);
            const int qr = q0 + rt + 8 * (e >> 1);
            const float x = s[j][e] * sl2 - lse2[e >> 1];
            const bool ok = (!mask || (kc < tk && (!causal || qr >= kc))) &&
                            isfinite(x);
            const float p = ok ? exp2_ftz(x) : 0.f;
            dp[j][e] = p * (dp[j][e] - delta[e >> 1]);
          }
      };
      if (kc0 + kSub <= tk && (!causal || kc0 + kSub <= wq0 + 1))
        grads(false);
      else
        grads(true);

      // dQ += dS K: dS (hi and lo) from the accumulators, K by
      // ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
        uint32_t hi[4], lo[4];
        split_a(dp[2 * kk], dp[2 * kk + 1], hi, lo);
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t b[4];
          ldsm_b_kn<D>(b, kst, 16 * np, c0 + 16 * kk, lane);
          mma(acc[2 * np], hi, b[0], b[1]);
          mma(acc[2 * np + 1], hi, b[2], b[3]);
          mma(acc[2 * np], lo, b[0], b[1]);
          mma(acc[2 * np + 1], lo, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }
  cp_async_wait<0>();
  __syncthreads();

  // dQ (scaled once) through this warp's rows of the Q tile
  acc_to_tile<D>(qs, 16 * warp, acc, scale, scale, lane);
  __syncwarp();
  store_rows16<D>(dq + size_t(bh) * tq * D, qs, 16 * warp, wq0, tq, lane);
}

template <int D>
cudaError_t launch_dq_bf16(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const void* lse,
                           void* dq, int bh, int tq, int tk, float scale,
                           int causal, cudaStream_t stream) {
  const size_t smem = dq_bf16_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_bf16_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tq + kTile - 1) / kTile);
  flash_bwd_dq_bf16_kernel<D><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<__nv_bfloat16*>(dq), tq, tk, scale, causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K2 and K3 in float32: tensor cores, 3xTF32
// ---------------------------------------------------------------------------

// K2 in float32.  Warp w owns query rows 16w .. 16w+15 of the block's
// 64-row query tile; Q and dO stay in shared memory, 32-key K and V tiles
// stream through the ring.  O is read once, from device memory, for delta
// (four lanes a row, fp32 FMAs); each thread keeps the LSE (log2 units) and
// delta of its rows g and g + 8 in registers, and a row past Tq or with a
// non-finite LSE takes LSE = +inf, so its P is 2^-inf = 0 on every tile
// without a mask.  Per key tile: S = Q K^T and dP = dO V^T; dS = P (dP -
// delta) in the dP accumulators; dQ += dS K.  dQ is scaled once on store.
constexpr int kTf32TileK = 32;  // keys of K2's streamed tiles

template <int D>
constexpr size_t dq_tf32_smem_bytes() {
  // the Q and dO tiles and a two-stage ring of K and V tiles, all fp32 at
  // row stride D + 4
  return sizeof(float) * (size_t(2) * kTile + size_t(4) * kTf32TileK) *
         (D + 4);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, D == 64 ? 3 : 1)
flash_bwd_dq_tf32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ o,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         float* __restrict__ dq, int tq, int tk, float scale,
                         int causal) {
  using mma_bf16::cp_async_commit;
  using mma_bf16::cp_async_wait;
  using mma_bf16::exp2_ftz;
  using mma_bf16::quad_sum;
  using namespace tf32;
  constexpr int BK = kTf32TileK;
  constexpr int kQElems = kTile * (D + 4), kKElems = BK * (D + 4);
  constexpr int kRowChunks = D / 16;  // 16-byte chunks of a row per lane
  extern __shared__ uint4 smem_tc[];
  float* qs = reinterpret_cast<float*>(smem_tc);
  float* dos = qs + kQElems;
  float* ks = dos + kQElems;  // stage s at ks + s * kKElems
  float* vs = ks + 2 * kKElems;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* kb = k + size_t(bh) * tk * D;
  const float* vb = v + size_t(bh) * tk * D;
  const float* ob = o + size_t(bh) * tq * D;

  // causal: the tile holding key q0 + 63 is the last one a query tile sees
  int num_kt = (tk + BK - 1) / BK;
  if (causal) num_kt = min(num_kt, (q0 + kTile + BK - 1) / BK);

  load_tile<kTile, D>(qs, q + size_t(bh) * tq * D, q0, tq, tid);
  load_tile<kTile, D>(dos, dout + size_t(bh) * tq * D, q0, tq, tid);
  cp_async_commit();
  if (num_kt > 0) {
    load_tile<BK, D>(ks, kb, 0, tk, tid);
    load_tile<BK, D>(vs, vb, 0, tk, tid);
  }
  cp_async_commit();

  // this thread's rows of the tile: rt and rt + 8; lane t of the quad takes
  // chunks t, t + 4, ... of each, O straight from device memory
  const int rt = 16 * warp + g;
  float4 ov[2][kRowChunks];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qr = q0 + rt + 8 * i;
#pragma unroll
    for (int c = 0; c < kRowChunks; ++c)
      ov[i][c] = qr < tq ? *reinterpret_cast<const float4*>(
                               ob + size_t(qr) * D + 4 * (t + 4 * c))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  cp_async_wait<1>();  // Q and dO have landed
  __syncthreads();

  float delta[2], lse2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rt + 8 * i;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kRowChunks; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(
          dos + Padded::at<D>(r, 4 * (t + 4 * c)));
      sum = fmaf(a.x, ov[i][c].x, sum);
      sum = fmaf(a.y, ov[i][c].y, sum);
      sum = fmaf(a.z, ov[i][c].z, sum);
      sum = fmaf(a.w, ov[i][c].w, sum);
    }
    delta[i] = quad_sum(sum);
    const float l = q0 + r < tq ? lse[size_t(bh) * tq + q0 + r] : -INFINITY;
    lse2[i] = isfinite(l) ? l * kLog2e : INFINITY;
  }

  float acc[D / 8][4];
  zero(acc);
  const float sl2 = scale * kLog2e;
  const int wq0 = q0 + 16 * warp;  // this warp's first query row

  for (int kt = 0; kt < num_kt; ++kt) {
    const int k0 = kt * BK;
    if (kt + 1 < num_kt) {
      const int nxt = ((kt + 1) & 1) * kKElems;
      load_tile<BK, D>(ks + nxt, kb, k0 + BK, tk, tid);
      load_tile<BK, D>(vs + nxt, vb, k0 + BK, tk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile kt has landed
    __syncthreads();
    const float* kst = ks + (kt & 1) * kKElems;
    const float* vst = vs + (kt & 1) * kKElems;

    // S = Q K^T and dP = dO V^T: 16 rows x BK keys each
    float s[BK / 8][4], dp[BK / 8][4];
    zero(s);
    zero(dp);
    mma3_abt<D>(s, qs, 16 * warp, kst, lane);
    mma3_abt<D>(dp, dos, 16 * warp, vst, lane);

    // dS = P (dP - delta) in place, P = 0 where keys pass Tk or lie right
    // of the diagonal (only the ragged and diagonal tiles mask) and, as in
    // the reference, where the score is not finite
    const auto grads = [&](bool mask) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kc = k0 + 8 * j + 2 * t + (e & 1);
          const int qr = q0 + rt + 8 * (e >> 1);
          const float x = s[j][e] * sl2 - lse2[e >> 1];
          const bool ok = (!mask || (kc < tk && (!causal || qr >= kc))) &&
                          isfinite(x);
          const float p = ok ? exp2_ftz(x) : 0.f;
          dp[j][e] = p * (dp[j][e] - delta[e >> 1]);
        }
    };
    if (k0 + BK <= tk && (!causal || k0 + BK <= wq0 + 1))
      grads(false);
    else
      grads(true);

    mma3_cb<D>(acc, dp, kst, g, t);  // dQ += dS K
    __syncthreads();  // every warp is done with this stage before its refill
  }
  cp_async_wait<0>();

  store_acc<D>(dq + size_t(bh) * tq * D, wq0, tq, acc, scale, scale, g, t);
}

template <int D>
cudaError_t launch_dq_tf32(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const void* lse,
                           void* dq, int bh, int tq, int tk, float scale,
                           int causal, cudaStream_t stream) {
  const size_t smem = dq_tf32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tf32_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tq + kTile - 1) / kTile);
  flash_bwd_dq_tf32_kernel<D><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(dq), tq, tk, scale, causal);
  return cudaGetLastError();
}

// K3 in float32.  Warp w owns key rows 16w .. 16w+15 of the block's 64-row
// key tile, which stays in shared memory with the V tile; 16-query tiles
// stream Q, dO and O through the ring (small tiles keep three blocks on an
// SM at D = 64, and S^T and dP^T at 8 registers a thread beside the D of dK
// and dV).  Per query tile: delta = rowsum(dO * O) and the LSE (log2 units)
// of its rows into shared memory; S^T = K Q^T and dP^T = V dO^T; P^T =
// exp2(scale log2e S^T - LSE) and dS^T = P^T (dP^T - delta) in the
// accumulators; dV += P^T dO and dK += dS^T Q.  dK is scaled once on store.
constexpr int kTf32TileQ = 16;  // queries of K3's streamed tiles

template <int D>
constexpr size_t dkv_tf32_smem_bytes() {
  // K and V tiles and a two-stage ring of Q, dO and O tiles, all fp32 at
  // row stride D + 4, and the LSE and delta of the current query tile
  return sizeof(float) * ((size_t(2) * kTile + size_t(6) * kTf32TileQ) *
                              (D + 4) + 2 * kTf32TileQ);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, D == 64 ? 3 : 1)
flash_bwd_dkv_tf32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ o,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int tq, int tk, float scale, int causal) {
  using mma_bf16::cp_async_commit;
  using mma_bf16::cp_async_wait;
  using mma_bf16::exp2_ftz;
  using namespace tf32;
  constexpr int BQ = kTf32TileQ;
  constexpr int kKElems = kTile * (D + 4), kQElems = BQ * (D + 4);
  extern __shared__ uint4 smem_tc[];
  float* ks = reinterpret_cast<float*>(smem_tc);
  float* vs = ks + kKElems;
  float* ring = vs + kKElems;  // stage s: Q, dO, O at ring + (3s + i) kQElems
  float* lse_s = ring + 6 * kQElems;
  float* delta_s = lse_s + BQ;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* qb = q + size_t(bh) * tq * D;
  const float* ob = o + size_t(bh) * tq * D;
  const float* dob = dout + size_t(bh) * tq * D;
  const float* lseb = lse + size_t(bh) * tq;

  // causal: query rows before k0 see no key of this tile (the reference's
  // qb_start); BQ divides 64, so the first query tile starts at k0
  const int num_qt = (tq + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;
  load_tile<kTile, D>(ks, k + size_t(bh) * tk * D, k0, tk, tid);
  load_tile<kTile, D>(vs, v + size_t(bh) * tk * D, k0, tk, tid);
  if (qt0 < num_qt) {
    load_tile<BQ, D>(ring, qb, qt0 * BQ, tq, tid);
    load_tile<BQ, D>(ring + kQElems, dob, qt0 * BQ, tq, tid);
    load_tile<BQ, D>(ring + 2 * kQElems, ob, qt0 * BQ, tq, tid);
  }
  cp_async_commit();

  float adk[D / 8][4], adv[D / 8][4];
  zero(adk);
  zero(adv);
  const float sl2 = scale * kLog2e;
  const int kr0 = k0 + 16 * warp + g;  // this thread's key rows: kr0, kr0 + 8

  for (int qt = qt0; qt < num_qt; ++qt) {
    const int q0 = qt * BQ;
    const int stage = (qt - qt0) & 1;
    if (qt + 1 < num_qt) {
      float* nxt = ring + 3 * (stage ^ 1) * kQElems;
      load_tile<BQ, D>(nxt, qb, q0 + BQ, tq, tid);
      load_tile<BQ, D>(nxt + kQElems, dob, q0 + BQ, tq, tid);
      load_tile<BQ, D>(nxt + 2 * kQElems, ob, q0 + BQ, tq, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile qt (and K, V) has landed
    __syncthreads();
    const float* qst = ring + 3 * stage * kQElems;
    const float* dost = qst + kQElems;
    const float* ost = dost + kQElems;
    bool full;
    {
      // delta and LSE (log2 units) of the tile's BQ rows, kPer threads a
      // row, fp32 FMAs
      constexpr int kPer = kTcThreads / BQ;
      const int r = tid / kPer, part = tid % kPer;
      float sum = 0.f;
#pragma unroll
      for (int c = part; c < D / 4; c += kPer) {
        const float4 a =
            *reinterpret_cast<const float4*>(dost + Padded::at<D>(r, 4 * c));
        const float4 b =
            *reinterpret_cast<const float4*>(ost + Padded::at<D>(r, 4 * c));
        sum = fmaf(a.x, b.x, sum);
        sum = fmaf(a.y, b.y, sum);
        sum = fmaf(a.z, b.z, sum);
        sum = fmaf(a.w, b.w, sum);
      }
      full = dkv_tile_stats<kPer>(sum, r, part, lseb, q0, tq, k0, tk, causal,
                                  lse_s, delta_s);
    }

    // S^T = K Q^T and dP^T = V dO^T: 16 key rows x BQ queries each
    float s[BQ / 8][4], dp[BQ / 8][4];
    zero(s);
    zero(dp);
    mma3_abt<D>(s, ks, 16 * warp, qst, lane);
    mma3_abt<D>(dp, vs, 16 * warp, dost, lane);

    // P^T = exp(scale S^T - LSE) with the mask and the isfinite guards
    // (keys past Tk, rows past Tq and rows that saw no key give 0 before any
    // product, and so does a score that is not finite, as in the
    // reference: x below is finite only where S^T and the LSE are), and
    // dS^T = P^T (dP^T - delta), in place
    const auto probs = [&](bool mask) {
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);
          const int kr = kr0 + 8 * (e >> 1);
          const float x = s[j][e] * sl2 - lse_s[c];
          const bool ok = (!mask || (kr < tk && (!causal || q0 + c >= kr))) &&
                          isfinite(x);
          const float p = ok ? exp2_ftz(x) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - delta_s[c]);
        }
    };
    if (full)
      probs(false);
    else
      probs(true);

    mma3_cb<D>(adv, s, dost, g, t);  // dV += P^T dO
    mma3_cb<D>(adk, dp, qst, g, t);  // dK += dS^T Q
    __syncthreads();  // every warp is done with this stage before its refill
  }
  cp_async_wait<0>();

  store_acc<D>(dk + size_t(bh) * tk * D, k0 + 16 * warp, tk, adk, scale,
               scale, g, t);
  store_acc<D>(dv + size_t(bh) * tk * D, k0 + 16 * warp, tk, adv, 1.f, 1.f,
               g, t);
}

template <int D>
cudaError_t launch_dkv_tf32(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse,
                            void* dk, void* dv, int bh, int tq, int tk,
                            float scale, int causal, cudaStream_t stream) {
  const size_t smem = dkv_tf32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tf32_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tk + kTile - 1) / kTile);
  flash_bwd_dkv_tf32_kernel<D><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(dk), static_cast<float*>(dv), tq, tk, scale,
      causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q, o, dout, dq: (bh, tq, d); k, v:
// (bh, tk, d); lse: (bh, tq) float32; all contiguous on the current device.
int mx_flash_bwd_dq(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const void* lse,
                    void* dq, int bh, int tq, int tk, int d, int dtype,
                    float scale, int causal, void* stream) {
  if (bh <= 0 || tq <= 0 || tk < 0 || tq > 65535 * kTile)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64)
    return int(launch_dq_tf32<64>(q, k, v, o, dout, lse, dq, bh, tq, tk, scale, causal, s));
  if (dtype == 0 && d == 128)
    return int(launch_dq_tf32<128>(q, k, v, o, dout, lse, dq, bh, tq, tk, scale, causal, s));
  if (dtype == 1 && d == 64)
    return int(launch_dq_bf16<64>(q, k, v, o, dout, lse, dq, bh, tq, tk, scale, causal, s));
  if (dtype == 1 && d == 128)
    return int(launch_dq_bf16<128>(q, k, v, o, dout, lse, dq, bh, tq, tk, scale, causal, s));
  return int(cudaErrorInvalidValue);
}

// Shapes as for mx_flash_bwd_dq; dk, dv: (bh, tk, d).  tk == 0 launches
// nothing.
int mx_flash_bwd_dkv(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const void* lse,
                     void* dk, void* dv, int bh, int tq, int tk, int d,
                     int dtype, float scale, int causal, void* stream) {
  if (bh <= 0 || tq <= 0 || tk < 0 || tk > 65535 * kTile)
    return int(cudaErrorInvalidValue);
  if (tk == 0) return int(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64)
    return int(launch_dkv_tf32<64>(q, k, v, o, dout, lse, dk, dv, bh, tq, tk, scale, causal, s));
  if (dtype == 0 && d == 128)
    return int(launch_dkv_tf32<128>(q, k, v, o, dout, lse, dk, dv, bh, tq, tk, scale, causal, s));
  if (dtype == 1 && d == 64)
    return int(launch_dkv_bf16<64>(q, k, v, o, dout, lse, dk, dv, bh, tq, tk, scale, causal, s));
  if (dtype == 1 && d == 128)
    return int(launch_dkv_bf16<128>(q, k, v, o, dout, lse, dk, dv, bh, tq, tk, scale, causal, s));
  return int(cudaErrorInvalidValue);
}

// Bytes of dynamic shared memory the instantiation that mx_flash_bwd_dq
// (dkv = 0) or mx_flash_bwd_dkv (dkv = 1) launches for (d, dtype) takes; 0
// for one it does not take.
int mx_flash_bwd_smem(int dkv, int d, int dtype) {
  if (d != 64 && d != 128) return 0;
  if (dtype == 0)
    return int(dkv ? (d == 64 ? dkv_tf32_smem_bytes<64>()
                              : dkv_tf32_smem_bytes<128>())
                   : (d == 64 ? dq_tf32_smem_bytes<64>()
                              : dq_tf32_smem_bytes<128>()));
  if (dtype == 1)
    return int(dkv ? (d == 64 ? dkv_bf16_smem_bytes<64>()
                              : dkv_bf16_smem_bytes<128>())
                   : (d == 64 ? dq_bf16_smem_bytes<64>()
                              : dq_bf16_smem_bytes<128>()));
  return 0;
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
