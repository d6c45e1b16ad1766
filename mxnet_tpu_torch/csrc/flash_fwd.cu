// Flash-attention forward for Hopper (sm_90a), fp32 or bf16 inputs, D in {64, 128}.
//
// Replaces: mxnet_tpu/ops/attention.py `_flash_fwd_kernel` (launched by
// `_flash_fwd_res` through `pl.pallas_call`).  Same function:
//     O   = softmax(scale * Q K^T  [causal: q_pos >= k_pos, top-left]) V
//     LSE = m + log(l) per row, -inf (with O = 0) on a row that sees no key
// computed by online softmax with a running max m, a running sum l and an fp32
// accumulator for every query row, so the T x T score matrix never reaches
// device memory.  One thread block per (b*h, query tile); a loop over
// key/value tiles replaces the TPU's sequential grid axis.  Ragged edges (Tq,
// Tk not multiples of the tiles) are masked here: out-of-range keys score
// -inf and out-of-range query rows are not written.  Causal tiles wholly above
// the diagonal are skipped.  Two designs, one per input type:
//
// float32: tensor cores, mma.sync.m16n8k8 on TF32 operands as a 3xTF32
// split (helpers in mma_tf32.cuh, shared with the fp32 K2 and K3, which says
// why one TF32 product misses the 1e-4 rule and how x splits into hi + lo).
// What bounds it: at BERT-base's serving shape (B*H = 96, T = 512, D = 64)
// one call needs 4*B*H*T^2*D = 6.44 GFLOP, 19.3 GFLOP issued as three TF32
// products, 0.039 ms at 495 TFLOP/s, against 50 MB of Q, K, V and O, 0.015
// ms at 3.35 TB/s: operations bound it, so the design keeps the tensor cores
// fed.  The CUDA-core design before this one (256 threads, each with a 4 x 4
// fp32 score tile and a 4 x D/16 output tile of FMAs, synchronous scalar
// tile loads, P through shared memory between two barriers a key tile) ran
// at 0.2685 ms there (NVIDIA H100 80GB HBM3, 700 W), 6.9x that bound.
// * 128 threads; warp w owns query rows 16w .. 16w+15 of a 64-row query
//   tile.  The Q tile stays in shared memory at a row stride of D + 4
//   floats, multiplied in place by scale * log2e once it lands, so S comes
//   out in log2 units and the softmax runs on exp2.
// * K and V tiles of 32 keys stream through a two-stage ring of 16-byte
//   cp.async copies: tile i+1 loads while tile i is computed.
// * Per key tile: S = Q K^T (both operands by ldmatrix, split as loaded);
//   the mask, only on a tile with keys past Tk or past the diagonal for a
//   row of the warp (keys past Tk load as zero and score -inf); the online
//   softmax on the accumulators with the reference's three guards (m_safe =
//   0 on a row with no finite score, alpha = 0 while m is -inf, p = 0 where
//   S is not finite), each row's max reduced across the quad that holds it
//   and its sum kept per thread until the end; O rescaled by alpha in
//   registers; O += P V with P (hi + lo) from the S accumulators in the k
//   permutation of mma_tf32.cuh and V's rows 2t, 2t + 1 by scalar loads.  P
//   never touches shared memory and no barrier separates the products.
// * O = acc / l (l at least 1e-30) and LSE = m ln 2 + ln l (-inf, with O =
//   0, on a row that saw no key), stored from the accumulators, 8 bytes a
//   store; rows past Tq are not written.  Causal key tiles wholly above the
//   diagonal are skipped; Tk = 0 loads no tile.
// * Shared memory: 52,224 bytes at D = 64 (four blocks fit an SM),
//   101,376 at D = 128 (two); the O accumulators take D / 2 registers a
//   thread.
// * Why not wgmma: S = Q K^T could use wgmma's .tf32 form, whose operands
//   are both K-major here, but P V cannot: V is MN-major and .tf32 takes no
//   transpose, so it would need a transposed copy of each V tile first.
//   That is later work.
//
// bfloat16: wgmma + TMA, warp-specialised, persistent (helpers in
// wgmma_bf16.cuh and mma_bf16.cuh).  What bounds it: at the training shape
// (B*H = 192, T = 512, D = 64) one call moves 51 MB and needs 12.9 GFLOP,
// 0.015 ms at 3.35 TB/s against 0.013 ms at 989 TFLOP/s (0.020 ms for the
// 19.3 GFLOP the hi + lo product issues), and its softmax runs an ex2 and
// some ten other instructions on each of its 50M scores, about as long
// again on the CUDA cores.  No bound is far ahead of the others, so the time
// goes where one waits for another.  The mma.sync design before this one
// (PR 4: 128 threads, a cp.async ring with two __syncthreads a tile, 64-row
// query tiles, every block paying its own first loads) ran at 4.9x the byte
// bound (0.0737 ms, NVIDIA H100 80GB HBM3, 700 W).  This design overlaps
// the three:
// * 384 threads: warpgroups 0 and 1 consume, each owning 64 rows of a
//   128-row query tile (half the K/V refetch of 64-row tiles); warpgroup 2
//   produces: one thread issues every load by TMA (3-D tensor maps over
//   (B*H, T, D), 64-column boxes, 128-byte swizzle; a box past T zero-fills
//   and never reads the next head).  The producer gives up registers
//   (setmaxnreg 24) and the consumers take them (240).
// * Persistent: one block an SM walks the work items (head, query tile), a
//   head's tiles adjacent so the blocks in flight share K and V in L2.  The
//   producer runs ahead into the next item: Q is released when the item's
//   last S = Q K^T completes, and K and V stream through a ring of three
//   128-key stages, each with its own K and V "full" mbarriers (S starts
//   before V lands) and an "empty" mbarrier the eight consumer warps arrive
//   at.  So the first loads of an item hide under the previous one, which
//   a grid of one item a block could not do.
// * S = Q K^T by wgmma m64n128k16, both operands K-major from the swizzled
//   tiles (descriptors); the online softmax in fp32 on log2-scaled scores
//   with the TPU kernel's isfinite guards; P from the S accumulators as the
//   register A operand of O += P V (m64nDk16, V MN-major), as two bf16
//   values hi + lo (mma_bf16.cuh says why one rounding is not enough), both
//   cut by truncation with byte permutes (wgmma_bf16.cuh): two wgmma per 16
//   keys and no conversion instruction beside the softmax's ex2.
// * Each warpgroup keeps one product ahead of its softmax (S of tile j + 1
//   is issued with P V of tile j, its softmax runs under P V), and the two
//   warpgroups take turns to issue (ping-pong, as FlashAttention-3), so one
//   softmax runs under the other's products rather than both at once.
// * O and LSE are stored from registers: each quad writes 16 contiguous
//   bytes of a row below Tq; LSE = m ln 2 + ln l.
// Where it bites: a wrong descriptor field gives wrong numbers, not an
// error (wgmma_bf16.cuh documents each field); a wrong mbarrier parity hangs
// the kernel; wgmma_fence must follow every register write a wgmma reads
// (the alpha rescale of O, P's hi/lo) and nothing may touch accumulators in
// flight; setmaxnreg is honoured only where the roles split once and never
// rejoin; a branch between a wgmma and its wait made ptxas serialise the
// wgmmas, and a __trap() in the mbarrier spin made the D = 128 consumer
// spill, so neither is there.
//
// Interface: plain C, loaded with ctypes.  Pointers and the stream are
// void*; the function returns cudaGetLastError() after the launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// float32: tensor cores, 3xTF32
// ---------------------------------------------------------------------------

constexpr int kTf32BlockQ = 64;  // query rows of a block, 16 a warp
constexpr int kTf32BlockK = 32;  // keys of the streamed K and V tiles

template <int D>
constexpr size_t tf32_smem_bytes() {
  // the Q tile and a two-stage ring of K and V tiles, all fp32 at row
  // stride D + 4
  return sizeof(float) * (size_t(kTf32BlockQ) + size_t(4) * kTf32BlockK) *
         (D + 4);
}

template <int D>
__global__ void __launch_bounds__(tf32::kThreads, D == 64 ? 3 : 2)
flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int tq, int tk, float scale,
                      int causal) {
  using mma_bf16::cp_async_commit;
  using mma_bf16::cp_async_wait;
  using mma_bf16::exp2_ftz;
  using namespace tf32;
  constexpr int BQ = kTf32BlockQ, BK = kTf32BlockK;
  constexpr int kQElems = BQ * (D + 4), kKElems = BK * (D + 4);
  extern __shared__ uint4 smem_tf32[];
  float* qs = reinterpret_cast<float*>(smem_tf32);
  float* ks = qs + kQElems;  // stage s at ks + s * kKElems
  float* vs = ks + 2 * kKElems;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* kb = k + size_t(bh) * tk * D;
  const float* vb = v + size_t(bh) * tk * D;
  const int wq0 = q0 + 16 * warp;  // this warp's first query row
  const int r0 = wq0 + g;          // this thread's rows: r0 and r0 + 8

  // causal (top-left): the tile holding key q0 + BQ - 1 is the last one the
  // query tile sees; Tk = 0 loads no tile
  int num_kt = (tk + BK - 1) / BK;
  if (causal) num_kt = min(num_kt, (q0 + BQ + BK - 1) / BK);

  load_tile<BQ, D>(qs, q + size_t(bh) * tq * D, q0, tq, tid);
  cp_async_commit();
  if (num_kt > 0) {
    load_tile<BK, D>(ks, kb, 0, tk, tid);
    load_tile<BK, D>(vs, vb, 0, tk, tid);
  }
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
  __syncthreads();
  // Q times scale * log2e, in place (the reference scales q before the
  // dot): S comes out in log2 units and the softmax runs on exp2; the first
  // key tile's barrier orders these writes before any read
  const float sl2 = scale * kLog2e;
#pragma unroll
  for (int j = 0; j < BQ * D / 4 / kThreads; ++j) {
    const int i = tid + j * kThreads;  // the i-th 16-byte chunk of the tile
    float4* p = reinterpret_cast<float4*>(
        qs + Padded::at<D>(i / (D / 4), 4 * (i % (D / 4))));
    const float4 x = *p;
    *p = make_float4(x.x * sl2, x.y * sl2, x.z * sl2, x.w * sl2);
  }

  float acc[D / 8][4];
  zero(acc);
  // running max (log2 units) and this thread's share of the running sum of
  // rows r0 and r0 + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

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

    // S = (scale log2e Q) K^T: 16 rows x BK keys
    float s[BK / 8][4];
    zero(s);
    mma3_abt<D>(s, qs, 16 * warp, kst, lane);

    // keys past Tk (loaded as zeros) and past the diagonal score -inf; only
    // a tile with such a key for a row of this warp takes the element mask
    if (!(k0 + BK <= tk && (!causal || k0 + BK - 1 <= wq0))) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kc = k0 + 8 * j + 2 * t + (e & 1);
          const int qr = r0 + 8 * (e >> 1);
          if (!(kc < tk && (!causal || qr >= kc))) s[j][e] = -INFINITY;
        }
    }

    // the online softmax with the reference's three guards: m_safe = 0 on a
    // row with no finite score yet, alpha = 0 while m is -inf, p = 0 where
    // S is not finite; the row max reduces across the quad that holds it
    float mx[2] = {-INFINITY, -INFINITY}, m_safe[2], alpha[2];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], mma_bf16::quad_max(mx[i]));
      m_safe[i] = isfinite(m_new) ? m_new : 0.f;
      alpha[i] = isfinite(m[i]) ? exp2_ftz(m[i] - m_safe[i]) : 0.f;
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float p = isfinite(x) ? exp2_ftz(x - m_safe[e >> 1]) : 0.f;
        s[j][e] = p;
        l[e >> 1] += p;
      }

    // O = alpha O + P V: P (hi and lo) from the S accumulators, V's rows by
    // scalar loads
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    mma3_cb<D>(acc, s, vst, g, t);
    __syncthreads();  // every warp is done with this stage before its refill
  }
  cp_async_wait<0>();

  // O = acc / l (l at least 1e-30, so O = 0 on a row that saw no key) from
  // the accumulators; LSE = m ln 2 + ln l, -inf where no key was seen
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = mma_bf16::quad_sum(l[i]);
    inv[i] = 1.f / fmaxf(l[i], 1e-30f);
  }
  store_acc<D>(o + size_t(bh) * tq * D, wq0, tq, acc, inv[0], inv[1], g, t);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qr = r0 + 8 * i;
      if (qr < tq)
        lse[size_t(bh) * tq + qr] =
            l[i] > 0.f ? (isfinite(m[i]) ? m[i] : 0.f) * kLn2 +
                             logf(fmaxf(l[i], 1e-30f))
                       : -INFINITY;
    }
  }
}

template <int D>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, void* o,
                        void* lse, int bh, int tq, int tk, float scale,
                        int causal, cudaStream_t stream) {
  const size_t smem = tf32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tq + kTf32BlockQ - 1) / kTf32BlockQ);
  flash_fwd_tf32_kernel<D><<<grid, tf32::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), tq, tk, scale, causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma + TMA, warp-specialised, persistent
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;       // query rows of one consumer warpgroup
constexpr int kWsBlockQ = 128;    // two consumer warpgroups
constexpr int kWsBlockK = 128;    // keys a K/V tile
constexpr int kWsThreads = 384;   // warpgroups 0, 1 consume; 2 produces
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // 128 x 24 + 256 x 240 <= 65536
constexpr int kConsumerWarps = 8;

// Shared memory, from a 1024-byte-aligned base: the Q tile (128 rows), a
// ring of K tiles, a ring of V tiles (128 rows each), every tile D / 64
// swizzled regions of 128-byte rows; then the mbarriers.  Three stages:
// 113 KB at D = 64, 225 KB (of the 227 KB a block may have) at D = 128.
template <int D>
struct WsLayout {
  static constexpr int kStages = 3;
  static constexpr uint32_t kQBytes = kWsBlockQ * D * 2;
  static constexpr uint32_t kTileBytes = kWsBlockK * D * 2;
  static constexpr uint32_t kQRegion = kWsBlockQ * 128;  // bytes of 64 cols
  static constexpr uint32_t kKvRegion = kWsBlockK * 128;
  static constexpr uint32_t kK = kQBytes;
  static constexpr uint32_t kV = kK + kStages * kTileBytes;
  static constexpr uint32_t kBars = kV + kStages * kTileBytes;
  // q_full, q_empty, then k_full, v_full and empty for each stage
  static constexpr uint32_t kBytes = kBars + 8 * (2 + 3 * kStages);
  static constexpr size_t kSmem = kBytes + 1024;  // room to align the base
};

// max(a, b), NaN if either is NaN (fmaxf passes over a NaN).
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int bh_count, int tq, int tk, float scale, int causal) {
  using namespace wgmma_bf16;
  using L = WsLayout<D>;
  constexpr int S = L::kStages;
  extern __shared__ uint8_t smem_ws[];
  uint8_t* base = smem_ws + ((1024u - (smem_u32(smem_ws) & 1023u)) & 1023u);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_full + 2;
  uint64_t* v_full = k_full + S;
  uint64_t* empty = v_full + S;

  // Work items are (head, 128-row query tile), a head's tiles adjacent;
  // block b takes items b, b + gridDim.x, ...  The blocks in flight at
  // any time hold neighbouring items, so a head's tiles run together and
  // share K and V in L2.
  const int num_qt = (tq + kWsBlockQ - 1) / kWsBlockQ;
  const int num_items = bh_count * num_qt;
  const auto key_tiles = [&](int q0) {
    int n = (tk + kWsBlockK - 1) / kWsBlockK;
    if (causal)  // key tiles at or before the last row of the query tile
      n = min(n, (q0 + kWsBlockQ + kWsBlockK - 1) / kWsBlockK);
    return n;
  };
  const int tid = threadIdx.x;
  // warp-uniform to the compiler as well (as CUTLASS reads it)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);

  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumerWarps);
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // One if/else for the two roles, never rejoined: ptxas honours
  // setmaxnreg only then.
  if (wg == 2) {
    // producer: one thread issues every TMA load, running ahead into the
    // next item's Q and K/V tiles as the consumers release buffers;
    // Tk = 0 loads nothing
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 256) {
      prefetch_tensormap(&tm_q);
      prefetch_tensormap(&tm_k);
      prefetch_tensormap(&tm_v);
      int it = 0, j = 0;  // key tiles and Q tiles loaded so far
      for (int item = blockIdx.x; item < num_items; item += gridDim.x) {
        const int bh = item / num_qt, q0 = (item % num_qt) * kWsBlockQ;
        const int n = key_tiles(q0);
        if (n == 0) continue;
        if (j > 0) mbar_wait(q_empty, (j - 1) & 1);  // previous Q is done
        mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_3d(base + c * L::kQRegion, &tm_q, q_full, 64 * c, q0, bh);
        ++j;
        for (int kt = 0; kt < n; ++kt, ++it) {
          const int s = it % S;
          // the consumers' release of this stage's previous tile
          if (it >= S) mbar_wait(empty + s, ((it / S) & 1) ^ 1);
          uint8_t* kd = base + L::kK + s * L::kTileBytes;
          uint8_t* vd = base + L::kV + s * L::kTileBytes;
          mbar_expect_tx(k_full + s, L::kTileBytes);
#pragma unroll
          for (int c = 0; c < D / 64; ++c)
            tma_load_3d(kd + c * L::kKvRegion, &tm_k, k_full + s, 64 * c,
                        kt * kWsBlockK, bh);
          mbar_expect_tx(v_full + s, L::kTileBytes);
#pragma unroll
          for (int c = 0; c < D / 64; ++c)
            tma_load_3d(vd + c * L::kKvRegion, &tm_v, v_full + s, 64 * c,
                        kt * kWsBlockK, bh);
        }
      }
    }
  } else {
    // consumer warpgroup wg: query rows q0 + 64 wg .. + 63 of each item
    setmaxnreg_inc<kConsumerRegs>();
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const float sl2 = scale * kLog2e;
    if (wg == 1) named_arrive(1, 256);  // warpgroup 0 issues first
    const uint32_t q_addr = smem_u32(base) + kWgRows * 128 * wg;
    const uint32_t k_addr = smem_u32(base + L::kK);
    const uint32_t v_addr = smem_u32(base + L::kV);
    int it = 0, j = 0;  // key tiles and Q tiles consumed so far
    for (int item = blockIdx.x; item < num_items; item += gridDim.x) {
      const int bh = item / num_qt, q0 = (item % num_qt) * kWsBlockQ;
      const int n = key_tiles(q0);
      const int row_w = q0 + kWgRows * wg + 16 * warp;  // this warp's row 0
      const int r0 = row_w + g;                         // and r0 + 8
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
      float acc[D / 8][4];
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
      // S of the tile whose softmax runs next, and the P (hi + lo bf16 A
      // fragments) of the tile whose P V is in flight
      float sc[kWsBlockK / 8][4];
      uint32_t hi[kWsBlockK / 16][4], lo[kWsBlockK / 16][4];

      // S = Q K^T (64 rows x 128 keys) of key tile kt (ring slot it + kt),
      // both operands K-major from the swizzled tiles; step kk reads D
      // columns 16 kk .. 16 kk + 15.  The first step overwrites sc
      // (scale-d 0).  Issued, not waited for.
      const auto issue_s = [&](int kt) {
        const int s = (it + kt) % S;
        mbar_wait(k_full + s, ((it + kt) / S) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t col = (kk & 3) * 32;  // bytes into 128-byte rows
          const uint64_t da =
              sw128_desc(q_addr + (kk >> 2) * L::kQRegion + col, 16, 1024);
          const uint64_t db = sw128_desc(
              k_addr + s * L::kTileBytes + (kk >> 2) * L::kKvRegion + col,
              16, 1024);
          wgmma_ss_n128(sc, da, db, kk > 0 ? 1u : 0u);
        }
        wgmma_commit();
      };

      // O += P V of key tile kt: P from registers, V (keys x D, D
      // contiguous) MN-major; step kk reads keys 16 kk .. 16 kk + 15,
      // 2048 bytes on.  Issued, not waited for.
      const auto issue_pv = [&](int kt) {
        const int s = (it + kt) % S;
        mbar_wait(v_full + s, ((it + kt) / S) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWsBlockK / 16; ++kk) {
          const uint64_t db = sw128_desc(
              v_addr + s * L::kTileBytes + kk * 2048, L::kKvRegion, 1024);
          RsWgmma<D>::run(acc, hi[kk], db);
          RsWgmma<D>::run(acc, lo[kk], db);
        }
        wgmma_commit();
      };
      const auto release = [&](uint64_t* bar) {  // this warp is done
        __syncwarp();
        if (lane == 0) mbar_arrive(bar);
      };
      // Ping-pong (as FlashAttention-3): the two warpgroups take turns to
      // issue their products, warpgroup wg waiting at barrier 1 + wg for
      // the other's go, so one's softmax runs while the tensor cores work
      // on the other's products instead of both softmaxes at once.
      const auto my_turn = [&]() { named_sync(1 + wg, 256); };
      const auto your_turn = [&]() { named_arrive(2 - wg, 256); };

      // The online softmax of the S in sc (key tile kt), in place: sc
      // becomes P, m and l move on, alpha is what O must be scaled by
      // before this P V.  Scores are scaled to log2 units and masked; the
      // TPU kernel's isfinite guards keep a fully masked tile or row free
      // of NaN; l is this thread's share of the row sum until the end.
      // Keys past Tk loaded as zeros and still need -inf: only a tile with
      // keys past Tk, or past the diagonal for a row of this warp, takes
      // the element mask.  The row max propagates NaN (max.NaN), so a
      // thread whose scores are all finite or -inf, the case of finite
      // inputs, knows it and skips the per-element guard, which 2^-inf = 0
      // makes redundant there; a NaN or +inf score takes the guarded path.
      const auto softmax = [&](int kt) {
        const int k0 = kt * kWsBlockK;
        float mx[2] = {-INFINITY, -INFINITY};
        const auto scale_mask = [&](bool mask) {
#pragma unroll
          for (int c = 0; c < kWsBlockK / 8; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kc = k0 + 8 * c + 2 * t + (e & 1);
              const int qr = r0 + 8 * (e >> 1);
              const bool ok = !mask || (kc < tk && (!causal || qr >= kc));
              sc[c][e] = ok ? sc[c][e] * sl2 : -INFINITY;
              mx[e >> 1] = max_nan(mx[e >> 1], sc[c][e]);
            }
        };
        if (k0 + kWsBlockK <= tk &&
            (!causal || k0 + kWsBlockK - 1 <= row_w))
          scale_mask(false);
        else
          scale_mask(true);
        const bool guarded = !(mx[0] < INFINITY && mx[1] < INFINITY);
        if (guarded) {  // the reference's max, which passes over NaN
          mx[0] = mx[1] = -INFINITY;
#pragma unroll
          for (int c = 0; c < kWsBlockK / 8; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              mx[e >> 1] = fmaxf(mx[e >> 1], sc[c][e]);
        }
        float m_safe[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float m_new = fmaxf(m[i], mma_bf16::quad_max(mx[i]));
          m_safe[i] = isfinite(m_new) ? m_new : 0.f;
          alpha[i] =
              isfinite(m[i]) ? mma_bf16::exp2_ftz(m[i] - m_safe[i]) : 0.f;
          m[i] = m_new;
          l[i] *= alpha[i];
        }
        const auto exp_rows = [&](bool guard) {
#pragma unroll
          for (int c = 0; c < kWsBlockK / 8; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float x = sc[c][e];
              const float p = !guard || isfinite(x)
                                  ? mma_bf16::exp2_ftz(x - m_safe[e >> 1])
                                  : 0.f;
              sc[c][e] = p;
              l[e >> 1] += p;
            }
        };
        if (guarded)
          exp_rows(true);
        else
          exp_rows(false);
      };

      // O = alpha O, then P into hi + lo: the registers of the previous
      // P V, so only once it has completed
      const auto rescale_split = [&]() {
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          acc[c][0] *= alpha[0];
          acc[c][1] *= alpha[0];
          acc[c][2] *= alpha[1];
          acc[c][3] *= alpha[1];
        }
#pragma unroll
        for (int kk = 0; kk < kWsBlockK / 16; ++kk)
          split_a_trunc(sc[2 * kk], sc[2 * kk + 1], hi[kk], lo[kk]);
      };

      // One product ahead of the softmax: S of key tile kt + 1 is issued
      // before P V of tile kt, and its softmax runs while P V does, so the
      // tensor cores and the softmax overlap within the warpgroup (and the
      // two warpgroups overlap besides).  Groups complete in commit order:
      // wait_group 1 is S of kt + 1, wait_group 0 also P V.  Q is released
      // once the item's last S has completed, so the producer loads the
      // next item's Q under this item's last products and its epilogue.
      // The step that issues the last S and the last P V are peeled off:
      // no branch sits between a wgmma and its wait (with one, ptxas
      // serialised the wgmmas).
      if (n > 0) {
        mbar_wait(q_full, j & 1);
        ++j;
        my_turn();
        issue_s(0);
        your_turn();
        wgmma_wait<0>();
        fence_acc(sc);
        if (n == 1) release(q_empty);
        softmax(0);
        rescale_split();
        for (int kt = 0; kt + 2 < n; ++kt) {
          my_turn();
          issue_s(kt + 1);
          issue_pv(kt);
          your_turn();
          wgmma_wait<1>();
          fence_acc(sc);
          softmax(kt + 1);
          wgmma_wait<0>();
          fence_acc(acc);
          release(empty + (it + kt) % S);
          rescale_split();
        }
        if (n >= 2) {
          my_turn();
          issue_s(n - 1);
          issue_pv(n - 2);
          your_turn();
          wgmma_wait<1>();
          fence_acc(sc);
          release(q_empty);
          softmax(n - 1);
          wgmma_wait<0>();
          fence_acc(acc);
          release(empty + (it + n - 2) % S);
          rescale_split();
        }
        my_turn();
        issue_pv(n - 1);
        your_turn();
        wgmma_wait<0>();
        fence_acc(acc);
        release(empty + (it + n - 1) % S);
        it += n;
      }

      // O = acc / l stored from registers (each quad writes 16 contiguous
      // bytes of a row; the rows below Tq only); LSE = m ln 2 + ln l, -inf
      // where no key was seen
      float inv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] = mma_bf16::quad_sum(l[i]);
        inv[i] = 1.f / fmaxf(l[i], 1e-30f);
      }
      __nv_bfloat16* ob = o + size_t(bh) * tq * D;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qr = r0 + 8 * i;
        if (qr >= tq) continue;
#pragma unroll
        for (int c = 0; c < D / 8; ++c)
          *reinterpret_cast<uint32_t*>(ob + size_t(qr) * D + 8 * c + 2 * t) =
              mma_bf16::pack_bf16x2(acc[c][2 * i] * inv[i],
                                    acc[c][2 * i + 1] * inv[i]);
        if (t == 0)
          lse[size_t(bh) * tq + qr] =
              l[i] > 0.f ? (isfinite(m[i]) ? m[i] : 0.f) * kLn2 +
                               logf(fmaxf(l[i], 1e-30f))
                         : -INFINITY;
      }
    }
    // take warpgroup 1's last go, so both barriers end balanced
    if (wg == 0) named_sync(1, 256);
  }
}

// cuTensorMapEncodeTiled from the driver, found at run time so that the
// library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A (bh, t, d) contiguous bf16 tensor as a 3-D map with (64, rows, 1)
// boxes and 128-byte swizzle: a box past row t zero-fills and never reads
// the next head's rows.  The base must be 16-byte aligned (the wrapper
// checks) and the strides are 16-byte multiples for d in {64, 128}.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int bh, int t, int d,
                     int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {cuuint64_t(d), cuuint64_t(t), cuuint64_t(bh)};
  const cuuint64_t strides[2] = {cuuint64_t(d) * 2, cuuint64_t(t) * d * 2};
  const cuuint32_t box[3] = {64, cuuint32_t(rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        void* lse, int bh, int tq, int tk, float scale,
                        int causal, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = make_map(&tm_q, q, bh, tq, D, kWsBlockQ);
  if (err != cudaSuccess) return err;
  if (tk > 0) {
    if ((err = make_map(&tm_k, k, bh, tk, D, kWsBlockK)) != cudaSuccess ||
        (err = make_map(&tm_v, v, bh, tk, D, kWsBlockK)) != cudaSuccess)
      return err;
  } else {  // no key tile is loaded: any valid map will do
    tm_k = tm_q;
    tm_v = tm_q;
  }
  const size_t smem = WsLayout<D>::kSmem;
  err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return err;
  const long long items = (long long)bh * ((tq + kWsBlockQ - 1) / kWsBlockQ);
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  // persistent: one block an SM (at most one an item), each walking items
  const unsigned blocks = unsigned(items < sms ? items : sms);
  flash_fwd_bf16_kernel<D><<<blocks, kWsThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), bh, tq, tk, scale, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q: (bh, tq, d), k/v: (bh, tk, d), o like
// q, lse: (bh, tq) float32, all contiguous on the current device.
int mx_flash_fwd(const void* q, const void* k, const void* v, void* o,
                 void* lse, int bh, int tq, int tk, int d, int dtype,
                 float scale, int causal, void* stream) {
  if (bh <= 0 || tq <= 0 || tk < 0 || tq > 65535 * kTf32BlockQ)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64)
    return int(launch_tf32<64>(q, k, v, o, lse, bh, tq, tk, scale, causal, s));
  if (dtype == 0 && d == 128)
    return int(launch_tf32<128>(q, k, v, o, lse, bh, tq, tk, scale, causal, s));
  if (dtype == 1 && d == 64)
    return int(launch_bf16<64>(q, k, v, o, lse, bh, tq, tk, scale, causal, s));
  if (dtype == 1 && d == 128)
    return int(launch_bf16<128>(q, k, v, o, lse, bh, tq, tk, scale, causal, s));
  return int(cudaErrorInvalidValue);
}

// Bytes of dynamic shared memory the instantiation that mx_flash_fwd
// launches for (d, dtype) takes; 0 for one it does not take.
int mx_flash_fwd_smem(int d, int dtype) {
  if (dtype == 0 && d == 64) return int(tf32_smem_bytes<64>());
  if (dtype == 0 && d == 128) return int(tf32_smem_bytes<128>());
  if (dtype == 1 && d == 64) return int(WsLayout<64>::kSmem);
  if (dtype == 1 && d == 128) return int(WsLayout<128>::kSmem);
  return 0;
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
