// Flash-attention forward for Hopper (sm_90a), fp32 or bf16 inputs, D in {64, 128}.
//
// Replaces: mxnet_tpu/ops/attention.py `_flash_fwd_kernel` (launched by
// `_flash_fwd_res` through `pl.pallas_call`).  Same function:
//     O   = softmax(scale * Q K^T  [causal: q_pos >= k_pos, top-left]) V
//     LSE = m + log(l) per row, -inf (with O = 0) on a row that sees no key
// computed by online softmax with a running max m, a running sum l and an fp32
// accumulator for every query row, so the T x T score matrix never reaches
// device memory.  One thread block per (b*h, 64-row query tile); a loop over
// 64-row key/value tiles replaces the TPU's sequential grid axis.  Ragged
// edges (Tq, Tk not multiples of 64) are masked here: out-of-range keys score
// -inf and out-of-range query rows are not written.  Causal tiles wholly above
// the diagonal are skipped.  Two designs, one per input type:
//
// float32: CUDA cores.  256 threads: thread (ty, tx) = (tid / 16, tid % 16)
// owns query rows 4*ty .. 4*ty+3, the score columns tx + 16*j (j < 4) of each
// key tile, and the output columns 64*g + 4*tx .. +3 (g < D/64).  The 16
// threads that share a row set sit in one half-warp, so the row max and row
// sum reduce with __shfl_xor_sync.  The fp32 path must agree with the plain
// version to 1e-4, which TF32 tensor cores cannot.  At BERT-base's shape
// (B*H = 96, T = 512, D = 64) one call does 4*B*H*T^2*D = 6.4 GFLOP on 50 MB
// of Q, K, V and O: about 130 operations per byte, so on CUDA cores (67
// TFLOP/s fp32, 3.35 TB/s on an H100 SXM) the floating-point rate bounds it.
// The inner loops stay FMA-bound rather than shared-memory-bound: operands
// are read as float4, Q and K tiles use a row stride of D + 4 floats so the
// eight threads of each 128-bit access phase hit distinct bank groups, and
// each thread carries a 4 x 4 score tile and a 4 x (D/16) output tile in
// registers.
//
// bfloat16: tensor cores (mma.sync m16n8k16, helpers in mma_bf16.cuh).  128
// threads; warp w owns query rows 16w .. 16w+15 of the tile, so a row's max
// and sum reduce over the four lanes of a quad.  Tiles stay bf16 in shared
// memory, XOR-swizzled, filled by 16-byte cp.async copies: Q once, K and V
// through a two-stage ring, so tile i+1 loads while tile i is computed.  Per
// key tile: S = Q K^T (Q and K by ldmatrix), scaled
// in fp32, then the online softmax in fp32 (exp2 of log2-scaled scores), then
// O += P V with P taken from the S accumulators in registers (V by
// ldmatrix.trans): no shared-memory P tile and no barrier between the two
// products.  P enters the product as two bf16 values, hi + lo (mma_bf16.cuh
// says why one rounding is not enough), so P V costs two mma each.  At the
// training shape (B*H = 192, T = 512, D = 64) one call moves 51 MB and needs
// 12.9 GFLOP: 0.015 ms at 3.35 TB/s against 0.013 ms at 989 TFLOP/s (0.020 ms
// for the 19.3 GFLOP the hi/lo product issues).  Bytes and tensor-core time
// are that close, so what decides the time is keeping loads in flight under
// the arithmetic and P out of shared memory, not wgmma's issue rate.  O is
// staged through the warp's rows of the Q tile and written with 16-byte
// stores.  wgmma/TMA pipelines are later work.
//
// Interface: plain C, loaded with ctypes.  Pointers and the stream are
// void*; the function returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kPStride = kBlockK + 4;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }

template <int D>
constexpr size_t smem_bytes() {
  // Q and K tiles (stride D + 4), V tile (stride D), P tile (stride kPStride)
  return sizeof(float) *
         (size_t(kBlockQ) * (D + 4) + size_t(kBlockK) * (D + 4) +
          size_t(kBlockK) * D + size_t(kBlockQ) * kPStride);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int tq, int tk, float scale,
                 int causal) {
  constexpr int kQS = D + 4;
  constexpr int kGroups = D / 64;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kBlockQ * kQS;
  float* vs = ks + kBlockK * kQS;
  float* ps = vs + kBlockK * D;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const size_t q_base = size_t(bh) * tq * D;
  const size_t kv_base = size_t(bh) * tk * D;

  // Q tile, pre-scaled as the TPU kernel does (q * scale, then the dot).
  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int qr = q0 + r;
    qs[r * kQS + c] =
        qr < tq ? load_f32(q + q_base + size_t(qr) * D + c) * scale : 0.f;
  }

  float m[4], l[4], acc[4][kGroups][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;
  }

  int num_kt = (tk + kBlockK - 1) / kBlockK;
  if (causal) {
    // only key tiles at or before this query tile contribute
    const int lim = (q0 + kBlockQ + kBlockK - 1) / kBlockK;
    num_kt = min(num_kt, lim);
  }

  for (int kt = 0; kt < num_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's readers are done with ks/vs/ps
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int kr = k0 + r;
      const bool in = kr < tk;
      const size_t g = kv_base + size_t(kr) * D + c;
      ks[r * kQS + c] = in ? load_f32(k + g) : 0.f;
      vs[r * D + c] = in ? load_f32(v + g) : 0.f;
    }
    __syncthreads();

    // S = (scale Q) K^T for rows 4*ty + i, key columns tx + 16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&qs[(4 * ty + i) * kQS + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&ks[(tx + 16 * j) * kQS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

    // mask, then the online-softmax update with the TPU kernel's isfinite
    // guards, so a fully masked tile or row gives no NaN
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = k0 + tx + 16 * j;
        const bool ok = kc < tk && (!causal || qr >= kc);
        s[i][j] = ok ? s[i][j] : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float alpha = isfinite(m[i]) ? expf(m[i] - m_safe) : 0.f;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = isfinite(s[i][j]) ? expf(s[i][j] - m_safe) : 0.f;
        s[i][j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(4 * ty + i) * kPStride + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    // acc += P V for rows 4*ty + i, output columns 64*g + 4*tx .. +3
#pragma unroll 2
    for (int kk = 0; kk < kBlockK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&ps[(4 * ty + i) * kPStride + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          const float4 vv =
              *reinterpret_cast<const float4*>(&vs[(kk + u) * D + 64 * g + 4 * tx]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y : u == 2 ? pv[i].z : pv[i].w;
            acc[i][g][0] = fmaf(p, vv.x, acc[i][g][0]);
            acc[i][g][1] = fmaf(p, vv.y, acc[i][g][1]);
            acc[i][g][2] = fmaf(p, vv.z, acc[i][g][2]);
            acc[i][g][3] = fmaf(p, vv.w, acc[i][g][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + 4 * ty + i;
    if (qr >= tq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + q_base + size_t(qr) * D;
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store_f32(orow + 64 * g + 4 * tx + e, acc[i][g][e] / denom);
    if (tx == 0)
      lse[size_t(bh) * tq + qr] =
          l[i] > 0.f ? (isfinite(m[i]) ? m[i] : 0.f) + logf(denom) : -INFINITY;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int tq, int tk, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tq + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      tq, tk, scale, causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;  // four warps, 16 query rows each
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
constexpr size_t tc_smem_bytes() {
  // the Q tile and a two-stage ring of K and V tiles, all bf16
  return sizeof(__nv_bfloat16) * (size_t(kBlockQ) * D + size_t(4) * kBlockK * D);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, D == 64 ? 3 : 1)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int tq, int tk, float scale, int causal) {
  using namespace mma_bf16;
  constexpr int kTileElems = kBlockK * D;
  extern __shared__ uint4 smem_tc[];
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* ks = qs + kBlockQ * D;  // stage s at ks + s * kTileElems
  bf16* vs = ks + 2 * kTileElems;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qb = q + size_t(bh) * tq * D;
  const bf16* kb = k + size_t(bh) * tk * D;
  const bf16* vb = v + size_t(bh) * tk * D;

  int num_kt = (tk + kBlockK - 1) / kBlockK;
  if (causal) num_kt = min(num_kt, (q0 + kBlockQ + kBlockK - 1) / kBlockK);

  if (num_kt > 0) {
    cp_async_tile<kBlockQ, D, kTcThreads>(qs, qb, q0, tq, tid);
    cp_async_tile<kBlockK, D, kTcThreads>(ks, kb, 0, tk, tid);
    cp_async_tile<kBlockK, D, kTcThreads>(vs, vb, 0, tk, tid);
  }
  cp_async_commit();

  // this thread's rows are r0 and r0 + 8; m is kept in log2 units
  const int r0 = q0 + 16 * warp + g;
  const float sl2 = scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < num_kt; ++kt) {
    const int k0 = kt * kBlockK;
    if (kt + 1 < num_kt) {
      const int nxt = ((kt + 1) & 1) * kTileElems;
      cp_async_tile<kBlockK, D, kTcThreads>(ks + nxt, kb, k0 + kBlockK, tk, tid);
      cp_async_tile<kBlockK, D, kTcThreads>(vs + nxt, vb, k0 + kBlockK, tk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile kt (and Q) has landed
    __syncthreads();
    const bf16* kst = ks + (kt & 1) * kTileElems;
    const bf16* vst = vs + (kt & 1) * kTileElems;

    // S = Q K^T: 16 rows x 64 keys, eight n8 tiles of fp32 accumulators
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldsm_a<D>(a, qs, 16 * warp, 16 * kk, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_b_nk<D>(b, kst, 16 * np, 16 * kk, lane);
        mma(s[2 * np], a, b[0], b[1]);
        mma(s[2 * np + 1], a, b[2], b[3]);
      }
    }

    // scale (log2 units) and mask, then the online-softmax update with the
    // TPU kernel's isfinite guards, so a fully masked tile or row gives no
    // NaN; l is this thread's share of the row sum until the end.  Only a
    // tile with keys past Tk, or past the diagonal for a row of this warp,
    // needs the mask.
    float mx[2] = {-INFINITY, -INFINITY};
    const auto scale_mask = [&](bool mask) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kc = k0 + 8 * j + 2 * t + (e & 1);
          const int qr = r0 + 8 * (e >> 1);
          const bool ok = !mask || (kc < tk && (!causal || qr >= kc));
          s[j][e] = ok ? s[j][e] * sl2 : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
    };
    if (k0 + kBlockK <= tk && (!causal || k0 + kBlockK <= q0 + 16 * warp + 1))
      scale_mask(false);
    else
      scale_mask(true);
    float m_safe[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      m_safe[i] = isfinite(m_new) ? m_new : 0.f;
      const float alpha = isfinite(m[i]) ? exp2_ftz(m[i] - m_safe[i]) : 0.f;
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * i] *= alpha;
        acc[n][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float p = isfinite(x) ? exp2_ftz(x - m_safe[e >> 1]) : 0.f;
        s[j][e] = p;
        l[e >> 1] += p;
      }

    // O += P V: P (hi and lo) from the S accumulators, V by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_a(s[2 * kk], s[2 * kk + 1], hi, lo);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t b[4];
        ldsm_b_kn<D>(b, vst, 16 * np, 16 * kk, lane);
        mma(acc[2 * np], hi, b[0], b[1]);
        mma(acc[2 * np + 1], hi, b[2], b[3]);
        mma(acc[2 * np], lo, b[0], b[1]);
        mma(acc[2 * np + 1], lo, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }
  cp_async_wait<0>();
  __syncthreads();

  // O = acc / l through this warp's rows of the Q tile, 16-byte stores;
  // LSE = m ln 2 + ln l, -inf where no key was seen
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l[i]);
    inv[i] = 1.f / fmaxf(l[i], 1e-30f);
  }
  acc_to_tile<D>(qs, 16 * warp, acc, inv[0], inv[1], lane);
  __syncwarp();
  store_rows16<D>(o + size_t(bh) * tq * D, qs, 16 * warp, q0 + 16 * warp, tq,
                  lane);
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
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        void* lse, int bh, int tq, int tk, float scale,
                        int causal, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tq + kBlockQ - 1) / kBlockQ);
  flash_fwd_bf16_kernel<D><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), tq, tk, scale, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q: (bh, tq, d), k/v: (bh, tk, d), o like
// q, lse: (bh, tq) float32, all contiguous on the current device.
int mx_flash_fwd(const void* q, const void* k, const void* v, void* o,
                 void* lse, int bh, int tq, int tk, int d, int dtype,
                 float scale, int causal, void* stream) {
  if (bh <= 0 || tq <= 0 || tk < 0 || tq > 65535 * kBlockQ)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64)
    return int(launch<float, 64>(q, k, v, o, lse, bh, tq, tk, scale, causal, s));
  if (dtype == 0 && d == 128)
    return int(launch<float, 128>(q, k, v, o, lse, bh, tq, tk, scale, causal, s));
  if (dtype == 1 && d == 64)
    return int(launch_bf16<64>(q, k, v, o, lse, bh, tq, tk, scale, causal, s));
  if (dtype == 1 && d == 128)
    return int(launch_bf16<128>(q, k, v, o, lse, bh, tq, tk, scale, causal, s));
  return int(cudaErrorInvalidValue);
}

// Bytes of dynamic shared memory the instantiation that mx_flash_fwd
// launches for (d, dtype) takes; 0 for one it does not take.
int mx_flash_fwd_smem(int d, int dtype) {
  if (dtype == 0 && d == 64) return int(smem_bytes<64>());
  if (dtype == 0 && d == 128) return int(smem_bytes<128>());
  if (dtype == 1 && d == 64) return int(tc_smem_bytes<64>());
  if (dtype == 1 && d == 128) return int(tc_smem_bytes<128>());
  return 0;
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
