// Flash-attention forward for Hopper (sm_90a), fp32 or bf16 inputs, D in {64, 128}.
//
// Replaces: mxnet_tpu/ops/attention.py `_flash_fwd_kernel` (launched by
// `_flash_fwd_res` through `pl.pallas_call`).  Same function:
//     O   = softmax(scale * Q K^T  [causal: q_pos >= k_pos, top-left]) V
//     LSE = m + log(l) per row, -inf (with O = 0) on a row that sees no key
// computed by online softmax with a running max m, a running sum l and an fp32
// accumulator for every query row, so the T x T score matrix never reaches
// device memory.
//
// Design.  One thread block per (b*h, 64-row query tile); a loop over 64-row
// key/value tiles staged in shared memory replaces the TPU's sequential grid
// axis.  256 threads: thread (ty, tx) = (tid / 16, tid % 16) owns query rows
// 4*ty .. 4*ty+3, the score columns tx + 16*j (j < 4) of each key tile, and the
// output columns 64*g + 4*tx .. +3 (g < D/64).  The 16 threads that share a
// row set sit in one half-warp, so the row max and row sum reduce with
// __shfl_xor_sync.  All arithmetic is fp32 on CUDA cores: the fp32 path must
// agree with the plain version to 1e-4, which TF32 tensor cores cannot.
//
// What bounds it.  At BERT-base's shape (B*H = 96, T = 512, D = 64) one call
// does 4*B*H*T^2*D = 6.4 GFLOP on 50 MB (fp32) of Q, K, V and O: about 130
// operations per byte, so on CUDA cores (67 TFLOP/s fp32, 3.35 TB/s on an H100
// SXM) the floating-point rate bounds it, not memory.  The design keeps the
// inner loops FMA-bound rather than shared-memory-bound: operands are read as
// float4, Q and K tiles use a row stride of D + 4 floats so the eight threads
// of each 128-bit access phase hit distinct bank groups, and each thread
// carries a 4 x 4 score tile and a 4 x (D/16) output tile in registers.  Ragged
// edges (Tq, Tk not multiples of 64) are masked here: out-of-range keys score
// -inf and out-of-range query rows are not written.  Causal tiles wholly above
// the diagonal are skipped.  wgmma/TMA pipelines are later work.
//
// Interface: plain C, loaded with ctypes.  Pointers and the stream are
// void*; the function returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kPStride = kBlockK + 4;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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
    return int(launch<__nv_bfloat16, 64>(q, k, v, o, lse, bh, tq, tk, scale, causal, s));
  if (dtype == 1 && d == 128)
    return int(launch<__nv_bfloat16, 128>(q, k, v, o, lse, bh, tq, tk, scale, causal, s));
  return int(cudaErrorInvalidValue);
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
