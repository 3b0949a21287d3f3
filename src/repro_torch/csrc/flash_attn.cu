// Hopper (sm_90a) kernel of the flash-attention forward, with a plain C
// interface loaded through ctypes.
//
// It replaces the Pallas TPU kernel of src/repro/kernels/flash_attn/kernel.py
// (_kernel via flash_attention_fwd). For every (batch b, query head h,
// query row i), with KV head h / (H / Hkv) and positions aligned at the
// suffix (row i sits at rq = i + Skv - Sq):
//   s_j  = (q_i / sqrt(Dh)) . k_j                      in f32
//   s_j  = NEG_INF where causal and rq < j, or windowed and rq - j >= window
//   out  = sum_j exp(s_j - m) v_j / max(sum_j exp(s_j - m), 1e-30)
// by the online softmax over KV tiles (running max m, sum l, accumulator),
// NEG_INF = -0.7 * FLT_MAX as in the TPU kernel; the output is in q's dtype
// (f32 or bf16, round to nearest even), all arithmetic in f32.
//
// What bounds it: arithmetic. At zamba2-2.7b's prefill (S = 2048, Dh = 80)
// each query row does about 2 S Dh / 2 multiply-adds (causal) against
// 3 Dh input values of its own: hundreds of operations per byte, so the
// card's compute rate is the limit. This kernel runs on the f32 CUDA
// cores (tensor cores are a later PR's work).
//
// What the design does: the TPU grid walks the KV blocks in order and keeps
// (m, l, acc) in VMEM across grid steps; Hopper's blocks run in any order.
// So one block owns one (b, h, tile of 64 query rows) and loops over the
// KV tiles of 64 keys itself, skipping the tiles that the causal mask or
// the window hide from every row of its tile. Per KV tile:
//   1. K and V into shared memory as f32 (Q, pre-scaled, was loaded once);
//   2. the 64 x 64 scores, a 4 x 4 register tile per thread, masked and
//      written to shared memory;
//   3. four threads per row take the row's max, exp and sum (shuffles in a
//      fixed order) and update m, l and the correction factor;
//   4. acc = acc * corr + P V, a 4 x (Dh/16) register tile per thread.
// Rows of Q and K are padded to Dh + 1 floats, rows of the scores to 65,
// so lanes reading down a column hit distinct banks. Keys past Skv (the
// ragged last tile) score -inf and add exactly nothing. No atomics and a
// fixed order of every sum: results are bit-identical from run to run.
//
// Limits, checked by the wrapper: Dh in {64, 80, 96, 128, 160}, H a
// multiple of Hkv, contiguous (B, S, heads, Dh) tensors. The entry point
// launches on the caller's stream, allocates nothing, does not synchronise,
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;   // a 16 x 16 grid of threads
constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per KV tile
constexpr int kSP = kBK + 1;    // padded row of the score tile
constexpr float kNegInf = -0.7f * 3.4028234663852886e38f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__host__ __device__ __forceinline__ int smem_floats(int d) {
  return kBQ * (d + 1)      // Q, pre-scaled
         + kBK * (d + 1)    // K
         + kBK * d          // V
         + kBQ * kSP        // scores, then probabilities
         + 3 * kBQ;         // m, l, corr
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
                 int H, int Hkv, float scale, int causal, int window) {
  constexpr int DP = D + 1;
  constexpr int DT = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;               // [kBQ][D + 1]
  float* Ks = Qs + kBQ * DP;      // [kBK][D + 1]
  float* Vs = Ks + kBK * DP;      // [kBK][D]
  float* Ss = Vs + kBK * D;       // [kBQ][kBK + 1]
  float* m_s = Ss + kBQ * kSP;    // [kBQ]
  float* l_s = m_s + kBQ;         // [kBQ]
  float* c_s = l_s + kBQ;         // [kBQ]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const long long q_row = static_cast<long long>(H) * D;
  const long long kv_row = static_cast<long long>(Hkv) * D;
  const T* qb = q + static_cast<long long>(b) * Sq * q_row +
                static_cast<long long>(h) * D;
  const T* kb = k + static_cast<long long>(b) * Skv * kv_row +
                static_cast<long long>(hk) * D;
  const T* vb = v + static_cast<long long>(b) * Skv * kv_row +
                static_cast<long long>(hk) * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    float val = 0.0f;
    if (q0 + r < Sq) val = to_f32(qb[(q0 + r) * q_row + d]) * scale;
    Qs[r * DP + d] = val;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.0f;
  }

  // the KV tiles some row of this query tile can see
  const int off = Skv - Sq;
  const int r_last = min(q0 + kBQ, Sq) - 1;
  int kv_end = Skv;
  if (causal) kv_end = min(Skv, r_last + off + 1);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q0 + off - window + 1);
  const int t_begin = kv_begin / kBK;
  const int t_end = (kv_end + kBK - 1) / kBK;

  float acc[4][DT];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int c = 0; c < DT; ++c) acc[u][c] = 0.0f;
  __syncthreads();

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    // ---- 1. K and V tiles
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int j = e / D;
      const int d = e - j * D;
      float kv = 0.0f, vv = 0.0f;
      if (k0 + j < Skv) {
        kv = to_f32(kb[(k0 + j) * kv_row + d]);
        vv = to_f32(vb[(k0 + j) * kv_row + d]);
      }
      Ks[j * DP + d] = kv;
      Vs[j * D + d] = vv;
    }
    __syncthreads();
    // ---- 2. scores: rows ty * 4 + u, keys tx + 16 c
    float s[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[u][c] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) qv[u] = Qs[(ty * 4 + u) * DP + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = Ks[(tx + 16 * c) * DP + d];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[u][c] = fmaf(qv[u], kv[c], s[u][c]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = ty * 4 + u;
      const int rq = q0 + r + off;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        const int rk = k0 + j;
        float val = s[u][c];
        if (causal && rq < rk) val = kNegInf;
        if (window > 0 && rq - rk >= window) val = kNegInf;
        if (rk >= Skv) val = -INFINITY;
        Ss[r * kSP + j] = val;
      }
    }
    __syncthreads();
    // ---- 3. online softmax statistics, four threads per row
    {
      const int r = tid >> 2;
      const int part = tid & 3;
      float mx = -INFINITY;
      for (int c = part; c < kBK; c += 4) mx = fmaxf(mx, Ss[r * kSP + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int c = part; c < kBK; c += 4) {
        const float p = expf(Ss[r * kSP + c] - m_new);
        Ss[r * kSP + c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_old - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();
    // ---- 4. acc = acc * corr + P V: rows ty * 4 + u, columns tx + 16 c
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float corr = c_s[ty * 4 + u];
#pragma unroll
      for (int c = 0; c < DT; ++c) acc[u][c] *= corr;
    }
    for (int j = 0; j < kBK; ++j) {
      float pv[4], vv[DT];
#pragma unroll
      for (int u = 0; u < 4; ++u) pv[u] = Ss[(ty * 4 + u) * kSP + j];
#pragma unroll
      for (int c = 0; c < DT; ++c) vv[c] = Vs[j * D + tx + 16 * c];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < DT; ++c) acc[u][c] = fmaf(pv[u], vv[c], acc[u][c]);
    }
    __syncthreads();   // the next tile overwrites Ks, Vs and Ss
  }

  T* ob = o + static_cast<long long>(b) * Sq * q_row +
          static_cast<long long>(h) * D;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = ty * 4 + u;
    if (q0 + r < Sq) {
      const float denom = fmaxf(l_s[r], 1e-30f);
#pragma unroll
      for (int c = 0; c < DT; ++c)
        ob[(q0 + r) * q_row + tx + 16 * c] = from_f32<T>(acc[u][c] / denom);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int Hkv, float scale, int causal,
           int window, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(smem_floats(D)) * sizeof(float);
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, H, Hkv, scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               int B, int Sq, int Skv, int H, int Hkv, float scale,
               int causal, int window, cudaStream_t st) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, o, B, Sq, Skv, H, Hkv, scale, causal,
                           window, st);
    case 80:
      return launch<T, 80>(q, k, v, o, B, Sq, Skv, H, Hkv, scale, causal,
                           window, st);
    case 96:
      return launch<T, 96>(q, k, v, o, B, Sq, Skv, H, Hkv, scale, causal,
                           window, st);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Sq, Skv, H, Hkv, scale, causal,
                            window, st);
    case 160:
      return launch<T, 160>(q, k, v, o, B, Sq, Skv, H, Hkv, scale, causal,
                            window, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q: (B, Sq, H, D), k and v: (B, Skv, Hkv, D), o: like q; all contiguous,
// bf16 if is_bf16 else f32. window <= 0 means no window.
int flash_attn_fwd_launch(int is_bf16, const void* q, const void* k,
                          const void* v, void* o, int B, int Sq, int Skv,
                          int H, int Hkv, int D, float scale, int causal,
                          int window, void* stream) {
  if (Hkv < 1 || H % Hkv != 0 || B < 1 || Sq < 1 || Skv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, Sq, Skv, H, Hkv,
                                     scale, causal, window, st);
  return dispatch_d<float>(D, q, k, v, o, B, Sq, Skv, H, Hkv, scale, causal,
                           window, st);
}

}  // extern "C"
