// Hopper (sm_90a) kernel of the Mamba2 SSD chunk scan, with a plain C
// interface loaded through ctypes.
//
// It replaces the Pallas TPU kernel of src/repro/kernels/ssd_scan/kernel.py
// (_kernel via ssd_scan). For every (batch b, head h), over the chunks of
// length Q in order, with a (P, N) state that starts at zero:
//   la   = dt * a[h],  cum = inclusive cumsum(la)           (Q,)
//   G    = (C B^T) o L,  L[i][j] = exp(cum_i - cum_j) for i >= j, else 0
//   y    = G (x dt) + exp(cum) o (C state^T)                 (Q, P)
//   state = exp(cum_last) state + (x dt)^T (B o exp(cum_last - cum))
// and the final state is written out. x, B and C are read in their dtype
// (f32 or bf16), dt and a in f32; all arithmetic is f32; y is f32.
//
// What bounds it: arithmetic. Per chunk and head it does about
// Q^2 N / 2 + Q^2 P / 2 + 2 Q P N multiply-adds on Q (P + 2N) input
// values: at zamba2-2.7b's width (Q = 128, P = 64, N = 64) that is about
// 90 multiply-adds per byte read, far above the card's f32 ratio of ~20
// operations per byte. So the design keeps every operand of a chunk in
// shared memory and computes from registers.
//
// What the design does: the TPU grid runs its chunk dimension in order and
// carries the state in VMEM across grid steps; Hopper's blocks run in any
// order. So one block owns one (b, h) and loops over its chunks itself,
// with the state in shared memory. Per chunk:
//   1. dt and la = dt a into shared memory; warp 0 takes the cumsum (each
//      lane a contiguous segment, then a shuffle scan of the lane sums);
//      all threads load B, C and x dt as f32;
//   2. for each block of 32 rows of y: G's rows (only j <= i are computed,
//      the causal half, from 4x4 register tiles over N), then y's rows from
//      G (x dt) and C state^T, written straight to device memory;
//   3. B's rows are scaled by exp(cum_last - cum_j) in place, and each
//      thread updates its own (P/8 x N/32) tile of the state.
// Rows of B and of the state are padded to N + 1 floats so that lanes
// reading a column of either hit distinct banks. No float atomics, a fixed
// order of every sum: results are bit-identical from run to run.
//
// Limits, checked by the wrapper before a launch: P and N in {32, 64, 128},
// 1 <= Q <= 128, S % Q == 0, and the shared memory of a chunk
// (ssd_scan_smem_bytes) within the card's per-block limit; there is no
// fallback to one chunk of the whole sequence. Each entry point launches on
// the caller's stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kRows = 32;       // rows of y per pass of step 2
constexpr int kMaxChunk = 128;  // 4 column groups of 32 in step 2's G tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__host__ __device__ __forceinline__ long long smem_floats(int q, int p,
                                                          int n) {
  return static_cast<long long>(q) * (n + 1)   // B, padded rows
         + static_cast<long long>(q) * n       // C
         + static_cast<long long>(q) * p       // x dt
         + static_cast<long long>(p) * (n + 1) // state, padded rows
         + static_cast<long long>(kRows) * q   // G rows of one pass
         + 2LL * q;                            // dt, cum
}

// Inclusive prefix sum of v[0..q) by one warp, in a fixed order.
__device__ __forceinline__ void warp_cumsum(float* v, int q, int lane) {
  const int per = (q + 31) / 32;
  const int i0 = lane * per;
  float run = 0.0f;
  for (int k = 0; k < per; ++k) {
    const int i = i0 + k;
    if (i < q) {
      run += v[i];
      v[i] = run;
    }
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0f;
  for (int k = 0; k < per; ++k) {
    const int i = i0 + k;
    if (i < q) v[i] += excl;
  }
  __syncwarp();
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, float* __restrict__ y,
                float* __restrict__ state_out, int S, int H, int Q,
                long long xs_b, long long xs_s, long long xs_h,
                long long bs_b, long long bs_s, long long cs_b,
                long long cs_s) {
  constexpr int NP = N + 1;
  constexpr int PY = P / 32;   // columns of y per thread in step 2
  constexpr int PS = P / 8;    // state rows per thread in step 3
  constexpr int NS = N / 32;   // state columns per thread in step 3
  extern __shared__ float smem[];
  float* Bs = smem;                // [Q][N + 1]
  float* Cs = Bs + Q * NP;         // [Q][N]
  float* Xs = Cs + Q * N;          // [Q][P]   x * dt
  float* St = Xs + Q * P;          // [P][N + 1]
  float* Gs = St + P * NP;         // [kRows][Q]
  float* dts = Gs + kRows * Q;     // [Q]
  float* cum = dts + Q;            // [Q]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid >> 5;
  const int tx = tid & 31;
  const float ah = a[h];

  for (int e = tid; e < P * NP; e += kThreads) St[e] = 0.0f;

  const int n_chunks = S / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const long long t0 = static_cast<long long>(c) * Q;
    // ---- 1. dt, log decay and its cumsum; B, C and x dt as f32
    for (int i = tid; i < Q; i += kThreads) {
      const float d = dt[(static_cast<long long>(b) * S + t0 + i) * H + h];
      dts[i] = d;
      cum[i] = d * ah;
    }
    __syncthreads();
    if (ty == 0) warp_cumsum(cum, Q, tx);
    for (int e = tid; e < Q * N; e += kThreads) {
      const int i = e / N;
      const int n = e - i * N;
      Bs[i * NP + n] = to_f32(bm[b * bs_b + (t0 + i) * bs_s + n]);
      Cs[e] = to_f32(cm[b * cs_b + (t0 + i) * cs_s + n]);
    }
    for (int e = tid; e < Q * P; e += kThreads) {
      const int i = e / P;
      const int p = e - i * P;
      Xs[e] = to_f32(x[b * xs_b + (t0 + i) * xs_s + h * xs_h + p]) * dts[i];
    }
    __syncthreads();

    // ---- 2. y, kRows rows at a time
    for (int i0 = 0; i0 < Q; i0 += kRows) {
      const int jmax = min(Q, i0 + kRows);   // causal: j <= i < i0 + kRows
      const int kg = (jmax + 31) / 32;       // column groups of G in use
      int rows[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) rows[u] = min(i0 + ty * 4 + u, Q - 1);
      // G[r][j] = (C_i . B_j) exp(cum_i - cum_j), j = tx + 32 k
      float g[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int k = 0; k < 4; ++k) g[u][k] = 0.0f;
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) cv[u] = Cs[rows[u] * N + n];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = min(tx + 32 * k, Q - 1);
          bv[k] = (k < kg) ? Bs[j * NP + n] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int k = 0; k < 4; ++k) g[u][k] = fmaf(cv[u], bv[k], g[u][k]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + ty * 4 + u;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = tx + 32 * k;
          if (j < jmax) {
            const float val = (i < Q && j <= i)
                                  ? g[u][k] * expf(cum[i] - cum[j])
                                  : 0.0f;
            Gs[(ty * 4 + u) * Q + j] = val;
          }
        }
      }
      __syncthreads();
      // y[i][p] = sum_j G[i][j] Xs[j][p] + exp(cum_i) sum_n C[i][n] St[p][n],
      // p = tx + 32 m
      float acc[4][PY], inter[4][PY];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int m = 0; m < PY; ++m) acc[u][m] = inter[u][m] = 0.0f;
      for (int j = 0; j < jmax; ++j) {
        float gv[4], xv[PY];
#pragma unroll
        for (int u = 0; u < 4; ++u) gv[u] = Gs[(ty * 4 + u) * Q + j];
#pragma unroll
        for (int m = 0; m < PY; ++m) xv[m] = Xs[j * P + tx + 32 * m];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int m = 0; m < PY; ++m)
            acc[u][m] = fmaf(gv[u], xv[m], acc[u][m]);
      }
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[PY];
#pragma unroll
        for (int u = 0; u < 4; ++u) cv[u] = Cs[rows[u] * N + n];
#pragma unroll
        for (int m = 0; m < PY; ++m) sv[m] = St[(tx + 32 * m) * NP + n];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int m = 0; m < PY; ++m)
            inter[u][m] = fmaf(cv[u], sv[m], inter[u][m]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + ty * 4 + u;
        if (i < Q) {
          const float e = expf(cum[i]);
          float* yrow = y + ((static_cast<long long>(b) * S + t0 + i) * H + h)
                                * P;
#pragma unroll
          for (int m = 0; m < PY; ++m)
            yrow[tx + 32 * m] = acc[u][m] + e * inter[u][m];
        }
      }
      __syncthreads();   // Gs is rewritten by the next pass
    }

    // ---- 3. state = exp(cum_last) state + (x dt)^T (B o exp(cum_last - cum))
    const float cl = cum[Q - 1];
    for (int e = tid; e < Q * N; e += kThreads) {
      const int i = e / N;
      const int n = e - i * N;
      Bs[i * NP + n] *= expf(cl - cum[i]);
    }
    __syncthreads();
    float s[PS][NS];
#pragma unroll
    for (int pp = 0; pp < PS; ++pp)
#pragma unroll
      for (int nn = 0; nn < NS; ++nn) s[pp][nn] = 0.0f;
    for (int j = 0; j < Q; ++j) {
      float xv[PS], bv[NS];
#pragma unroll
      for (int pp = 0; pp < PS; ++pp) xv[pp] = Xs[j * P + ty * PS + pp];
#pragma unroll
      for (int nn = 0; nn < NS; ++nn) bv[nn] = Bs[j * NP + tx + 32 * nn];
#pragma unroll
      for (int pp = 0; pp < PS; ++pp)
#pragma unroll
        for (int nn = 0; nn < NS; ++nn)
          s[pp][nn] = fmaf(xv[pp], bv[nn], s[pp][nn]);
    }
    const float ecl = expf(cl);
#pragma unroll
    for (int pp = 0; pp < PS; ++pp)
#pragma unroll
      for (int nn = 0; nn < NS; ++nn) {
        const int idx = (ty * PS + pp) * NP + tx + 32 * nn;
        St[idx] = ecl * St[idx] + s[pp][nn];
      }
    __syncthreads();   // the next chunk overwrites Bs, Xs, dts and cum
  }

  float* out = state_out + (static_cast<long long>(b) * H + h) * P * N;
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N;
    const int n = e - p * N;
    out[e] = St[p * NP + n];
  }
}

template <typename T, int P, int N>
int launch(const void* x, const float* dt, const float* a, const void* bm,
           const void* cm, float* y, float* state, int B, int S, int H,
           int Q, long long xs_b, long long xs_s, long long xs_h,
           long long bs_b, long long bs_s, long long cs_b, long long cs_s,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(smem_floats(Q, P, N)) *
                      sizeof(float);
  auto kern = ssd_scan_kernel<T, P, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), y, state, S, H, Q, xs_b, xs_s, xs_h, bs_b,
      bs_s, cs_b, cs_s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
int dispatch_n(int N, const void* x, const float* dt, const float* a,
               const void* bm, const void* cm, float* y, float* state, int B,
               int S, int H, int Q, long long xs_b, long long xs_s,
               long long xs_h, long long bs_b, long long bs_s, long long cs_b,
               long long cs_s, cudaStream_t stream) {
  switch (N) {
    case 32:
      return launch<T, P, 32>(x, dt, a, bm, cm, y, state, B, S, H, Q, xs_b,
                              xs_s, xs_h, bs_b, bs_s, cs_b, cs_s, stream);
    case 64:
      return launch<T, P, 64>(x, dt, a, bm, cm, y, state, B, S, H, Q, xs_b,
                              xs_s, xs_h, bs_b, bs_s, cs_b, cs_s, stream);
    case 128:
      return launch<T, P, 128>(x, dt, a, bm, cm, y, state, B, S, H, Q, xs_b,
                               xs_s, xs_h, bs_b, bs_s, cs_b, cs_s, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_p(int P, int N, const void* x, const float* dt, const float* a,
               const void* bm, const void* cm, float* y, float* state, int B,
               int S, int H, int Q, long long xs_b, long long xs_s,
               long long xs_h, long long bs_b, long long bs_s, long long cs_b,
               long long cs_s, cudaStream_t stream) {
  switch (P) {
    case 32:
      return dispatch_n<T, 32>(N, x, dt, a, bm, cm, y, state, B, S, H, Q,
                               xs_b, xs_s, xs_h, bs_b, bs_s, cs_b, cs_s,
                               stream);
    case 64:
      return dispatch_n<T, 64>(N, x, dt, a, bm, cm, y, state, B, S, H, Q,
                               xs_b, xs_s, xs_h, bs_b, bs_s, cs_b, cs_s,
                               stream);
    case 128:
      return dispatch_n<T, 128>(N, x, dt, a, bm, cm, y, state, B, S, H, Q,
                                xs_b, xs_s, xs_h, bs_b, bs_s, cs_b, cs_s,
                                stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs for chunk q.
long long ssd_scan_smem_bytes(int q, int p, int n) {
  return smem_floats(q, p, n) * static_cast<long long>(sizeof(float));
}

// The largest chunk the kernel's register tiles take.
int ssd_scan_max_chunk() { return kMaxChunk; }

// The current device's opt-in shared memory per block, or -1.
int ssd_scan_max_smem() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return v;
}

// x: (B, S, H, P) with strides (xs_b, xs_s, xs_h, 1); dt: (B, S, H) f32
// contiguous; a: (H,) f32; bm, cm: (B, S, N) with strides (*_b, *_s, 1);
// y: (B, S, H, P) f32 contiguous; state: (B, H, P, N) f32 contiguous.
// is_bf16 selects the dtype of x, bm and cm (f32 otherwise).
int ssd_scan_launch(int is_bf16, const void* x, const float* dt,
                    const float* a, const void* bm, const void* cm, float* y,
                    float* state, int B, int S, int H, int P, int N, int Q,
                    long long xs_b, long long xs_s, long long xs_h,
                    long long bs_b, long long bs_s, long long cs_b,
                    long long cs_s, void* stream) {
  if (Q < 1 || Q > kMaxChunk || S % Q != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_p<__nv_bfloat16>(P, N, x, dt, a, bm, cm, y, state, B, S,
                                     H, Q, xs_b, xs_s, xs_h, bs_b, bs_s, cs_b,
                                     cs_s, st);
  return dispatch_p<float>(P, N, x, dt, a, bm, cm, y, state, B, S, H, Q,
                           xs_b, xs_s, xs_h, bs_b, bs_s, cs_b, cs_s, st);
}

}  // extern "C"
