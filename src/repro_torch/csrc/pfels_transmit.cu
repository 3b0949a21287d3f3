// Hopper (sm_90a) kernels of the fused PFELS transmit pipeline
// (Alg. 2 lines 12-15), with a plain C interface loaded through ctypes.
//
// They replace the two Pallas TPU kernels of
// src/repro/kernels/pfels_transmit/kernel.py:
//   client_sumsq  (_sumsq_kernel)   per-client sum of squares of the
//                                   (r, d) update batch: pass 1 of the
//                                   transmit clip;
//   fused_combine (_combine_kernel) g_i = sum_m h_im;
//                                   y_j = sum_i g_i tx_i txm_i m_j u_ij + z_j;
//                                   E   = sum_i tx_i^2 txm_i sum_j (m_j u_ij)^2.
//
// What bounds them: both are memory-bound streams over the (r, d) f32
// update batch, with about one multiply-add per byte-quad read. At the
// main-path shape (r = 32, d = 9,222,858) client_sumsq reads 1.18 GB and
// fused_combine moves 1.29 GB (u, plus the mask, noise and y columns), so
// the card's memory rate is the whole story; the arithmetic is noise.
//
// What the design does about it: every element of u is read exactly
// once, in coalesced warp-wide rows, with several independent loads in
// flight per thread; nothing of size (r, d) is written. The TPU kernels
// carry their sums across a sequential grid, which Hopper does not have:
// its blocks run in any order. So
//   - client_sumsq runs a grid over (column chunk, client); each block
//     writes one partial, and a second small pass sums each client's
//     partials in a fixed order;
//   - fused_combine gives each block a range of columns; for every column
//     it loops over the r clients and writes y directly (no cross-block
//     reduction is needed for y); each block writes its energy partial,
//     and a second pass sums the partials in a fixed order.
// No float atomics: results are bit-identical from run to run. d is taken
// as it is; the ragged last chunk is masked in the kernel.
//
// Each entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;         // threads of the streaming kernels
constexpr int kReduceThreads = 1024;  // threads of the partial-sum pass
constexpr int kCombineCols = 4;       // columns per thread in fused_combine
constexpr int kSumsqUnroll = 4;       // loads in flight per thread in sumsq

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// Sum over the block in a fixed order; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_part[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  const int n_warps = (blockDim.x + 31) >> 5;
  v = (threadIdx.x < n_warps) ? warp_part[threadIdx.x] : 0.0f;
  if (warp == 0) v = warp_sum(v);
  return v;
}

// partial[row, chunk] = sum of u[row, j]^2 over the chunk's columns.
// grid = (n_chunks, r).
__global__ void __launch_bounds__(kThreads)
sumsq_partial_kernel(const float* __restrict__ u, float* __restrict__ partial,
                     long long d, int chunk_cols, int n_chunks) {
  const int row = blockIdx.y;
  const long long c0 = static_cast<long long>(blockIdx.x) * chunk_cols;
  const long long c1 = (c0 + chunk_cols < d) ? c0 + chunk_cols : d;
  const float* __restrict__ rowp = u + static_cast<long long>(row) * d;
  const int step = blockDim.x;
  float acc[kSumsqUnroll];
#pragma unroll
  for (int q = 0; q < kSumsqUnroll; ++q) acc[q] = 0.0f;
  long long j = c0 + threadIdx.x;
  for (; j + (kSumsqUnroll - 1) * step < c1; j += kSumsqUnroll * step) {
    float a[kSumsqUnroll];
#pragma unroll
    for (int q = 0; q < kSumsqUnroll; ++q) a[q] = __ldg(rowp + j + q * step);
#pragma unroll
    for (int q = 0; q < kSumsqUnroll; ++q) acc[q] += a[q] * a[q];
  }
  for (; j < c1; j += step) {
    const float a = __ldg(rowp + j);
    acc[0] += a * a;
  }
  float v = 0.0f;
#pragma unroll
  for (int q = 0; q < kSumsqUnroll; ++q) v += acc[q];
  v = block_sum(v);
  if (threadIdx.x == 0) {
    partial[static_cast<long long>(row) * n_chunks + blockIdx.x] = v;
  }
}

// out[row] = sum over the row's n_cols partials, in a fixed order.
// grid = (rows,).
__global__ void __launch_bounds__(kReduceThreads)
sum_rows_kernel(const float* __restrict__ partial, float* __restrict__ out,
                int n_cols) {
  const float* __restrict__ rowp =
      partial + static_cast<long long>(blockIdx.x) * n_cols;
  float acc = 0.0f;
  for (int j = threadIdx.x; j < n_cols; j += blockDim.x) acc += rowp[j];
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

// One block owns kThreads * kCombineCols consecutive columns.
// Dynamic shared memory: the r receive coefficients g_i tx_i txm_i and
// the r energy weights tx_i^2 txm_i. grid = (n_blocks,).
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ u, const float* __restrict__ mask,
               const float* __restrict__ z, const float* __restrict__ gains,
               int m_ant, const float* __restrict__ tx,
               const float* __restrict__ txm, float* __restrict__ y,
               float* __restrict__ e_partial, int r, long long d) {
  extern __shared__ float coef[];
  float* rxw = coef;
  float* wsq = coef + r;
  for (int i = threadIdx.x; i < r; i += blockDim.x) {
    float g = 0.0f;
    for (int m = 0; m < m_ant; ++m) {
      g += gains[static_cast<long long>(i) * m_ant + m];
    }
    const float t = tx[i];
    const float tm = txm[i];
    rxw[i] = g * t * tm;
    wsq[i] = t * t * tm;
  }
  __syncthreads();

  const long long base =
      static_cast<long long>(blockIdx.x) * (kThreads * kCombineCols) +
      threadIdx.x;
  long long col[kCombineCols];
  bool live[kCombineCols];
  float mj[kCombineCols];
  float acc[kCombineCols];
#pragma unroll
  for (int c = 0; c < kCombineCols; ++c) {
    col[c] = base + static_cast<long long>(c) * kThreads;
    live[c] = col[c] < d;
    mj[c] = live[c] ? __ldg(mask + col[c]) : 0.0f;
    acc[c] = 0.0f;
  }
  float e_acc = 0.0f;
  for (int i = 0; i < r; ++i) {
    const float* __restrict__ rowp = u + static_cast<long long>(i) * d;
    const float a = rxw[i];
    const float w = wsq[i];
    float ui[kCombineCols];
#pragma unroll
    for (int c = 0; c < kCombineCols; ++c) {
      ui[c] = live[c] ? __ldg(rowp + col[c]) : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < kCombineCols; ++c) {
      const float um = ui[c] * mj[c];
      acc[c] += um * a;
      e_acc += w * (um * um);
    }
  }
#pragma unroll
  for (int c = 0; c < kCombineCols; ++c) {
    if (live[c]) y[col[c]] = acc[c] + __ldg(z + col[c]);
  }
  e_acc = block_sum(e_acc);
  if (threadIdx.x == 0) e_partial[blockIdx.x] = e_acc;
}

}  // namespace

extern "C" {

// Columns of d one fused_combine block owns (the wrapper sizes the energy
// scratch from it).
int pfels_combine_cols_per_block() { return kThreads * kCombineCols; }

// u: (r, d) f32 row-major; partial: (r, ceil(d / chunk_cols)) scratch;
// out: (r,) per-client sums of squares.
int pfels_client_sumsq(const float* u, float* partial, float* out, int r,
                       long long d, int chunk_cols, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = static_cast<int>((d + chunk_cols - 1) / chunk_cols);
  sumsq_partial_kernel<<<dim3(n_chunks, r), kThreads, 0, s>>>(
      u, partial, d, chunk_cols, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_rows_kernel<<<r, kReduceThreads, 0, s>>>(partial, out, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

// u: (r, d); mask, z, y: (d,); gains: (r, m_ant); tx, txm: (r,);
// e_partial: (ceil(d / pfels_combine_cols_per_block()),) scratch;
// energy: (1,). All f32, contiguous.
int pfels_fused_combine(const float* u, const float* mask, const float* z,
                        const float* gains, int m_ant, const float* tx,
                        const float* txm, float* y, float* e_partial,
                        float* energy, int r, long long d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cols = static_cast<long long>(kThreads) * kCombineCols;
  const int n_blocks = static_cast<int>((d + cols - 1) / cols);
  const size_t smem = 2 * static_cast<size_t>(r) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        combine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  combine_kernel<<<n_blocks, kThreads, smem, s>>>(
      u, mask, z, gains, m_ant, tx, txm, y, e_partial, r, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_rows_kernel<<<1, kReduceThreads, 0, s>>>(e_partial, energy, n_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
