// Hopper (sm_90a) kernels of the global l2-norm clip, with a plain C
// interface loaded through ctypes.
//
// They replace the two Pallas TPU kernels of
// src/repro/kernels/clip_norm/kernel.py (clip_norm: _sumsq_kernel, then
// _scale_kernel):
//   nrm = ||x||_2 (sum of squares in f32);
//   out = x * min(1, C / max(nrm, 1e-12)), cast back to x's dtype.
// x is the (R, 128) row view of a flat vector, f32 or bf16, taken here as
// R * 128 contiguous elements.
//
// What bounds it: memory. At the paper's VGG-11 width (R = 72,054 rows,
// 36.9 MB in f32) the function must read x once and write out once,
// 22 us at 3.35 TB/s, with one multiply-add per element read. This design
// reads x twice (33 us at best): once for the norm, once for the scale,
// because the scale of the first element depends on the last one.
//
// What the design does about it: the TPU kernel carries the sum across a
// sequential grid; Hopper's blocks run in any order. So pass 1 runs a grid
// over chunks of kChunk elements, each block writing one partial sum of
// squares, and a one-block second pass sums the partials in a fixed order
// and writes nrm. Pass 2 is a grid-stride elementwise pass in which every
// thread reads nrm from device memory and forms the scale itself, in f32,
// with no host sync between the passes. No float atomics: the results
// are bit-identical from run to run. Loads are coalesced, several in
// flight per thread.
//
// Each entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;         // threads of the streaming kernels
constexpr int kReduceThreads = 1024;  // threads of the partial-sum pass
constexpr int kUnroll = 4;            // loads in flight per thread
constexpr int kChunk = kThreads * 32;  // elements of one pass-1 block
constexpr int kScaleBlocksPerSm = 16;  // grid of the scale pass: 132 SMs
constexpr int kScaleMaxBlocks = 132 * kScaleBlocksPerSm;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

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

// partial[b] = sum of x[j]^2 over block b's kChunk elements. grid = (n_chunks,).
template <typename T>
__global__ void __launch_bounds__(kThreads)
sumsq_partial_kernel(const T* __restrict__ x, float* __restrict__ partial,
                     long long n) {
  const long long c0 = static_cast<long long>(blockIdx.x) * kChunk;
  const long long c1 = (c0 + kChunk < n) ? c0 + kChunk : n;
  float acc[kUnroll];
#pragma unroll
  for (int q = 0; q < kUnroll; ++q) acc[q] = 0.0f;
  long long j = c0 + threadIdx.x;
  for (; j + (kUnroll - 1) * kThreads < c1; j += kUnroll * kThreads) {
    float a[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) a[q] = to_f32(x[j + q * kThreads]);
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) acc[q] += a[q] * a[q];
  }
  for (; j < c1; j += kThreads) {
    const float a = to_f32(x[j]);
    acc[0] += a * a;
  }
  float v = 0.0f;
#pragma unroll
  for (int q = 0; q < kUnroll; ++q) v += acc[q];
  v = block_sum(v);
  if (threadIdx.x == 0) partial[blockIdx.x] = v;
}

// norm[0] = sqrt(sum of the n_parts partials), summed in a fixed order.
__global__ void __launch_bounds__(kReduceThreads)
norm_kernel(const float* __restrict__ partial, float* __restrict__ norm,
            int n_parts) {
  float acc = 0.0f;
  for (int j = threadIdx.x; j < n_parts; j += blockDim.x) acc += partial[j];
  acc = block_sum(acc);
  if (threadIdx.x == 0) norm[0] = sqrtf(acc);
}

// out[j] = x[j] * min(1, clip / max(norm, 1e-12)), formed in f32 and cast
// back. The comparisons are written so that a NaN norm gives a NaN scale,
// as jnp.minimum and jnp.maximum do (fminf and fmaxf would drop it).
template <typename T>
__global__ void __launch_bounds__(kThreads)
scale_kernel(const T* __restrict__ x, T* __restrict__ out,
             const float* __restrict__ norm, float clip, long long n) {
  const float nrm = __ldg(norm);
  const float den = (nrm < 1e-12f) ? 1e-12f : nrm;
  const float q = clip / den;
  const float s = (q > 1.0f) ? 1.0f : q;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long j = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       j < n; j += step) {
    out[j] = from_f32<T>(to_f32(x[j]) * s);
  }
}

template <typename T>
int launch(const void* x_, void* out_, float* partial, float* norm,
           long long n, float clip, cudaStream_t s) {
  const T* x = static_cast<const T*>(x_);
  T* out = static_cast<T*>(out_);
  const int n_chunks = static_cast<int>((n + kChunk - 1) / kChunk);
  sumsq_partial_kernel<T><<<n_chunks, kThreads, 0, s>>>(x, partial, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  norm_kernel<<<1, kReduceThreads, 0, s>>>(partial, norm, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kScaleMaxBlocks) blocks = kScaleMaxBlocks;
  scale_kernel<T><<<static_cast<int>(blocks), kThreads, 0, s>>>(
      x, out, norm, clip, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Elements of one pass-1 block (the wrapper sizes the partials from it).
int clip_norm_chunk() { return kChunk; }

// x, out: n contiguous elements, f32 or (is_bf16) bf16; partial:
// (ceil(n / clip_norm_chunk()),) f32 scratch; norm: (1,) f32.
int clip_norm_launch(int is_bf16, const void* x, void* out, float* partial,
                     float* norm, long long n, float clip, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(x, out, partial, norm, n, clip, s);
  }
  return launch<float>(x, out, partial, norm, n, clip, s);
}

}  // extern "C"
