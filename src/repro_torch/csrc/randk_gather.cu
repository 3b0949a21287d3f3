// Hopper (sm_90a) kernel of the rand-k row gather with the power scale
// (Alg. 2 line 12, x_i = (beta/|h_i|) A^t Delta_i), with a plain C
// interface loaded through ctypes.
//
// It replaces the Pallas TPU kernel of
// src/repro/kernels/randk_gather/kernel.py (randk_gather: _kernel):
//   out[j, :] = delta[idx[j], :] * scale,
// delta (R, 128) and out (k_rows, 128) in f32 or bf16, idx (k_rows,)
// int32 row indices, scale one value of delta's dtype (in bf16 the product
// is rounded to bf16, as the TPU kernel's bf16 multiply is). The row-
// granular omega (128-lane rows instead of coordinates) is the op's
// contract.
//
// What bounds it: memory, with one multiply per element. At the paper's
// VGG-11 width (k_rows = 21,616 of R = 72,054 rows) it reads 11.07 MB of
// delta rows and 86 kB of indices and writes 11.07 MB: 6.6 us at
// 3.35 TB/s.
//
// What the design does about it: the TPU kernel holds omega in SMEM by
// scalar prefetch and DMAs one row at a time; here each thread computes
// its own (output row, lane) from its flat output index, so 32 neighbouring
// threads read 32 neighbouring elements of one 128-element row (rows are
// 512 B in f32, 256 B in bf16, so the loads are coalesced) and the row's
// index is one broadcast load per warp. Every output element is written
// once, with no atomics. An index outside [0, R) reads nothing and yields
// NaN (the fill of jnp.take), so a bad index cannot read outside delta.
//
// The entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks on each of 132 SMs

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

// grid-stride over the k_rows * 128 output elements.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const T* __restrict__ delta, const int* __restrict__ idx,
              const T* __restrict__ scale, T* __restrict__ out,
              long long rows, long long n_out) {
  const float s = to_f32(scale[0]);
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       e < n_out; e += step) {
    const long long j = e / kLanes;
    const int lane = static_cast<int>(e % kLanes);
    const long long row = __ldg(idx + j);
    float v = __int_as_float(0x7fc00000);  // NaN
    if (row >= 0 && row < rows) {
      v = to_f32(delta[row * kLanes + lane]) * s;
    }
    out[e] = from_f32<T>(v);
  }
}

template <typename T>
int launch(const void* delta, const int* idx, const void* scale, void* out,
           long long rows, long long k_rows, cudaStream_t s) {
  const long long n_out = k_rows * kLanes;
  long long blocks = (n_out + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  gather_kernel<T><<<static_cast<int>(blocks), kThreads, 0, s>>>(
      static_cast<const T*>(delta), idx, static_cast<const T*>(scale),
      static_cast<T*>(out), rows, n_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// delta: (rows, 128); out: (k_rows, 128); scale: (1,), all f32 or
// (is_bf16) bf16; idx: (k_rows,) int32. All contiguous.
int randk_gather_launch(int is_bf16, const void* delta, const int* idx,
                        const void* scale, void* out, long long rows,
                        long long k_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(delta, idx, scale, out, rows, k_rows, s);
  }
  return launch<float>(delta, idx, scale, out, rows, k_rows, s);
}

}  // extern "C"
