// Hopper (sm_90a) kernel of the AirComp server combine (Alg. 2 lines
// 15-16: Delta_hat = (A^t)^T y / (r beta), fused with theta <- theta +
// Delta_hat), with a plain C interface loaded through ctypes.
//
// It replaces the Pallas TPU kernel of
// src/repro/kernels/aircomp_combine/kernel.py (aircomp_combine: _kernel,
// theta aliased input to output):
//   theta[idx[j], :] += (y[j, :] * inv).astype(theta.dtype),
// theta (R, 128) updated in place, y (k_rows, 128) of theta's dtype (f32
// or bf16), idx (k_rows,) int32 row indices, inv = 1/(r beta) one value of
// that dtype (in bf16 the product is rounded to bf16 before the add, as
// the TPU kernel's is).
//
// Duplicate rows. The TPU grid runs in order, so a row that appears
// twice in idx receives both adds, one after the other. Here every
// element is added with one atomicAdd (f32, or __nv_bfloat16, native on
// Hopper), so duplicates accumulate too, but in an order that varies from
// run to run:
//   - with unique rows, which is what row_indices_from_coords draws, each
//     element receives exactly one add: the result is the rounded sum
//     theta + upd, bit-equal to the sequential plain version and
//     deterministic;
//   - with duplicates, the adds to one element round in another order, so
//     the result matches the plain version only within a tolerance of
//     about one rounding of the element per extra add (f32: 2^-24 of
//     max|theta| per add; bf16: 2^-8, since each bf16 atomic rounds).
//
// What bounds it: memory, with one multiply-add per element. At the
// paper's VGG-11 width (k_rows = 21,616 of R = 72,054 rows) it reads
// 11.07 MB of y and 86 kB of indices and reads and writes 11.07 MB of
// theta rows: 9.9 us at 3.35 TB/s.
//
// What the design does about it: each thread computes its own (input
// row, lane) from its flat index, so 32 neighbouring threads add into 32
// neighbouring elements of one theta row (coalesced reductions, issued as
// RED instructions since the old value is not used), and a row's index is
// one broadcast load per warp. An index outside [0, R) is dropped, as
// .at[].add drops it, so a bad index cannot write outside theta.
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

// grid-stride over the k_rows * 128 elements of y.
template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(T* __restrict__ theta, const T* __restrict__ y,
               const int* __restrict__ idx, const T* __restrict__ inv,
               long long rows, long long n_in) {
  const float w = to_f32(inv[0]);
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       e < n_in; e += step) {
    const long long j = e / kLanes;
    const int lane = static_cast<int>(e % kLanes);
    const long long row = __ldg(idx + j);
    if (row < 0 || row >= rows) continue;
    atomicAdd(theta + row * kLanes + lane, from_f32<T>(to_f32(y[e]) * w));
  }
}

template <typename T>
int launch(void* theta, const void* y, const int* idx, const void* inv,
           long long rows, long long k_rows, cudaStream_t s) {
  const long long n_in = k_rows * kLanes;
  long long blocks = (n_in + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  combine_kernel<T><<<static_cast<int>(blocks), kThreads, 0, s>>>(
      static_cast<T*>(theta), static_cast<const T*>(y), idx,
      static_cast<const T*>(inv), rows, n_in);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// theta: (rows, 128), updated in place; y: (k_rows, 128); inv: (1,), all
// f32 or (is_bf16) bf16; idx: (k_rows,) int32. All contiguous.
int aircomp_combine_launch(int is_bf16, void* theta, const void* y,
                           const int* idx, const void* inv, long long rows,
                           long long k_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(theta, y, idx, inv, rows, k_rows, s);
  }
  return launch<float>(theta, y, idx, inv, rows, k_rows, s);
}

}  // extern "C"
