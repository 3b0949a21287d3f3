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
// the TPU kernel's is). inv comes by value (the wrapper rounds a number
// to the dtype on the host) or as a pointer to one element.
//
// Duplicate rows. The TPU grid runs in order, so a row that appears
// twice in idx receives both adds, one after the other. Here every
// element is added with an atomic reduction, so duplicates accumulate
// too, but in an order that varies from run to run:
//   - with unique rows, which is what row_indices_from_coords draws, each
//     element receives exactly one add: the result is the rounded sum
//     theta + upd, bit-equal to the sequential plain version and
//     deterministic;
//   - with duplicates, the adds to one element round in another order, so
//     the result matches the plain version only within a tolerance of
//     about one rounding of the element per extra add (f32: 2^-24 of
//     max|theta| per add; bf16: 2^-8, since each bf16 reduction rounds).
//
// What bounds it: memory, with one multiply-add per element. At the
// paper's VGG-11 width (k_rows = 21,616 of R = 72,054 rows) it reads
// 11.07 MB of y and 86 kB of indices and reads and writes 11.07 MB of
// theta rows: 9.9 us at 3.35 TB/s.
//
// What the design does about it: one warp per y row in f32 (512 bytes),
// one half-warp in bf16 (256 bytes). A lane loads 16 bytes of y with one
// streaming load and adds them into theta with one vector reduction
// (red.global.add of 4 f32, or of 4 bf16x2 pairs), so a row costs 32 or
// 16 reductions where one per element cost 128. The row's index is
// loaded once by the row's first lane and shuffled to the others. An
// index outside [0, R) is dropped, as .at[].add drops it, so a bad index
// cannot write outside theta. Vector reductions need 16-byte-aligned
// rows; an operand whose start is not aligned takes the same layout with
// four scalar atomic adds per lane.
//
// The entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;

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

// Lanes that share one y row: 16 bytes a lane on the vector path, four
// elements a lane on the scalar path.
template <typename T, bool kVec>
struct RowGeo {
  static constexpr int kRowLanes =
      kVec ? kLanes * static_cast<int>(sizeof(T)) / 16 : 32;
  static constexpr int kPerLane = kLanes / kRowLanes;
};

// theta[0:4] += (y[0:4] * w) for 16-byte-aligned rows: one reduction.
__device__ __forceinline__ void add16(float* theta, const float* y,
                                      float w) {
  const float4 v = __ldcs(reinterpret_cast<const float4*>(y));
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "l"(theta), "f"(v.x * w), "f"(v.y * w), "f"(v.z * w),
                  "f"(v.w * w)
               : "memory");
}

__device__ __forceinline__ uint32_t scaled_bf16x2(uint32_t pair, float w) {
  const float lo = __uint_as_float(pair << 16) * w;
  const float hi = __uint_as_float(pair & 0xffff0000u) * w;
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// theta[0:8] += bf16(y[0:8] * w) for 16-byte-aligned rows: one reduction.
__device__ __forceinline__ void add16(__nv_bfloat16* theta,
                                      const __nv_bfloat16* y, float w) {
  const uint4 v = __ldcs(reinterpret_cast<const uint4*>(y));
  asm volatile("red.global.add.noftz.v4.bf16x2 [%0], {%1, %2, %3, %4};"
               :: "l"(theta), "r"(scaled_bf16x2(v.x, w)),
                  "r"(scaled_bf16x2(v.y, w)), "r"(scaled_bf16x2(v.z, w)),
                  "r"(scaled_bf16x2(v.w, w))
               : "memory");
}

// grid = ceil(k_rows / rows a block), kThreads threads.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
combine_kernel(T* __restrict__ theta, const T* __restrict__ y,
               const int* __restrict__ idx, const T* __restrict__ inv_ptr,
               float inv_val, long long rows, long long k_rows) {
  using G = RowGeo<T, kVec>;
  const float w = inv_ptr ? to_f32(inv_ptr[0]) : inv_val;
  const int lane = threadIdx.x & 31;
  const int sub = lane % G::kRowLanes;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long j = warp * (32 / G::kRowLanes) + lane / G::kRowLanes;
  long long row = -1;
  if (sub == 0 && j < k_rows) row = __ldg(idx + j);
  row = __shfl_sync(0xffffffffu, row, lane - sub);
  if (j >= k_rows || row < 0 || row >= rows) return;
  T* dst = theta + row * kLanes + sub * G::kPerLane;
  const T* src = y + j * kLanes + sub * G::kPerLane;
  if constexpr (kVec) {
    add16(dst, src, w);
  } else {
#pragma unroll
    for (int e = 0; e < G::kPerLane; ++e) {
      atomicAdd(dst + e, from_f32<T>(to_f32(src[e]) * w));
    }
  }
}

template <typename T, bool kVec>
int launch(void* theta, const void* y, const int* idx, const void* inv_ptr,
           float inv_val, long long rows, long long k_rows, cudaStream_t s) {
  constexpr long long rows_per_block =
      kThreads / 32 * (32 / RowGeo<T, kVec>::kRowLanes);
  const long long blocks = (k_rows + rows_per_block - 1) / rows_per_block;
  combine_kernel<T, kVec><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<T*>(theta), static_cast<const T*>(y), idx,
      static_cast<const T*>(inv_ptr), inv_val, rows, k_rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_aligned_or_not(void* theta, const void* y, const int* idx,
                          const void* inv_ptr, float inv_val, long long rows,
                          long long k_rows, cudaStream_t s) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(theta) |
                      reinterpret_cast<uintptr_t>(y);
  if (a % 16 == 0) {
    return launch<T, true>(theta, y, idx, inv_ptr, inv_val, rows, k_rows, s);
  }
  return launch<T, false>(theta, y, idx, inv_ptr, inv_val, rows, k_rows, s);
}

}  // namespace

extern "C" {

// theta: (rows, 128), updated in place; y: (k_rows, 128), both f32 or
// (is_bf16) bf16; idx: (k_rows,) int32; all contiguous. inv: inv_ptr to
// one element of theta's dtype, or (inv_ptr null) inv_val, already
// rounded to that dtype.
int aircomp_combine_launch(int is_bf16, void* theta, const void* y,
                           const int* idx, const void* inv_ptr,
                           float inv_val, long long rows, long long k_rows,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_aligned_or_not<__nv_bfloat16>(theta, y, idx, inv_ptr,
                                                inv_val, rows, k_rows, s);
  }
  return launch_aligned_or_not<float>(theta, y, idx, inv_ptr, inv_val, rows,
                                      k_rows, s);
}

}  // extern "C"
