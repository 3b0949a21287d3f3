// Hopper (sm_90a) kernel of the rand-k row gather with the power scale
// (Alg. 2 line 12, x_i = (beta/|h_i|) A^t Delta_i), with a plain C
// interface loaded through ctypes.
//
// It replaces the Pallas TPU kernel of
// src/repro/kernels/randk_gather/kernel.py (randk_gather: _kernel):
//   out[j, :] = delta[idx[j], :] * scale,
// delta (R, 128) and out (k_rows, 128) in f32 or bf16, idx (k_rows,)
// int32 row indices, scale one value of delta's dtype (in bf16 the
// product is taken in f32, where it is exact, and rounded once to bf16,
// as the TPU kernel's bf16 multiply rounds it). The scale comes by value
// (the wrapper rounds a number to the dtype on the host) or as a pointer
// to one element, of delta's dtype or of f32 (rounded here to delta's
// dtype, as a cast would: so an f32 tensor scale costs no cast kernel).
// The row-granular omega (128-lane rows instead of coordinates) is the
// op's contract.
//
// What bounds it: memory, with one multiply per element. At the paper's
// VGG-11 width (k_rows = 21,616 of R = 72,054 rows) it reads 11.07 MB of
// delta rows and 86 kB of indices and writes 11.07 MB: 6.6 us at
// 3.35 TB/s in f32, 3.3 us in bf16.
//
// What the design does about it. The TPU kernel holds omega in SMEM by
// scalar prefetch and moves one row per DMA with the scale fused; here a
// row is the unit of work too:
//   - one warp per f32 row (512 bytes, a float4 a lane), one half-warp
//     per bf16 row (256 bytes, 8 bf16 a lane), so every load and store
//     is 16 bytes and a warp's access to a row is one coalesced sweep;
//   - a warp takes a group of rows at a time (kGroup = 4 in f32, 8 in
//     bf16): the group's indices first, one coalesced load by one lane
//     each, handed to the row's lanes by shuffle (no division per
//     element, one index round trip for the group); then all of the
//     group's row loads, kGroup 16-byte loads in flight per lane; then
//     the scaled stores. Rows are read with
//     ld.global.nc.L1::no_allocate and written with streaming stores:
//     each byte is touched once;
//   - the grid is at most one resident wave (SMs times the blocks an SM
//     holds, from the occupancy API, cached per device), and each warp
//     walks whole groups;
//   - row offsets are 64-bit, so R * 128 may pass 2^31 elements.
// Rows start at multiples of 512 (f32) or 256 (bf16) bytes from the
// base, so 16-byte vectors are legal exactly when delta and out are
// 16-byte aligned. An operand whose start is not takes the scalar-load
// instantiation of the same kernel (four elements a lane, neighbouring
// lanes on neighbouring elements), selected at launch: the same bits.
// An index outside [0, R) reads nothing and yields a row of NaN (the
// fill of jnp.take), so a bad index cannot read outside delta.
//
// The entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
// 16-byte row loads each lane keeps in flight: on an H100 at the VGG-11
// shape 2 is 3-4% slower than 4 in f32 and 8 4-5% slower in bf16, and 8
// takes 62-72 registers against 4's 40
constexpr int kGroup = 4;

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

template <typename T>
__device__ __forceinline__ T nan_of();
template <>
__device__ __forceinline__ float nan_of<float>() {
  return __int_as_float(0x7fc00000);
}
template <>
__device__ __forceinline__ __nv_bfloat16 nan_of<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0x7fc0);
}

// Lanes that share one row, elements a lane, and rows a warp covers in
// one step: 16 bytes a lane on the vector path, four elements a lane on
// the scalar path.
template <typename T, bool kVec>
struct RowGeo {
  static constexpr int kRowLanes =
      kVec ? kLanes * static_cast<int>(sizeof(T)) / 16 : 32;
  static constexpr int kPerLane = kLanes / kRowLanes;
  static constexpr int kRowsPerStep = 32 / kRowLanes;
};

// One lane's share of a row: 16 raw bytes on the vector path, four
// elements on the scalar path.
template <typename T, bool kVec>
struct Frag {
  uint4 v;
};
template <typename T>
struct Frag<T, false> {
  T v[4];
};

__device__ __forceinline__ uint4 load_nc16(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// row: the row's first element; sub: the lane's place among the row's
// lanes.
template <typename T>
__device__ __forceinline__ void load(Frag<T, true>& f, const T* row,
                                     int sub) {
  f.v = load_nc16(row + sub * RowGeo<T, true>::kPerLane);
}
template <typename T>
__device__ __forceinline__ void load(Frag<T, false>& f, const T* row,
                                     int sub) {
#pragma unroll
  for (int e = 0; e < 4; ++e) f.v[e] = row[sub + 32 * e];
}

// Two bf16 (or one f32) in a 32-bit word, times s in f32, rounded once.
template <typename T>
__device__ __forceinline__ uint32_t scale_word(uint32_t w, float s) {
  if constexpr (sizeof(T) == 4) {
    return __float_as_uint(__uint_as_float(w) * s);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(
        __uint_as_float(w << 16) * s, __uint_as_float(w & 0xffff0000u) * s);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
}

template <typename T>
__device__ __forceinline__ void scale(Frag<T, true>& f, float s) {
  f.v.x = scale_word<T>(f.v.x, s);
  f.v.y = scale_word<T>(f.v.y, s);
  f.v.z = scale_word<T>(f.v.z, s);
  f.v.w = scale_word<T>(f.v.w, s);
}
template <typename T>
__device__ __forceinline__ void scale(Frag<T, false>& f, float s) {
#pragma unroll
  for (int e = 0; e < 4; ++e) f.v[e] = from_f32<T>(to_f32(f.v[e]) * s);
}

template <typename T>
__device__ __forceinline__ void fill_nan(Frag<T, true>& f) {
  const uint32_t w = sizeof(T) == 4 ? 0x7fc00000u : 0x7fc07fc0u;
  f.v = make_uint4(w, w, w, w);
}
template <typename T>
__device__ __forceinline__ void fill_nan(Frag<T, false>& f) {
#pragma unroll
  for (int e = 0; e < 4; ++e) f.v[e] = nan_of<T>();
}

template <typename T>
__device__ __forceinline__ void store(T* row, int sub,
                                      const Frag<T, true>& f) {
  __stcs(reinterpret_cast<uint4*>(row + sub * RowGeo<T, true>::kPerLane),
         f.v);
}
template <typename T>
__device__ __forceinline__ void store(T* row, int sub,
                                      const Frag<T, false>& f) {
#pragma unroll
  for (int e = 0; e < 4; ++e) row[sub + 32 * e] = f.v[e];
}

// grid: at most one resident wave of kThreads-thread blocks; each warp
// walks groups of kGroup * kRowsPerStep output rows.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const T* __restrict__ delta, const int* __restrict__ idx,
              const void* __restrict__ scale_ptr, int scale_is_f32,
              float scale_val, T* __restrict__ out, long long rows,
              long long k_rows) {
  using G = RowGeo<T, kVec>;
  constexpr int kGroupRows = kGroup * G::kRowsPerStep;
  static_assert(kGroupRows <= 32, "a group's indices are one lane each");
  float s = scale_val;
  if (scale_ptr) {
    s = scale_is_f32
            ? to_f32(from_f32<T>(*static_cast<const float*>(scale_ptr)))
            : to_f32(*static_cast<const T*>(scale_ptr));
  }
  const int lane = threadIdx.x & 31;
  const int sub = lane % G::kRowLanes;
  const int step_row = lane / G::kRowLanes;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long stride =
      static_cast<long long>(gridDim.x) * (kThreads / 32) * kGroupRows;
  for (long long base = warp * kGroupRows; base < k_rows; base += stride) {
    // the group's indices, lane g holding row base + g's (-1 past the end)
    int my_row = -1;
    if (lane < kGroupRows && base + lane < k_rows) {
      my_row = __ldg(idx + base + lane);
    }
    Frag<T, kVec> f[kGroup];
    bool ok[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int row = __shfl_sync(0xffffffffu, my_row,
                                  g * G::kRowsPerStep + step_row);
      ok[g] = row >= 0 && row < rows;
      if (ok[g]) {
        load(f[g], delta + static_cast<long long>(row) * kLanes, sub);
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const long long j = base + g * G::kRowsPerStep + step_row;
      if (j >= k_rows) continue;
      if (ok[g]) {
        scale(f[g], s);
      } else {
        fill_nan(f[g]);
      }
      store(out + j * kLanes, sub, f[g]);
    }
  }
}

template <typename T, bool kVec>
int launch(const void* delta, const int* idx, const void* scale_ptr,
           int scale_is_f32, float scale_val, void* out, long long rows,
           long long k_rows, cudaStream_t s) {
  // one resident wave of blocks, per device, found once
  static int wave[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks_max = dev < kMaxDevices ? wave[dev] : 0;
  if (blocks_max == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gather_kernel<T, kVec>, kThreads, 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    blocks_max = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < kMaxDevices) wave[dev] = blocks_max;
  }
  constexpr long long rows_per_block =
      kThreads / 32 * kGroup * RowGeo<T, kVec>::kRowsPerStep;
  long long blocks = (k_rows + rows_per_block - 1) / rows_per_block;
  if (blocks > blocks_max) blocks = blocks_max;
  gather_kernel<T, kVec>
      <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const T*>(delta), idx, scale_ptr, scale_is_f32, scale_val,
      static_cast<T*>(out), rows, k_rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_aligned_or_not(const void* delta, const int* idx,
                          const void* scale_ptr, int scale_is_f32,
                          float scale_val, void* out, long long rows,
                          long long k_rows, cudaStream_t s) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(delta) |
                      reinterpret_cast<uintptr_t>(out);
  if (a % 16 == 0) {
    return launch<T, true>(delta, idx, scale_ptr, scale_is_f32, scale_val,
                           out, rows, k_rows, s);
  }
  return launch<T, false>(delta, idx, scale_ptr, scale_is_f32, scale_val,
                          out, rows, k_rows, s);
}

}  // namespace

extern "C" {

// delta: (rows, 128); out: (k_rows, 128), both f32 or (is_bf16) bf16;
// idx: (k_rows,) int32; all contiguous. scale: scale_ptr to one element
// of delta's dtype, or (scale_is_f32) of f32; or (scale_ptr null)
// scale_val, already rounded to delta's dtype.
int randk_gather_launch(int is_bf16, const void* delta, const int* idx,
                        const void* scale_ptr, int scale_is_f32,
                        float scale_val, void* out, long long rows,
                        long long k_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_aligned_or_not<__nv_bfloat16>(delta, idx, scale_ptr,
                                                scale_is_f32, scale_val, out,
                                                rows, k_rows, s);
  }
  return launch_aligned_or_not<float>(delta, idx, scale_ptr, scale_is_f32,
                                      scale_val, out, rows, k_rows, s);
}

}  // extern "C"
