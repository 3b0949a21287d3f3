// Hopper (sm_90a) kernel of the global l2-norm clip, with a plain C
// interface loaded through ctypes.
//
// It replaces the two Pallas TPU kernels of
// src/repro/kernels/clip_norm/kernel.py (clip_norm: _sumsq_kernel, then
// _scale_kernel):
//   nrm = ||x||_2 (sum of squares in f32);
//   out = x * min(1, C / max(nrm, 1e-12)), cast back to x's dtype.
// x is the (R, 128) row view of a flat vector, f32 or bf16, taken here as
// R * 128 contiguous elements.
//
// What bounds it: memory. At the paper's VGG-11 width (R = 72,054 rows,
// 36.9 MB in f32) the function must read x once and write out once,
// 22 us at 3.35 TB/s, with one multiply-add per element read. The scale
// of the first element depends on the last one, so every element is
// needed twice, and the writes cannot start before the reads end.
//
// What the design does about it: one cooperative launch of one
// 1024-thread block per SM, the blocks resident at once. Each block owns
// one contiguous slice of x. Pass 1 reads the slice with 16-byte loads
// and keeps it on chip: each thread's first four loads in registers, the
// next in the block's dynamic shared memory (227 KB); 291 KB an SM, 38 MB
// over 132 SMs, so the VGG-11 update stays whole. What does not fit is
// read under an L2 evict_last policy. Each block writes one partial sum
// of squares. After a grid-wide barrier every block sums all partials in
// the same fixed order (no atomics), so every block holds the same norm,
// bit-identical from run to run; block 0 stores it. Pass 2 forms the
// scale in f32 and writes the slice from registers and shared memory,
// re-reading only the part that did not fit (from L2, or above its size
// from HBM), with streaming stores that do not push x out of L2. Up to
// about 38 MB the HBM traffic is the bound's read-once-write-once.
//
// A view whose start is not 16-byte aligned takes the same kernel with
// one element per load and no cache hints.
//
// The entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns the launch's cudaError_t.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;    // one block of 1024 threads an SM
constexpr int kRegUnits = 4;      // units a thread holds in registers
constexpr int kUnroll = 4;        // units in flight per thread
constexpr int kMaxDevices = 64;

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

// One load: 16 bytes (4 f32 or 8 bf16), or one element on the scalar
// path; Raw is its bits, as held in registers and shared memory.
template <typename T, bool kVec>
struct Unit {
  static constexpr int E = kVec ? 16 / static_cast<int>(sizeof(T)) : 1;
  using Raw = std::conditional_t<kVec, uint4, T>;
};

__device__ __forceinline__ uint64_t l2_policy_evict_last() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(pol));
  return pol;
}

__device__ __forceinline__ uint64_t l2_policy_evict_first() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(pol));
  return pol;
}

__device__ __forceinline__ uint4 ld_hint(const void* p, uint64_t pol) {
  uint4 v;
  asm volatile(
      "ld.global.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(pol));
  return v;
}

// A unit as f32 values: 4 floats, 8 bf16 (the low half first), or one.
__device__ __forceinline__ void unpack(uint4 v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(uint4 v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <typename T>
__device__ __forceinline__ void unpack(T v, float (&f)[1]) {
  f[0] = to_f32(v);
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                    pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
}

template <typename T, bool kVec>
__device__ __forceinline__ typename Unit<T, kVec>::Raw load_unit(
    const T* x, long long u, uint64_t pol) {
  if constexpr (kVec) {
    return ld_hint(x + u * Unit<T, kVec>::E, pol);
  } else {
    return x[u];
  }
}

template <typename T, bool kVec>
__device__ __forceinline__ float sumsq(typename Unit<T, kVec>::Raw r) {
  float f[Unit<T, kVec>::E];
  unpack(r, f);
  float s = 0.0f;
#pragma unroll
  for (int e = 0; e < Unit<T, kVec>::E; ++e) s += f[e] * f[e];
  return s;
}

// out unit u = r * sc, rounded to T; 16-byte units as streaming stores.
template <typename T, bool kVec>
__device__ __forceinline__ void store_scaled(T* out, long long u,
                                             typename Unit<T, kVec>::Raw r,
                                             float sc) {
  float f[Unit<T, kVec>::E];
  unpack(r, f);
#pragma unroll
  for (int e = 0; e < Unit<T, kVec>::E; ++e) f[e] *= sc;
  if constexpr (kVec) {
    __stcs(reinterpret_cast<uint4*>(out + u * Unit<T, kVec>::E), pack(f));
  } else {
    out[u] = from_f32<T>(f[0]);
  }
}

// visit(i, raw, q) for the units i of [i0, i1) this thread owns
// (i0 + threadIdx.x, then every kThreads), kUnroll loads in flight.
template <int kU, typename Load, typename Visit>
__device__ __forceinline__ void sweep(long long i0, long long i1, Load load,
                                      Visit visit) {
  long long i = i0 + threadIdx.x;
  for (; i + (kU - 1) * kThreads < i1; i += kU * kThreads) {
    decltype(load(i)) r[kU];
#pragma unroll
    for (int q = 0; q < kU; ++q) r[q] = load(i + q * kThreads);
#pragma unroll
    for (int q = 0; q < kU; ++q) visit(i + q * kThreads, r[q], q);
  }
  for (; i < i1; i += kThreads) visit(i, load(i), 0);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// Sum over the block in a fixed order; the result is returned to every
// thread.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_part[kThreads / 32];
  __shared__ float total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = (lane < kThreads / 32) ? warp_part[lane] : 0.0f;
    v = warp_sum(v);
    if (lane == 0) total = v;
  }
  __syncthreads();
  return total;
}

// grid = at most one block an SM; block b owns slice units
// [n_units * b / G, n_units * (b + 1) / G). Slice unit i lives, between
// the passes, in registers (i < kRegUnits * kThreads), in dynamic shared
// memory (the next stash_units), or only in device memory (the rest).
// scratch[0] = the norm, scratch[1 + b] = block b's partial sum of
// squares.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
clip_kernel(const T* __restrict__ x, T* __restrict__ out,
            float* __restrict__ scratch, long long n_units, float clip,
            long long stash_units) {
  using Raw = typename Unit<T, kVec>::Raw;
  extern __shared__ __align__(16) unsigned char stash_bytes[];
  Raw* stash = reinterpret_cast<Raw*>(stash_bytes);
  const long long g = gridDim.x;
  const long long u0 = n_units * blockIdx.x / g;
  const long long len = n_units * (blockIdx.x + 1) / g - u0;
  constexpr long long kInRegs = static_cast<long long>(kRegUnits) * kThreads;
  const long long on_chip =
      len < kInRegs + stash_units ? len : kInRegs + stash_units;

  // pass 1: the slice's sum of squares; x kept on chip, the rest in L2
  const uint64_t keep = kVec ? l2_policy_evict_last() : 0;
  auto load_keep = [&](long long i) {
    return load_unit<T, kVec>(x, u0 + i, keep);
  };
  float acc[kUnroll];
#pragma unroll
  for (int q = 0; q < kUnroll; ++q) acc[q] = 0.0f;
  Raw reg[kRegUnits];
#pragma unroll
  for (int k = 0; k < kRegUnits; ++k) {
    const long long i = k * kThreads + threadIdx.x;
    reg[k] = i < len ? load_keep(i) : Raw{};
  }
#pragma unroll
  for (int k = 0; k < kRegUnits; ++k) {
    acc[k % kUnroll] += sumsq<T, kVec>(reg[k]);
  }
  sweep<kUnroll>(kInRegs, on_chip, load_keep,
                 [&](long long i, Raw r, int q) {
                   stash[i - kInRegs] = r;
                   acc[q] += sumsq<T, kVec>(r);
                 });
  sweep<kUnroll>(on_chip, len, load_keep, [&](long long, Raw r, int q) {
    acc[q] += sumsq<T, kVec>(r);
  });
  float v = 0.0f;
#pragma unroll
  for (int q = 0; q < kUnroll; ++q) v += acc[q];
  v = block_sum(v);
  if (threadIdx.x == 0) scratch[1 + blockIdx.x] = v;

  cg::this_grid().sync();

  // every block sums the partials in the same order: the same norm
  float s = 0.0f;
  for (long long b = threadIdx.x; b < g; b += kThreads) {
    s += __ldcg(scratch + 1 + b);
  }
  const float nrm = sqrtf(block_sum(s));
  if (blockIdx.x == 0 && threadIdx.x == 0) scratch[0] = nrm;

  // the scale, written so that a NaN norm gives a NaN scale, as
  // jnp.minimum and jnp.maximum do (fminf and fmaxf would drop it)
  const float den = (nrm < 1e-12f) ? 1e-12f : nrm;
  const float quo = clip / den;
  const float sc = (quo > 1.0f) ? 1.0f : quo;

  // pass 2: scale the slice from where it lives; out streamed
#pragma unroll
  for (int k = 0; k < kRegUnits; ++k) {
    const long long i = k * kThreads + threadIdx.x;
    if (i < len) store_scaled<T, kVec>(out, u0 + i, reg[k], sc);
  }
  auto store = [&](long long i, Raw r, int) {
    store_scaled<T, kVec>(out, u0 + i, r, sc);
  };
  sweep<kUnroll>(kInRegs, on_chip,
                 [&](long long i) { return stash[i - kInRegs]; }, store);
  const uint64_t drop = kVec ? l2_policy_evict_first() : 0;
  sweep<kUnroll>(on_chip, len,
                 [&](long long i) { return load_unit<T, kVec>(x, u0 + i,
                                                              drop); },
                 store);
}

// The launch geometry of clip_kernel<T, kVec> on one device, set up once:
// the dynamic shared memory it opts into, and the blocks resident at once.
struct Geometry {
  int resident = 0;
  int smem_bytes = 0;
};

template <typename T, bool kVec>
const Geometry& geometry(int dev) {
  static Geometry cached[kMaxDevices];
  Geometry& g = cached[dev];
  if (g.resident == 0) {
    const void* fn = reinterpret_cast<const void*>(clip_kernel<T, kVec>);
    int optin = 0, sms = 0, per_sm = 0;
    cudaFuncAttributes attr;
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncGetAttributes(&attr, fn);
    const int smem = optin - static_cast<int>(attr.sharedSizeBytes);
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, clip_kernel<T, kVec>, kThreads, smem);
    g.smem_bytes = smem;
    g.resident = per_sm * sms;
  }
  return g;
}

template <typename T, bool kVec>
int launch(const void* x_, void* out_, float* scratch, long long n,
           float clip, int dev, cudaStream_t s) {
  using Raw = typename Unit<T, kVec>::Raw;
  const T* x = static_cast<const T*>(x_);
  T* out = static_cast<T*>(out_);
  const Geometry& geo = geometry<T, kVec>(dev);
  if (geo.resident < 1) {
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }
  long long n_units = n / Unit<T, kVec>::E;
  long long stash_units = geo.smem_bytes / static_cast<int>(sizeof(Raw));
  const long long want = (n_units + kRegUnits * kThreads - 1) /
                         (kRegUnits * kThreads);
  const int grid = static_cast<int>(want < geo.resident ? want
                                                         : geo.resident);
  void* args[] = {&x, &out, &scratch, &n_units, &clip, &stash_units};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(clip_kernel<T, kVec>), dim3(grid),
      dim3(kThreads), args, geo.smem_bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_aligned_or_not(const void* x, void* out, float* scratch,
                          long long n, float clip, int dev, cudaStream_t s) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x) |
                      reinterpret_cast<uintptr_t>(out);
  if (a % 16 == 0) return launch<T, true>(x, out, scratch, n, clip, dev, s);
  return launch<T, false>(x, out, scratch, n, clip, dev, s);
}

}  // namespace

extern "C" {

// Length of the scratch the launch needs on the current device, in
// floats: the norm and one partial for each block of the largest grid.
int clip_norm_scratch_len() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return -1;
  int m = geometry<float, true>(dev).resident;
  const int others[3] = {geometry<float, false>(dev).resident,
                         geometry<__nv_bfloat16, true>(dev).resident,
                         geometry<__nv_bfloat16, false>(dev).resident};
  for (int o : others) m = o > m ? o : m;
  return 1 + m;
}

// x, out: n contiguous elements (n a multiple of 128), f32 or (is_bf16)
// bf16, on the current device; scratch: clip_norm_scratch_len() f32,
// scratch[0] receives the norm.
int clip_norm_launch(int is_bf16, const void* x, void* out, float* scratch,
                     long long n, float clip, void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_aligned_or_not<__nv_bfloat16>(x, out, scratch, n, clip,
                                                dev, s);
  }
  return launch_aligned_or_not<float>(x, out, scratch, n, clip, dev, s);
}

}  // extern "C"
