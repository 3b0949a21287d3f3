// Hopper (sm_90a) kernels of JAX's threefry-2x32 draws, with a plain C
// interface loaded through ctypes.
//
// They replace no Pallas kernel. They replace the JAX package's
// jax.random draws (threefry_2x32 over iota, then the sampler's
// transform), which XLA fuses into one pass on the TPU and which the
// port's repro_torch/prng.py computes one element-wise torch op at a
// time:
//   threefry_sample  uniform (f32, [0, 1)), bernoulli (bool, u < f32(p))
//                    or normal (f32) over n counts of one key, or of each
//                    key of a batch (one row a key, as jax.vmap draws);
//   threefry_combine the single-client PFELS production aggregate of one
//                    leaf (core/aggregation.py pfels_production_aggregate,
//                    group None): the channel noise z = normal(key, n)
//                    drawn in registers and
//                      out = fma_f32(x * mf, beta, (sigma0 * mf) * z) * scale
//                    with mf the bool mask as 0.0 or 1.0, written once.
//
// Every value is prng.py's bit for bit: each device function below is
// that module's code op for op (named after it), every float op an
// explicit round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn, __dmul_rn, __dadd_rn, __dsub_rn, __double2float_rn,
// __dsqrt_rn), so that nvcc, which contracts a * b + c into an FMA by
// default, contracts nothing the CPU route rounds twice. Nothing is
// flushed: no sampler here calls prng.py's _flush. The constants are
// prng.py's, rounded to f32, as hex literals.
//
// What bounds them on the H100:
//   - the mask (bernoulli): 1 byte written a value and ~40 integer ops
//     (20 threefry rounds a pair of values): at the production step's
//     2.90e9 values, 0.87 ms of memory and ~7 ms of integer instructions;
//   - the normal: XLA's CPU erf_inv and log1p run in f32 with every FMA
//     computed as prng.py's _fma_f64 does it (an f64 product, an f64 add,
//     one rounding to f32): about 40 f64 operations and as many f32/f64
//     conversions a value, which the card executes at 64 and 16 a clock an
//     SM, so the draw is bound by those instructions, not by its bytes;
//   - the combine: the normal's instructions, plus 9 bytes a value (x and
//     the mask read, out written), 26.1 GB over the step's tree.
//
// What the design does about it: one thread per counter pair (i, i +
// ceil(n/2)), hashed once, both of its outputs computed and stored by
// the same thread, so nothing round-trips through device memory: no
// uint32 words, no noise vector, no f64 temporaries. A grid of the
// blocks resident at once walks the pairs with a grid stride; neighbour
// threads take neighbour pairs, so every load and store is coalesced in
// each half of the output. The key words, beta and the scale are read
// on the card through pointers (a key is a row of prng.split's output):
// no host synchronisation. No shared memory, no atomics: a value depends
// on its count alone, so the result is the same whatever the grid.
//
// The entry points launch on the caller's stream, allocate nothing, do
// not synchronise, and return the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
constexpr int kUniform = 0, kBernoulli = 1, kNormal = 2;

// prng.py's constants, each rounded to f32 as prng.py rounds it, as hex
// literals (tests/test_torch_threefry.py reads them back against
// prng.py). The polynomial tables are local to the functions that use
// them: indexed in fully unrolled loops, they fold into immediates, each
// converted to f64 at compile time.
#define ERFINV_LT5                                                        \
  {0x1.e2cb1p-26f, 0x1.70966cp-22f, -0x1.d8e6aep-19f, -0x1.26b582p-18f,   \
   0x1.ca65b6p-13f, -0x1.48a81p-10f, -0x1.11c9dep-8f, 0x1.f91ec6p-3f,     \
   0x1.805c5ep+0f}
#define ERFINV_GE5                                                        \
  {-0x1.a3e136p-13f, 0x1.a76ad6p-14f, 0x1.61b8e4p-10f, -0x1.e17bcep-9f,   \
   0x1.7824f6p-8f, -0x1.f38baep-8f, 0x1.354afcp-7f, 0x1.006db6p+0f,       \
   0x1.6a9efcp+1f}
#define LOG_P                                                             \
  {0x1.204376p-4f, -0x1.d7a37p-4f, 0x1.de4a34p-4f, -0x1.fcba9ep-4f,       \
   0x1.23d37ep-3f, -0x1.555cap-3f, 0x1.999d58p-3f, -0x1.fffff8p-3f,       \
   0x1.555554p-2f}
#define LOG1P_NUM                                                         \
  {0x1.7bc096p-15f, 0x1.fe818ap-2f, 0x1.a509f4p+2f, 0x1.de9738p+4f,       \
   0x1.e798ecp+5f, 0x1.c8e75ap+5f, 0x1.40a202p+4f}
#define LOG1P_DEN                                                         \
  {0x1.e2035ap+3f, 0x1.4c30b6p+6f, 0x1.bb865ap+7f, 0x1.351946p+8f,        \
   0x1.b0db14p+7f, 0x1.e0f304p+5f}
constexpr float kLogQ1 = -0x1.bd0106p-13f;       // _LOG_Q1
constexpr float kLogQ2 = 0x1.63p-1f;             // _LOG_Q2
constexpr float kSqrtHalf = 0x1.6a09e6p-1f;      // f32(sqrt(1/2))
constexpr float kLog1pSmall = 0x1.a8279ap-2f;    // _LOG1P_SMALL
constexpr float kNormalLo = -0x1.fffffep-1f;     // _NORMAL_LO
constexpr float kNormalSpan = 0x1p+1f;           // f32(1 - _NORMAL_LO)
constexpr float kSqrt2 = 0x1.6a09e6p+0f;         // _SQRT2_F32

// _threefry2x32: 20 rounds over the counter pair (x0, x1) under the key
// words (k1, k2), in place.
__device__ __forceinline__ void threefry2x32(uint32_t k1, uint32_t k2,
                                             uint32_t& x0, uint32_t& x1) {
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, kRot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// _bits_to_unit: the 23 high bits as the mantissa of a float in [1, 2),
// minus one.
__device__ __forceinline__ float bits_to_unit(uint32_t b) {
  return __fsub_rn(__uint_as_float((b >> 9) | 0x3F800000u), 1.0f);
}

// _fma_f64: f32 a * b + c as an f64 product (exact), an f64 add, and one
// rounding to f32. The operands are f32 values (or, for the Horner steps,
// the f64 cast of one), passed as doubles.
__device__ __forceinline__ float fma_f64(double a, double b, double c) {
  return __double2float_rn(__dadd_rn(__dmul_rn(a, b), c));
}

// _log with fma = _fma_f64: x = m 2^e, Cephes' polynomial in m - 1.
__device__ float log_xla(float x) {
  if (!(x > 0.0f) || isinf(x)) return logf(x);  // torch.log's specials
  int ei;
  const float m = frexpf(x, &ei);
  const bool small = m < kSqrtHalf;
  const float e = __fsub_rn(static_cast<float>(ei), small ? 1.0f : 0.0f);
  const float z = __fadd_rn(__fsub_rn(m, 1.0f), small ? m : 0.0f);
  const float z2 = __fmul_rn(z, z);
  const double zd = z;
  const double z3d = __fmul_rn(z2, z);
  constexpr float kLogP[9] = LOG_P;
  const float y0 = fma_f64(fma_f64(zd, kLogP[0], kLogP[1]), zd, kLogP[2]);
  const float y1 = fma_f64(fma_f64(zd, kLogP[3], kLogP[4]), zd, kLogP[5]);
  const float y2 = fma_f64(fma_f64(zd, kLogP[6], kLogP[7]), zd, kLogP[8]);
  float y = fma_f64(fma_f64(y0, z3d, y1), z3d, y2);
  y = fma_f64(y, z3d, __fmul_rn(e, kLogQ1));
  return fma_f64(e, kLogQ2,
                 __fadd_rn(__fsub_rn(z, __fmul_rn(z2, 0.5f)), y));
}

// _log1p with fma = _fma_f64: Cephes' rational below |x| = sqrt(2) - 1,
// log(1 + x) above it (prng.py computes both and selects one).
__device__ float log1p_xla(float x) {
  constexpr float kNum[7] = LOG1P_NUM;
  constexpr float kDen[6] = LOG1P_DEN;
  if (!(fabsf(x) < kLog1pSmall)) return log_xla(__fadd_rn(x, 1.0f));
  const float t = __fmul_rn(x, 0.0f);
  const double xd = x;
  float num = __fadd_rn(t, kNum[0]);
#pragma unroll
  for (int i = 1; i < 7; ++i) num = fma_f64(num, xd, kNum[i]);
  float den = __fadd_rn(t, 1.0f);
#pragma unroll
  for (int i = 0; i < 6; ++i) den = fma_f64(den, xd, kDen[i]);
  const float ratio = __fdiv_rn(num, den);
  const float x2 = __fmul_rn(x, x);
  return __fadd_rn(x, fma_f64(x2, -0.5, __fmul_rn(__fmul_rn(x, x2), ratio)));
}

// _erfinv (erf_inv on the draws' inputs): Giles' polynomial of w's side
// of 5 times x, its FMAs as _fma_f64.
__device__ float erfinv_xla(float x) {
  constexpr float kLt5[9] = ERFINV_LT5;
  constexpr float kGe5[9] = ERFINV_GE5;
  if (fabsf(x) == 1.0f) return __fmul_rn(x, __int_as_float(0x7F800000));
  float w = -log1p_xla(__fmul_rn(x, -x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f)
         : __fsub_rn(__double2float_rn(__dsqrt_rn(static_cast<double>(w))),
                     3.0f);  // sqrt_f32
  const double wd = w;
  float p = lt ? kLt5[0] : kGe5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    // selected as doubles, so that no conversion runs on the card
    p = fma_f64(p, wd, lt ? static_cast<double>(kLt5[i])
                          : static_cast<double>(kGe5[i]));
  }
  return __fmul_rn(p, x);
}

// _bits_to_normal: sqrt(2) erfinv(U(nextafter(-1, 0), 1)), the uniform's
// affine map as _affine with _fma_f64, then clamped below.
__device__ __forceinline__ float bits_to_normal(uint32_t b) {
  float v = fma_f64(bits_to_unit(b), kNormalSpan, kNormalLo);
  v = v < kNormalLo ? kNormalLo : v;  // clamp_min, NaN kept
  return __fmul_rn(kSqrt2, erfinv_xla(v));
}

// fma_f32: the f64 sum of the exact product and c, moved one f64 ulp
// toward the exact sum where it falls on a midpoint between two f32
// values but the exact sum does not (Knuth's two-sum error), then
// rounded to f32.
__device__ __forceinline__ float fma_f32(float a, float b, float c) {
  const double prod = __dmul_rn(a, b);
  double s = __dadd_rn(prod, c);
  const double v = __dsub_rn(s, prod);
  const double err = __dadd_rn(__dsub_rn(prod, __dsub_rn(s, v)),
                               __dsub_rn(static_cast<double>(c), v));
  const long long bits = __double_as_longlong(s);
  if ((bits & ((1LL << 29) - 1)) == (1LL << 28) && err != 0.0) {
    s = __longlong_as_double(bits + ((err > 0.0) == (s > 0.0) ? 1 : -1));
  }
  return __double2float_rn(s);
}

template <int kKind>
__device__ __forceinline__ void store(void* out, long long j, uint32_t b,
                                      float p) {
  if (kKind == kBernoulli) {
    static_cast<bool*>(out)[j] = bits_to_unit(b) < p;
  } else if (kKind == kUniform) {
    static_cast<float*>(out)[j] = bits_to_unit(b);
  } else {
    static_cast<float*>(out)[j] = bits_to_normal(b);
  }
}

// JAX's non-partitionable count layout: pair i of a row is (i, i + half),
// half = ceil(n/2); an odd n pads the last pair's second count with 0;
// the pair's outputs are elements i and i + half of the row.
template <int kKind>
__global__ void __launch_bounds__(kThreads)
    sample_kernel(const long long* __restrict__ keys, long long key_stride,
                  long long rows, long long n, float p,
                  void* __restrict__ out) {
  const long long half = (n + 1) / 2;
  const long long pairs = rows * half;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  uint32_t k1 = static_cast<uint32_t>(keys[0]);
  uint32_t k2 = static_cast<uint32_t>(keys[1]);
  for (long long t = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       t < pairs; t += stride) {
    long long row = 0, i = t;
    if (rows > 1) {
      row = t / half;
      i = t - row * half;
      k1 = static_cast<uint32_t>(keys[row * key_stride]);
      k2 = static_cast<uint32_t>(keys[row * key_stride + 1]);
    }
    uint32_t x0 = static_cast<uint32_t>(i);
    uint32_t x1 = i + half < n ? static_cast<uint32_t>(i + half) : 0u;
    threefry2x32(k1, k2, x0, x1);
    store<kKind>(out, row * n + i, x0, p);
    if (i + half < n) store<kKind>(out, row * n + i + half, x1, p);
  }
}

__device__ __forceinline__ float combine_one(float x, unsigned char m,
                                             uint32_t b, float beta,
                                             float sigma0, float scale) {
  const float mf = m ? 1.0f : 0.0f;
  const float z = bits_to_normal(b);
  return __fmul_rn(fma_f32(__fmul_rn(x, mf), beta,
                           __fmul_rn(__fmul_rn(sigma0, mf), z)),
                   scale);
}

__global__ void __launch_bounds__(kThreads)
    combine_kernel(const float* __restrict__ x,
                   const unsigned char* __restrict__ mask,
                   const long long* __restrict__ key,
                   const float* __restrict__ beta_p,
                   const float* __restrict__ scale_p, float sigma0,
                   float* __restrict__ out, long long n) {
  const long long half = (n + 1) / 2;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const uint32_t k1 = static_cast<uint32_t>(key[0]);
  const uint32_t k2 = static_cast<uint32_t>(key[1]);
  const float beta = *beta_p, scale = *scale_p;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < half; i += stride) {
    const long long j = i + half;
    uint32_t x0 = static_cast<uint32_t>(i);
    uint32_t x1 = j < n ? static_cast<uint32_t>(j) : 0u;
    threefry2x32(k1, k2, x0, x1);
    out[i] = combine_one(x[i], mask[i], x0, beta, sigma0, scale);
    if (j < n) out[j] = combine_one(x[j], mask[j], x1, beta, sigma0, scale);
  }
}

// The blocks of each kernel resident at once on one device, set up once:
// 0-2 threefry_sample of kind 0-2, 3 threefry_combine.
int resident(int which, int dev) {
  static int cached[4][kMaxDevices];
  int& n = cached[which][dev];
  if (n == 0) {
    const void* fns[4] = {reinterpret_cast<const void*>(sample_kernel<0>),
                          reinterpret_cast<const void*>(sample_kernel<1>),
                          reinterpret_cast<const void*>(sample_kernel<2>),
                          reinterpret_cast<const void*>(combine_kernel)};
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fns[which],
                                                      kThreads, 0) !=
            cudaSuccess ||
        per_sm < 1) {
      return -1;
    }
    n = per_sm * sms;
  }
  return n;
}

int grid_for(int which, int dev, long long pairs) {
  const int most = resident(which, dev);
  if (most < 1) return -1;
  const long long blocks = (pairs + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < most ? blocks : most);
}

// Makes dev the current device for one launch, and the caller's again
// after it.
struct DeviceScope {
  int prev = -1;
  int err = 0;
  explicit DeviceScope(int dev) {
    if (dev < 0 || dev >= kMaxDevices) {
      err = static_cast<int>(cudaErrorInvalidDevice);
    } else if ((err = static_cast<int>(cudaGetDevice(&prev))) == 0 &&
               prev != dev) {
      err = static_cast<int>(cudaSetDevice(dev));
    } else {
      prev = -1;
    }
  }
  ~DeviceScope() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace

extern "C" {

// kind: 0 uniform, 1 bernoulli, 2 normal. keys: rows keys of two int64
// words each (the uint32 values), key_stride int64s apart; out: rows * n
// f32 (bool for bernoulli), row after row; 0 < n < 2^32; p: bernoulli's
// f32 threshold.
int threefry_sample(int dev, int kind, const void* keys,
                    long long key_stride, long long rows, long long n,
                    float p, void* out, void* stream) {
  DeviceScope scope(dev);
  if (scope.err != 0) return scope.err;
  if (kind < 0 || kind > 2 || rows < 1 || n < 1 || n >= (1LL << 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = grid_for(kind, dev, rows * ((n + 1) / 2));
  if (grid < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* k = static_cast<const long long*>(keys);
  if (kind == kUniform) {
    sample_kernel<kUniform><<<grid, kThreads, 0, s>>>(k, key_stride, rows,
                                                       n, p, out);
  } else if (kind == kBernoulli) {
    sample_kernel<kBernoulli><<<grid, kThreads, 0, s>>>(k, key_stride, rows,
                                                         n, p, out);
  } else {
    sample_kernel<kNormal><<<grid, kThreads, 0, s>>>(k, key_stride, rows, n,
                                                      p, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// x: n f32; mask: n bools; key: two int64 words; beta, scale: one f32
// each, on the device; out: n f32; 0 < n < 2^32.
int threefry_combine(int dev, const void* x, const void* mask,
                     const void* key, const void* beta, const void* scale,
                     float sigma0, void* out, long long n, void* stream) {
  DeviceScope scope(dev);
  if (scope.err != 0) return scope.err;
  if (n < 1 || n >= (1LL << 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = grid_for(3, dev, (n + 1) / 2);
  if (grid < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  combine_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const unsigned char*>(mask),
      static_cast<const long long*>(key), static_cast<const float*>(beta),
      static_cast<const float*>(scale), sigma0, static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
