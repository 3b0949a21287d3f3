// Hopper (sm_90a) kernels of the flash-attention forward, with a plain C
// interface loaded through ctypes.
//
// They replace the Pallas TPU kernel of src/repro/kernels/flash_attn/kernel.py
// (_kernel via flash_attention_fwd). For every (batch b, query head h,
// query row i), with KV head h / (H / Hkv) and positions aligned at the
// suffix (row i sits at rq = i + Skv - Sq):
//   s_j  = (q_i . k_j) / sqrt(Dh)                      in f32
//   s_j  = NEG_INF where causal and rq < j, or windowed and rq - j >= window
//   out  = sum_j exp(s_j - m) v_j / max(sum_j exp(s_j - m), 1e-30)
// by the online softmax over KV tiles (running max m, sum l, accumulator),
// NEG_INF = -0.7 * FLT_MAX as in the TPU kernel, -inf for keys past Skv;
// the output is in q's dtype (f32, or bf16 rounded to nearest even).
// No atomics and a fixed order of every sum: results are bit-identical
// from run to run.
//
// What bounds it: operations. At zamba2-2.7b's prefill (B 8, S 2048,
// H = Hkv = 32, Dh 80, causal) the kept (query, key) pairs need 1.72e11
// FLOP against 0.34 GB of inputs and output: 0.174 ms on the bf16 tensor
// cores (989 TFLOP/s) against 0.100 ms of memory traffic. Beside the
// products, every kept pair takes one exp2 on the special-function units
// (16 a clock per SM): at Dh 80 that is about as long as the products, so
// the bf16 design keeps the softmax off the products' critical path.
//
// Two routes, by dtype:
//
// bf16 (what serving runs): tensor cores and the Tensor Memory Accelerator.
//   One block owns one (b, h) and 128 query rows: two consumer warpgroups
//   of 64 rows each, and a producer warpgroup that gives its registers to
//   them (setmaxnreg: 40 and 232 a thread). The query tiles of one (b, h)
//   are launched together, the last (most causal work) first, so they
//   share that head's K and V in L2.
//   - Loads: K and V tiles of BK keys (128; 64 at Dh >= 128, where
//     registers are tight) through a ring of 2 stages, by TMA
//     (cp.async.bulk.tensor, 4-D maps {Dh, heads, S, B} built on the host
//     for each call) into swizzled shared memory. One thread of the
//     producer starts every copy; mbarriers report completion ("full")
//     and release ("empty", one arrival per consumer warpgroup, K and V
//     apart), so loads run ahead of the products. Q is read once per
//     block, straight into wgmma's register A fragments.
//   - S = Q K^T: wgmma.mma_async m64n{BK}k16, bf16 in, f32 accumulator, Q
//     from registers, K K-major in shared memory. Q goes in unscaled (it
//     is the input, exact in bf16); S is scaled by log2(e) / sqrt(Dh) in
//     f32.
//   - Online softmax in registers: a row of the accumulator lives in the 4
//     threads of a quad, so its max takes two __shfl_xor_sync steps; each
//     thread keeps a partial l over its own columns, summed over the quad
//     once at the end. Masks run only on tiles that cross the diagonal,
//     the window's edge or Skv.
//   - O += P V: P is rounded to bf16 in registers and is wgmma's register
//     A operand (the f32 accumulator's fragment of S is the A fragment of
//     P, FlashAttention-3's layout trick: no trip through shared memory).
//     V is the B operand, MN-major (Dh contiguous), with wgmma's transpose
//     bit. l sums the f32 p, so P's rounding moves the output by at most
//     2^-9 max|v| (see tests/test_torch_flash_attn.py).
//   - Overlap: a warpgroup starts tile i's S product together with tile
//     i - 1's P V and runs tile i's softmax while P V runs; the two
//     warpgroups take turns to start them (named barriers), so one's softmax
//     runs while the other's products hold the tensor cores.
//   - Epilogue: O / max(l, 1e-30), rounded to bf16, stored from registers
//     with rows past Sq masked.
//   Traps, each handled where it is marked TRAP n below:
//   1. Dh = 80, 96 and 160 are not multiples of 64, the widest row of a
//      128-byte swizzle: the head dimension is loaded as boxes of 64
//      columns (128-byte swizzle) and a tail box of 16 or 32 columns
//      (32- or 64-byte swizzle), so nothing past Dh is loaded; Q K^T
//      runs only Dh / 16 k-steps (5 at Dh 80), and P V one N chunk per
//      box (64, then 16 or 32 columns).
//   2. The wgmma descriptors: start address >> 4, LBO, SBO (both >> 4),
//      and the swizzle mode of the box; every box starts 1024-byte
//      aligned, so the base offset is 0.
//   3. mbarrier phase parity: the i-th use of stage s waits on parity
//      (i / 2) & 1; the producer's first wait on "empty" passes (parity 1
//      of a fresh barrier). A wait that never ends traps after ~2^35
//      cycles, so a wrong phase fails the launch rather than hanging it.
//   4. The finite NEG_INF: a row whose first visited tile is wholly masked
//      (at a window's edge) sums exp(NEG_INF - NEG_INF) = 1 per key; its
//      next real score wipes that with corr = exp2(NEG_INF - m) = 0, as
//      the TPU kernel does. m never becomes -inf, so no NaN.
//   5. Ragged edges: rows past Sq read as zeros and are never stored; keys
//      past Skv load as zeros (TMA fills outside the tensor) and score
//      -inf by their index.
//   6. Build: plain PTX in this one file (no CUTLASS), and
//      cuTensorMapEncodeTiled is fetched with cudaGetDriverEntryPoint, so
//      the library needs no -lcuda.
//
// f32 (the on-card f32 parity runs): CUDA cores. One block owns one (b, h,
//   tile of 64 query rows) and loops over the KV tiles of 64 keys itself,
//   skipping the tiles that the causal mask or the window hide from every
//   row of its tile. Per KV tile:
//   1. K and V into shared memory as f32 (Q, pre-scaled, was loaded once);
//   2. the 64 x 64 scores, a 4 x 4 register tile per thread, masked and
//      written to shared memory;
//   3. four threads per row take the row's max, exp and sum (shuffles in a
//      fixed order) and update m, l and the correction factor;
//   4. acc = acc * corr + P V, a 4 x (Dh/16) register tile per thread.
//   Rows of Q and K are padded to Dh + 1 floats, rows of the scores to 65,
//   so lanes reading down a column hit distinct banks.
//
// Limits, checked by the wrapper: Dh in {64, 80, 96, 128, 160}, H a
// multiple of Hkv, contiguous (B, S, heads, Dh) tensors, bf16 data 16-byte
// aligned (TMA). The entry point launches on the caller's stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError()
// (or cudaErrorInvalidValue if a tensor map cannot be encoded).

#include <cuda.h>   // CUtensorMap and its enums; libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ============================================================ f32 route

constexpr int kThreads = 256;   // a 16 x 16 grid of threads
constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per KV tile
constexpr int kSP = kBK + 1;    // padded row of the score tile
constexpr float kNegInf = -0.7f * 3.4028234663852886e38f;

__host__ __device__ __forceinline__ int smem_floats(int d) {
  return kBQ * (d + 1)      // Q, pre-scaled
         + kBK * (d + 1)    // K
         + kBK * d          // V
         + kBQ * kSP        // scores, then probabilities
         + 3 * kBQ;         // m, l, corr
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int Sq,
                 int Skv, int H, int Hkv, float scale, int causal,
                 int window) {
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
  const float* qb = q + static_cast<long long>(b) * Sq * q_row +
                    static_cast<long long>(h) * D;
  const float* kb = k + static_cast<long long>(b) * Skv * kv_row +
                    static_cast<long long>(hk) * D;
  const float* vb = v + static_cast<long long>(b) * Skv * kv_row +
                    static_cast<long long>(hk) * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    float val = 0.0f;
    if (q0 + r < Sq) val = qb[(q0 + r) * q_row + d] * scale;
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
        kv = kb[(k0 + j) * kv_row + d];
        vv = vb[(k0 + j) * kv_row + d];
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

  float* ob = o + static_cast<long long>(b) * Sq * q_row +
              static_cast<long long>(h) * D;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = ty * 4 + u;
    if (q0 + r < Sq) {
      const float denom = fmaxf(l_s[r], 1e-30f);
#pragma unroll
      for (int c = 0; c < DT; ++c)
        ob[(q0 + r) * q_row + tx + 16 * c] = acc[u][c] / denom;
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int Hkv, float scale, int causal,
           int window, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(smem_floats(D)) * sizeof(float);
  auto kern = flash_fwd_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Skv, H, Hkv,
      scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}


// ============================================================ bf16 route

namespace tc {

constexpr int kConsumers = 2;                   // warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);  // and a producer warpgroup
constexpr int kBQ = 64 * kConsumers;             // query rows per block
constexpr int kStages = 2;                       // K/V ring
constexpr int kBoxCols = 64;    // bf16 columns of one 128-byte swizzled row
constexpr float kLog2e = 1.4426950408889634f;
constexpr long long kHangCycles = 1ll << 35;
// registers per thread: the producer warpgroup gives up what the
// consumers' accumulators need (128 x (40 + 2 x 232) <= 65,536)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// TRAP 1: Dh = 64 f + t, f full boxes of 64 columns in the 128-byte
// swizzle and a tail box of t = 0, 16 or 32 columns in the 32- or 64-byte
// swizzle (the widest that its rows fill), so no column past Dh is loaded
// or stored. A K or V tile is [full boxes][tail box], each box BK rows.
template <int D>
struct Cfg {
  static constexpr int kBK = D >= 128 ? 64 : 128;      // keys per tile
  static constexpr int kFull = D / kBoxCols;
  static constexpr int kTail = D % kBoxCols;
  static constexpr int kTailRow = 2 * kTail;           // bytes: 0, 32, 64
  static constexpr int kBox = kBK * 128;               // a full box
  static constexpr int kTailBox = kBK * kTailRow;
  static constexpr int kKVBytes = kFull * kBox + kTailBox;   // a K (or V) tile
  static constexpr int kBarOff = 2 * kStages * kKVBytes;
  // 1024 bytes of slack to align the base for the swizzle, 8 mbarriers
  static constexpr int kSmem = 1024 + kBarOff + 64;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// TRAP 3: returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long t0 = 0;
  for (int n = 0;; ++n) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == 0) t0 = clock64();
    else if (clock64() - t0 > kHangCycles) __trap();
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// TRAP 2: a wgmma shared-memory descriptor. `row` is the swizzle's row in
// bytes (128, 64 or 32; layout types 1, 2, 3 in bits 62-63); SBO, the
// stride between groups of 8 rows, is 8 rows. K (K-major) and V
// (MN-major) boxes are read within one swizzle row, so LBO, the stride
// to the next row-wide block, is never reached (set to the box).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, int row,
                                              uint32_t box) {
  const uint64_t layout = row == 128 ? 1 : (row == 64 ? 2 : 3);
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((box >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(((8 * row) >> 4) & 0x3FFF) << 32) |
         (layout << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of wgmma's registers across the
// asynchronous product
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (*pa)[4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(pa[i][r])::"memory");
}

// Ping-pong between the two consumer warpgroups (named barriers 1 and 2,
// 256 threads: one warpgroup syncs, the other arrives): warpgroup w starts
// its products only on its turn and passes the turn right after, so one
// warpgroup's softmax runs while the other's products use the tensor
// cores.
template <int ID>
__device__ __forceinline__ void bar_sync_n() {
  asm volatile("bar.sync %0, 256;\n" ::"n"(ID) : "memory");
}
template <int ID>
__device__ __forceinline__ void bar_arrive_n() {
  asm volatile("bar.arrive %0, 256;\n" ::"n"(ID) : "memory");
}
__device__ __forceinline__ void turn_wait(int wg) {
  if (wg == 0) bar_sync_n<1>();
  else bar_sync_n<2>();
}
__device__ __forceinline__ void turn_pass(int wg) {
  if (wg == 0) bar_arrive_n<2>();
  else bar_arrive_n<1>();
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- wgmma m64nNk16, bf16 in, f32 accumulator d[N / 2] per thread, A
// from registers (4 x bf16x2: the fragment of rows r, r + 8 and columns
// 2 (lane % 4) + {0, 1}, + 8 of the thread's warp's 16 rows), B from
// shared memory. _kmajor: B K-major (K, for S = Q K^T); scale_d = 0
// overwrites d. The others: B MN-major (V, transpose bit set), accumulate.

__device__ __forceinline__ void wgmma_rs_kmajor_n128(
    float* d, const uint32_t* a, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_kmajor_n64(
    float* d, const uint32_t* a, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else wgmma_rs_n16(d, a, db);
}

template <int BK>
__device__ __forceinline__ void wgmma_qk(float* d, const uint32_t* a,
                                         uint64_t db, int scale_d) {
  if constexpr (BK == 128) wgmma_rs_kmajor_n128(d, a, db, scale_d);
  else wgmma_rs_kmajor_n64(d, a, db, scale_d);
}

// S = Q K^T for the warpgroup's 64 rows of Q (register fragments qa) and
// one K tile (TRAP 1, 2: D / 16 k-steps, 5 at Dh 80; k-step kk is 32 bytes
// into a swizzled row of its box)
template <int D>
__device__ __forceinline__ void qk_gemm(float* sc, uint32_t (*qa)[4],
                                        uint32_t k) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < 4 * C::kFull; ++kk)
    wgmma_qk<C::kBK>(sc, qa[kk],
                     make_desc(k + (kk / 4) * C::kBox + (kk % 4) * 32, 128,
                               C::kBox),
                     kk > 0);
#pragma unroll
  for (int kk = 0; kk < C::kTail / 16; ++kk)
    wgmma_qk<C::kBK>(sc, qa[4 * C::kFull + kk],
                     make_desc(k + C::kFull * C::kBox + kk * 32, C::kTailRow,
                               C::kTailBox),
                     C::kFull > 0 || kk > 0);
}

// O += P V for one V tile (TRAP 1, 2: an N chunk of 64 columns per full
// box, then one of 16 or 32 for the tail; a k-step is 16 rows of a box)
template <int D>
__device__ __forceinline__ void pv_gemm(float* acc, uint32_t (*pa)[4],
                                        uint32_t v) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < C::kBK / 16; ++kk) {
#pragma unroll
    for (int c = 0; c < C::kFull; ++c)
      wgmma_rs<kBoxCols>(acc + 32 * c, pa[kk],
                         make_desc(v + c * C::kBox + kk * 16 * 128, 128,
                                   C::kBox));
    if constexpr (C::kTail > 0)
      wgmma_rs<C::kTail>(acc + 32 * C::kFull, pa[kk],
                         make_desc(v + C::kFull * C::kBox +
                                       kk * 16 * C::kTailRow,
                                   C::kTailRow, C::kTailBox));
  }
}

// The online softmax of one tile of scores, in registers (TRAP 4, 5).
// Thread t holds rows r and r + 8 of its warp's 16, columns 8 j + cq and
// + 1 of each group j of 8; a row lives in the 4 threads of a quad. Only a
// tile that crosses the diagonal, the window's edge or Skv is scaled and
// masked first (a branch around whole loops, so other tiles run none of
// its integer work); any other tile keeps its raw scores, takes their max,
// and folds the scale into one FFMA before each ex2 (the max commutes with
// a positive scale). The max and the sum run in 4 independent chains (a
// fixed order), so that a warp does not wait on each add. Writes P as
// wgmma A fragments: for keys 16 kk .. + 15, {row r cols 0-7, row r+8
// cols 0-7, row r cols 8-15, row r+8 cols 8-15}, and the correction
// factors of the two rows.
struct RowState {
  float m0, m1;   // running max, log2 units
  float l0, l1;   // this thread's partial row sums
};

template <int BK>
__device__ __forceinline__ void softmax_tile(float* sc, uint32_t (*pa)[4],
                                             RowState& st, float& c0,
                                             float& c1, bool edge, int rq0,
                                             int k0, int causal, int window,
                                             int Skv, int cq,
                                             float scale_log2) {
  float s = scale_log2;   // what still multiplies sc
  if (edge) {
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int rq = rq0 + ((j & 2) ? 8 : 0);
      const int rk = k0 + (j >> 2) * 8 + cq + (j & 1);
      float x = sc[j] * scale_log2;
      if (causal && rq < rk) x = kNegInf;
      if (window > 0 && rq - rk >= window) x = kNegInf;
      if (rk >= Skv) x = -INFINITY;
      sc[j] = x;
    }
    s = 1.0f;
  }
  float mx0[4], mx1[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) mx0[u] = mx1[u] = -INFINITY;
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) {
    if (j & 2) mx1[(j >> 2) & 3] = fmaxf(mx1[(j >> 2) & 3], sc[j]);
    else mx0[(j >> 2) & 3] = fmaxf(mx0[(j >> 2) & 3], sc[j]);
  }
  float m0 = fmaxf(fmaxf(mx0[0], mx0[1]), fmaxf(mx0[2], mx0[3]));
  float m1 = fmaxf(fmaxf(mx1[0], mx1[1]), fmaxf(mx1[2], mx1[3]));
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
  const float mn0 = fmaxf(st.m0, m0 * s);
  const float mn1 = fmaxf(st.m1, m1 * s);
  c0 = ex2(st.m0 - mn0);
  c1 = ex2(st.m1 - mn1);
  st.m0 = mn0;
  st.m1 = mn1;
  float ps0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float ps1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = 8 * kk + 4 * half;
      const int u = (2 * kk + half) & 3;
      const float p00 = ex2(fmaf(sc[j], s, -mn0));
      const float p01 = ex2(fmaf(sc[j + 1], s, -mn0));
      const float p10 = ex2(fmaf(sc[j + 2], s, -mn1));
      const float p11 = ex2(fmaf(sc[j + 3], s, -mn1));
      ps0[u] += p00 + p01;
      ps1[u] += p10 + p11;
      pa[kk][2 * half] = pack_bf16(p00, p01);
      pa[kk][2 * half + 1] = pack_bf16(p10, p11);
    }
  }
  st.l0 = st.l0 * c0 + ((ps0[0] + ps0[1]) + (ps0[2] + ps0[3]));
  st.l1 = st.l1 * c1 + ((ps1[0] + ps1[1]) + (ps1[2] + ps1[3]));
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tk_tail,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tv_tail,
                    const __nv_bfloat16* __restrict__ q,
                    __nv_bfloat16* __restrict__ o, int Sq, int Skv, int H,
                    int Hkv, float scale_log2, int causal, int window) {
  using C = Cfg<D>;
  constexpr int BK = C::kBK;
  constexpr int NS = BK / 2;      // S accumulator floats per thread
  constexpr int NO = D / 2;       // O accumulator floats per thread
  constexpr int KQK = D / 16;     // k-steps of Q K^T
  constexpr int KPV = BK / 16;    // k-steps of P V
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = base;                            // + stage * kKVBytes
  const uint32_t sV = sK + kStages * C::kKVBytes;      // + stage * kKVBytes
  // mbarriers, one of each per stage: K and V loaded ("full"), K and V
  // read by both consumer warpgroups ("empty")
  const uint32_t bar_k = base + C::kBarOff;
  const uint32_t bar_v = bar_k + 8 * kStages;
  const uint32_t bar_ek = bar_v + 8 * kStages;
  const uint32_t bar_ev = bar_ek + 8 * kStages;

  // the query tiles of one (b, h) are neighbours in the launch order, so
  // they share K and V in L2; the last (most causal work) goes first
  const int q0 = static_cast<int>(gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int off = Skv - Sq;
  // the KV tiles some row of this query tile can see
  const int r_last = min(q0 + kBQ, Sq) - 1;
  int kv_end = Skv;
  if (causal) kv_end = min(Skv, r_last + off + 1);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q0 + off - window + 1);
  const int t_begin = kv_begin / BK;
  const int n_tiles = (kv_end + BK - 1) / BK - t_begin;

  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_ek + 8 * s, kConsumers);
      mbar_init(bar_ev + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128 * kConsumers) {   // ---- producer: one thread loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 128 * kConsumers) {
      auto load = [&](const CUtensorMap* full, const CUtensorMap* tail,
                      uint32_t dst, uint32_t bar, int k0) {
        mbar_expect_tx(bar, C::kKVBytes);
#pragma unroll
        for (int c = 0; c < C::kFull; ++c)
          tma_load(dst + c * C::kBox, full, bar, c * kBoxCols, hk, k0, b);
        if constexpr (C::kTail > 0)
          tma_load(dst + C::kFull * C::kBox, tail, bar, C::kFull * kBoxCols,
                   hk, k0, b);
      };
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const uint32_t ph = (i / kStages) & 1;
        const int k0 = (t_begin + i) * BK;
        mbar_wait(bar_ek + 8 * s, ph ^ 1);
        load(&tk, &tk_tail, sK + s * C::kKVBytes, bar_k + 8 * s, k0);
        mbar_wait(bar_ev + 8 * s, ph ^ 1);
        load(&tv, &tv_tail, sV + s * C::kKVBytes, bar_v + 8 * s, k0);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  // ---- consumer warpgroup wg: query rows q0 + 64 wg .. + 63, thread t
  // rows row0 and row0 + 8. Q is loaded once, straight into the wgmma A
  // fragments, unscaled (rows past Sq as zeros: TRAP 5). Tile i's S
  // product is started together with tile i - 1's P V, and tile i's
  // softmax runs while P V does.
  const int wg = tid >> 7;
  const int t = tid & 127;
  const int lane = t & 31;
  const int row0 = q0 + wg * 64 + (t >> 5) * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);

  uint32_t qa[KQK][4];
  {
    const long long q_row = static_cast<long long>(H) * D;
    const __nv_bfloat16* qh = q + static_cast<long long>(b) * Sq * q_row +
                              static_cast<long long>(h) * D + cq;
#pragma unroll
    for (int kk = 0; kk < KQK; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = row0 + (r & 1) * 8;
        const int col = 16 * kk + (r >> 1) * 8;
        qa[kk][r] = row < Sq ? __ldg(reinterpret_cast<const unsigned int*>(
                                   qh + row * q_row + col))
                             : 0u;
      }
  }

  float sc[NS];
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NS; ++i) sc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.0f;
  RowState st = {kNegInf, kNegInf, 0.0f, 0.0f};
  uint32_t pa[KPV][4];    // P of the tile whose P V is in flight
  float c0, c1;
  auto is_edge = [&](int k0) {
    return (causal && k0 + BK - 1 > q0 + off) ||
           (window > 0 && q0 + kBQ - 1 + off - k0 >= window) ||
           k0 + BK > Skv;
  };

  // warpgroup 0 has the first turn; each warpgroup waits for its turn
  // n_tiles + 1 times and passes it as often, but for warpgroup 1's last
  if (wg == 1) bar_arrive_n<1>();
  {  // tile 0: S, softmax (O is zero: no correction)
    const int k0 = t_begin * BK;
    mbar_wait(bar_k, 0);
    fence_regs<NS>(sc);
    turn_wait(wg);
    wg_fence();
    qk_gemm<D>(sc, qa, sK);
    wg_commit();
    turn_pass(wg);
    wg_wait<0>();
    fence_regs<NS>(sc);
    if (t == 0) mbar_arrive(bar_ek);
    softmax_tile<BK>(sc, pa, st, c0, c1, is_edge(k0), row0 + off, k0,
                     causal, window, Skv, cq, scale_log2);
  }
  for (int i = 1; i < n_tiles; ++i) {
    const int s = i % kStages;
    const int sp = (i - 1) % kStages;
    const int k0 = (t_begin + i) * BK;
    mbar_wait(bar_k + 8 * s, (i / kStages) & 1);
    mbar_wait(bar_v + 8 * sp, ((i - 1) / kStages) & 1);
    fence_regs<NS>(sc);
    fence_regs<NO>(acc);
    fence_frags<KPV>(pa);
    turn_wait(wg);
    wg_fence();
    qk_gemm<D>(sc, qa, sK + s * C::kKVBytes);
    wg_commit();
    pv_gemm<D>(acc, pa, sV + sp * C::kKVBytes);
    wg_commit();
    turn_pass(wg);
    wg_wait<1>();                 // S of tile i is done, P V runs on
    fence_regs<NS>(sc);
    if (t == 0) mbar_arrive(bar_ek + 8 * s);
    uint32_t pn[KPV][4];
    softmax_tile<BK>(sc, pn, st, c0, c1, is_edge(k0), row0 + off, k0,
                     causal, window, Skv, cq, scale_log2);
    wg_wait<0>();
    fence_regs<NO>(acc);
    fence_frags<KPV>(pa);
    if (t == 0) mbar_arrive(bar_ev + 8 * sp);
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[j] *= (j & 2) ? c1 : c0;
#pragma unroll
    for (int kk = 0; kk < KPV; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pn[kk][r];
  }
  {  // the last tile's P V
    const int sp = (n_tiles - 1) % kStages;
    mbar_wait(bar_v + 8 * sp, ((n_tiles - 1) / kStages) & 1);
    fence_regs<NO>(acc);
    fence_frags<KPV>(pa);
    turn_wait(wg);
    wg_fence();
    pv_gemm<D>(acc, pa, sV + sp * C::kKVBytes);
    wg_commit();
    if (wg == 0) turn_pass(wg);
    wg_wait<0>();
    fence_regs<NO>(acc);
  }

  // ---- epilogue: l over the quad, O / max(l, 1e-30) to bf16, rows < Sq
  float l0 = st.l0, l1 = st.l1;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f);
  const float d1 = fmaxf(l1, 1e-30f);
  const long long q_row = static_cast<long long>(H) * D;
  __nv_bfloat16* ob = o + static_cast<long long>(b) * Sq * q_row +
                      static_cast<long long>(h) * D;
#pragma unroll
  for (int j = 0; j < NO; j += 4) {
    const int col = (j / 32) * kBoxCols + ((j % 32) / 4) * 8 + cq;
    if (row0 < Sq)
      *reinterpret_cast<uint32_t*>(ob + row0 * q_row + col) =
          pack_bf16(acc[j] / d0, acc[j + 1] / d0);
    if (row0 + 8 < Sq)
      *reinterpret_cast<uint32_t*>(ob + (row0 + 8) * q_row + col) =
          pack_bf16(acc[j + 2] / d1, acc[j + 3] / d1);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// TRAP 6: the tensor-map encoder, fetched through the runtime, so nothing
// links -lcuda
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a 4-D map {Dh, heads, S, B} over a contiguous (B, S, heads, Dh) bf16
// tensor, read in boxes of `cols` columns (64, 32 or 16: one swizzled row
// of 128, 64 or 32 bytes) x `rows` rows of one head
bool make_map(CUtensorMap* map, const void* ptr, int D, int heads, int S,
              int B, int rows, int cols) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(D) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                 : (cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                               : CU_TENSOR_MAP_SWIZZLE_32B);
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int Hkv, float scale, int causal,
           int window, cudaStream_t stream) {
  using C = Cfg<D>;
  // with no tail, the tail maps are the full ones again (never read)
  const int tail = C::kTail > 0 ? C::kTail : kBoxCols;
  CUtensorMap tk, tk_tail, tv, tv_tail;
  if (!make_map(&tk, k, D, Hkv, Skv, B, C::kBK, kBoxCols) ||
      !make_map(&tk_tail, k, D, Hkv, Skv, B, C::kBK, tail) ||
      !make_map(&tv, v, D, Hkv, Skv, B, C::kBK, kBoxCols) ||
      !make_map(&tv_tail, v, D, Hkv, Skv, B, C::kBK, tail))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_fwd_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, C::kSmem, stream>>>(
      tk, tk_tail, tv, tv_tail, static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(o), Sq, Skv, H, Hkv, scale * kLog2e,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

int dispatch_f32(int D, const void* q, const void* k, const void* v, void* o,
                 int B, int Sq, int Skv, int H, int Hkv, float scale,
                 int causal, int window, cudaStream_t st) {
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, B, Sq, Skv, H, Hkv, scale, causal,
                        window, st);
    case 80:
      return launch<80>(q, k, v, o, B, Sq, Skv, H, Hkv, scale, causal,
                        window, st);
    case 96:
      return launch<96>(q, k, v, o, B, Sq, Skv, H, Hkv, scale, causal,
                        window, st);
    case 128:
      return launch<128>(q, k, v, o, B, Sq, Skv, H, Hkv, scale, causal,
                         window, st);
    case 160:
      return launch<160>(q, k, v, o, B, Sq, Skv, H, Hkv, scale, causal,
                         window, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch_bf16(int D, const void* q, const void* k, const void* v,
                  void* o, int B, int Sq, int Skv, int H, int Hkv,
                  float scale, int causal, int window, cudaStream_t st) {
  switch (D) {
    case 64:
      return tc::launch<64>(q, k, v, o, B, Sq, Skv, H, Hkv, scale, causal,
                            window, st);
    case 80:
      return tc::launch<80>(q, k, v, o, B, Sq, Skv, H, Hkv, scale, causal,
                            window, st);
    case 96:
      return tc::launch<96>(q, k, v, o, B, Sq, Skv, H, Hkv, scale, causal,
                            window, st);
    case 128:
      return tc::launch<128>(q, k, v, o, B, Sq, Skv, H, Hkv, scale, causal,
                             window, st);
    case 160:
      return tc::launch<160>(q, k, v, o, B, Sq, Skv, H, Hkv, scale, causal,
                             window, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q: (B, Sq, H, D), k and v: (B, Skv, Hkv, D), o: like q; all contiguous,
// bf16 (tensor cores, 16-byte aligned) if is_bf16 else f32 (CUDA cores).
// window <= 0 means no window.
int flash_attn_fwd_launch(int is_bf16, const void* q, const void* k,
                          const void* v, void* o, int B, int Sq, int Skv,
                          int H, int Hkv, int D, float scale, int causal,
                          int window, void* stream) {
  if (Hkv < 1 || H % Hkv != 0 || B < 1 || Sq < 1 || Skv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_bf16(D, q, k, v, o, B, Sq, Skv, H, Hkv, scale, causal,
                         window, st);
  return dispatch_f32(D, q, k, v, o, B, Sq, Skv, H, Hkv, scale, causal,
                      window, st);
}

}  // extern "C"
