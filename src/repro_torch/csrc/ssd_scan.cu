// Hopper (sm_90a) kernels of the Mamba2 SSD chunk scan, with a plain C
// interface loaded through ctypes.
//
// They replace the Pallas TPU kernel of src/repro/kernels/ssd_scan/kernel.py
// (_kernel via ssd_scan). For every (batch b, head h), over the chunks of
// length Q in order, with a (P, N) state H that starts at zero:
//   la   = dt * a[h],  cum = inclusive cumsum(la)           (Q,)
//   G    = (C B^T) o L o dt_j,  L[i][j] = exp(cum_i - cum_j) for i >= j,
//          else 0
//   y    = G x + exp(cum) o (C H^T)                          (Q, P)
//   H    = exp(cum_last) H + x^T W,
//          W[j][n] = B[j][n] exp(cum_last - cum_j) dt_j
// and the final state is written out. dt and a are f32, y and the state
// f32. Both routes run one block per (b, h), looping over its chunks with
// the state on chip (the TPU grid carries it in VMEM across its sequential
// chunk steps; Hopper's blocks run in no order, so nothing is handed
// between blocks), and take the cumsum as one warp's fixed-order scan
// (each lane a contiguous segment, then a shuffle scan of the lane sums).
// No float atomics and a fixed order of every sum: results are
// bit-identical from run to run.
//
// Two routes, by the dtype of x, B and C:
//
// f32 (the parity runs): CUDA cores. Per chunk: dt, B, C and x dt as f32
//   in shared memory; G's causal half in 4x4 register tiles over N, then
//   y from G (x dt) and C H^T, 32 rows a pass; B scaled by
//   exp(cum_last - cum_j) in place and each thread updating its own tile
//   of H. Rows of B and H are padded to N + 1 floats (distinct banks).
//
// bf16 (what serving runs): tensor cores and asynchronous copies.
//   What bounds it: bytes. At zamba2-2.7b's prefill (B 8, S 2048, H 80,
//   P 64, N 64, Q 128) the scan reads 0.17 GB of x and writes 0.34 GB of
//   y: 0.156 ms at 3.35 TB/s. Its products as this route computes them
//   (C B^T for each head, the other three in two passes, below) are about
//   1.2e11 FLOP: 0.12 ms at the dense bf16 tensor-core rate; unsplit, on
//   the f32 CUDA cores (the f32 route), 0.48 ms. So every product runs on
//   the tensor cores, and the loads are asynchronous copies that other
//   products cover: the next chunk's, or another block's.
//   - Loads: each chunk's x (Q x P), B and C (Q x N) bf16 tiles and its Q
//     values of dt go into shared memory by cp.async (16-byte copies; dt 4
//     bytes each, strided by H), one commit group a chunk. The tiles'
//     16-byte chunks are XOR-swizzled by row, so ldmatrix's 8 row
//     addresses hit distinct banks with no padding. An operand whose base
//     or strides are not 16-byte aligned is loaded element by element into
//     the same tiles by the same threads. The ring is 2 stages deep (the
//     next chunk's copies run during this chunk's products) where that
//     fits and costs no block an SM, else 1 stage (the copies start after
//     the products and another block on the SM covers them): at zamba2's
//     width 1 stage is 67 KB a block and two blocks share an SM, where 2
//     stages (117 KB) leave one, slower on an H100 (0.59 against 0.49 ms);
//     at mamba2-130m's (N 128) 2 stages, one block an SM either way.
//   - Products: mma.sync m16n8k16, bf16 in, f32 accumulators, operands
//     from shared memory by ldmatrix (.trans where the operand is stored
//     K-major). wgmma's 64-row tiles would need 64 rows of one product
//     per warpgroup, but the causal G x and the state update have 16-row
//     pieces that differ from warp to warp; at the byte bound the
//     products take half of mma.sync's rate, so it suffices. The kernel
//     is held back by latency instead: 8 warps a block, one or two blocks
//     an SM, and each warp's chain of products, exps and conversions.
//   - Exactness: x, B and C are bf16 inputs and enter every product
//     unchanged. dt and the decays are folded into the other operand,
//     which is f32: G (Q x Q, causal), H (P x N, the carried state) and W
//     (Q x N). Each is split into bf16 halves v = hi + lo, hi = bf16(v),
//     lo = bf16(v - hi), so |v - hi - lo| <= 2^-18 |v|, and runs two
//     passes (hi, lo) into one f32 accumulator. C B^T needs no split:
//     bf16 products are exact in f32.
//   - Per chunk, 8 warps: warp w owns y's rows 16w..16w+15 (if the chunk
//     has them): its C fragments stay in registers; acc = C (Hhi + Hlo)^T,
//     scaled by exp(cum_i); then for each causal 16-column tile j of G,
//     C B^T's tile into registers, G = (C B^T) (exp(cum_i - cum_j) dt_j)
//     (with j > i set to 0 on the diagonal tile, by selects, the only
//     tile that has such pairs), split in registers into
//     the A fragments of G x (the accumulator's layout is the A
//     operand's), acc += Ghi x + Glo x. Row tile t has t + 1 column
//     tiles, so warps w and w + 4, which share a scheduler, take tiles w
//     and 7 - w. y's rows go out as f32, 16-byte stores after one shuffle
//     between lane pairs. The state lives in registers, spread over the
//     8 warps by (16-row, 8-column) tiles: H = exp(cum_last) H, then
//     += x^T Whi + x^T Wlo, W's fragments made in registers from B's and
//     the row scales exp(cum_last - cum_j) dt_j that warp 0 writes with
//     the cumsum (in registers, in warp_cumsum's order).
//     After a barrier each warp writes its tiles of H as bf16 hi and lo
//     into shared memory for the next chunk's C H^T.
//   - Ragged chunks: Q is padded to a multiple of 16 rows. The padded
//     rows of x, B, C and dt are zero in shared memory (never loaded), so
//     they add nothing; their cum is cum[Q-1]; their y is not stored.
//
// Limits, checked by the wrapper before a launch: P and N in {32, 64, 128},
// 1 <= Q <= 128, S % Q == 0, and the shared memory of a chunk
// (ssd_scan_smem_bytes) within the card's per-block limit; there is no
// fallback to one chunk of the whole sequence. Each entry point launches on
// the caller's stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxChunk = 128;

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

int device_max_smem() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return v;
}

// ============================================================ f32 route

namespace f32 {

constexpr int kThreads = 256;   // 8 warps
constexpr int kRows = 32;       // rows of y per pass of step 2

__host__ __device__ __forceinline__ long long smem_floats(int q, int p,
                                                          int n) {
  return static_cast<long long>(q) * (n + 1)   // B, padded rows
         + static_cast<long long>(q) * n       // C
         + static_cast<long long>(q) * p       // x dt
         + static_cast<long long>(p) * (n + 1) // state, padded rows
         + static_cast<long long>(kRows) * q   // G rows of one pass
         + 2LL * q;                            // dt, cum
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const float* __restrict__ bm,
                const float* __restrict__ cm, float* __restrict__ y,
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
      Bs[i * NP + n] = bm[b * bs_b + (t0 + i) * bs_s + n];
      Cs[e] = cm[b * cs_b + (t0 + i) * cs_s + n];
    }
    for (int e = tid; e < Q * P; e += kThreads) {
      const int i = e / P;
      const int p = e - i * P;
      Xs[e] = x[b * xs_b + (t0 + i) * xs_s + h * xs_h + p] * dts[i];
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

template <int P, int N>
int launch(const void* x, const float* dt, const float* a, const void* bm,
           const void* cm, float* y, float* state, int B, int S, int H,
           int Q, long long xs_b, long long xs_s, long long xs_h,
           long long bs_b, long long bs_s, long long cs_b, long long cs_s,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(smem_floats(Q, P, N)) *
                      sizeof(float);
  auto kern = ssd_scan_kernel<P, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), dt, a, static_cast<const float*>(bm),
      static_cast<const float*>(cm), y, state, S, H, Q, xs_b, xs_s, xs_h,
      bs_b, bs_s, cs_b, cs_s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// ============================================================ bf16 route

namespace tc {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

__host__ __device__ __forceinline__ int tile_rows(int q) {
  return (q + 15) / 16 * 16;
}

// Byte offsets into shared memory, every region 16-byte aligned.
struct Smem {
  int x, b, c, dt;     // stage 0's tiles; stage s adds s * stage
  int stage;
  int hhi, hlo, cum, wsc;
  int total;
};

__host__ __device__ __forceinline__ Smem smem_layout(int q, int p, int n,
                                                     int stages) {
  const int qt = tile_rows(q);
  Smem s;
  s.x = 0;
  s.b = s.x + qt * p * 2;
  s.c = s.b + qt * n * 2;
  s.dt = s.c + qt * n * 2;
  s.stage = s.dt + qt * 4;
  s.hhi = stages * s.stage;
  s.hlo = s.hhi + p * n * 2;
  s.cum = s.hlo + p * n * 2;
  s.wsc = s.cum + qt * 4;
  s.total = s.wsc + qt * 4;
  return s;
}

// The element offset of (row, col) in a tile of rows of W bf16 in shared
// memory, its 16-byte chunks XOR-swizzled by the row so that the 8 rows
// that one ldmatrix phase (or one row of fragment stores) reads hit 8
// distinct groups of 4 banks: rows of 128 and 256 bytes take chunk ^
// (row & 7), rows of 64 bytes (two a 128-byte bank line) chunk ^
// ((row >> 1) & 3).
template <int W>
__device__ __forceinline__ int sw(int row, int col) {
  const int f = (W == 32) ? ((row >> 1) & 3) : (row & 7);
  return row * W + (((col >> 3) ^ f) << 3) + (col & 7);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1,
                                          const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(smem_u32(p))
      : "memory");
}

// d += A B: A 16x16 row-major (4 registers), B 16x8 column-major (2).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// v0 at the lower k, v1 at the next: the hi halves and the lo halves,
// each as one bf16x2 register (one packed conversion each).
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(v0 - hf.x, v1 - hf.y));
}

__device__ __forceinline__ float2 unpack(uint32_t r) {
  return make_float2(__bfloat162float(__ushort_as_bfloat16(
                         static_cast<unsigned short>(r & 0xffffu))),
                     __bfloat162float(__ushort_as_bfloat16(
                         static_cast<unsigned short>(r >> 16))));
}

struct Args {
  const __nv_bfloat16* x;
  const float* dt;
  const float* a;
  const __nv_bfloat16* bm;
  const __nv_bfloat16* cm;
  float* y;
  float* state;
  int S, H, Q, stages;
  long long xs_b, xs_s, xs_h, bs_b, bs_s, cs_b, cs_s;
  int x_vec, b_vec, c_vec;   // 16-byte aligned: cp.async; else by element
};

// Rows [0, Q) of a (Q x W) bf16 tile with row stride rs (elements) into
// a swizzled shared tile.
template <int W>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long rs, int q, int vec,
                                          int tid) {
  if (vec) {
    for (int e = tid; e < q * (W / 8); e += kThreads) {
      const int i = e / (W / 8);
      const int v = 8 * (e - i * (W / 8));
      cp_async16(dst + sw<W>(i, v), src + i * rs + v);
    }
  } else {
    for (int e = tid; e < q * W; e += kThreads) {
      const int i = e / W;
      const int v = e - i * W;
      dst[sw<W>(i, v)] = src[i * rs + v];
    }
  }
}

template <int P, int N>
__device__ __forceinline__ void load_chunk(const Args& g, char* smem,
                                           const Smem& L, int b, int h,
                                           int c, int st, int tid) {
  const int Q = g.Q;
  const long long t0 = static_cast<long long>(c) * Q;
  char* base = smem + st * L.stage;
  load_tile<P>(reinterpret_cast<__nv_bfloat16*>(base + L.x),
               g.x + b * g.xs_b + t0 * g.xs_s + h * g.xs_h, g.xs_s, Q,
               g.x_vec, tid);
  load_tile<N>(reinterpret_cast<__nv_bfloat16*>(base + L.b),
               g.bm + b * g.bs_b + t0 * g.bs_s, g.bs_s, Q, g.b_vec, tid);
  load_tile<N>(reinterpret_cast<__nv_bfloat16*>(base + L.c),
               g.cm + b * g.cs_b + t0 * g.cs_s, g.cs_s, Q, g.c_vec, tid);
  float* dts = reinterpret_cast<float*>(base + L.dt);
  const float* src = g.dt + (static_cast<long long>(b) * g.S + t0) * g.H + h;
  for (int i = tid; i < Q; i += kThreads)
    cp_async4(dts + i, src + static_cast<long long>(i) * g.H);
}

// Blocks an SM that the registers allow: two where y's and the state's
// accumulators fit 128 registers a thread without spills (P <= 64 and
// P N <= 64 x 64), else one.
__host__ __device__ constexpr int reg_blocks(int p, int n) {
  return p <= 64 && p * n <= 64 * 64 ? 2 : 1;
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads, reg_blocks(P, N))
ssd_scan_tc_kernel(const Args g) {
  constexpr int KN = N / 16;     // k-steps over N
  constexpr int PT = P / 8;      // 8-column tiles of y
  // the state's tiles: WN warps along N (8-column tiles), WM along P
  constexpr int WN = (N / 8) < kWarps ? (N / 8) : kWarps;
  constexpr int WM = kWarps / WN;
  constexpr int NT = N / 8 / WN;      // n-tiles a warp
  constexpr int MT = P / 16 / WM;     // m-tiles a warp
  static_assert(MT >= 1 && NT >= 1, "state tiles");

  extern __shared__ __align__(16) char smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gr = lane >> 2;      // fragment row
  const int tq = lane & 3;       // fragment column pair
  const int Q = g.Q;
  const int qt = tile_rows(Q);
  const int stages = g.stages;
  const Smem L = smem_layout(Q, P, N, stages);
  __nv_bfloat16* Hhi = reinterpret_cast<__nv_bfloat16*>(smem + L.hhi);
  __nv_bfloat16* Hlo = reinterpret_cast<__nv_bfloat16*>(smem + L.hlo);
  float* cum = reinterpret_cast<float*>(smem + L.cum);
  float* wsc = reinterpret_cast<float*>(smem + L.wsc);
  const float ah = g.a[h];

  // zero all of it: padded rows, the first H, dt past Q
  for (int e = tid; e < L.total / 16; e += kThreads)
    reinterpret_cast<int4*>(smem)[e] = make_int4(0, 0, 0, 0);
  __syncthreads();

  const int n_chunks = g.S / Q;
  load_chunk<P, N>(g, smem, L, b, h, 0, 0, tid);
  cp_async_commit();
  if (stages == 2) {
    if (n_chunks > 1) load_chunk<P, N>(g, smem, L, b, h, 1, 1, tid);
    cp_async_commit();
  }

  const int wn = warp % WN;
  const int wm = warp / WN;
  float st[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) st[mt][nt][r] = 0.0f;

  // ldmatrix lane offsets: A from [row][k] (x4), B from [n][k] (x4: two
  // n-tiles), and the transposed loads from [k][n] (B, x4 and x2) and
  // [k][m] (A, x4)
  const int half = (lane >> 4) * 8, odd8 = ((lane >> 3) & 1) * 8;
  const int a_row = lane & 15, a_col = half;
  const int b_row = (lane & 7) + half, b_col = odd8;
  const int bt_row = (lane & 7) + odd8, bt_col = half;
  const int at_row = (lane & 7) + half, at_col = odd8;
  // a 16-row tile's swizzle is the same for every tile (it depends on the
  // row mod 8), so each lane's element offsets within a tile are fixed:
  // B and C by k-step, x by 16-column pair, and the state's W and x^T
  int off_b[KN], off_c[KN], off_x[P / 16], off_w[NT], off_xt[MT];
#pragma unroll
  for (int ks = 0; ks < KN; ++ks) {
    off_b[ks] = sw<N>(b_row, 16 * ks + b_col);
    off_c[ks] = sw<N>(a_row, 16 * ks + a_col);
  }
#pragma unroll
  for (int pp = 0; pp < P / 16; ++pp)
    off_x[pp] = sw<P>(bt_row, 16 * pp + bt_col);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) off_w[nt] = sw<N>(bt_row, 8 * (wn * NT + nt));
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    off_xt[mt] = sw<P>(at_row, 16 * (wm * MT + mt) + at_col);

  for (int c = 0; c < n_chunks; ++c) {
    const int sg = (stages == 2) ? (c & 1) : 0;
    char* base = smem + sg * L.stage;
    using bf16 = __nv_bfloat16;
    const bf16* Xs = reinterpret_cast<const bf16*>(base + L.x);
    const bf16* Bs = reinterpret_cast<const bf16*>(base + L.b);
    const bf16* Cs = reinterpret_cast<const bf16*>(base + L.c);
    const float* dts = reinterpret_cast<const float*>(base + L.dt);
    if (stages == 2) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();   // chunk c's tiles and the last chunk's H are in

    if (warp == 0) {
      // warp_cumsum's order in registers: lane l sums dt a over its
      // segment of per <= 4 values (la rounded before each add, as the
      // f32 route's la is), then the shuffle scan of the lane sums
      const int per = (Q + 31) / 32;
      const int j0 = lane * per;
      float v[4];
      float run = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[k] = 0.0f;
        if (k < per && j0 + k < Q) {
          run = __fadd_rn(run, __fmul_rn(dts[j0 + k], ah));
          v[k] = run;
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
      const int kl = (Q - 1) % per;
      float vl = v[0];
#pragma unroll
      for (int k = 1; k < 4; ++k)
        if (k == kl) vl = v[k];
      const float last = __shfl_sync(0xffffffffu, vl + excl, (Q - 1) / per);
      // cum, and W's row scales exp(cum_last - cum_j) dt_j (0 on the
      // padded rows, whose cum is cum_last)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = j0 + k;
        if (k < per && j < Q) {
          const float cj = v[k] + excl;
          cum[j] = cj;
          wsc[j] = expf(last - cj) * dts[j];
        }
      }
      for (int j = Q + lane; j < qt; j += 32) {
        cum[j] = last;
        wsc[j] = 0.0f;
      }
    }
    __syncthreads();
    const float cl = cum[Q - 1];

    // ---- y for rows i0 .. i0 + 15. Row tile t has t + 1 causal column
    // tiles: at 8 tiles, warps w and w + 4 (which share a scheduler) take
    // tiles w and 7 - w, 9 column tiles a pair
    const int rt = (qt == kMaxChunk && warp >= 4) ? 11 - warp : warp;
    const int i0 = 16 * rt;
    if (i0 < Q) {
      uint32_t cf[KN][4];
#pragma unroll
      for (int ks = 0; ks < KN; ++ks)
        ldsm_x4(cf[ks], Cs + i0 * N + off_c[ks]);
      float acc[PT][4];
#pragma unroll
      for (int pt = 0; pt < PT; ++pt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[pt][r] = 0.0f;
      // carried in: C (Hhi + Hlo)^T, then exp(cum_i)
#pragma unroll
      for (int pp = 0; pp < P / 16; ++pp)
#pragma unroll
        for (int ks = 0; ks < KN; ++ks) {
          uint32_t hf[4];
          const int off = sw<N>(16 * pp + b_row, 16 * ks + b_col);
          ldsm_x4(hf, Hhi + off);
          mma(acc[2 * pp], cf[ks], hf[0], hf[1]);
          mma(acc[2 * pp + 1], cf[ks], hf[2], hf[3]);
          ldsm_x4(hf, Hlo + off);
          mma(acc[2 * pp], cf[ks], hf[0], hf[1]);
          mma(acc[2 * pp + 1], cf[ks], hf[2], hf[3]);
        }
      const float ci0 = cum[i0 + gr], ci1 = cum[i0 + gr + 8];
      const float e0 = expf(ci0), e1 = expf(ci1);
#pragma unroll
      for (int pt = 0; pt < PT; ++pt) {
        acc[pt][0] *= e0;
        acc[pt][1] *= e0;
        acc[pt][2] *= e1;
        acc[pt][3] *= e1;
      }
      // intra-chunk: G x over the causal 16-column tiles of G, the
      // diagonal one (rt) last and the only one with masked pairs
      const int ia = i0 + gr, ib = ia + 8;
      auto tile = [&](int jt, auto diagonal) {
        float cb[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int r = 0; r < 4; ++r) cb[u][r] = 0.0f;
        const bf16* Bt = Bs + 16 * jt * N;
#pragma unroll
        for (int ks = 0; ks < KN; ++ks) {
          uint32_t bf[4];
          ldsm_x4(bf, Bt + off_b[ks]);
          mma(cb[0], cf[ks], bf[0], bf[1]);
          mma(cb[1], cf[ks], bf[2], bf[3]);
        }
        // G's A fragments: register 2 u + r holds row gr + 8 r, columns
        // 8 u + 2 tq and + 1 of this tile
        uint32_t ghi[4], glo[4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = 16 * jt + 8 * u + 2 * tq;
          const float cj0 = cum[j], cj1 = cum[j + 1];
          const float d0 = dts[j], d1 = dts[j + 1];
          float g00, g01, g10, g11;
          if constexpr (decltype(diagonal)::value) {
            // masked pairs take exp(0), then 0: no branch around the exp
            const bool m00 = j <= ia, m01 = j + 1 <= ia;
            const bool m10 = j <= ib, m11 = j + 1 <= ib;
            const float e00 = expf(m00 ? ci0 - cj0 : 0.0f);
            const float e01 = expf(m01 ? ci0 - cj1 : 0.0f);
            const float e10 = expf(m10 ? ci1 - cj0 : 0.0f);
            const float e11 = expf(m11 ? ci1 - cj1 : 0.0f);
            g00 = m00 ? cb[u][0] * (e00 * d0) : 0.0f;
            g01 = m01 ? cb[u][1] * (e01 * d1) : 0.0f;
            g10 = m10 ? cb[u][2] * (e10 * d0) : 0.0f;
            g11 = m11 ? cb[u][3] * (e11 * d1) : 0.0f;
          } else {
            g00 = cb[u][0] * (expf(ci0 - cj0) * d0);
            g01 = cb[u][1] * (expf(ci0 - cj1) * d1);
            g10 = cb[u][2] * (expf(ci1 - cj0) * d0);
            g11 = cb[u][3] * (expf(ci1 - cj1) * d1);
          }
          split2(g00, g01, ghi[2 * u], glo[2 * u]);
          split2(g10, g11, ghi[2 * u + 1], glo[2 * u + 1]);
        }
        const bf16* Xt = Xs + 16 * jt * P;
#pragma unroll
        for (int pp = 0; pp < P / 16; ++pp) {
          uint32_t xf[4];
          ldsm_x4_t(xf, Xt + off_x[pp]);
          mma(acc[2 * pp], ghi, xf[0], xf[1]);
          mma(acc[2 * pp + 1], ghi, xf[2], xf[3]);
          mma(acc[2 * pp], glo, xf[0], xf[1]);
          mma(acc[2 * pp + 1], glo, xf[2], xf[3]);
        }
      };
      // off the diagonal every j < 16 rt <= i: a real row and column
      for (int jt = 0; jt < rt; ++jt) tile(jt, std::false_type{});
      tile(rt, std::true_type{});
      // y out: lane pairs swap halves so that each lane holds 4
      // consecutive columns of one row (even lanes row ia, odd lanes ib)
      const bool odd = tq & 1;
      const int row = odd ? ib : ia;
      float* yrow = g.y + ((static_cast<long long>(b) * g.S +
                            static_cast<long long>(c) * Q + row) *
                               g.H + h) * P + 2 * (tq & ~1);
#pragma unroll
      for (int pt = 0; pt < PT; ++pt) {
        const float r0 = __shfl_xor_sync(0xffffffffu,
                                         odd ? acc[pt][0] : acc[pt][2], 1);
        const float r1 = __shfl_xor_sync(0xffffffffu,
                                         odd ? acc[pt][1] : acc[pt][3], 1);
        if (row < Q)
          *reinterpret_cast<float4*>(yrow + 8 * pt) =
              odd ? make_float4(r0, r1, acc[pt][2], acc[pt][3])
                  : make_float4(acc[pt][0], acc[pt][1], r0, r1);
      }
    }

    // ---- state: H = exp(cum_last) H + x^T (Whi + Wlo)
    {
      const float ecl = expf(cl);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) st[mt][nt][r] *= ecl;
      for (int k0 = 0; k0 < qt; k0 += 16) {
        // W's B fragments: rows k0 + 2 tq (+1) and + 8, column gr
        const int j = k0 + 2 * tq;
        const float w0 = wsc[j], w1 = wsc[j + 1];
        const float w8 = wsc[j + 8], w9 = wsc[j + 9];
        uint32_t whi[NT][2], wlo[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t r0, r1;
          ldsm_x2_t(r0, r1, Bs + k0 * N + off_w[nt]);
          const float2 f0 = unpack(r0), f1 = unpack(r1);
          split2(f0.x * w0, f0.y * w1, whi[nt][0], wlo[nt][0]);
          split2(f1.x * w8, f1.y * w9, whi[nt][1], wlo[nt][1]);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t xf[4];
          ldsm_x4_t(xf, Xs + k0 * P + off_xt[mt]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            mma(st[mt][nt], xf, whi[nt][0], whi[nt][1]);
            mma(st[mt][nt], xf, wlo[nt][0], wlo[nt][1]);
          }
        }
      }
    }
    __syncthreads();   // every read of this stage, of cum and of H is done

    if (c + 1 < n_chunks) {
      // H's bf16 halves for the next chunk's C H^T
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int p = 16 * (wm * MT + mt) + gr;
          const int n = 8 * (wn * NT + nt) + 2 * tq;
          uint32_t hi, lo;
          split2(st[mt][nt][0], st[mt][nt][1], hi, lo);
          *reinterpret_cast<uint32_t*>(Hhi + sw<N>(p, n)) = hi;
          *reinterpret_cast<uint32_t*>(Hlo + sw<N>(p, n)) = lo;
          split2(st[mt][nt][2], st[mt][nt][3], hi, lo);
          *reinterpret_cast<uint32_t*>(Hhi + sw<N>(p + 8, n)) = hi;
          *reinterpret_cast<uint32_t*>(Hlo + sw<N>(p + 8, n)) = lo;
        }
      if (c + stages < n_chunks)
        load_chunk<P, N>(g, smem, L, b, h, c + stages, sg, tid);
      cp_async_commit();
    }
  }

  float* out = g.state + (static_cast<long long>(b) * g.H + h) * P * N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int p = 16 * (wm * MT + mt) + gr;
      const int n = 8 * (wn * NT + nt) + 2 * tq;
      *reinterpret_cast<float2*>(out + p * N + n) =
          make_float2(st[mt][nt][0], st[mt][nt][1]);
      *reinterpret_cast<float2*>(out + (p + 8) * N + n) =
          make_float2(st[mt][nt][2], st[mt][nt][3]);
    }
}

// Blocks of `smem` bytes that one SM holds, at most `cap`.
int blocks_per_sm(int smem, int cap) {
  int dev = 0, per_sm = 0, reserved = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&per_sm,
                             cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                             dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&reserved,
                             cudaDevAttrReservedSharedMemoryPerBlock,
                             dev) != cudaSuccess)
    return 0;
  const int by_smem = per_sm / (smem + reserved);
  return by_smem < cap ? by_smem : cap;
}

// The ring's depth: 2 stages where they fit the block's shared memory and
// cost no block an SM, else 1; 0 if not even one fits.
int stages_for(int q, int p, int n) {
  const int have = device_max_smem();
  const int s1 = smem_layout(q, p, n, 1).total;
  const int s2 = smem_layout(q, p, n, 2).total;
  if (s1 > have) return 0;
  if (s2 > have) return 1;
  const int cap = reg_blocks(p, n);
  return blocks_per_sm(s2, cap) >= blocks_per_sm(s1, cap) ? 2 : 1;
}

bool aligned16(const void* ptr, long long s0, long long s1, long long s2) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && s0 % 8 == 0 &&
         s1 % 8 == 0 && s2 % 8 == 0;
}

template <int P, int N>
int launch(const void* x, const float* dt, const float* a, const void* bm,
           const void* cm, float* y, float* state, int B, int S, int H,
           int Q, long long xs_b, long long xs_s, long long xs_h,
           long long bs_b, long long bs_s, long long cs_b, long long cs_s,
           cudaStream_t stream) {
  const int stages = stages_for(Q, P, N);
  if (stages == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_layout(Q, P, N, stages).total;
  auto kern = ssd_scan_tc_kernel<P, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args g;
  g.x = static_cast<const __nv_bfloat16*>(x);
  g.dt = dt;
  g.a = a;
  g.bm = static_cast<const __nv_bfloat16*>(bm);
  g.cm = static_cast<const __nv_bfloat16*>(cm);
  g.y = y;
  g.state = state;
  g.S = S;
  g.H = H;
  g.Q = Q;
  g.stages = stages;
  g.xs_b = xs_b;
  g.xs_s = xs_s;
  g.xs_h = xs_h;
  g.bs_b = bs_b;
  g.bs_s = bs_s;
  g.cs_b = cs_b;
  g.cs_s = cs_s;
  g.x_vec = aligned16(x, xs_b, xs_s, xs_h);
  g.b_vec = aligned16(bm, bs_b, bs_s, 0);
  g.c_vec = aligned16(cm, cs_b, cs_s, 0);
  dim3 grid(H, B);
  kern<<<grid, kThreads, smem, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

using LaunchFn = int (*)(const void*, const float*, const float*,
                         const void*, const void*, float*, float*, int, int,
                         int, int, long long, long long, long long, long long,
                         long long, long long, long long, cudaStream_t);

// The instantiation of route `bf16` at (P, N), or null.
LaunchFn pick(int bf16, int P, int N) {
#define SSD_CASE(PP, NN)                                           \
  if (P == PP && N == NN)                                          \
    return bf16 ? &tc::launch<PP, NN> : &f32::launch<PP, NN>;
  SSD_CASE(32, 32) SSD_CASE(32, 64) SSD_CASE(32, 128)
  SSD_CASE(64, 32) SSD_CASE(64, 64) SSD_CASE(64, 128)
  SSD_CASE(128, 32) SSD_CASE(128, 64) SSD_CASE(128, 128)
#undef SSD_CASE
  return nullptr;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the route takes for chunk
// q (bf16: with the ring as deep as the current device allows).
long long ssd_scan_smem_bytes(int is_bf16, int q, int p, int n) {
  if (!is_bf16)
    return f32::smem_floats(q, p, n) * static_cast<long long>(sizeof(float));
  const int stages = tc::stages_for(q, p, n);
  return tc::smem_layout(q, p, n, stages > 0 ? stages : 1).total;
}

// The depth of the bf16 route's ring for chunk q on the current device.
int ssd_scan_stages(int q, int p, int n) { return tc::stages_for(q, p, n); }

// The current device's opt-in shared memory per block, or -1.
int ssd_scan_max_smem() { return device_max_smem(); }

// x: (B, S, H, P) with strides (xs_b, xs_s, xs_h, 1); dt: (B, S, H) f32
// contiguous; a: (H,) f32; bm, cm: (B, S, N) with strides (*_b, *_s, 1);
// y: (B, S, H, P) f32 contiguous; state: (B, H, P, N) f32 contiguous.
// is_bf16 selects the dtype of x, bm and cm and the route (f32 otherwise).
int ssd_scan_launch(int is_bf16, const void* x, const float* dt,
                    const float* a, const void* bm, const void* cm, float* y,
                    float* state, int B, int S, int H, int P, int N, int Q,
                    long long xs_b, long long xs_s, long long xs_h,
                    long long bs_b, long long bs_s, long long cs_b,
                    long long cs_s, void* stream) {
  if (Q < 1 || Q > kMaxChunk || S % Q != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const LaunchFn fn = pick(is_bf16, P, N);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(x, dt, a, bm, cm, y, state, B, S, H, Q, xs_b, xs_s, xs_h, bs_b,
            bs_s, cs_b, cs_s, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
