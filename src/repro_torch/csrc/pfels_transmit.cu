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
// update batch, with about one multiply-add per 4 bytes read. At the
// main-path shape (r = 32, d = 9,222,858) client_sumsq reads 1.18 GB and
// fused_combine moves 1.29 GB (u, plus the mask, noise and y columns), so
// the card's memory rate is the whole story. At one client a rank
// (r = 1) the bound is 11 us (client_sumsq) and 44 us (fused_combine),
// and a launch, a second pass and a half-empty card are what cost.
//
// What the design does about it:
//   - One launch a call. Each block writes its partial sums; the block
//     that takes the last ticket of a counter (__threadfence, then
//     atomicAdd on an unsigned int) sums every partial in a fixed order
//     and writes the result. No float atomics: the results are
//     bit-identical from run to run.
//   - A grid sized to the card, not to r: the blocks resident at once
//     (on the H100 5 an SM for client_sumsq, 3 for fused_combine, from
//     the occupancy the registers and the shared-memory ring allow), or
//     fewer when there is less work. client_sumsq's blocks take (row,
//     column tile) work items from a counter, the next free item each
//     time, so r = 1 fills the card and no block waits on a static
//     share larger than the others'; fused_combine's block b of G walks
//     the column tiles b, b + G, ...
//   - Bytes in flight. client_sumsq: each thread loads 8 of its 64
//     columns of a tile at once with 4-byte loads (which take a row at
//     any alignment), 5 blocks an SM, about 40 KB in flight an SM; a
//     two-stage ring of 64 KB bulk copies, as fused_combine has, and 64
//     loads a thread at once were slower at r = 32 on the H100
//     (PERF.md). fused_combine: each block streams the mask, the r
//     client rows and the noise of its tiles through a ring of 2 stages
//     of 32 KB in shared memory, filled by 1-D bulk copies
//     (cp.async.bulk) that complete on an mbarrier each and are issued
//     by one thread, a stage ahead, with an L2 evict-first policy: every
//     byte of u is read once, and y, the mask and the noise stay.
//   - Rows off alignment: d = 9,222,858 and 11,189,886 are 2 mod 4, so
//     every odd row of the batch starts 8 bytes off a 16-byte boundary,
//     and a bulk copy needs a 16-byte aligned address and size. Each
//     fused_combine copy rounds its global start down and its end up to
//     16 bytes (at most 12 bytes each side, inside the 16-byte granules
//     that hold the tile's first and last elements, so inside the
//     allocation), and the readers skip the 0-3 leading elements. In
//     both kernels thread t always takes the tile's columns t, t + 256,
//     ...: the column-to-thread map, and with it the order of every sum,
//     is the same for every row.
//
// The order of the sums:
//   client_sumsq: a row is cut into tiles of 16,384 columns. A tile's
//   partial is each thread's sequential sum of its 64 columns, then the
//   block's fixed shuffle tree; a row's sum is, over its tiles' partials
//   in groups of 4, each lane's sequential sum of groups lane, lane + 32,
//   ..., then the warp's shuffle tree. All of it depends only on the
//   row's values and d, never on the row's index or on r: a client's sum
//   is the same bits alone, in a shard of 8 or in row 21 of 32.
//   fused_combine: y_j starts at 0 and takes, for clients 0 to r-1 in
//   turn, one multiply-add of (m_j u_ij) by g_i tx_i txm_i, then + z_j:
//   the order of the first design, whatever the rows' alignment. Each
//   thread's energy partial runs over its columns of the block's tiles
//   in order, the block's tree sums them, and the last block sums the
//   blocks' partials in block order: block b's partial holds the tiles
//   b, b + G, ..., so the order is fixed in column space for a grid, and
//   the grid is fixed for a card.

// The counters: two unsigned ints that the wrapper holds for each device
// and stream, zeroed once when they are made: the tickets of the blocks
// that are done, and client_sumsq's next work item past the first G. The
// last block of a launch sets both back to 0 before it ends, so the next
// launch on the stream finds 0 and a call costs one device kernel and no
// fill. Two launches running at once on one pair of counters would
// interleave their tickets and items: a block of one could take the
// other's last ticket and sum partials not yet written, and a reset could
// zero a count in use. Launches on one stream run one after another; the
// wrapper keys the counters by stream, so two streams never share them.
//
// Each entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;

// columns of a tile, per kernel, and stages of fused_combine's ring; a
// stage holds a tile and the 4 floats a copy rounded to 16 bytes adds at
// most
constexpr int kSumsqTile = 16384;
constexpr int kSumsqGroup = 8;  // client_sumsq's loads in flight a thread
constexpr int kCombineTile = 8192;
constexpr int kCombineStages = 2;

__host__ __device__ constexpr int stage_floats(int tile) { return tile + 4; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// Copy the n floats at src into dst (16-byte aligned shared memory) by
// one bulk copy of src's enclosing 16-byte granules, completing on bar.
// Returns nothing; the reader finds src[0] at dst[lead(src)].
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int n, uint64_t* bar) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t lo = a & ~static_cast<uintptr_t>(15);
  const uintptr_t hi = (a + 4 * static_cast<uintptr_t>(n) + 15) &
                       ~static_cast<uintptr_t>(15);
  const uint32_t bytes = static_cast<uint32_t>(hi - lo);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
  // each byte is read once: first out of L2, so that y, the mask and
  // the noise stay
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(pol));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;"
      :: "r"(smem_u32(dst)), "l"(lo), "r"(bytes), "r"(smem_u32(bar)),
         "l"(pol)
      : "memory");
}

// Elements between src's 16-byte granule start and src.
__device__ __forceinline__ int lead(const float* src) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
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
  __shared__ float warp_part[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  v = (lane < kWarps) ? warp_part[lane] : 0.0f;
  if (warp == 0) v = warp_sum(v);
  return v;
}

// Every thread of every block calls this after its partials are stored;
// true in every thread of the one block that took the last ticket, which
// then sees every block's partials. That block also sets both counters
// back to 0 for the next launch.
__device__ __forceinline__ bool took_last_ticket(unsigned int* ticket) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    if (last) ticket[0] = ticket[1] = 0u;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// grid = at most the resident blocks; block b takes the work item b of
// the r * n_tiles (row, tile) pairs, row-major, then the next free one
// from counter[1] (G + its count). partial[row * stride + tile] = the
// tile's sum of squares (stride: n_tiles rounded up to 4, 16-byte
// aligned); out[row] = the row's sum, by the last block. Each thread
// loads kSumsqGroup of its columns at once, then adds their squares in
// column order. The bound of at least 1 block an SM is stated because
// ptxas then gives it 44 registers (5 blocks an SM on the H100), which
// read faster there than the 32 (8 blocks) it gives without it (PERF.md).
__global__ void __launch_bounds__(kThreads, 1)
client_sumsq_kernel(const float* __restrict__ u, float* __restrict__ out,
                    float* __restrict__ partial,
                    unsigned int* __restrict__ ticket, int r, long long d,
                    int n_tiles, int stride) {
  constexpr int kPerThread = kSumsqTile / kThreads;
  __shared__ float red[2][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  __shared__ long long next[2];
  const long long n_items = static_cast<long long>(r) * n_tiles;
  int step = 0;
  for (long long item = blockIdx.x; item < n_items;
       item = next[step & 1], ++step) {
    const long long row = item / n_tiles;
    const int tile = static_cast<int>(item - row * n_tiles);
    const long long c0 = static_cast<long long>(tile) * kSumsqTile;
    const float* src = u + row * d + c0 + threadIdx.x;
    const long long left = d - c0;
    float acc = 0.0f;
    if (left >= kSumsqTile) {
#pragma unroll 1
      for (int k0 = 0; k0 < kPerThread; k0 += kSumsqGroup) {
        float x[kSumsqGroup];
#pragma unroll
        for (int k = 0; k < kSumsqGroup; ++k) {
          x[k] = __ldg(src + (k0 + k) * kThreads);
        }
#pragma unroll
        for (int k = 0; k < kSumsqGroup; ++k) {
          acc = __fmaf_rn(x[k], x[k], acc);
        }
      }
    } else {
      const int n = static_cast<int>(left);
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        if (threadIdx.x + k * kThreads < n) {
          const float x = __ldg(src + k * kThreads);
          acc = __fmaf_rn(x, x, acc);
        }
      }
    }
    // the block's tree; red alternates between steps, so that a warp
    // ahead by one step does not overwrite what warp 0 has yet to read
    acc = warp_sum(acc);
    if (lane == 0) red[step & 1][warp] = acc;
    // the block's next item, read by every thread after the barrier;
    // next alternates between steps as red does
    if (threadIdx.x == 0) {
      next[step & 1] = gridDim.x + static_cast<long long>(
                                       atomicAdd(ticket + 1, 1u));
    }
    __syncthreads();
    if (warp == 0) {
      float v = (lane < kWarps) ? red[step & 1][lane] : 0.0f;
      v = warp_sum(v);
      if (lane == 0) partial[row * stride + tile] = v;
    }
  }

  if (!took_last_ticket(ticket)) return;
  // warp w sums rows w, w + kWarps, ...: lane l the float4 groups l,
  // l + 32, ... of the row's partials, in order, then the warp's tree
  const int n4 = stride / 4;
  for (int rw = warp; rw < r; rw += kWarps) {
    const float4* p =
        reinterpret_cast<const float4*>(partial + static_cast<long long>(rw) *
                                                      stride);
    float acc = 0.0f;
    for (int q = lane; q < n4; q += 32) {
      const float4 v = __ldcg(p + q);
      const int j = 4 * q;
      acc += v.x;
      if (j + 1 < n_tiles) acc += v.y;
      if (j + 2 < n_tiles) acc += v.z;
      if (j + 3 < n_tiles) acc += v.w;
    }
    acc = warp_sum(acc);
    if (lane == 0) out[rw] = acc;
  }
}

// grid = at most the resident blocks; block b of G takes the column tiles
// b, b + G, ...; for each tile the ring carries r + 2 stages: the mask,
// the r client rows, the noise. e_partial[b] = block b's energy;
// energy[0] = their sum, by the last block.
__global__ void __launch_bounds__(kThreads)
fused_combine_kernel(const float* __restrict__ u,
                     const float* __restrict__ mask,
                     const float* __restrict__ z,
                     const float* __restrict__ gains, int m_ant,
                     const float* __restrict__ tx,
                     const float* __restrict__ txm, float* __restrict__ y,
                     float* __restrict__ energy,
                     float* __restrict__ e_partial,
                     unsigned int* __restrict__ ticket, int r, long long d,
                     int n_tiles) {
  constexpr int kStageFloats = stage_floats(kCombineTile);
  constexpr int kPerThread = kCombineTile / kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + kCombineStages * kStageFloats * sizeof(float));

  const long long g = gridDim.x;
  const int n_mine = static_cast<int>((n_tiles - blockIdx.x + g - 1) / g);
  // the block's j-th tile
  auto tile_of = [&](int j) { return static_cast<int>(blockIdx.x + j * g); };
  const int per_tile = r + 2;
  const long long n_steps = static_cast<long long>(n_mine) * per_tile;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kCombineStages; ++s) mbar_init(&full[s], 1);
    fence_mbar_init();
  }
  __syncthreads();

  // stage `kind` of a tile: 0 the mask, 1..r client kind - 1, r + 1 z
  auto source = [&](int tile, int kind) -> const float* {
    const long long c0 = static_cast<long long>(tile) * kCombineTile;
    if (kind == 0) return mask + c0;
    if (kind <= r) return u + static_cast<long long>(kind - 1) * d + c0;
    return z + c0;
  };
  auto tile_cols = [&](int tile) {
    const long long left = d - static_cast<long long>(tile) * kCombineTile;
    return left < kCombineTile ? static_cast<int>(left) : kCombineTile;
  };
  // the producer's cursor (thread 0): the next stage to copy
  int p_j = 0, p_kind = 0;
  auto issue = [&](long long step) {
    const int slot = static_cast<int>(step % kCombineStages);
    const int tile = tile_of(p_j);
    load_tile(ring + slot * kStageFloats, source(tile, p_kind),
              tile_cols(tile), &full[slot]);
    if (++p_kind == per_tile) {
      p_kind = 0;
      ++p_j;
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kCombineStages && s < n_steps; ++s) issue(s);
  }

  float m[kPerThread], acc[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) m[k] = acc[k] = 0.0f;
  float e_acc = 0.0f;
  long long step = 0;
  for (int j = 0; j < n_mine; ++j) {
    const int tile = tile_of(j);
    const int n = tile_cols(tile);
    const long long c0 = static_cast<long long>(tile) * kCombineTile;
    for (int kind = 0; kind < per_tile; ++kind, ++step) {
      const int slot = static_cast<int>(step % kCombineStages);
      // a client's receive coefficient g_i tx_i txm_i and energy weight
      // tx_i^2 txm_i, read before the wait
      float a = 0.0f, w = 0.0f;
      if (kind >= 1 && kind <= r) {
        const int i = kind - 1;
        float g = 0.0f;
        for (int mm = 0; mm < m_ant; ++mm) {
          g += __ldg(gains + static_cast<long long>(i) * m_ant + mm);
        }
        const float t = __ldg(tx + i);
        const float tm = __ldg(txm + i);
        a = g * t * tm;
        w = t * t * tm;
      }
      const float* b = ring + slot * kStageFloats + lead(source(tile, kind));
      mbar_wait(&full[slot],
                static_cast<uint32_t>((step / kCombineStages) & 1));
      if (kind == 0) {
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) {
          const int c = threadIdx.x + k * kThreads;
          m[k] = (c < n) ? b[c] : 0.0f;
          acc[k] = 0.0f;
        }
      } else if (kind <= r) {
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) {
          const int c = threadIdx.x + k * kThreads;
          if (c < n) {
            const float um = __fmul_rn(b[c], m[k]);
            acc[k] = __fmaf_rn(um, a, acc[k]);
            e_acc = __fmaf_rn(w, __fmul_rn(um, um), e_acc);
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) {
          const int c = threadIdx.x + k * kThreads;
          if (c < n) y[c0 + c] = __fadd_rn(acc[k], b[c]);
        }
      }
      __syncthreads();  // the stage is read: its slot may be refilled
      if (threadIdx.x == 0 && step + kCombineStages < n_steps) {
        issue(step + kCombineStages);
      }
    }
  }

  e_acc = block_sum(e_acc);
  if (threadIdx.x == 0) e_partial[blockIdx.x] = e_acc;
  if (!took_last_ticket(ticket)) return;
  float s = 0.0f;
  for (int j = threadIdx.x; j < static_cast<int>(gridDim.x); j += kThreads) {
    s += __ldcg(e_partial + j);
  }
  s = block_sum(s);
  if (threadIdx.x == 0) energy[0] = s;
}

constexpr size_t ring_bytes(int tile, int stages) {
  return static_cast<size_t>(stages) *
         (stage_floats(tile) * sizeof(float) + sizeof(uint64_t));
}
constexpr size_t kSumsqSmem = 0;
constexpr size_t kCombineSmem = ring_bytes(kCombineTile, kCombineStages);

// The blocks of each kernel resident at once on one device, set up once
// (with the dynamic shared memory each opts into): 0 client_sumsq,
// 1 fused_combine.
int resident(int which, int dev) {
  static int cached[2][kMaxDevices];
  int& n = cached[which][dev];
  if (n == 0) {
    const void* fn =
        which == 0 ? reinterpret_cast<const void*>(client_sumsq_kernel)
                   : reinterpret_cast<const void*>(fused_combine_kernel);
    const int smem = static_cast<int>(which == 0 ? kSumsqSmem
                                                 : kCombineSmem);
    int sms = 0, per_sm = 0;
    if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      smem) != cudaSuccess) {
      return -1;
    }
    n = per_sm * sms;
  }
  return n;
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

// Columns of a client_sumsq tile and of a fused_combine tile (the wrapper
// sizes the partial sums from them).
int pfels_sumsq_tile_cols() { return kSumsqTile; }
int pfels_combine_tile_cols() { return kCombineTile; }

// The blocks of client_sumsq (which = 0) or fused_combine (1) resident
// at once on device dev: the largest grid either entry takes. < 1 on
// failure.
int pfels_resident_blocks(int dev, int which) {
  DeviceScope scope(dev);
  if (scope.err != 0 || which < 0 || which > 1) return -1;
  return resident(which, dev);
}

// On device dev (made current for the launch): u: (r, d) f32 row-major;
// out: (r,); partial: (r, stride) scratch, 16-byte aligned, stride =
// ceil(d / tile) rounded up to 4; ticket: the stream's 2 counters (0
// between launches); grid: at most pfels_resident_blocks(dev, 0) and at
// most r * ceil(d / tile).
int pfels_client_sumsq(int dev, const float* u, float* out, float* partial,
                       unsigned int* ticket, int r, long long d, int stride,
                       int grid, void* stream) {
  DeviceScope scope(dev);
  if (scope.err != 0) return scope.err;
  const int most = resident(0, dev);
  const long long n_tiles = (d + kSumsqTile - 1) / kSumsqTile;
  if (grid < 1 || grid > most || grid > r * n_tiles || stride < n_tiles) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  client_sumsq_kernel<<<grid, kThreads, kSumsqSmem,
                        static_cast<cudaStream_t>(stream)>>>(
      u, out, partial, ticket, r, d, static_cast<int>(n_tiles), stride);
  return static_cast<int>(cudaGetLastError());
}

// On device dev (made current for the launch): u: (r, d); mask, z, y:
// (d,); gains: (r, m_ant); tx, txm: (r,); energy: (1,); e_partial: (grid,)
// scratch; ticket: the stream's 2 counters; grid: at most
// pfels_resident_blocks(dev, 1) and at most ceil(d / tile). All f32,
// contiguous.
int pfels_fused_combine(int dev, const float* u, const float* mask,
                        const float* z, const float* gains, int m_ant,
                        const float* tx, const float* txm, float* y,
                        float* energy, float* e_partial,
                        unsigned int* ticket, int r, long long d, int grid,
                        void* stream) {
  DeviceScope scope(dev);
  if (scope.err != 0) return scope.err;
  const int most = resident(1, dev);
  const long long n_tiles = (d + kCombineTile - 1) / kCombineTile;
  if (grid < 1 || grid > most || grid > n_tiles) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  fused_combine_kernel<<<grid, kThreads, kCombineSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      u, mask, z, gains, m_ant, tx, txm, y, energy, e_partial, ticket, r, d,
      static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
