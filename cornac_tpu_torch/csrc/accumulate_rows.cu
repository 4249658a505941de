// Deterministic row accumulation, table[ids] += updates, for Hopper
// (sm_90a).
//
// Replaces cornac_tpu/ops/accumulate.py::accumulate_rows, which the JAX
// package computes with XLA (a one-hot product or a sorted scatter-add, both
// deterministic on the TPU). On the card, index_add_ and scatter_add_ sum
// float updates with atomics, in an order that changes from launch to launch;
// this kernel gives the same bits on every launch and needs no sync with the
// host.
//
// Input: the batch's row ids as the trainers hold them (int64, any stride,
// in batch order; ids outside [0, R) are dropped), the updates (B, d) and
// the table (R, d), float32, row-major. For every row the sum starts at 0.0f
// and adds that row's updates in batch order; the table entry then adds the
// sum once: the arithmetic of the plain version on the CPU. One launch per
// call: no sort, no cast, no scratch memory, no float atomics.
//
// The design: row ownership, the card's counterpart of the JAX package's
// one-hot strategy, where each output row is owned by one reduction.
//
//  * Block (x, y) owns table rows [x * rows, (x + 1) * rows) and columns
//    [y * cols, (y + 1) * cols) (ops/accumulate.py::accumulate_plan sizes
//    them). Row r of the range belongs to warp r % kWarps, whose lanes hold
//    its columns; the sums live in dynamic shared memory.
//  * Every block streams all B ids, kThreads * per_lane a round: each thread
//    copies its own ids of the next round into a shared-memory ring with
//    cp.async while this round is sorted out. Ballots and a prefix over the
//    warps' counts list the ids that fall in the block's rows, in batch
//    order, and the warp that found a position copies its update row into
//    a shared-memory stage with 4-byte cp.async, so the gather of the
//    updates overlaps the scan.
//  * When the stage is full, and after the last round, each warp walks the
//    staged list in order, picks its own entries by ballots (windows of 128,
//    padded to whole groups of kGroup with adds of a row of zeros) and adds
//    them to the running sum of its current row, kept in registers: a
//    popular row's run is a chain of register adds, the next group's
//    shared-memory loads issued before this group's adds. A row's first
//    entry lists it among the warp's touched rows; switching rows stores
//    one sum and loads another.
//  * Then each warp adds its touched rows' sums to the table once, without
//    waiting for the other warps. Untouched rows are neither read nor
//    written.
//
// What bounds it on an H100: bytes. The function must read the ids (8 B each)
// and the updates once and read and write each touched row once: at the
// trainers' shapes (B up to 32,768, d <= 33) under 7 MB, about 2 us at
// 3.35 TB/s, and B * d additions far below the float32 peak. Row ownership
// adds the ids read again by every block, grid * B * 8 bytes from L2 (16 per
// id for the trainers' strided user ids, a column of (user, item) pairs).
// So the plan uses as few blocks as fill the 132 SMs, more only where the
// sums do not fit, and the ring keeps the next round in flight. At 227 KB a
// block (ops/accumulate.py::accumulate_plan):
//  - 32,768 ids into 10,000 x 33 (BPR's V update at full width): 132 blocks
//    of 76 rows, 1,087 staged updates, 34.6 MB of ids from L2;
//  - 16,384 strided ids into 100,000 x 33 (its U update): 132 blocks of 758
//    rows (100 KB of sums each), 410 staged, 34.6 MB;
//  - 8,192 and 4,096 (strided) ids into 1,682 and 943 rows x 11 (the bench
//    shape): 130 and 118 blocks of 13 and 8 rows, 8.5 and 7.7 MB; the
//    popular item's ~1,000 updates are one warp's chain of adds;
//  - 16,384 ids into 480,000 x 51: 949 blocks of 506 rows (98 MB of sums in
//    all, 103 KB a block beside the 64 KB ring and 256 staged updates; 7.2
//    waves of the card), 124 MB of ids from L2.
// On the card (PERF.md) the scan costs about four times a bare read of the
// same ids by every block: it is bound by the instructions and the barrier
// of each round, not by L2.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "on_device.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;  // a power of two
constexpr int kMaxPerLane = 8;         // ids a lane takes per round
constexpr int kRing = 2;               // rounds of ids in shared memory: one loads while one is read
constexpr int kMaxCols = 64;           // columns a block owns: 2 per lane
constexpr int kMaxIndex = 65535;       // rows a block owns; stage entries below it (16 bits)
constexpr int kWindow = 4;             // list entries a lane looks at per window of the sum
constexpr int kGroup = 8;              // a warp's staged entries loaded before they are added
constexpr int kAhead = 8;              // touched rows a warp loads before it writes them
constexpr int kFixedBytes = 8 * kRing * kThreads * kMaxPerLane  // the ids' ring
                            + 4 * (2 * kWarps + kWarps * 32 * kWindow)  // counts, windows
                            + 4 * 64;  // room for the lanes past ncols to read past the stage
constexpr unsigned kFull = 0xffffffffu;
static_assert((kWarps & (kWarps - 1)) == 0 && (kRing & (kRing - 1)) == 0, "powers of two");

__host__ __device__ inline int warp_rows(int rows) { return (rows + kWarps - 1) / kWarps; }

// Dynamic shared memory: the ring of ids (kRing rounds of kThreads *
// kMaxPerLane int64), the sums (rows x cols floats), the stage (cap + 1
// rows of cols floats, the last one zeros) and its entries' local rows (cap
// ints), two sets of per-warp counts, a window of 32 * kWindow entries per
// warp, each warp's list of touched rows (16 bits each), a touched flag per
// row (a byte) and 64 floats of room at the end.
// ops/accumulate.py::smem_bytes mirrors it.
__host__ __device__ inline size_t smem_bytes(int rows, int cols, int cap) {
  return 4 * ((size_t)rows * cols + (size_t)(cap + 1) * cols + cap) + kFixedBytes +
         2 * (size_t)kWarps * warp_rows(rows) + rows;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async8(int64_t* dst, const int64_t* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Lane `lane` of warp w takes positions (w * per_lane + j) * 32 + lane of a
// round (warp, then j, then lane is batch order); `left` is how many of the
// round's positions from the lane's first one are below B. The thread
// copies its ids of the round into its own slots of the ring, `slot` + j *
// kThreads, and writes -1 (no row) past B: only it reads them, so no
// barrier is needed, only its own wait for the copies.
__device__ __forceinline__ void load_round(int64_t* slot, const int64_t* from, int64_t step,
                                           int64_t left, int per_lane) {
  const int valid = left <= 0 ? 0 : (int)min((left + 31) / 32, (int64_t)per_lane);
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    if (j < valid)
      cp_async8(slot + j * kThreads, from + j * step);
    else
      slot[j * kThreads] = -1;
  }
  cp_async_commit();
}

// A warp's running sum: the row it is adding to (-1 before the first), its
// columns' sums, and how many rows the warp has touched (listed in `rows`).
template <int kCols>
struct WarpSum {
  int cur;
  float s[kCols];
  int count;
  unsigned short* rows;
};

// Loads a group of window entries and their staged updates.
template <int kCols>
__device__ __forceinline__ void fetch_group(const unsigned* window, const float* stage, int cols,
                                            int lane, unsigned (&q)[kGroup],
                                            float (&v)[kGroup][kCols]) {
  const uint4 qa = *reinterpret_cast<const uint4*>(window);
  const uint4 qb = *reinterpret_cast<const uint4*>(window + 4);
  q[0] = qa.x, q[1] = qa.y, q[2] = qa.z, q[3] = qa.w;
  q[4] = qb.x, q[5] = qb.y, q[6] = qb.z, q[7] = qb.w;
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    const float* src = stage + (q[u] & 0xffffu) * cols + lane;
#pragma unroll
    for (int t = 0; t < kCols; ++t) v[u][t] = src[32 * t];
  }
}

// Adds a group to the warp's running sums in order.
template <int kCols>
__device__ __forceinline__ void add_group(const unsigned (&q)[kGroup],
                                          const float (&v)[kGroup][kCols], float* acc,
                                          unsigned char* touched, int cols, int ncols, int lane,
                                          WarpSum<kCols>& w) {
  unsigned other = 0;  // a row other than the current one, in the high bits
#pragma unroll
  for (int u = 0; u < kGroup; ++u) other |= q[u] ^ ((unsigned)w.cur << 16);
  if ((other >> 16) == 0) {
    // the group continues the current row (its padding adds +0.0, which
    // leaves a sum that started at +0.0 as it is)
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
#pragma unroll
      for (int t = 0; t < kCols; ++t) w.s[t] += v[u][t];
    }
    return;
  }
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    const int r = (int)(q[u] >> 16);
    if (r != w.cur) {
      const bool seen = touched[r];
#pragma unroll
      for (int t = 0; t < kCols; ++t) {
        const int c = lane + 32 * t;
        if (w.cur >= 0 && c < ncols) acc[w.cur * cols + c] = w.s[t];
        w.s[t] = seen && c < ncols ? acc[r * cols + c] : 0.0f;
      }
      if (!seen) {
        touched[r] = 1;
        w.rows[w.count++] = (unsigned short)r;
      }
      w.cur = r;
    }
#pragma unroll
    for (int t = 0; t < kCols; ++t) w.s[t] += v[u][t];
  }
}

// Adds the first n staged updates to the running sums, each warp those of
// its rows, in the order of the list (batch order). Stage row `zero` holds
// zeros. Lanes at or past ncols add whatever lies there and never store it.
template <int kCols>
__device__ __forceinline__ void sum_staged(int n, const int* list, const float* stage, float* acc,
                                           unsigned char* touched, unsigned* window, int zero,
                                           int cols, int ncols, WarpSum<kCols>& w) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  for (int w0 = 0; w0 < n; w0 += 32 * kWindow) {
    // the window's entries of this warp's rows, in order, packed as
    // (local row << 16 | stage entry)
    int cnt = 0;
    unsigned last = 0;
#pragma unroll
    for (int j = 0; j < kWindow; ++j) {
      const int e = w0 + j * 32 + lane;
      const int r = e < n ? list[e] : -1;
      const bool mine = r >= 0 && (r & (kWarps - 1)) == warp;
      const unsigned m = __ballot_sync(kFull, mine);
      const unsigned q = ((unsigned)r << 16) | (unsigned)e;
      if (mine) window[cnt + __popc(m & below)] = q;
      if (m) last = __shfl_sync(kFull, q, 31 - __clz(m));
      cnt += __popc(m);
    }
    if (cnt == 0) continue;
    // pad to whole groups with entries that add the zero row to the last row
    const int padded = (cnt + kGroup - 1) & ~(kGroup - 1);
    if (lane < padded - cnt) window[cnt + lane] = (last & 0xffff0000u) | (unsigned)zero;
    __syncwarp();
    // groups of kGroup entries; the next group's loads are issued before
    // this group's adds, so a popular row's chain of adds never waits for
    // shared memory
    unsigned qa[kGroup], qb[kGroup];
    float va[kGroup][kCols], vb[kGroup][kCols];
    fetch_group<kCols>(window + 0, stage, cols, lane, qa, va);
    for (int k = 0;; k += 2 * kGroup) {
      if (k + kGroup < padded) fetch_group<kCols>(window + k + kGroup, stage, cols, lane, qb, vb);
      add_group<kCols>(qa, va, acc, touched, cols, ncols, lane, w);
      if (k + kGroup >= padded) break;
      if (k + 2 * kGroup < padded) fetch_group<kCols>(window + k + 2 * kGroup, stage, cols, lane, qa, va);
      add_group<kCols>(qb, vb, acc, touched, cols, ncols, lane, w);
      if (k + 2 * kGroup >= padded) break;
    }
    __syncwarp();  // the window is rewritten next
  }
}

template <int kCols>
__global__ void __launch_bounds__(kThreads, 1)
accumulate_rows_kernel(float* __restrict__ table, const float* __restrict__ updates,
                       const int64_t* __restrict__ ids, int64_t id_stride, int64_t B, int64_t R,
                       int d, int rows, int cols, int per_lane, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* ring = reinterpret_cast<int64_t*>(smem);
  unsigned* windows = reinterpret_cast<unsigned*>(ring + kRing * kMaxPerLane * kThreads);
  int* counts = reinterpret_cast<int*>(windows + kWarps * 32 * kWindow);
  float* acc = reinterpret_cast<float*>(counts + 2 * kWarps);
  float* stage = acc + (size_t)rows * cols;
  int* list = reinterpret_cast<int*>(stage + (size_t)(cap + 1) * cols);
  unsigned short* warp_lists = reinterpret_cast<unsigned short*>(list + cap);
  unsigned char* touched = reinterpret_cast<unsigned char*>(warp_lists + kWarps * warp_rows(rows));

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  const int64_t r0 = (int64_t)blockIdx.x * rows;
  const int nrows = R - r0 < rows ? (int)(R - r0) : rows;
  const int c0 = blockIdx.y * cols;
  const int ncols = min(cols, d - c0);
  const float* upd = updates + c0;
  unsigned* window = windows + warp * 32 * kWindow;

  // round i's ids: this thread's slots of ring row i % kRing
  const int64_t tile = (int64_t)kThreads * per_lane;
  const int64_t rounds = (B + tile - 1) / tile;
  const int64_t lane_pos = (int64_t)warp * per_lane * 32 + lane;  // in a round
  const int64_t* from = ids + lane_pos * id_stride;
  const int64_t step = 32 * id_stride, round_step = tile * id_stride;
  auto load = [&](int64_t i) {
    load_round(ring + (int)(i & (kRing - 1)) * (kMaxPerLane * kThreads) + threadIdx.x,
               from + i * round_step, step, B - i * tile - lane_pos, per_lane);
  };
#pragma unroll
  for (int i = 0; i < kRing - 1; ++i) load(i);
  for (int r = threadIdx.x; r < nrows; r += kThreads) touched[r] = 0;
  for (int c = threadIdx.x; c < cols; c += kThreads) stage[(size_t)cap * cols + c] = 0.0f;

  WarpSum<kCols> w;
  w.cur = -1;
  w.count = 0;
  w.rows = warp_lists + warp * warp_rows(rows);
#pragma unroll
  for (int t = 0; t < kCols; ++t) w.s[t] = 0.0f;

  int n = 0;  // entries listed and not yet summed
  for (int64_t i = 0; i < rounds; ++i) {
    const int64_t b0 = i * tile;
    load(i + kRing - 1);
    cp_async_wait<kRing - 1>();  // round i's copies have landed
    const int64_t* mine = ring + (int)(i & (kRing - 1)) * (kMaxPerLane * kThreads) + threadIdx.x;
    int64_t id[kMaxPerLane];
    unsigned m[kMaxPerLane];
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) {
      id[j] = mine[j * kThreads];
      m[j] = __ballot_sync(kFull, (uint64_t)id[j] - (uint64_t)r0 < (uint64_t)nrows);
      cnt += __popc(m[j]);
    }
    // the warps' counts (two sets, so no barrier is needed before the write)
    // and their prefix
    int* round_counts = counts + (int)(i & 1) * kWarps;
    if (lane == 0) round_counts[warp] = cnt;
    __syncthreads();
    const int c = lane < kWarps ? round_counts[lane] : 0;
    int incl = c;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const int at = n + __shfl_sync(kFull, incl - c, warp);  // this warp's first list position
    const int end = n + __shfl_sync(kFull, incl, kWarps - 1);
    // list the round's hits at positions at..; the warp copies each one's
    // update row to the stage; each time the list fills, sum it and go on at
    // position 0
    for (int base = 0;; base += cap) {
      int a = at - base;
#pragma unroll
      for (int j = 0; j < kMaxPerLane; ++j) {
        if (m[j] == 0) continue;
        if ((m[j] >> lane) & 1) {
          const int v = a + __popc(m[j] & below);
          if (v >= 0 && v < cap) list[v] = (int)(id[j] - r0);
        }
        const float* rows_j = upd + (b0 + ((int64_t)warp * per_lane + j) * 32) * d;
        for (unsigned mm = m[j]; mm; mm &= mm - 1, ++a) {
          if (a < 0 || a >= cap) continue;
          const float* src = rows_j + (int64_t)(__ffs(mm) - 1) * d;
          float* dst = stage + (size_t)a * cols;
#pragma unroll
          for (int t = 0; t < kCols; ++t) {
            const int col = lane + 32 * t;
            if (col < ncols) cp_async4(dst + col, src + col);
          }
        }
      }
      if (end - base <= cap) {
        n = end - base;
        break;
      }
      cp_async_wait_all();
      __syncthreads();
      sum_staged<kCols>(cap, list, stage, acc, touched, window, cap, cols, ncols, w);
      __syncthreads();
    }
  }
  cp_async_wait_all();
  __syncthreads();
  sum_staged<kCols>(n, list, stage, acc, touched, window, cap, cols, ncols, w);
  if (w.cur >= 0) {
#pragma unroll
    for (int t = 0; t < kCols; ++t) {
      const int c = lane + 32 * t;
      if (c < ncols) acc[w.cur * cols + c] = w.s[t];
    }
  }
  __syncwarp();

  // the warp's touched rows add their sums to the table once, kAhead rows'
  // loads in flight; the rows are the warp's own, so no other warp waits
  for (int i = 0; i < w.count; i += kAhead) {
    int r[kAhead];
    float t_old[kAhead][kCols];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      r[u] = i + u < w.count ? w.rows[i + u] : -1;
#pragma unroll
      for (int t = 0; t < kCols; ++t) {
        const int c = lane + 32 * t;
        t_old[u][t] = r[u] >= 0 && c < ncols ? table[(r0 + r[u]) * d + c0 + c] : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
#pragma unroll
      for (int t = 0; t < kCols; ++t) {
        const int c = lane + 32 * t;
        if (r[u] >= 0 && c < ncols) table[(r0 + r[u]) * d + c0 + c] = t_old[u][t] + acc[r[u] * cols + c];
      }
    }
  }
}

}  // namespace

extern "C" {

// The SM count of `device` and the shared memory a block may opt into
// there, which every instantiation of the kernel is then allowed to use.
// Call once per device before cornac_accumulate_rows launches there.
// Returns a cudaError_t (0 on success).
int cornac_accumulate_rows_limits(int device, int* sms, int* smem) {
  OnDevice on(device);
  cudaError_t err = on.err;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(accumulate_rows_kernel<1>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(accumulate_rows_kernel<2>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  return (int)err;
}

// table (R, d) += the updates (B, d) of rows ids[q * id_stride], summed per
// row in batch order, on `stream` of `device`, with the plan of
// ops/accumulate.py::accumulate_plan (rows and cols a block owns, ids a lane
// loads per round, staged entries). Returns the launch's cudaError_t (0 on
// success; cudaErrorInvalidValue for a plan outside the kernel's limits).
int cornac_accumulate_rows(int device, void* table, const void* updates, const void* ids,
                           int64_t id_stride, int64_t B, int64_t R, int d, int rows, int cols,
                           int per_lane, int cap, void* stream) {
  if (B <= 0 || R <= 0 || d <= 0) return 0;
  if (B > INT_MAX || rows < 1 || rows > kMaxIndex || cols < 1 || cols > kMaxCols || per_lane < 1 ||
      per_lane > kMaxPerLane || cap < 1 || cap >= kMaxIndex)
    return (int)cudaErrorInvalidValue;
  const int64_t grid_rows = (R + rows - 1) / rows;
  const int grid_cols = (d + cols - 1) / cols;
  if (grid_rows > INT_MAX || grid_cols > 65535) return (int)cudaErrorInvalidValue;
  OnDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  const dim3 grid((unsigned)grid_rows, (unsigned)grid_cols);
  const size_t smem = smem_bytes(rows, cols, cap);
  if (cols <= 32)
    accumulate_rows_kernel<1><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (float*)table, (const float*)updates, (const int64_t*)ids, id_stride, B, R, d, rows, cols,
        per_lane, cap);
  else
    accumulate_rows_kernel<2><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (float*)table, (const float*)updates, (const int64_t*)ids, id_stride, B, R, d, rows, cols,
        per_lane, cap);
  return (int)cudaGetLastError();
}

const char* cornac_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
