// Deterministic grouped row accumulation, table[ids] += updates, for Hopper
// (sm_90a).
//
// Replaces cornac_tpu/ops/accumulate.py::accumulate_rows, which the JAX
// package computes with XLA (a one-hot product or a sorted scatter-add, both
// deterministic on the TPU). On the card, index_add_ and scatter_add_ sum
// float updates with atomics, in an order that changes from launch to launch;
// this kernel gives the same bits on every launch and needs no sync with the
// host.
//
// Input: the batch's row ids sorted by a stable sort (ids_sorted, int32),
// the sort's permutation (order, int64: position q of the sorted batch holds
// update order[q]), the updates (B, d) and the table (R, d), float32,
// row-major. Equal ids form runs of consecutive positions, in batch order
// within each run.
//
// What bounds it on an H100: bytes. The function reads the ids and the
// updates once and reads and writes each touched row of the table once:
// 4 * d * (B + 2 * touched rows) + 12 * B bytes (ids and order), against
// B * d additions. At the trainers' shapes (B up to 32,768, d <= 64) that is
// well under a megabyte, a few hundred nanoseconds at 3.35 TB/s: a launch
// costs more. The design:
//
//  * one warp per position p of the sorted batch; the warp whose p starts a
//    run (p == 0 or ids_sorted[p - 1] != ids_sorted[p]) owns that run, the
//    others leave at once. Each table row is read and written by one warp,
//    once, so no atomics and no second pass;
//  * the owner reads the run 32 positions at a time (one id and one order
//    entry per lane, a ballot finds where the run ends), then broadcasts each
//    position's update row index with a shuffle; its lanes hold columns
//    lane, lane + 32, ... (kCols per lane, further column passes for d >
//    32 * kCols) and load kUnroll rows before adding them, so the loads of
//    a long run (a popular item among the negatives) overlap;
//  * every column's sum starts from 0.0f and adds the run's updates in batch
//    order, then the table entry adds that sum once: the same arithmetic as
//    the plain version on the CPU (a sum per run, then one add per row).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps, one position each
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;       // columns a lane holds per pass: 128 per warp
constexpr int kUnroll = 8;     // update rows loaded before they are added
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
accumulate_rows_kernel(float* __restrict__ table, const float* __restrict__ updates,
                       const int32_t* __restrict__ ids, const int64_t* __restrict__ order,
                       int64_t B, int64_t R, int d) {
  const int lane = threadIdx.x & 31;
  const int64_t p = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= B) return;
  const int32_t id = ids[p];
  if ((p > 0 && ids[p - 1] == id) || id < 0 || id >= R) return;

  for (int c0 = 0; c0 < d; c0 += 32 * kCols) {
    float acc[kCols];
#pragma unroll
    for (int t = 0; t < kCols; ++t) acc[t] = 0.0f;

    for (int64_t q0 = p;; q0 += 32) {
      const int64_t q = q0 + lane;
      const bool in_run = q < B && ids[q] == id;
      const int64_t row = in_run ? order[q] : 0;
      // sorted ids: the run's positions in this window are lanes 0 .. cnt-1
      const int cnt = __popc(__ballot_sync(kFull, in_run));
      for (int j = 0; j < cnt; j += kUnroll) {
        float v[kUnroll][kCols];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int64_t r = __shfl_sync(kFull, row, (j + u) & 31);
#pragma unroll
          for (int t = 0; t < kCols; ++t) {
            const int c = c0 + t * 32 + lane;
            v[u][t] = (j + u < cnt && c < d) ? updates[r * d + c] : 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (j + u < cnt) {
#pragma unroll
            for (int t = 0; t < kCols; ++t) acc[t] += v[u][t];
          }
        }
      }
      if (cnt < 32) break;
    }

#pragma unroll
    for (int t = 0; t < kCols; ++t) {
      const int c = c0 + t * 32 + lane;
      if (c < d) table[(int64_t)id * d + c] += acc[t];
    }
  }
}

}  // namespace

extern "C" {

// table (R, d) += the updates (B, d) of each run of ids_sorted, on `stream`.
// Returns the cudaError_t of the launch (0 on success).
int cornac_accumulate_rows(void* table, const void* updates, const void* ids_sorted,
                           const void* order, int64_t B, int64_t R, int d, void* stream) {
  if (B <= 0 || d <= 0) return 0;
  const int64_t blocks = (B + kWarps - 1) / kWarps;
  accumulate_rows_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (float*)table, (const float*)updates, (const int32_t*)ids_sorted,
      (const int64_t*)order, B, R, d);
  return (int)cudaGetLastError();
}

const char* cornac_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
