// All-pairs co-support cosine similarity + exact streaming top-k over the
// nonzeros of W, for Hopper (sm_90a).
//
// Replaces the TPU kernel cornac_tpu/ops/pallas_similarity.py::_sim_topk_kernel:
// for every row r of W (n, m) it returns the k rows c with the largest
//
//   sim(r, c) = num / max(sqrt(d1) * sqrt(d2), 1e-12),   0 where num == 0,
//   num = sum_j W[r,j] W[c,j],  d1 = sum_j W[r,j]^2 [W[c,j] != 0],
//   d2 = sum_j [W[r,j] != 0] W[c,j]^2,
//
// best first, equal similarities ordered by ascending c; with exclude_self
// the diagonal is -3e38. The (n, n) similarity matrix never reaches device
// memory.
//
// What bounds it on an H100: every term of the three sums is zero unless
// both W[r,j] and W[c,j] are nonzero, so the function needs one update of
// (num, d1, d2) per co-rated pair and column: 3 * sum_j c_j^2 operations
// for column counts c_j, against the bytes of two compressed views of W
// (CSR and CSC, 8 bytes an entry each) in and 8*n*k bytes out. At the
// ML-10M item side (n = 10,677, m = 69,878, 10M entries) that is 9.5e9
// operations (0.14 ms at the H100 SXM's published 67 TFLOP/s) against
// 0.17 GB (0.05 ms at 3.35 TB/s), where the dense form needs 2.4e13
// operations: no dense kernel can come near. What bounds this kernel in practice is latency: r's support
// is visited column by column, each visit a few hundred entries. The
// design:
//
//  * a block owns one row r at a time: persistent blocks take rows from a
//    global counter, so a block that drew a short row takes the next at
//    once, however unevenly the rows' supports are spread; shared memory
//    holds the float32 accumulators num, d1 and d2 for a range of C
//    candidate rows (12*C bytes; C up to 16,632, so the ML-1M and ML-10M
//    shapes need one range, a larger n walks r's support once per range);
//  * each of the block's 8 warps owns a span of consecutive candidate
//    rows, cut so the spans carry about equal work, and `split` gives the
//    span's share of every column (a column's entries are sorted by row).
//    For each column j of r's support, in ascending j, with a = W[r,j],
//    the warp's lanes take its share of column j's entries (c, b) and
//    update num[c] = fmaf(a, b, num[c]), d1[c] += a*a, d2[c] += b*b. One
//    column's entries have distinct c and every c belongs to one warp, so
//    no two threads ever touch one accumulator at once, with no float
//    atomics and no barrier across the block inside a range (one between
//    ranges, whose spans do not line up); a __syncwarp between columns
//    keeps every sum in ascending j. The kernel is deterministic
//    (two launches give the same bits) and, on star ratings, exact;
//  * a warp hides the loads' latency itself: it reads the spans of 32
//    support columns in one step, then the first 64 entries of 8 columns'
//    spans before it accumulates the first of them (a longer span's rest
//    four loads a lane deep), so one memory round trip serves 8 column
//    visits, and no warp waits for another: sharing each column among all
//    256 threads would cost a block barrier per column visit;
//  * the epilogue of a range computes sqrtf(d1) * sqrtf(d2), fmaxf(.,
//    1e-12f) and an IEEE division (no fast-math), 0 where num == 0, -3e38
//    on the diagonal, and every candidate enters the top-k, zeros
//    included: each warp folds its span into its own running list with
//    fold_topk (topk_keys.cuh, shared with fused_topk.cu: a ballot filter,
//    a bitonic sort in registers, a rank merge), then one warp merges the
//    eight lists.
//
// Where W is dense the sparse form loses: a dense product's cost does not
// depend on the density, and on a half-dense matrix at the ML-1M widths
// two cuBLAS SGEMMs beat this kernel (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "on_device.cuh"
#include "topk_keys.cuh"

namespace {

using cornac_topk::u64;
using cornac_topk::fold_topk;
using cornac_topk::key_index;
using cornac_topk::key_score;
using cornac_topk::make_key;

constexpr int kThreads = 256;                 // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;                     // columns whose entries a warp loads before using them
constexpr int kTile = 512;                    // keys per warp in the epilogue
constexpr int kFixedBytes = kWarps * kTile * 8 + (1 + 2 * kWarps) * 4;

constexpr float kNegInf = -3.0e38f;

// Accumulator floats per array for a range of C rows, kept a multiple of 4
// so the key tiles behind them stay 16-byte aligned.
__host__ __device__ __forceinline__ int padded(int C) { return (C + 3) & ~3; }

__host__ __device__ __forceinline__ int smem_bytes(int C) { return 12 * padded(C) + kFixedBytes; }

__device__ __forceinline__ void accumulate(float* num, float* d1, float* d2, int c, float a,
                                           float a2, float b) {
  num[c] = fmaf(a, b, num[c]);
  d1[c] = __fadd_rn(d1[c], a2);
  d2[c] = __fadd_rn(d2[c], __fmul_rn(b, b));
}

// Candidate rows come in `ranges` ranges of at most C rows, range q from
// bounds[q * kWarps] to bounds[(q + 1) * kWarps], and warp w owns rows
// bounds[q * kWarps + w] up to the next bound. split[j * T + t], for
// T = ranges * kWarps + 1, is the index of column j's first CSC entry
// whose row is at or past bounds[t], so warp w's share of column j in
// range q is split[j*T + q*kWarps + w] up to the next. Scratch: per block,
// (kWarps + 1) lists of two halves of k keys: each warp's running list,
// then the row's merged list.
__global__ void __launch_bounds__(kThreads)
cosine_topk_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col_idx,
                   const float* __restrict__ row_val, const int* __restrict__ split,
                   const int* __restrict__ row_idx, const float* __restrict__ col_val,
                   const int* __restrict__ bounds, int n, int ranges, int C, int k,
                   int exclude_self, float* __restrict__ out_s, int* __restrict__ out_i,
                   u64* scratch, int* next_row) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Cp = padded(C);
  float* num = reinterpret_cast<float*>(smem);
  float* d1 = num + Cp;
  float* d2 = d1 + Cp;
  u64* keys = reinterpret_cast<u64*>(d2 + Cp);  // kWarps tiles of kTile keys
  int* misc = reinterpret_cast<int*>(keys + kWarps * kTile);  // [0] row; [1 + w] count, [1 + kWarps + w] half

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = ranges * kWarps + 1;
  u64* lists = scratch + (size_t)blockIdx.x * (kWarps + 1) * 2 * k;
  u64* mine = lists + (size_t)warp * 2 * k;
  u64* K = keys + warp * kTile;

  for (;;) {
    if (tid == 0) misc[0] = atomicAdd(next_row, 1);
    __syncthreads();
    const int r = misc[0];
    if (r >= n) break;
    const int s0 = row_ptr[r], deg = row_ptr[r + 1] - s0;
    int count = 0, cur = 0;  // this warp's running list

    for (int q = 0; q < ranges; ++q) {
      // the spans are cut by work, so this range's span of a warp overlaps
      // other warps' spans of the last range: wait until every warp is done
      // with those before any zeroes its own
      if (q > 0) __syncthreads();
      const int t0 = q * kWarps + warp, base = bounds[q * kWarps];
      const int lo = bounds[t0] - base, hi = bounds[t0 + 1] - base;  // this warp's rows
      for (int c = lo + lane; c < hi; c += 32) { num[c] = 0.f; d1[c] = 0.f; d2[c] = 0.f; }
      __syncwarp();

      // r's support, 32 columns at a time: lane l holds column l's value and
      // this warp's span of it; the spans' entries are loaded kGroup
      // columns at a time, then accumulated column by column, ascending j
      for (int w0 = 0; w0 < deg; w0 += 32) {
        int e0 = 0, e1 = 0;
        float a_l = 0.f;
        if (w0 + lane < deg) {
          const int j = col_idx[s0 + w0 + lane];
          a_l = row_val[s0 + w0 + lane];
          e0 = split[(size_t)j * T + t0];
          e1 = split[(size_t)j * T + t0 + 1];
        }
        const int cols = min(32, deg - w0);
        for (int g0 = 0; g0 < cols; g0 += kGroup) {
          int ci[kGroup][2];
          float cv[kGroup][2];
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            const int b0 = __shfl_sync(0xFFFFFFFFu, e0, (g0 + g) & 31);
            const int b1 = __shfl_sync(0xFFFFFFFFu, e1, (g0 + g) & 31);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int e = b0 + lane + 32 * h;
              const bool ok = g0 + g < cols && e < b1;
              ci[g][h] = ok ? row_idx[e] : -1;
              cv[g][h] = ok ? col_val[e] : 0.f;
            }
          }
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            const float a = __shfl_sync(0xFFFFFFFFu, a_l, (g0 + g) & 31), a2 = __fmul_rn(a, a);
            const int b0 = __shfl_sync(0xFFFFFFFFu, e0, (g0 + g) & 31);
            const int b1 = __shfl_sync(0xFFFFFFFFu, e1, (g0 + g) & 31);
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if (ci[g][h] >= 0) accumulate(num, d1, d2, ci[g][h] - base, a, a2, cv[g][h]);
            // a span longer than 64 entries: the rest from memory, four
            // loads a lane in flight at a time
            for (int e0 = b0 + 64; g0 + g < cols && e0 < b1; e0 += 4 * 32) {
              int ti[4];
              float tv[4];
#pragma unroll
              for (int h = 0; h < 4; ++h) {
                const int e = e0 + lane + 32 * h;
                ti[h] = e < b1 ? row_idx[e] : -1;
                tv[h] = e < b1 ? col_val[e] : 0.f;
              }
#pragma unroll
              for (int h = 0; h < 4; ++h)
                if (ti[h] >= 0) accumulate(num, d1, d2, ti[h] - base, a, a2, tv[h]);
            }
            __syncwarp();  // the next column may touch the same rows
          }
        }
      }

      for (int t = lo; t < hi; t += kTile) {
        for (int i = lane; i < kTile; i += 32) {
          const int c = t + i;
          u64 key = 0ull;
          if (c < hi) {
            const float nm = num[c];
            float sim = 0.f;
            if (nm != 0.f) sim = nm / fmaxf(sqrtf(d1[c]) * sqrtf(d2[c]), 1e-12f);
            if (exclude_self && base + c == r) sim = kNegInf;
            key = make_key(sim, base + c);
          }
          K[i] = key;
        }
        __syncwarp();
        const int merged = fold_topk(K, kTile, mine + cur * k, mine + (cur ^ 1) * k, count, k, lane);
        if (merged >= 0) { count = merged; cur ^= 1; }
      }
    }

    if (lane == 0) { misc[1 + warp] = count; misc[1 + kWarps + warp] = cur; }
    __syncthreads();
    if (warp == 0) {  // merge the warps' lists, packed into whole tiles
      u64* row_list = lists + (size_t)kWarps * 2 * k;
      int fcount = 0, fcur = 0, fill = 0;
      auto fold = [&]() {
        for (int t = fill + lane; t < kTile; t += 32) K[t] = 0ull;
        __syncwarp();
        const int merged = fold_topk(K, kTile, row_list + fcur * k, row_list + (fcur ^ 1) * k,
                                     fcount, k, lane);
        if (merged >= 0) { fcount = merged; fcur ^= 1; }
        fill = 0;
      };
      for (int w = 0; w < kWarps; ++w) {
        const u64* L = lists + ((size_t)w * 2 + misc[1 + kWarps + w]) * k;
        const int cnt = misc[1 + w];
        for (int p = 0; p < cnt;) {
          const int take = min(cnt - p, kTile - fill);
          for (int t = lane; t < take; t += 32) K[fill + t] = L[p + t];
          fill += take;
          p += take;
          __syncwarp();
          if (fill == kTile) fold();
        }
      }
      if (fill > 0) fold();
      const u64* run = row_list + fcur * k;
      for (int p = lane; p < k; p += 32) {
        const u64 x = run[p];
        out_s[(size_t)r * k + p] = key_score(x);
        out_i[(size_t)r * k + p] = key_index(x);
      }
    }
    __syncthreads();  // misc and warp 0's tile are reused by the next row
  }
}

}  // namespace

extern "C" {

// For n rows on `device`: the candidate rows one range holds (C) and the
// number of persistent blocks a launch uses, which sizes its scratch.
// Returns a cudaError_t (0 on success).
int cornac_cosine_topk_plan(int device, int n, int* C, int* blocks) {
  int smem_limit, sms, per_sm;
  OnDevice on(device);
  cudaError_t err = on.err;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  // as many candidate rows per range as shared memory holds, spread evenly
  // over the ranges n needs
  const int cap = ((smem_limit - kFixedBytes) / 12) & ~3;
  const int ranges = (n + cap - 1) / cap;
  *C = (n + ranges - 1) / ranges;
  err = cudaFuncSetAttribute(cosine_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes(*C));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cosine_topk_kernel, kThreads,
                                                        smem_bytes(*C));
  if (err != cudaSuccess) return (int)err;
  const int resident = per_sm * sms;
  *blocks = n < resident ? (n > 0 ? n : 1) : resident;
  return (int)cudaSuccess;
}

// Launches on `stream` of `device`. W (n, m) comes as its CSR (row_ptr n + 1, col_idx,
// row_val) and its CSC entries (row_idx, col_val), indices ascending
// within each row and column, no explicit zeros; `bounds` (ranges * 8 + 1
// ints: range q of at most C rows is bounds[8q] to bounds[8q + 8], split
// among the 8 warps) and `split` (m x (ranges * 8 + 1) ints) as described
// at cosine_topk_kernel. `scratch` holds blocks * (8 + 1) * 2 * k 64-bit
// words, for the C and blocks that cornac_cosine_topk_plan gave for n on
// this device, `next_row` one int set to 0. Requires 1 <= k <= n - 1 with
// exclude_self (else k <= n). Returns the launch's cudaError_t (0 on
// success).
int cornac_cosine_topk(int device, const int* row_ptr, const int* col_idx, const float* row_val,
                       const int* split, const int* row_idx, const float* col_val,
                       const int* bounds, int n, int ranges, int C, int k, int exclude_self,
                       int blocks, float* out_s, int* out_i, void* scratch, int* next_row,
                       void* stream) {
  if (C < 1 || blocks < 1 || ranges != (n + C - 1) / C) return (int)cudaErrorInvalidValue;
  OnDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  // refuses a C whose accumulators shared memory cannot hold
  cudaError_t err = cudaFuncSetAttribute(
      cosine_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(C));
  if (err != cudaSuccess) return (int)err;
  cosine_topk_kernel<<<blocks, kThreads, smem_bytes(C), (cudaStream_t)stream>>>(
      row_ptr, col_idx, row_val, split, row_idx, col_val, bounds, n, ranges, C, k, exclude_self,
      out_s, out_i, static_cast<u64*>(scratch), next_row);
  return (int)cudaGetLastError();
}

const char* cornac_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
