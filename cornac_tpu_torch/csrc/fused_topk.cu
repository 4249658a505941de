// Fused full-catalog scoring + exact streaming top-k, for Hopper (sm_90a).
//
// Replaces the TPU kernel cornac_tpu/ops/pallas_ranking.py::_topk_kernel:
// for every user row u it returns the k items with the largest
// score(u, i) = <U[u], V[i]> (+ bias[i]), best first, equal scores ordered
// by ascending item index. The (B, N) score matrix never reaches device
// memory.
//
// What bounds it on an H100: the score is 2*B*N*d float32 operations
// against (B*d + N*d + N)*4 bytes in and B*k*8 bytes out, so at the
// serving shape (B=8192, N=17700, d=51, k=100) the FP32 FMA rate bounds it
// (about 0.22 ms at 67 TFLOP/s), not the memory (about 4 us of traffic).
// At small B the work is far too small to fill 132 SMs (B=1: 1.8 MFLOP,
// bound by the 3.6 MB of V): what a small batch waits for is how many SMs
// take part and the latency of each block's steps, above all the
// selection's. The contract is exact float32 with float32 accumulation, so
// the tensor cores (TF32 at best) are out of reach. The design:
//
//  * the grid is (ceil(B / kRows), S): block (b, s) owns kRows user rows
//    and slice s of the catalog (chunks s*C/S up to (s+1)*C/S of the C
//    chunks of kChunk items), and walks it chunk by chunk. The wrapper
//    picks S (ops/fused_topk.py::split_plan) so that the grid fills the
//    card in one wave: S = 1 at large B (B=8192 gives 512 row blocks, two
//    waves already), up to one slice per chunk at B=1;
//  * each chunk is scored as a register-tiled product: the U and V tiles
//    are staged in shared memory kDepth features at a time, through
//    kStages buffers filled by cp.async two steps ahead, and every thread
//    accumulates kRows x kItemsPerThread scores with fmaf, so one
//    shared-memory read feeds several FMAs;
//  * a (score, item) pair is packed into one 64-bit key whose unsigned
//    order is "score descending, then item ascending", which makes the
//    tie rule a plain integer compare (topk_keys.cuh, shared with
//    cosine_topk.cu);
//  * each (row, slice) keeps its running top-k, sorted: in shared memory
//    for k <= kSmemListMaxK, else in a global scratch buffer of two halves
//    used in turn, so every 1 <= k <= N works. A chunk's keys below the
//    list's current k-th key are dropped by a warp ballot, the survivors
//    are bitonic-sorted in registers and merged into the list by rank
//    (fold_topk). Where the lists live is a template argument, so the
//    compiler knows each access's memory;
//  * with S > 1 a slice may hold fewer than k items, so each slice's list
//    is written out padded with key 0 (the empty slot), and a second
//    kernel, merge_topk_kernel, merges each row's S sorted lists in a
//    tree of pairwise rank merges, one block per row. Keys are unique, so
//    the merge is exact and keeps the tie rule whatever order the blocks
//    ran in.
//
// A smaller row tile for small B (B=1 leaves 15 of the 16 rows of every
// block as padding) was not tried: the split, with the selection in
// registers, brought B = 1 and 256 under the matmul + topk yardstick
// (PERF.md), and the padded rows cost only their scoring FMAs, not a fold.

#include <cuda_runtime.h>
#include <stdint.h>

#include "on_device.cuh"
#include "topk_keys.cuh"

namespace {

using cornac_topk::u64;
using cornac_topk::count_greater;
using cornac_topk::fold_topk;
using cornac_topk::key_index;
using cornac_topk::key_score;
using cornac_topk::make_key;

constexpr int kThreads = 256;                        // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                            // user rows per block
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kChunk = 512;                          // items per chunk, power of two
constexpr int kItemsPerThread = kChunk / kThreads;
constexpr int kDepth = 8;                            // features staged per step
constexpr int kStages = 3;                           // feature steps in flight: one computed, two loading
constexpr int kVPitch = kChunk + 4;                  // padding spreads the transposed stores over the banks
constexpr int kSmemListMaxK = 512;                   // up to this k the running lists live in shared memory

constexpr int kUTileBytes = kDepth * kRows * (int)sizeof(float);
constexpr int kVTileBytes = kDepth * kVPitch * (int)sizeof(float);
constexpr int kKeyTileBytes = kRows * kChunk * (int)sizeof(u64);
constexpr int kSmemBytes = kStages * kUTileBytes + (kStages * kVTileBytes > kKeyTileBytes
                                                       ? kStages * kVTileBytes : kKeyTileBytes);

static_assert((kChunk & (kChunk - 1)) == 0, "bitonic sort needs a power of two");
static_assert(kChunk % kThreads == 0 && kRows % kWarps == 0 && kRows % 4 == 0, "tiling");
static_assert((kStages * kUTileBytes) % 16 == 0, "key tile must stay 16-byte aligned");
static_assert(kStages == 3, "stage() is called for steps 0 and 1 before the loop");

__host__ __device__ __forceinline__ bool lists_in_smem(int k) { return k <= kSmemListMaxK; }

// A 4-byte asynchronous copy to shared memory; zero-fills when !ok (src
// must still be a valid address).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Dynamic shared memory of the scoring kernel: the tiles, then (small k)
// two halves of a k-key running list for each of its rows.
__host__ __device__ __forceinline__ int scoring_smem(int k) {
  return kSmemBytes + (lists_in_smem(k) ? 2 * kRows * k * (int)sizeof(u64) : 0);
}

// Key 0 marks an empty slot (topk_keys.cuh). Scratch is (2, B, S, k) keys:
// the list of (row, slice) in either half at ((row * S) + slice) * k. Up
// to kSmemListMaxK the running lists live in shared memory instead, where
// fold_topk's binary searches and merges cost a shared-memory access each
// rather than a trip to L2, and only the slice's final list is written.
// kSmemLists is lists_in_smem(k), fixed at compile time so that the
// compiler knows which memory the lists' loads and stores go to.
template <bool kSmemLists>
__global__ void __launch_bounds__(kThreads)
fused_topk_kernel(const float* __restrict__ U, const float* __restrict__ V,
                  const float* __restrict__ bias, int B, int N, int d, int k,
                  float* __restrict__ out_s, int* __restrict__ out_i, u64* scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Us0 = reinterpret_cast<float*>(smem);                      // [kStages][kDepth][kRows]
  float* Vs0 = reinterpret_cast<float*>(smem + kStages * kUTileBytes);  // [kStages][kDepth][kVPitch]
  u64* Ks = reinterpret_cast<u64*>(smem + kStages * kUTileBytes);   // [kRows][kChunk], aliases Vs0

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kRows;
  const int S = gridDim.y, slice = blockIdx.y;
  const int chunks = (N + kChunk - 1) / kChunk;
  const int lo = (int)((long long)slice * chunks / S) * kChunk;
  const int hi = min(N, (int)((long long)(slice + 1) * chunks / S) * kChunk);
  const size_t half = (size_t)B * S * k;  // offset of the scratch's second half
  u64* Ls = reinterpret_cast<u64*>(smem + kSmemBytes);              // [kRows][2][k], small k
  auto list = [&](int lr, int h) -> u64* {  // half h of local row lr's running list
    return kSmemLists ? Ls + ((size_t)lr * 2 + h) * k
                      : scratch + h * half + ((size_t)(row0 + lr) * S + slice) * k;
  };

  // copies feature step s of the chunk at c0 (U and V tiles) into buffer
  // s % kStages; one commit group per call, empty past the last step
  const int steps = (d + kDepth - 1) / kDepth;
  auto stage = [&](int c0, int s) {
    if (s < steps) {
      const int k0 = s * kDepth;
      float* Us = Us0 + (s % kStages) * (kDepth * kRows);
      float* Vs = Vs0 + (s % kStages) * (kDepth * kVPitch);
      if (tid < kRows * kDepth) {
        const int r = tid / kDepth, j = tid % kDepth, row = row0 + r, dim = k0 + j;
        const bool ok = row < B && dim < d;
        cp_async4(Us + j * kRows + r, ok ? U + (size_t)row * d + dim : U, ok);
      }
      for (int e = tid; e < kChunk * kDepth; e += kThreads) {
        const int item = e / kDepth, j = e % kDepth, gi = c0 + item, dim = k0 + j;
        const bool ok = gi < hi && dim < d;
        cp_async4(Vs + j * kVPitch + item, ok ? V + (size_t)gi * d + dim : V, ok);
      }
    }
    cp_async_commit();
  };

  int count[kRowsPerWarp], cur[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) { count[r] = 0; cur[r] = 0; }

  for (int c0 = lo; c0 < hi; c0 += kChunk) {
    float acc[kRows][kItemsPerThread];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int t = 0; t < kItemsPerThread; ++t) acc[r][t] = 0.f;

    stage(c0, 0);
    stage(c0, 1);
    for (int s = 0; s < steps; ++s) {
      cp_async_wait<kStages - 2>();  // step s has landed, step s + 1 may still be loading
      __syncthreads();               // for every thread; step s - 1's buffer is free
      stage(c0, s + kStages - 1);
      const float* Us = Us0 + (s % kStages) * (kDepth * kRows);
      const float* Vs = Vs0 + (s % kStages) * (kDepth * kVPitch);
#pragma unroll
      for (int j = 0; j < kDepth; ++j) {
        float v[kItemsPerThread];
#pragma unroll
        for (int t = 0; t < kItemsPerThread; ++t) v[t] = Vs[j * kVPitch + tid + t * kThreads];
        const float4* u4 = reinterpret_cast<const float4*>(Us + j * kRows);
#pragma unroll
        for (int q = 0; q < kRows / 4; ++q) {
          const float4 u = u4[q];
#pragma unroll
          for (int t = 0; t < kItemsPerThread; ++t) {
            acc[4 * q + 0][t] = fmaf(u.x, v[t], acc[4 * q + 0][t]);
            acc[4 * q + 1][t] = fmaf(u.y, v[t], acc[4 * q + 1][t]);
            acc[4 * q + 2][t] = fmaf(u.z, v[t], acc[4 * q + 2][t]);
            acc[4 * q + 3][t] = fmaf(u.w, v[t], acc[4 * q + 3][t]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // Ks aliases the V buffers

#pragma unroll
    for (int t = 0; t < kItemsPerThread; ++t) {
      const int col = tid + t * kThreads, item = c0 + col;
      const float b = (item < hi && bias != nullptr) ? bias[item] : 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        Ks[r * kChunk + col] = item < hi ? make_key(acc[r][t] + b, item) : 0ull;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int lr = warp + kWarps * r, row = row0 + lr;
      if (row >= B) continue;
      u64* K = Ks + lr * kChunk;
      const int merged = fold_topk(K, kChunk, list(lr, cur[r]), list(lr, cur[r] ^ 1), count[r], k, lane);
      if (merged < 0) continue;
      count[r] = merged;
      cur[r] ^= 1;
    }
    __syncthreads();  // the next chunk's V tile overwrites Ks
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int lr = warp + kWarps * r, row = row0 + lr;
    if (row >= B) continue;
    const u64* run = list(lr, cur[r]);
    if (S == 1) {  // the slice is the whole catalog: its list is the answer
      for (int p = lane; p < k; p += 32) {
        const u64 x = run[p];
        out_s[(size_t)row * k + p] = key_score(x);
        out_i[(size_t)row * k + p] = key_index(x);
      }
    } else {  // the list goes to the first half for the merge, padded with empty keys
      u64* out = scratch + ((size_t)row * S + slice) * k;
      for (int p = lane; p < k; p += 32) out[p] = p < count[r] ? run[p] : 0ull;
    }
  }
}

// One block per row: merges the row's S lists (first scratch half, each k
// keys, sorted descending, padded with key 0) into its top k by a tree of
// pairwise merges, ceil(log2 S) levels, the two scratch halves used in
// turn. In a merge of lists A and B every key finds its place by rank: its
// position in its own list plus the count of keys above it in the other
// (a binary search); keys are unique, so the places form a bijection and
// the merge is exact, ties included. An empty key (0) lands at or past
// the merged list's count, which leaves those slots 0 too.
__global__ void __launch_bounds__(kThreads)
merge_topk_kernel(int B, int S, int k, float* __restrict__ out_s, int* __restrict__ out_i,
                  u64* scratch) {
  const int row = blockIdx.x;
  const size_t region = (size_t)S * k, half = (size_t)B * region;
  u64* src = scratch + (size_t)row * region;
  u64* dst = src + half;
  for (int lists = S; lists > 1; lists = (lists + 1) / 2) {
    const int pairs = (lists + 1) / 2;
    for (int e = threadIdx.x; e < pairs * 2 * k; e += kThreads) {
      const int q = e / (2 * k), t = e % (2 * k), p = t < k ? t : t - k;
      const int own = 2 * q + (t < k ? 0 : 1), other = own ^ 1;
      if (own >= lists) continue;  // the odd list out has no partner
      const u64 x = src[(size_t)own * k + p];
      const int pos = p + (other < lists ? count_greater(src + (size_t)other * k, k, x) : 0);
      if (pos < k) dst[(size_t)q * k + pos] = x;
    }
    __syncthreads();
    u64* t = src; src = dst; dst = t;
  }
  for (int p = threadIdx.x; p < k; p += kThreads) {
    const u64 x = src[p];
    out_s[(size_t)row * k + p] = key_score(x);
    out_i[(size_t)row * k + p] = key_index(x);
  }
}

}  // namespace

extern "C" {

// Launches on `stream` of `device`: the scoring kernel over S catalog
// slices (1 <= S <= the number of 512-item chunks), then, when S > 1, the
// merge. `scratch` holds 2*S*B*k 64-bit words. Requires 1 <= k <= N and
// row-major contiguous U (B, d), V (N, d), bias (N,) or NULL on that
// device. Returns the first launch error's cudaError_t (0 on success).
int cornac_fused_topk(int device, const float* U, const float* V, const float* bias, int B,
                      int N, int d, int k, int S, float* out_s, int* out_i, void* scratch,
                      void* stream) {
  if (S < 1 || S > (N + kChunk - 1) / kChunk) return (int)cudaErrorInvalidValue;
  OnDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  const auto kernel = lists_in_smem(k) ? fused_topk_kernel<true> : fused_topk_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, scoring_smem(k));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kRows - 1) / kRows, S);
  u64* keys = static_cast<u64*>(scratch);
  kernel<<<grid, kThreads, scoring_smem(k), (cudaStream_t)stream>>>(
      U, V, bias, B, N, d, k, out_s, out_i, keys);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return (int)err;
  merge_topk_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(B, S, k, out_s, out_i, keys);
  return (int)cudaGetLastError();
}

// How many blocks of the scoring kernel one SM of `device` holds at once
// for this k (its registers and shared memory decide), which split_plan
// needs. Returns a cudaError_t (0 on success).
int cornac_fused_topk_blocks_per_sm(int device, int k, int* blocks) {
  OnDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  const auto kernel = lists_in_smem(k) ? fused_topk_kernel<true> : fused_topk_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, scoring_smem(k));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads, scoring_smem(k));
  return (int)err;
}

const char* cornac_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
