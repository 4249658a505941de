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
// The contract is exact float32 with float32 accumulation, so the tensor
// cores (TF32 at best) are out of reach; the design keeps the CUDA cores
// fed and keeps selection off the critical path:
//
//  * a block owns kRows user rows and walks the catalog in chunks of
//    kChunk items (the loop takes the place of the TPU grid's sequential
//    item-tile axis, since CUDA blocks run in no order);
//  * each chunk is scored as a register-tiled product: the U and V tiles
//    are staged in shared memory kDepth features at a time and every
//    thread accumulates kRows x kItemsPerThread scores with fmaf, so one
//    shared-memory read feeds several FMAs;
//  * a (score, item) pair is packed into one 64-bit key whose unsigned
//    order is "score descending, then item ascending", which makes the
//    tie rule a plain integer compare (topk_keys.cuh, shared with
//    cosine_topk.cu);
//  * each row keeps its running top-k, sorted, in a global scratch buffer
//    (two halves used in turn) so every 1 <= k <= N works; a chunk's keys
//    below the row's current k-th key are dropped by a warp ballot, the
//    few survivors are bitonic-sorted in shared memory and merged into the
//    running list by rank (position in own list + binary-search count in
//    the other). After the first chunk only a small share of any chunk
//    survives, so the selection costs little beside the scoring.

#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_keys.cuh"

namespace {

using cornac_topk::u64;
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
constexpr int kVPitch = kChunk + 4;                  // padding spreads the transposed stores over the banks

constexpr int kUTileBytes = kDepth * kRows * (int)sizeof(float);
constexpr int kVTileBytes = kDepth * kVPitch * (int)sizeof(float);
constexpr int kKeyTileBytes = kRows * kChunk * (int)sizeof(u64);
constexpr int kSmemBytes =
    kUTileBytes + (kVTileBytes > kKeyTileBytes ? kVTileBytes : kKeyTileBytes);

static_assert((kChunk & (kChunk - 1)) == 0, "bitonic sort needs a power of two");
static_assert(kChunk % kThreads == 0 && kRows % kWarps == 0 && kRows % 4 == 0, "tiling");
static_assert(kUTileBytes % 16 == 0, "key tile must stay 16-byte aligned");

// Key 0 marks an empty slot (topk_keys.cuh).
__global__ void __launch_bounds__(kThreads)
fused_topk_kernel(const float* __restrict__ U, const float* __restrict__ V,
                  const float* __restrict__ bias, int B, int N, int d, int k,
                  float* __restrict__ out_s, int* __restrict__ out_i,
                  u64* scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Us = reinterpret_cast<float*>(smem);                       // [kDepth][kRows]
  float* Vs = reinterpret_cast<float*>(smem + kUTileBytes);         // [kDepth][kVPitch], scoring
  u64* Ks = reinterpret_cast<u64*>(smem + kUTileBytes);             // [kRows][kChunk], selection

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kRows;
  const size_t half = (size_t)B * k;  // offset of the scratch's second half

  int count[kRowsPerWarp], cur[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) { count[r] = 0; cur[r] = 0; }

  for (int c0 = 0; c0 < N; c0 += kChunk) {
    float acc[kRows][kItemsPerThread];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int t = 0; t < kItemsPerThread; ++t) acc[r][t] = 0.f;

    for (int k0 = 0; k0 < d; k0 += kDepth) {
      if (tid < kRows * kDepth) {
        const int r = tid / kDepth, j = tid % kDepth;
        const int row = row0 + r, dim = k0 + j;
        Us[j * kRows + r] = (row < B && dim < d) ? U[(size_t)row * d + dim] : 0.f;
      }
      for (int e = tid; e < kChunk * kDepth; e += kThreads) {
        const int item = e / kDepth, j = e % kDepth;
        const int gi = c0 + item, dim = k0 + j;
        Vs[j * kVPitch + item] = (gi < N && dim < d) ? V[(size_t)gi * d + dim] : 0.f;
      }
      __syncthreads();
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
      __syncthreads();  // Ks aliases Vs
    }

#pragma unroll
    for (int t = 0; t < kItemsPerThread; ++t) {
      const int col = tid + t * kThreads, item = c0 + col;
      const float b = (item < N && bias != nullptr) ? bias[item] : 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        Ks[r * kChunk + col] = item < N ? make_key(acc[r][t] + b, item) : 0ull;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int lr = warp + kWarps * r, row = row0 + lr;
      if (row >= B) continue;
      u64* K = Ks + lr * kChunk;
      const u64* run = scratch + cur[r] * half + (size_t)row * k;
      u64* next = scratch + (cur[r] ^ 1) * half + (size_t)row * k;
      const int merged = fold_topk(K, kChunk, run, next, count[r], k, lane);
      if (merged < 0) continue;
      count[r] = merged;
      cur[r] ^= 1;
    }
    __syncthreads();  // the next chunk's V tile overwrites Ks
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + warp + kWarps * r;
    if (row >= B) continue;
    const u64* run = scratch + cur[r] * half + (size_t)row * k;
    for (int p = lane; p < k; p += 32) {
      const u64 x = run[p];
      out_s[(size_t)row * k + p] = key_score(x);
      out_i[(size_t)row * k + p] = key_index(x);
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; `scratch` holds 2*B*k 64-bit words. Requires
// 1 <= k <= N and row-major contiguous U (B, d), V (N, d), bias (N,) or
// NULL. Returns the launch's cudaError_t (0 on success).
int cornac_fused_topk(const float* U, const float* V, const float* bias, int B, int N,
                      int d, int k, float* out_s, int* out_i, void* scratch, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kRows - 1) / kRows);
  fused_topk_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      U, V, bias, B, N, d, k, out_s, out_i, static_cast<u64*>(scratch));
  return (int)cudaGetLastError();
}

const char* cornac_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
