// All-pairs co-support cosine similarity + exact streaming top-k, for
// Hopper (sm_90a).
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
// What bounds it on an H100: the function needs 3*n*n*m float32
// operations, since num is symmetric (half of its 2*n*n*m) and d2 is d1
// transposed (d2[r,c] = d1[c,r]), against 4*n*m bytes in and 8*n*k bytes
// out. At the ML-10M item side (n = 10,677, m = 69,878) that is 2.4e13
// operations, 0.36 s at 67 TFLOP/s, against 3.0 GB, 0.9 ms at 3.35 TB/s:
// operation-bound by about 400x. This kernel does twice that work: every
// (rows, columns) tile computes all three accumulators, and the (C, R)
// tile repeats the (R, C) one transposed. The contract is exact float32
// (on star ratings the sums are exact, and the neighbour tables must equal
// the plain version's index for index), so the tensor cores (TF32 at
// best) are out of reach; the design keeps the CUDA cores fed:
//
//  * a block owns kRows = 32 rows of W and walks every column tile of
//    kCols = 128 other rows itself (the loop takes the place of the TPU
//    grid's sequential column-tile axis, since CUDA blocks run in no
//    order);
//  * one TPU block held whole rows of W in VMEM; here one row of W alone
//    (273 KB at m = 69,878) exceeds the 227 KB of shared memory, so each
//    tile loops over m in slabs of kDepth entries, as a tiled GEMM does.
//    Each slab is staged in shared memory as three arrays (w, w^2,
//    [w != 0]) and every thread accumulates 2 x 8 pairs with three fmaf
//    each, so one shared-memory read feeds several FMAs;
//  * W is read from device memory once per row block, so arithmetic
//    intensity is 1.5 * kRows = 48 FLOP/byte, above the card's FP32 ridge
//    of 67e12 / 3.35e12 = 20; at n = 10,677 there are 334 blocks, two per
//    SM at this register count, so 1.27 waves over the 132 SMs;
//  * the running top-k is fused_topk.cu's (topk_keys.cuh): 64-bit keys,
//    a warp-ballot filter against the row's current k-th key, a bitonic
//    sort of the survivors and a rank merge into a double-buffered list
//    in global scratch. Columns at or past n never enter the list: their
//    key is 0, the empty slot, which no ballot lets through.
//
// Arithmetic, in this order, as the TPU kernel: fmaf accumulation of num,
// d1 and d2 over m; then sqrtf(d1) * sqrtf(d2), fmaxf(., 1e-12f) and an
// IEEE division (no fast-math: -prec-div and -prec-sqrt stay on).

#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_keys.cuh"

namespace {

using cornac_topk::u64;
using cornac_topk::fold_topk;
using cornac_topk::key_index;
using cornac_topk::key_score;
using cornac_topk::make_key;

constexpr int kThreads = 256;                  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;                      // rows of W per block
constexpr int kCols = 128;                     // column tile: other rows of W, power of two
constexpr int kDepth = 32;                     // entries of m per slab
constexpr int kRowsPerWarp = kRows / kWarps;   // rows each warp selects for
constexpr int kTR = 2;                         // rows per thread
constexpr int kTC = 8;                         // columns per thread, two groups of 4
constexpr int kRPitch = kRows + 4;             // padding spreads the transposed stores
constexpr int kCPitch = kCols + 4;
constexpr int kRTile = kDepth * kRPitch;       // floats per staged row array
constexpr int kCTile = kDepth * kCPitch;       // floats per staged column array

constexpr int kStageBytes = 3 * (kRTile + kCTile) * (int)sizeof(float);
constexpr int kKeyBytes = kRows * kCols * (int)sizeof(u64);
constexpr int kSmemBytes = kStageBytes > kKeyBytes ? kStageBytes : kKeyBytes;

constexpr float kNegInf = -3.0e38f;

static_assert((kCols & (kCols - 1)) == 0 && kCols % 32 == 0, "bitonic sort needs a power of two");
static_assert((kRows / kTR) * (kCols / kTC) == kThreads, "one thread per 2 x 8 pairs");
static_assert(kCols / kTC == 16 && kCols == 128, "thread columns: tx*4 and 64 + tx*4");
static_assert(kRows % kWarps == 0, "rows split evenly over the warps");
static_assert((kRTile * 4) % 16 == 0 && (kCTile * 4) % 16 == 0, "vector loads stay aligned");

__global__ void __launch_bounds__(kThreads, 2)
cosine_topk_kernel(const float* __restrict__ W, int n, int m, int k, int exclude_self,
                   float* __restrict__ out_s, int* __restrict__ out_i, u64* scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Rv = reinterpret_cast<float*>(smem);  // [kDepth][kRPitch]: w, w^2, [w != 0]
  float* Rs = Rv + kRTile;
  float* Rz = Rs + kRTile;
  float* Cv = Rz + kRTile;                     // [kDepth][kCPitch]: the same for the columns
  float* Cs = Cv + kCTile;
  float* Cz = Cs + kCTile;
  u64* Ks = reinterpret_cast<u64*>(smem);      // [kRows][kCols] keys, aliases the slabs

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid / (kCols / kTC), tx = tid % (kCols / kTC);
  const int row0 = blockIdx.x * kRows;
  const size_t half = (size_t)n * k;  // offset of the scratch's second half

  int count[kRowsPerWarp], cur[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) { count[r] = 0; cur[r] = 0; }

  for (int c0 = 0; c0 < n; c0 += kCols) {
    float num[kTR][kTC], d1[kTR][kTC], d2[kTR][kTC];
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int j = 0; j < kTC; ++j) { num[i][j] = 0.f; d1[i][j] = 0.f; d2[i][j] = 0.f; }

    for (int k0 = 0; k0 < m; k0 += kDepth) {
      // stage: consecutive threads read consecutive entries of one row
      for (int e = tid; e < kRows * kDepth; e += kThreads) {
        const int r = e / kDepth, j = e % kDepth;
        const int row = row0 + r, col = k0 + j;
        const float a = (row < n && col < m) ? W[(size_t)row * m + col] : 0.f;
        Rv[j * kRPitch + r] = a;
        Rs[j * kRPitch + r] = a * a;
        Rz[j * kRPitch + r] = a != 0.f ? 1.f : 0.f;
      }
      for (int e = tid; e < kCols * kDepth; e += kThreads) {
        const int c = e / kDepth, j = e % kDepth;
        const int row = c0 + c, col = k0 + j;
        const float b = (row < n && col < m) ? W[(size_t)row * m + col] : 0.f;
        Cv[j * kCPitch + c] = b;
        Cs[j * kCPitch + c] = b * b;
        Cz[j * kCPitch + c] = b != 0.f ? 1.f : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kDepth; ++j) {
        const float2 av = *reinterpret_cast<const float2*>(Rv + j * kRPitch + ty * kTR);
        const float2 as = *reinterpret_cast<const float2*>(Rs + j * kRPitch + ty * kTR);
        const float2 az = *reinterpret_cast<const float2*>(Rz + j * kRPitch + ty * kTR);
        const float a_v[kTR] = {av.x, av.y}, a_s[kTR] = {as.x, as.y}, a_z[kTR] = {az.x, az.y};
        float b_v[kTC], b_s[kTC], b_z[kTC];
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          const int off = j * kCPitch + g * (kCols / 2) + tx * 4;
          const float4 v = *reinterpret_cast<const float4*>(Cv + off);
          const float4 s = *reinterpret_cast<const float4*>(Cs + off);
          const float4 z = *reinterpret_cast<const float4*>(Cz + off);
          b_v[4 * g + 0] = v.x; b_v[4 * g + 1] = v.y; b_v[4 * g + 2] = v.z; b_v[4 * g + 3] = v.w;
          b_s[4 * g + 0] = s.x; b_s[4 * g + 1] = s.y; b_s[4 * g + 2] = s.z; b_s[4 * g + 3] = s.w;
          b_z[4 * g + 0] = z.x; b_z[4 * g + 1] = z.y; b_z[4 * g + 2] = z.z; b_z[4 * g + 3] = z.w;
        }
#pragma unroll
        for (int i = 0; i < kTR; ++i)
#pragma unroll
          for (int c = 0; c < kTC; ++c) {
            num[i][c] = fmaf(a_v[i], b_v[c], num[i][c]);
            d1[i][c] = fmaf(a_s[i], b_z[c], d1[i][c]);
            d2[i][c] = fmaf(a_z[i], b_s[c], d2[i][c]);
          }
      }
      __syncthreads();  // the next slab, or the keys, overwrite the slabs
    }

#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      const int lr = ty * kTR + i, row = row0 + lr;
#pragma unroll
      for (int c = 0; c < kTC; ++c) {
        const int lc = (c / 4) * (kCols / 2) + tx * 4 + (c % 4), col = c0 + lc;
        float sim = 0.f;
        if (num[i][c] != 0.f) {
          const float denom = sqrtf(d1[i][c]) * sqrtf(d2[i][c]);
          sim = num[i][c] / fmaxf(denom, 1e-12f);
        }
        if (exclude_self && row == col) sim = kNegInf;
        Ks[lr * kCols + lc] = col < n ? make_key(sim, col) : 0ull;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int lr = warp + kWarps * r, row = row0 + lr;
      if (row >= n) continue;
      const u64* run = scratch + cur[r] * half + (size_t)row * k;
      u64* next = scratch + (cur[r] ^ 1) * half + (size_t)row * k;
      const int merged = fold_topk(Ks + lr * kCols, kCols, run, next, count[r], k, lane);
      if (merged < 0) continue;
      count[r] = merged;
      cur[r] ^= 1;
    }
    __syncthreads();  // the next tile's slabs overwrite Ks
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + warp + kWarps * r;
    if (row >= n) continue;
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

// Launches on `stream`; `scratch` holds 2*n*k 64-bit words. Requires
// 1 <= k <= n - 1 with exclude_self (else k <= n) and a row-major
// contiguous W (n, m); offsets into W are 64-bit. Returns the launch's
// cudaError_t (0 on success).
int cornac_cosine_topk(const float* W, int n, int m, int k, int exclude_self,
                       float* out_s, int* out_i, void* scratch, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      cosine_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kRows - 1) / kRows);
  cosine_topk_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      W, n, m, k, exclude_self, out_s, out_i, static_cast<u64*>(scratch));
  return (int)cudaGetLastError();
}

const char* cornac_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
