// Running exact top-k over 64-bit keys, shared by the port's streaming
// top-k kernels (fused_topk.cu, cosine_topk.cu).
//
// A (score, index) pair is packed into one 64-bit key whose unsigned order
// is "score descending, then index ascending", so the tie rule is a plain
// integer compare. Key 0 marks an empty slot: no real key is 0, because
// index < 2^32 - 1.
//
// Each row keeps its running top-k, sorted, in a global scratch buffer
// (two halves used in turn), so every 1 <= k works. `fold_topk` folds one
// tile of candidate keys into that list: keys that do not beat the row's
// current k-th key are dropped by a warp ballot, the few survivors are
// bitonic-sorted in shared memory and merged into the running list by
// rank (position in own list + binary-search count in the other).

#pragma once

#include <stdint.h>

namespace cornac_topk {

typedef unsigned long long u64;

// -0.0 is folded into +0.0 first, so the two tie on the index as they do
// under a float comparison
__device__ __forceinline__ u64 make_key(float s, int index) {
  uint32_t u = __float_as_uint(s + 0.0f);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((u64)u << 32) | (u64)(0xFFFFFFFFu - (uint32_t)index);
}

__device__ __forceinline__ float key_score(u64 key) {
  uint32_t u = (uint32_t)(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u;
  return __uint_as_float(u);
}

__device__ __forceinline__ int key_index(u64 key) {
  return (int)(0xFFFFFFFFu - (uint32_t)key);
}

// number of entries greater than x in a descending array
__device__ __forceinline__ int count_greater(const u64* a, int n, u64 x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a[mid] > x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Called by one whole warp. K: `tile` candidate keys in shared memory
// (`tile` a power of two and a multiple of 32; empty slots hold 0), which
// this overwrites. run: the row's m best keys so far, sorted descending;
// the merged list goes to next. Returns the new count, or -1 (and leaves
// next untouched) when no candidate beats the current k-th key.
__device__ __forceinline__ int fold_topk(u64* K, int tile, const u64* run, u64* next,
                                         int m, int k, int lane) {
  const u64 theta = (m == k) ? run[k - 1] : 0ull;

  // keep the keys that beat the current k-th; compaction in place is safe
  // because every write lands at or before the slots just read
  int S = 0;
  for (int base = 0; base < tile; base += 32) {
    const u64 x = K[base + lane];
    const bool keep = x > theta;
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, keep);
    if (keep) K[S + __popc(ballot & ((1u << lane) - 1u))] = x;
    S += __popc(ballot);
  }
  if (S == 0) return -1;

  int P = 1;
  while (P < S) P <<= 1;
  for (int i = S + lane; i < P; i += 32) K[i] = 0ull;
  __syncwarp();
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < (P >> 1); t += 32) {
        const int i = 2 * t - (t & (stride - 1)), j = i + stride;
        const u64 a = K[i], b = K[j];
        const bool desc = (i & size) == 0;
        if ((a < b) == desc) { K[i] = b; K[j] = a; }
      }
      __syncwarp();
    }
  }

  // merge by rank: keys are unique, so the positions are a bijection
  for (int i = lane; i < S && i < k; i += 32) {
    const u64 x = K[i];
    const int pos = i + count_greater(run, m, x);
    if (pos < k) next[pos] = x;
  }
  for (int j = lane; j < m; j += 32) {
    const u64 y = run[j];
    const int pos = j + count_greater(K, S, y);
    if (pos < k) next[pos] = y;
  }
  __syncwarp();
  return min(m + S, k);
}

}  // namespace cornac_topk
