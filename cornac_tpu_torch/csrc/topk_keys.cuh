// Running exact top-k over 64-bit keys, shared by the port's streaming
// top-k kernels (fused_topk.cu, cosine_topk.cu).
//
// A (score, index) pair is packed into one 64-bit key whose unsigned order
// is "score descending, then index ascending", so the tie rule is a plain
// integer compare. Key 0 marks an empty slot: no real key is 0, because
// index < 2^32 - 1.
//
// Each row keeps its running top-k, sorted, in a buffer of two halves used
// in turn (shared memory or global scratch), so every 1 <= k works.
// `fold_topk` folds one tile of candidate keys into that list: keys that
// do not beat the row's current k-th key are dropped by a warp ballot
// (while the list is not full, keys below a bisected floor that k others
// reach), the survivors are bitonic-sorted in registers (held up to 16 to a lane,
// exchanged across lanes with shuffles) and merged into the running list
// by rank (position in own list + binary-search count in the other).

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

// One bitonic step whose partners lie in the same lane, Q registers apart.
template <int R, int Q>
__device__ __forceinline__ void step_in_lane(u64 (&v)[R], int lane, int size) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if ((r & Q) == 0) {
      const u64 a = v[r], b = v[r + Q];
      if ((a < b) == (((lane * R + r) & size) == 0)) { v[r] = b; v[r + Q] = a; }
    }
  }
}

// Sorts the 32 * R keys at K descending, called by one whole warp: lane l
// holds K[l*R .. l*R + R) in registers; a bitonic step whose partner lies
// in the same lane swaps registers, one whose partner lies in lane
// l ^ (stride / R) exchanges with a shuffle. The loops over the network's
// steps stay rolled (unrolled, the 512-key network is thousands of
// instructions and misses the instruction cache); only the work on the R
// registers of one step is unrolled, so no register is indexed at run time.
template <int R>
__device__ __forceinline__ void warp_sort_desc(u64* K, int lane) {
  constexpr int kLog = 5 + (R >= 2) + (R >= 4) + (R >= 8) + (R >= 16);
  static_assert(R >= 1 && R <= 16 && (R & (R - 1)) == 0, "R keys a lane, a power of two");
  u64 v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = K[lane * R + r];
#pragma unroll 1
  for (int ls = 1; ls <= kLog; ++ls) {
    const int size = 1 << ls;
#pragma unroll 1
    for (int lt = ls - 1; lt >= 0; --lt) {
      const int stride = 1 << lt;
      if (stride >= R) {
        const int mask = stride / R;
        const bool lower = (lane & mask) == 0;  // this lane holds the lower index of each pair
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const u64 o = __shfl_xor_sync(0xFFFFFFFFu, v[r], mask);
          const bool desc = ((lane * R + r) & size) == 0;
          v[r] = (lower == desc) ? (v[r] > o ? v[r] : o) : (v[r] < o ? v[r] : o);
        }
      } else if (stride == 1) {
        step_in_lane<R, (R > 1 ? 1 : 0)>(v, lane, size);
      } else if (stride == 2) {
        step_in_lane<R, (R > 2 ? 2 : 0)>(v, lane, size);
      } else if (stride == 4) {
        step_in_lane<R, (R > 4 ? 4 : 0)>(v, lane, size);
      } else {
        step_in_lane<R, (R > 8 ? 8 : 0)>(v, lane, size);
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < R; ++r) K[lane * R + r] = v[r];
  __syncwarp();
}

// Called by one whole warp. K: `tile` candidate keys in shared memory
// (`tile` a power of two from 32 to 512, so a lane holds at most 16 of
// them; empty slots hold 0), which this overwrites. run: the row's m best keys so far, sorted descending; the
// merged list goes to next. Returns the new count, or -1 (and leaves next
// untouched) when no candidate beats the current k-th key.
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

  // a list not yet full lets every candidate through; when far more than
  // k did, bisect on the keys' upper (score) words for the highest floor
  // that at least k candidates reach, and drop the rest: each dropped key
  // has k keys above it, so it could not be kept
  if (m < k && S > 2 * k) {
    uint32_t hi[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const int i = lane + 32 * t;
      hi[t] = i < S ? (uint32_t)(K[i] >> 32) : 0u;
    }
    uint32_t lo = 0u, top = 0xFFFFFFFFu;
    while (lo < top) {
      const uint32_t mid = lo + (uint32_t)(((u64)top - lo + 1) >> 1);
      unsigned c = 0;
#pragma unroll
      for (int t = 0; t < 16; ++t) c += hi[t] >= mid;
      if ((int)__reduce_add_sync(0xFFFFFFFFu, c) >= k) lo = mid; else top = mid - 1;
    }
    const u64 floor_key = (u64)lo << 32;
    int kept = 0;
    for (int base = 0; base < S; base += 32) {
      const int i = base + lane;
      const u64 x = i < S ? K[i] : 0ull;
      const bool keep = i < S && x >= floor_key;
      const unsigned ballot = __ballot_sync(0xFFFFFFFFu, keep);
      if (keep) K[kept + __popc(ballot & ((1u << lane) - 1u))] = x;
      kept += __popc(ballot);
    }
    S = kept;
  }

  int P = 32;
  while (P < S) P <<= 1;
  for (int i = S + lane; i < P; i += 32) K[i] = 0ull;
  __syncwarp();
  switch (P) {
    case 32: warp_sort_desc<1>(K, lane); break;
    case 64: warp_sort_desc<2>(K, lane); break;
    case 128: warp_sort_desc<4>(K, lane); break;
    case 256: warp_sort_desc<8>(K, lane); break;
    default: warp_sort_desc<16>(K, lane); break;
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
