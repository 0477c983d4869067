// Shared-memory splitter tree over a sorted int64 array, for Hopper
// (sm_90a).  Included by probe_sorted.cu and merge_ranks.cu, which each
// define their own kernels around it.
//
// The tree holds the splitters right[j << s], j = 0 .. table - 1, with
// table = ceil(m / 2^s) <= 2^h: slot 0 holds right[0], and slots
// k in [1, 2^h) a complete binary search tree of splitters 1 .. 2^h - 1
// in breadth-first (Eytzinger) order, pads (j >= table) LLONG_MAX.  A
// level of the descent reads 2^d neighbouring slots, where a sorted
// table's halving steps would put every lane of a warp on one bank.
//
// A search for key counts the splitters that satisfy the side's
// predicate (v < key for side left, v <= key for side right) by
// descending the tree, which narrows the answer to one aligned window of
// 2^s right keys; s halving steps in device memory finish it.  When
// s = 0 the tree is the whole array and the search never leaves shared
// memory.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace splitter_tree {

// right[j << s] for slot k (the tree's in-order index j(k)), LLONG_MAX
// past the last splitter: the gather form, one strided load per slot
__device__ __forceinline__ long long tree_slot(const long long* right, int s,
                                               int table, int h, int k) {
  if (k == 0) return __ldg(right);
  const int d = 31 - __clz(k);
  const int j = (2 * (k - (1 << d)) + 1) << (h - 1 - d);
  return j < table ? __ldg(right + (static_cast<int64_t>(j) << s))
                   : LLONG_MAX;
}

// The slot that holds splitter j (the inverse of tree_slot's j(k))
__device__ __forceinline__ int slot_of(int j, int h) {
  if (j == 0) return 0;
  const int z = __ffs(j) - 1;
  return (1 << (h - 1 - z)) + (j >> (z + 1));
}

// The tree into shared memory `tab` (2^h slots), by the whole block:
// copied from `tree` (a gather pass's output in device memory) when it is
// given, else built from the right array itself, one strided load a slot.
// Ends with __syncthreads().
__device__ __forceinline__ void load_tree(long long* tab,
                                          const long long* right, int s,
                                          int table, int h,
                                          const long long* tree) {
  const int slots = table ? 1 << h : 0;
  for (int k = threadIdx.x; k < slots; k += blockDim.x)
    tab[k] = tree ? __ldg(tree + k) : tree_slot(right, s, table, h, k);
  __syncthreads();
}

template <bool RIGHT>
__device__ __forceinline__ bool before(long long v, long long key) {
  return RIGHT ? v <= key : v < key;
}

// The count c of splitters before the key.  The path's right turns spell
// c - 1 in binary when right[0] is before the key (else c = 0); pads
// count only for side right at key LLONG_MAX, so c is capped at table.
// With CARRY, *ub is the first splitter not before the key (the last left
// turn's, or right[0]), the right key at the answer when the window adds
// nothing.
template <bool RIGHT, bool CARRY>
__device__ __forceinline__ int descend(const long long* tab, int table,
                                       int h, long long key, long long* ub) {
  if (!table) return 0;
  const long long first = tab[0];
  int c = 1;
  long long u = first;
  for (int d = 0; d < h; ++d) {
    const long long v = tab[c];
    const bool go = before<RIGHT>(v, key);
    if (CARRY && !go) u = v;
    c = 2 * c + go;
  }
  if (!before<RIGHT>(first, key)) {
    if (CARRY) *ub = first;
    return 0;
  }
  if (CARRY) *ub = u;
  c = c - (1 << h) + 1;
  return c < table ? c : table;
}

// The answer in the window after the descent: the count of right keys
// before the key.  right[pos] is before the key (or pos = -1) and the
// answer lies in (pos, end]; halving steps over device memory.  With
// CARRY, *ub becomes the last probe that failed.  Positions fit 32 bits
// (m < 2^31); p is formed in 64.
template <bool RIGHT, bool CARRY>
__device__ __forceinline__ int32_t window(const long long* right, int64_t m,
                                          int s, int c, long long key,
                                          long long* ub) {
  const int64_t wend = static_cast<int64_t>(c) << s;
  int32_t pos = c ? static_cast<int32_t>(wend - (int64_t(1) << s)) : -1;
  const int32_t end = static_cast<int32_t>(c ? (wend < m ? wend : m) : 0);
  for (int st = s - 1; st >= 0; --st) {
    const int64_t p = pos + (int64_t(1) << st);
    if (p < end) {
      const long long v = __ldg(right + p);
      if (before<RIGHT>(v, key)) pos = static_cast<int32_t>(p);
      else if (CARRY) *ub = v;
    }
  }
  return pos + 1;
}

// The plan for m right keys and a tree of at most 2^table_log2 slots: the
// least s with ceil(m / 2^s) <= 2^table_log2, the table, and the tree's
// height h (2^h >= table).
struct Plan {
  int s = 0, table = 0, h = 0;
};

inline Plan plan(int64_t m, int table_log2) {
  Plan p;
  while (m > 0 && ((m - 1) >> p.s) + 1 > (int64_t(1) << table_log2)) ++p.s;
  p.table = m > 0 ? static_cast<int>(((m - 1) >> p.s) + 1) : 0;
  while ((1 << p.h) < p.table) ++p.h;
  return p;
}

// Per device, for one kernel: the SM count, and its resident blocks per
// SM by the tree's height (at 8 << h bytes of shared memory a block),
// queried once each.  The kernel's shared-memory limit is raised to the
// largest tree on the first query.
constexpr int MAX_DEVICES = 64;
constexpr int MAX_H = 14;  // 2^14 slots, 128 KB: one block's shared memory

struct Occupancy {
  int sms[MAX_DEVICES] = {};
  int blocks[MAX_DEVICES][MAX_H + 1] = {};
};

template <typename Kernel>
cudaError_t occupancy(Occupancy& occ, Kernel kernel, int threads, int h,
                      int* sms, int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (h < 0 || h > MAX_H) return cudaErrorInvalidValue;
  if (occ.sms[dev] == 0) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sizeof(long long)) << MAX_H);
    int count = 0;
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return err;
    occ.sms[dev] = count;
  }
  if (occ.blocks[dev][h] == 0) {
    int b = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, kernel, threads, sizeof(long long) << h);
    if (err != cudaSuccess) return err;
    occ.blocks[dev][h] = b > 0 ? b : 1;
  }
  *sms = occ.sms[dev];
  *blocks = occ.blocks[dev][h];
  return cudaSuccess;
}

}  // namespace splitter_tree
