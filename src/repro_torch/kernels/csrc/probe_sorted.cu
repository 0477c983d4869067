// Sorted-run probe for Hopper (sm_90a).
//
// Replaces the TPU kernel `probe_sorted` (`_probe_kernel`) of
// src/repro/kernels/mergejoin/mergejoin.py: for every left key, the
// [lo, hi) run of equal keys in a sorted right array, as int32 bounds
// (searchsorted side="left" and side="right"), for m < 2^31.
//
// The Pallas kernel holds the whole right array in VMEM for each launch
// (BlockSpec((m,))); a block here has at most 227 KB of shared memory.
// Bound on this card: the inputs are read once and the bounds written once
// (8n + 8m + 8n bytes, 0.010 ms at n = 2^20, m = 2^21), but every step of
// a search is a load at an address no other lane of the warp shares, so
// what the kernel pays for is the number of such loads and the shared-
// memory bank conflicts of the table's levels.
//
// What held the first design back (one thread per left key, two full
// binary searches of ~21 dependent 8-byte loads each, nothing in shared
// memory, the second search restarting from hi = m; 0.261 ms at n = 2^20,
// m = 2^21 against 0.207 for two torch.searchsorted calls; PERF.md §6).
// What the design does about it:
//
// - A splitter table in shared memory: every 2^s-th right key, with s the
//   least that keeps the table at 2^PROBE_TABLE_LOG2 entries or fewer.
//   It is held as a complete binary search tree in breadth-first
//   (Eytzinger) order: a level of the descent reads neighbouring slots,
//   where a sorted table's halving steps put every lane of a warp on one
//   bank (up to 32-way conflicts at 10 of the 14 levels).  For s > 0 a
//   small pre-kernel (`probe_gather`) writes the tree to scratch once, so
//   that each block copies it with coalesced reads; for s = 0 each block
//   builds it from the right array, one strided load a slot (at n = 2^12,
//   m = 2^13 this measured 0.0100 ms against 0.0113 for coalesced reads
//   stored at scattered slots).  The tree, its descent and the window
//   steps live in splitter_tree.cuh, shared with merge_ranks.cu.  The
//   grid is sized to the card (SMs x resident blocks, from the occupancy
//   API, queried once per device and tree height); each block loads the
//   tree once and strides over the left keys.  When m fits the table (s =
//   0) the tree holds the whole right array and the whole search, the
//   upper bound included, runs in shared memory.
// - Lower bound: the descent counts the splitters below the key, which
//   narrows it to one aligned window of 2^s right keys (128 at m = 2^21);
//   s halving steps in device memory finish it.  The right key at the
//   lower bound is carried out of the search: the splitter of the descent's
//   last left turn, then the last probe that failed.
// - Upper bound by galloping from the lower bound: an empty run (the
//   carried key above the probe key) costs no load; otherwise probes at
//   lo+1, lo+3, lo+7, ... until a key is above the probe key or the array
//   ends, then halving steps over the last gap.  O(log run length) loads,
//   O(log m) when one run fills the array (the engine's INT64_MAX tail
//   pads).
// - One left key a thread.  Two or four keys a thread, their searches
//   interleaved and read with 16-byte loads, measured slower at every size
//   (PERF.md §6, tools/search_probe.py): the search is bound by the load
//   pipeline's throughput (each lane's probe is its own cache line) and
//   the tree's bank conflicts, not by the latency of one chain.
//
// The staged search is mirrored by `probe_staged` in
// src/repro_torch/kernels/mergejoin/mergejoin.py (test-only), which the
// CPU tests hold against torch.searchsorted and the Pallas kernel; the
// constants below are read by those tests.
//
// Plain C interface for ctypes: launches on the given stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "splitter_tree.cuh"

namespace {

constexpr int PROBE_THREADS = 1024;    // threads per block
constexpr int PROBE_TABLE_LOG2 = 14;   // most table entries, log2 (128 KB)

static_assert(PROBE_TABLE_LOG2 >= 0 &&
                  PROBE_TABLE_LOG2 <= splitter_tree::MAX_H,
              "the table fits one block's shared memory");

// Right key i: from the tree when it holds every key (s = 0), else from
// device memory.
__device__ __forceinline__ long long right_at(const long long* tab,
                                              const long long* right,
                                              bool in_smem, int h,
                                              int64_t i) {
  if (!in_smem) return __ldg(right + i);
  return tab[splitter_tree::slot_of(static_cast<int>(i), h)];
}

// The tree in device memory, for s > 0: one strided pass, so that every
// block of the probe then loads it with coalesced reads
__global__ void probe_gather(const long long* __restrict__ right, int s,
                             int table, int h, long long* __restrict__ tree) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < (1 << h)) tree[k] = splitter_tree::tree_slot(right, s, table, h, k);
}

// tree: probe_gather's output when s > 0 (null when s = 0: each block
// builds the tree from the right array, which it then holds whole)
__global__ void __launch_bounds__(PROBE_THREADS)
probe_splitters(const long long* __restrict__ left, int64_t n,
                const long long* __restrict__ right, int64_t m, int s,
                const long long* __restrict__ tree, int table, int h,
                int32_t* __restrict__ lo_out, int32_t* __restrict__ hi_out) {
  extern __shared__ long long tab[];
  splitter_tree::load_tree(tab, right, s, table, h, tree);
  const bool in_smem = s == 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const long long key = __ldg(left + i);

    // 1-2. the lower bound: the tree's descent, then halving steps in the
    // window; ub is the right key at the lower bound once known (the
    // first splitter at or above the key, then the last failed probe)
    long long ub = 0;
    const int c = splitter_tree::descend<false, true>(tab, table, h, key,
                                                      &ub);
    const int32_t lo =
        splitter_tree::window<false, true>(right, m, s, c, key, &ub);

    // 3. the upper bound by galloping from the lower bound, when the run
    // is not empty: a is the last position known to hold a key <= the
    // probe key; span doubles while probes succeed, then halves over the
    // last gap
    int32_t hi = lo;
    if (lo < m && ub == key) {
      int32_t a = lo;
      uint32_t span = 1;
      bool gal = true;
      while (span) {
        const int64_t p = static_cast<int64_t>(a) + span;
        const bool ok = p < m && right_at(tab, right, in_smem, h, p) <= key;
        if (ok) a = static_cast<int32_t>(p);
        span = (gal && ok) ? span << 1 : span >> 1;
        gal = gal && ok;
      }
      hi = a + 1;
    }
    lo_out[i] = lo;
    hi_out[i] = hi;
  }
}

splitter_tree::Occupancy g_occupancy;

}  // namespace

extern "C" {

// left: n int64 keys; right: m int64 keys sorted ascending; lo/hi: n
// int32; tree: scratch for the table's tree, 2^ceil(log2(table)) int64
// when m > 2^PROBE_TABLE_LOG2 (unused otherwise).
int probe_sorted_i64(const void* left, int64_t n, const void* right,
                     int64_t m, void* lo, void* hi, void* tree,
                     int64_t tree_len, void* stream) {
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const splitter_tree::Plan plan = splitter_tree::plan(m, PROBE_TABLE_LOG2);
  const int s = plan.s, table = plan.table, h = plan.h;
  if (s > 0 && tree_len < (int64_t(1) << h))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto r = static_cast<const long long*>(right);
  if (s > 0) {
    probe_gather<<<((1 << h) + 255) / 256, 256, 0, st>>>(
        r, s, table, h, static_cast<long long*>(tree));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int sms = 0, per_sm = 0;
  const cudaError_t err = splitter_tree::occupancy(
      g_occupancy, probe_splitters, PROBE_THREADS, h, &sms, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t blocks = (n + PROBE_THREADS - 1) / PROBE_THREADS;
  if (blocks > static_cast<int64_t>(sms) * per_sm)
    blocks = static_cast<int64_t>(sms) * per_sm;
  const size_t smem = table ? sizeof(long long) << h : 0;
  probe_splitters<<<static_cast<unsigned>(blocks), PROBE_THREADS, smem, st>>>(
      static_cast<const long long*>(left), n, r, m, s,
      s > 0 ? static_cast<const long long*>(tree) : nullptr, table, h,
      static_cast<int32_t*>(lo), static_cast<int32_t*>(hi));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
