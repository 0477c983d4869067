// Two-run merge ranks for Hopper (sm_90a).
//
// Replaces the TPU kernel `merge_ranks` (`_rank_kernel`) of
// src/repro/kernels/sortmerge/sortmerge.py: for every element of x (in
// any order), its rank in a sorted run `other` -- the count of strictly
// smaller elements (side left) or of elements at or below it (side
// right), i.e. searchsorted.  Two launches (a's ranks in b, side left;
// b's ranks in a, side right) give every element of two sorted runs its
// position in their stable merge, which is how an appended tail is merged
// into a resident sorted index mirror instead of re-sorting the column.
//
// The Pallas kernel holds the whole other run in VMEM for each launch
// (BlockSpec((m,))); a block here has at most 227 KB of shared memory.
// Bound on this card: x is read once and the ranks written once (8n + 8m
// + 4n bytes; 0.0075 ms for both launches of the engine's largest merge,
// a 2^21-lane run against a 2^13-lane delta).
//
// What held the first design back (one thread per key, a full binary
// search of ~log2(m) dependent 8-byte loads over device memory, nothing
// in shared memory; 0.0447 ms for that pair against 0.0539 for two
// torch.searchsorted calls; PERF.md §6).  The design now is the probe's
// (probe_sorted.cu), through the splitter tree of splitter_tree.cuh:
//
// - When `other` fits the tree (m <= 2^RANK_TABLE_LOG2, the engine's
//   deltas), each block builds the whole of it in shared memory and every
//   search runs there: the launch that ranks the 2^21-lane run streams its
//   keys in and its ranks out.
// - When `other` is larger, the tree holds every 2^s-th key, and s
//   halving steps in device memory finish each search.  For many keys a
//   pre-kernel (`rank_gather`) writes the tree to scratch once so that
//   each block copies it coalesced; for few keys (the delta ranked into
//   the run) each block loads its small tree's slots itself, in one
//   launch.  Only the side's one bound is searched: no gallop.
// - The tree's size and the block's follow n: at most
//   2^RANK_SMALL_TABLE_LOG2 slots and RANK_SMALL_THREADS threads when n <=
//   2^RANK_SMALL_N_LOG2, where a large tree in every block costs more than
//   the few searches it serves and large blocks leave most SMs idle
//   (tools/search_probe.py --kernel merge_ranks measures the choice).
// - The grid is sized to the card (SMs x resident blocks, from the
//   occupancy API); each block loads the tree once and strides over the
//   keys, one key a thread at a time, the next one's load in flight.  Two
//   or four keys a thread, read as 16-byte vectors, measured slower
//   (PERF.md §6).  The side is a template parameter.
//
// The plan is mirrored by `merge_ranks_plan` and the search by
// `merge_ranks_staged` in src/repro_torch/kernels/mergejoin/mergejoin.py
// (test-only), which the CPU tests hold against torch.searchsorted and
// the Pallas kernel; the constants below are read by those tests.
//
// Plain C interface for ctypes: launches on the given stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "splitter_tree.cuh"

namespace {

constexpr int RANK_THREADS = 1024;        // threads per block
constexpr int RANK_TABLE_LOG2 = 14;       // most tree slots, log2 (128 KB)
constexpr int RANK_SMALL_N_LOG2 = 13;     // n at or below 2^this ...
constexpr int RANK_SMALL_TABLE_LOG2 = 8;   // ... takes at most 2^this slots,
constexpr int RANK_SMALL_THREADS = 256;   // ... blocks of this many, and
                                          // no gather pass: each block
                                          // loads its tree's slots itself

static_assert(RANK_TABLE_LOG2 >= 0 &&
                  RANK_TABLE_LOG2 <= splitter_tree::MAX_H &&
                  RANK_SMALL_TABLE_LOG2 >= 0 &&
                  RANK_SMALL_TABLE_LOG2 <= splitter_tree::MAX_H,
              "the tree fits one block's shared memory");
static_assert(RANK_SMALL_THREADS % 32 == 0 &&
                  RANK_SMALL_THREADS <= RANK_THREADS,
              "small blocks are whole warps within the launch bound");

// The tree in device memory, for s > 0: one strided pass, so that every
// block then loads it with coalesced reads
__global__ void rank_gather(const long long* __restrict__ other, int s,
                            int table, int h, long long* __restrict__ tree) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < (1 << h)) tree[k] = splitter_tree::tree_slot(other, s, table, h, k);
}

// tree: rank_gather's output (null when s = 0, where each block builds
// the tree from `other`, which it then holds whole, and for few keys,
// where each block loads its tree's slots itself).  A thread's first key
// is in flight while the tree loads, and its next key while it searches
// the current one.
template <bool RIGHT>
__global__ void __launch_bounds__(RANK_THREADS)
rank_splitters(const long long* __restrict__ x, int64_t n,
               const long long* __restrict__ other, int64_t m, int s,
               const long long* __restrict__ tree, int table, int h,
               int32_t* __restrict__ ranks) {
  extern __shared__ long long tab[];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long key = i < n ? __ldg(x + i) : 0;
  splitter_tree::load_tree(tab, other, s, table, h, tree);
  for (; i < n; i += stride) {
    const long long next = i + stride < n ? __ldg(x + i + stride) : 0;
    const int c =
        splitter_tree::descend<RIGHT, false>(tab, table, h, key, nullptr);
    ranks[i] =
        splitter_tree::window<RIGHT, false>(other, m, s, c, key, nullptr);
    key = next;
  }
}

splitter_tree::Occupancy g_occupancy[2];

template <bool RIGHT>
cudaError_t launch(const long long* x, int64_t n, const long long* other,
                   int64_t m, const splitter_tree::Plan& p,
                   const long long* tree, int32_t* ranks, cudaStream_t st) {
  int sms = 0, per_sm = 0;
  cudaError_t err = splitter_tree::occupancy(
      g_occupancy[RIGHT], rank_splitters<RIGHT>, RANK_THREADS, p.h, &sms,
      &per_sm);
  if (err != cudaSuccess) return err;
  // few keys: smaller blocks, on more SMs (the occupancy is the large
  // blocks', scaled)
  const int threads = n <= (int64_t(1) << RANK_SMALL_N_LOG2)
                          ? RANK_SMALL_THREADS
                          : RANK_THREADS;
  const int64_t most = static_cast<int64_t>(sms) * per_sm *
                       (RANK_THREADS / threads);
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > most) blocks = most;
  const size_t smem = p.table ? sizeof(long long) << p.h : 0;
  rank_splitters<RIGHT><<<static_cast<unsigned>(blocks), threads, smem,
                          st>>>(x, n, other, m, p.s, tree, p.table, p.h,
                                ranks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: n int64 keys; other: m int64 keys sorted ascending; ranks: n int32.
// side_right != 0 counts elements <= key, else elements < key.  tree:
// scratch for the tree, 2^ceil(log2(table)) int64 when the plan's s > 0
// and n > 2^RANK_SMALL_N_LOG2 (unused otherwise).
int merge_ranks_i64(const void* x, int64_t n, const void* other, int64_t m,
                    int64_t side_right, void* ranks, void* tree,
                    int64_t tree_len, void* stream) {
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const bool small = n <= (int64_t(1) << RANK_SMALL_N_LOG2);
  const splitter_tree::Plan p = splitter_tree::plan(
      m, small ? RANK_SMALL_TABLE_LOG2 : RANK_TABLE_LOG2);
  const bool gather = p.s > 0 && !small;
  if (gather && tree_len < (int64_t(1) << p.h))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto os = static_cast<const long long*>(other);
  if (gather) {
    rank_gather<<<((1 << p.h) + 255) / 256, 256, 0, st>>>(
        os, p.s, p.table, p.h, static_cast<long long*>(tree));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const auto xs = static_cast<const long long*>(x);
  const auto tr = gather ? static_cast<const long long*>(tree) : nullptr;
  const auto rs = static_cast<int32_t*>(ranks);
  return static_cast<int>(
      side_right ? launch<true>(xs, n, os, m, p, tr, rs, st)
                 : launch<false>(xs, n, os, m, p, tr, rs, st));
}

}  // extern "C"
