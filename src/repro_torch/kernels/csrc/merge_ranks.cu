// Two-run merge ranks for Hopper (sm_90a).
//
// Replaces the TPU kernel `merge_ranks` (`_rank_kernel`) of
// src/repro/kernels/sortmerge/sortmerge.py: for every element of x, its
// rank in a second sorted run -- the count of strictly smaller elements
// (side left) or of elements at or below it (side right), i.e.
// searchsorted.  Two launches (a's ranks in b, side left; b's ranks in a,
// side right) give every element of two sorted runs its position in their
// stable merge, which is how an appended tail is merged into a resident
// sorted index mirror instead of re-sorting the column.
//
// The Pallas kernel holds the whole other run in VMEM for each launch
// (BlockSpec((m,))); a block here has at most 227 KB of shared memory, so
// the search runs over device memory.  Bound on this card: x is read once
// and the ranks written once (8n + 8m + 4n bytes), but each search makes
// ~log2(m) dependent, scattered 8-byte loads, so the kernel is bound by
// memory latency rather than bandwidth.  Design: one thread per element
// of x and one search per thread; the top levels of every search land on
// the same few lines, which the 50 MB L2 keeps.  The side is a template
// parameter, so the inner loop has no branch on it.
//
// Plain C interface for ctypes: launches on the given stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <bool SIDE_RIGHT>
__global__ void rank_kernel(const long long* __restrict__ x, int64_t n,
                            const long long* __restrict__ other, int64_t m,
                            int32_t* __restrict__ ranks) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const long long key = x[t];
  int64_t lo = 0, hi = m;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    const long long v = __ldg(other + mid);
    const bool go_right = SIDE_RIGHT ? (v <= key) : (v < key);
    if (go_right) lo = mid + 1; else hi = mid;
  }
  ranks[t] = static_cast<int32_t>(lo);
}

}  // namespace

extern "C" {

// x: n int64 keys; other: m int64 keys sorted ascending; ranks: n int32.
// side_right != 0 counts elements <= key, else elements < key.
int merge_ranks_i64(const void* x, int64_t n, const void* other, int64_t m,
                    int64_t side_right, void* ranks, void* stream) {
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const unsigned blocks = static_cast<unsigned>((n + THREADS - 1) / THREADS);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto xs = static_cast<const long long*>(x);
  const auto os = static_cast<const long long*>(other);
  const auto rs = static_cast<int32_t*>(ranks);
  if (side_right)
    rank_kernel<true><<<blocks, THREADS, 0, s>>>(xs, n, os, m, rs);
  else
    rank_kernel<false><<<blocks, THREADS, 0, s>>>(xs, n, os, m, rs);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
