// Sorted-run probe for Hopper (sm_90a).
//
// Replaces the TPU kernel `probe_sorted` (`_probe_kernel`) of
// src/repro/kernels/mergejoin/mergejoin.py: for every left key, the
// [lo, hi) run of equal keys in a sorted right array, as int32 bounds
// (searchsorted side="left" and side="right").
//
// The Pallas kernel holds the whole right array in VMEM for each launch
// (BlockSpec((m,))); a block here has at most 227 KB of shared memory, so
// the search runs over device memory.  Bound on this card: the inputs are
// read once and the bounds written once (8n + 8m + 8n bytes), but each
// binary search makes ~log2(m) dependent, scattered 8-byte loads, so the
// kernel is bound by memory latency rather than bandwidth.  Design: one
// thread per left key, both searches in the same thread; the top levels
// of every search land on the same few lines, which the 50 MB L2 keeps,
// so only the last levels go to device memory.  Caching the top levels in
// shared memory explicitly is later work.
//
// Plain C interface for ctypes: launches on the given stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void probe_kernel(const long long* __restrict__ left, int64_t n,
                             const long long* __restrict__ right, int64_t m,
                             int32_t* __restrict__ lo_out,
                             int32_t* __restrict__ hi_out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const long long key = left[t];
  int64_t lo = 0, hi = m;
  while (lo < hi) {  // first element >= key
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(right + mid) < key) lo = mid + 1; else hi = mid;
  }
  const int64_t first = lo;
  hi = m;
  while (lo < hi) {  // first element > key, starting from the lower bound
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(right + mid) <= key) lo = mid + 1; else hi = mid;
  }
  lo_out[t] = static_cast<int32_t>(first);
  hi_out[t] = static_cast<int32_t>(lo);
}

}  // namespace

extern "C" {

// left: n int64 keys; right: m int64 keys sorted ascending; lo/hi: n int32.
int probe_sorted_i64(const void* left, int64_t n, const void* right,
                     int64_t m, void* lo, void* hi, void* stream) {
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const unsigned blocks = static_cast<unsigned>((n + THREADS - 1) / THREADS);
  probe_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(left), n,
      static_cast<const long long*>(right), m, static_cast<int32_t*>(lo),
      static_cast<int32_t*>(hi));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
