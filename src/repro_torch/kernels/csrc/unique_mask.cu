// First-of-run mask over a sorted array, for Hopper (sm_90a).
//
// Replaces the TPU kernel `unique_mask_sorted` (`_unique_mask_kernel`) of
// src/repro/kernels/uniquefilter/uniquefilter.py: mask[i] is true iff
// i == 0 or x[i] != x[i-1] (paper §2.4, the SU neighbour compare).
//
// The Pallas kernel pads the array to a multiple of its block and reads
// the previous tile through a second BlockSpec (`prev_ref`) to compare a
// tile's first lane with its neighbour: grid steps there run in order on
// one core and a tile cannot see past its edge.  Here every thread loads
// its own element and its predecessor straight from device memory, so
// there is no tile edge, no padding and no cross-block dependency; only
// lanes < n are read or written.
//
// Bound on this card: bytes.  Each int64 input is read once (the
// predecessor load hits the line its neighbour thread just brought into
// L1/L2) and each bool written once, 9n bytes at 3.35 TB/s; there is one
// compare per element.  Design: one thread per element in a grid-stride
// loop, consecutive threads on consecutive addresses, so both loads and
// the byte store coalesce.  Wider per-thread vectors are later work.
//
// Plain C interface for ctypes: launches on the given stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int64_t MAX_BLOCKS = 132 * 32;  // 32 resident blocks per SM

__global__ void unique_mask_kernel(const long long* __restrict__ x, int64_t n,
                                   uint8_t* __restrict__ mask) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const bool first = (i == 0) || (__ldg(x + i) != __ldg(x + i - 1));
    mask[i] = first ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// x: n sorted int64 keys; mask: n bytes (a torch.bool tensor), 0 or 1.
int unique_mask_i64(const void* x, int64_t n, void* mask, void* stream) {
  if (n == 0) return static_cast<int>(cudaGetLastError());
  int64_t blocks = (n + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  unique_mask_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(x), n, static_cast<uint8_t*>(mask));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
