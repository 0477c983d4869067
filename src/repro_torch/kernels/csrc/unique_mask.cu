// First-of-run mask over a sorted array, for Hopper (sm_90a).
//
// Replaces the TPU kernel `unique_mask_sorted` (`_unique_mask_kernel`) of
// src/repro/kernels/uniquefilter/uniquefilter.py: mask[i] is true iff
// i == 0 or x[i] != x[i-1] (paper §2.4, the SU neighbour compare).
//
// The Pallas kernel pads the array to a multiple of its block and reads
// the previous tile through a second BlockSpec (`prev_ref`) to compare a
// tile's first lane with its neighbour: grid steps there run in order on
// one core and a tile cannot see past its edge.  Here a thread's
// predecessor comes from the neighbouring lane, so there is no tile edge,
// no padding and no cross-block dependency; only lanes < n are read or
// written.
//
// Bound on this card: bytes.  Each int64 input is read once and each bool
// written once, 9n bytes at 3.35 TB/s (0.0056 ms at 2^21); there is one
// compare per element.  The first design (one element per thread, two
// 8-byte loads and a one-byte store each, a grid capped at 132 x 32
// blocks) reached 39 % of that bound (0.0144 ms at 2^21; PERF.md §6).
// Design:
//
// - UM_KEYS = 8 consecutive keys per thread, read with four 16-byte loads,
//   their 8 mask bytes written as one 8-byte store.  Both carry the
//   streaming (evict-first) hint: the keys are read once, and in L2 they
//   then give way before other lines (measured 3-4 % faster at 2^21, where
//   L2 held dirty lines; 16 keys a thread and 128-1024 threads a block
//   were no faster; PERF.md §6).
// - The key before a thread's first key comes from the neighbouring
//   lane's last key by __shfl_up_sync; lane 0 of each warp loads it
//   itself.
// - A contiguous int64 tensor may start 8 bytes past a 16-byte boundary
//   (x[1:] of an aligned one).  Then every thread's loads start one key
//   later (x[8g+1 .. 8g+8], aligned), the last two keys of the lane before
//   supply x[8g-1] and x[8g], and the mask stores stay where they are
//   (8g, aligned): the template parameter H is that one-key shift.
// - The keys past the last whole group (fewer than 8 + H) go to one more
//   thread, scalar.  The grid covers n / 8 threads in one wave, with no
//   grid-stride loop.
//
// Plain C interface for ctypes: launches on the given stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int UM_THREADS = 256;
constexpr int UM_KEYS = 8;  // four 16-byte loads, one 8-byte mask store

template <int H>
__global__ void __launch_bounds__(UM_THREADS)
unique_mask_vec(const long long* __restrict__ x, int64_t n, int64_t groups,
                uint8_t* __restrict__ mask) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool body = g < groups;
  long long w[UM_KEYS];  // x[8g + H .. 8g + H + 7]
  if (body) {
    const longlong2* p =
        reinterpret_cast<const longlong2*>(x + g * UM_KEYS + H);
#pragma unroll
    for (int q = 0; q < UM_KEYS / 2; ++q) {
      const longlong2 v = __ldcs(p + q);
      w[2 * q] = v.x;
      w[2 * q + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < UM_KEYS; ++j) w[j] = 0;
  }
  // e[j] = x[8g - 1 + j], j = 0..8: the lane before supplies the first
  // 1 + H of them (its last 1 + H keys), lane 0 reads them itself
  long long e[UM_KEYS + 1];
  e[H] = __shfl_up_sync(0xffffffffu, w[UM_KEYS - 1], 1);
  if (H) e[0] = __shfl_up_sync(0xffffffffu, w[UM_KEYS - 2], 1);
  if (lane == 0 && body) {
    if (g > 0) e[0] = __ldg(x + g * UM_KEYS - 1);
    if (H) e[1] = __ldg(x + g * UM_KEYS);
  }
#pragma unroll
  for (int j = 1 + H; j <= UM_KEYS; ++j) e[j] = w[j - 1 - H];
  if (body) {
    uint64_t bits = 0;
#pragma unroll
    for (int j = 0; j < UM_KEYS; ++j)
      bits |= static_cast<uint64_t>(e[j + 1] != e[j]) << (8 * j);
    if (g == 0) bits |= 1;  // key 0 has no predecessor
    __stcs(reinterpret_cast<unsigned long long*>(mask + g * UM_KEYS),
           static_cast<unsigned long long>(bits));
  } else if (g == groups) {  // the H .. 7 + H keys past the last group
#pragma unroll
    for (int j = 0; j < UM_KEYS + H; ++j) {
      const int64_t i = groups * UM_KEYS + j;
      if (i < n) mask[i] = (i == 0 || __ldg(x + i) != __ldg(x + i - 1));
    }
  }
}

}  // namespace

extern "C" {

// x: n sorted int64 keys, 8-byte aligned; mask: n bytes (a torch.bool
// tensor), 0 or 1, 8-byte aligned.
int unique_mask_i64(const void* x, int64_t n, void* mask, void* stream) {
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const auto xa = reinterpret_cast<uintptr_t>(x);
  if (xa % 8 != 0 || reinterpret_cast<uintptr_t>(mask) % 8 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int h = xa % 16 != 0 ? 1 : 0;
  const int64_t groups = (n - h) / UM_KEYS;
  const unsigned blocks =
      static_cast<unsigned>((groups + 1 + UM_THREADS - 1) / UM_THREADS);
  const auto kernel = h ? unique_mask_vec<1> : unique_mask_vec<0>;
  kernel<<<blocks, UM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(x), n, groups,
      static_cast<uint8_t*>(mask));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
