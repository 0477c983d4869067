// Bitonic sort and key-value bitonic sort for Hopper (sm_90a).
//
// Replaces the TPU kernels `bitonic_sort` (`_intra_kernel`, `_cross_kernel`)
// and `bitonic_sort_kv` (`_intra_kernel_kv`, `_cross_kernel_kv`) of
// src/repro/kernels/sortmerge/sortmerge.py.
//
// Network: the same XOR-partner bitonic network and the same (k, j) launch
// sequence as `_launch_plan` there — element i exchanges with i ^ j,
// ascending iff (i & k) == 0, and a pair swaps only on a strict order
// violation.  The caller pads to a power of two with the dtype's maximum, so
// the output (the key-value payload included, ties too) is bit-identical to
// the Pallas kernel and to the plain PyTorch version whatever the tile size.
//
// Bound on this card: memory.  A sort of n int64 keys has to read and write
// 16n bytes at least; this network instead streams the array through device
// memory once for every pass with j >= TILE, which is ~log2(n / TILE)^2 / 2
// passes.  Design: every run of passes with j < TILE happens inside one
// shared-memory tile (TILE = 4096 elements: 32 KB of int64 keys, 48 KB with
// the int32 payload), so the number of device-memory round trips falls from
// log2(n)^2 / 2 to one per cross-tile pass plus one per tile stage; each
// cross-tile pass is one compare-exchange per thread with coalesced loads of
// both partners.  Making it fast (register-resident sub-networks, radix
// sort) is later work.
//
// Plain C interface for ctypes: every entry point sorts a device buffer in
// place, launches on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int64_t TILE = 4096;
constexpr int TILE_THREADS = 1024;
constexpr int CROSS_THREADS = 256;

template <typename K>
__device__ __forceinline__ bool needs_swap(K a, K b, bool asc) {
  return asc ? (a > b) : (a < b);
}

// All passes (k, j) with j < tile of one stage on a shared-memory tile.
// k_outer == 0: the initial full sort of each tile (k = 2 .. tile);
// otherwise the tail of stage k_outer (j = tile / 2 .. 1).
template <typename K, bool KV>
__global__ void tile_passes(K* __restrict__ keys, int32_t* __restrict__ vals,
                            int64_t tile, int64_t k_outer) {
  extern __shared__ unsigned char smem_raw[];
  K* sk = reinterpret_cast<K*>(smem_raw);
  int32_t* sv = reinterpret_cast<int32_t*>(smem_raw + tile * sizeof(K));
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
  for (int64_t t = threadIdx.x; t < tile; t += blockDim.x) {
    sk[t] = keys[base + t];
    if (KV) sv[t] = vals[base + t];
  }
  __syncthreads();
  const int64_t half = tile >> 1;
  int64_t k = k_outer ? k_outer : 2;
  const int64_t k_last = k_outer ? k_outer : tile;
  for (; k <= k_last; k <<= 1) {
    for (int64_t j = (k_outer ? half : (k >> 1)); j >= 1; j >>= 1) {
      for (int64_t p = threadIdx.x; p < half; p += blockDim.x) {
        const int64_t i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int64_t q = i | j;
        const bool asc = ((base + i) & k) == 0;
        const K a = sk[i];
        const K b = sk[q];
        if (needs_swap(a, b, asc)) {
          sk[i] = b;
          sk[q] = a;
          if (KV) {
            const int32_t va = sv[i];
            sv[i] = sv[q];
            sv[q] = va;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int64_t t = threadIdx.x; t < tile; t += blockDim.x) {
    keys[base + t] = sk[t];
    if (KV) vals[base + t] = sv[t];
  }
}

// One pass (k, j) with j >= tile through device memory: one
// compare-exchange per thread; neighbouring threads touch neighbouring
// addresses on both sides of the pair.
template <typename K, bool KV>
__global__ void cross_pass(K* __restrict__ keys, int32_t* __restrict__ vals,
                           int64_t n, int64_t k, int64_t j) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= (n >> 1)) return;
  const int64_t i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
  const int64_t q = i | j;
  const bool asc = (i & k) == 0;
  const K a = keys[i];
  const K b = keys[q];
  if (needs_swap(a, b, asc)) {
    keys[i] = b;
    keys[q] = a;
    if (KV) {
      const int32_t va = vals[i];
      vals[i] = vals[q];
      vals[q] = va;
    }
  }
}

template <typename K, bool KV>
int run_network(K* keys, int32_t* vals, int64_t n, cudaStream_t stream) {
  if (n < 2) return static_cast<int>(cudaGetLastError());
  const int64_t tile = n < TILE ? n : TILE;
  const int threads = static_cast<int>(tile / 2 < TILE_THREADS ? tile / 2
                                                                : TILE_THREADS);
  const size_t smem = tile * (sizeof(K) + (KV ? sizeof(int32_t) : 0));
  const unsigned tiles = static_cast<unsigned>(n / tile);
  const unsigned cross_blocks =
      static_cast<unsigned>((n / 2 + CROSS_THREADS - 1) / CROSS_THREADS);
  cudaError_t err;
  tile_passes<K, KV><<<tiles, threads, smem, stream>>>(keys, vals, tile, 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  for (int64_t k = tile * 2; k <= n; k <<= 1) {
    for (int64_t j = k >> 1; j >= tile; j >>= 1) {
      cross_pass<K, KV><<<cross_blocks, CROSS_THREADS, 0, stream>>>(
          keys, vals, n, k, j);
      if ((err = cudaGetLastError()) != cudaSuccess)
        return static_cast<int>(err);
    }
    tile_passes<K, KV><<<tiles, threads, smem, stream>>>(keys, vals, tile, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// n must be a power of two; the buffers hold exactly n elements.
int bitonic_sort_i64(void* keys, int64_t n, void* stream) {
  return run_network<long long, false>(static_cast<long long*>(keys), nullptr,
                                       n, static_cast<cudaStream_t>(stream));
}

int bitonic_sort_i32(void* keys, int64_t n, void* stream) {
  return run_network<int32_t, false>(static_cast<int32_t*>(keys), nullptr, n,
                                     static_cast<cudaStream_t>(stream));
}

int bitonic_sort_kv_i64(void* keys, void* vals, int64_t n, void* stream) {
  return run_network<long long, true>(static_cast<long long*>(keys),
                                      static_cast<int32_t*>(vals), n,
                                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
