// Bitonic sort and key-value bitonic sort for Hopper (sm_90a).
//
// Replaces the TPU kernels `bitonic_sort` (src/repro/kernels/sortmerge/
// sortmerge.py:218; `_intra_kernel`, `_cross_kernel`) and `bitonic_sort_kv`
// (:252; `_intra_kernel_kv`, `_cross_kernel_kv`).
//
// Network: the XOR-partner bitonic network of `_passes` in
// src/repro_torch/kernels/sortmerge/sortmerge.py — element i exchanges with
// i ^ j for every pass (k, j) in order, ascending iff (i & k) == 0, and a
// pair swaps only on a strict order violation.  The caller pads to a power
// of two with the dtype's maximum.  The kernel below regroups the passes
// into launches, registers, warps and shared memory, but it runs the same
// compare-exchanges in the same order, so its output (the payload order of
// tied keys included) is bit-identical to the Pallas kernel and to the
// plain PyTorch version.  The grouping is mirrored by `launch_plan` in
// sortmerge.py, which the CPU tests hold against `_passes`; keep the two in
// step (the constants below are read by those tests).
//
// Bound on this card: bytes.  A sort has to read and write its array once:
// 16n bytes for n int64 keys, 24n with the int32 payload (0.010 ms at
// 2^21 keys, 0.0075 ms at 2^20 key-value pairs, at 3.35 TB/s).
//
// What held the first design back (4096-element tiles, one launch per
// cross-tile pass; tools/sort_probe.py with torch.profiler on an H100;
// PERF.md §6): at 2^21 int64 keys one call was 55 launches, 0.71
// ms — the first tile launch 0.165 ms, 45 cross-tile passes 0.22 ms (each
// streamed the whole array for one compare-exchange per thread), 9 later
// tile launches 0.26 ms (every level through shared memory, a barrier
// after each, 64-bit index math); at 2^20 key-value pairs 45 launches,
// 0.47 ms.  What the design does about it:
//
// - A larger tile (up to 2^14 elements in dynamic shared memory, past the
//   48 KB default): every doubling removes one cross-tile level from
//   every later stage, and n <= tile is one launch.  The tile is picked
//   by size: the largest of the tiers below that the array holds
//   SORT_MIN_TILES times, so that mid-sized arrays still fill the card.
// - In a tile, each thread holds E consecutive elements in registers.
//   Levels j < E run in registers, levels E <= j < 32E through
//   __shfl_xor_sync (the partner lives in lane ^ j/E), and only larger j
//   go through shared memory, up to four levels per barrier: each thread
//   loads the 2^r elements of a sub-network (stride j / 2^(r-1)), applies
//   r levels in registers and stores once.  Shared memory holds a pad
//   slot after every E elements, so the per-thread row transfers and the
//   strided sub-network accesses are free of bank conflicts.  Index math
//   inside a tile is 32-bit.  A thread that keeps a pair's minimum takes
//   one 64-bit comparison (two for the payload's strict order).  The
//   tail of a stage reads its tile with the first group's loads, so no
//   barrier separates the loads from the levels.
// - Cross-tile passes are fused: one launch applies up to SORT_FUSE
//   consecutive levels to sub-networks of 2^r elements held in registers,
//   each thread loading its sub-network once (neighbouring threads on
//   neighbouring addresses) and storing it once; on arrays of 2^20 and
//   more, a stage's remaining cross levels (up to SORT_CROSS_LEVELS) run
//   in one launch over shared-memory blocks of 2^r rows.
// - A register layout that transposes through shared memory in place of
//   the warp levels, and a 2^14 tile for the key-value sort (1024
//   threads, so 64 registers a thread), were tried on the card; both
//   spilled and were slower.

// Plain C interface for ctypes: every entry point sorts a device buffer in
// place, launches on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Tile and register width of the keys-only sort and of the key-value sort
// on large arrays, and the cross-tile levels fused per launch.  A sort of
// n elements takes this top tier when n holds SORT_MIN_TILES of its tiles
// (the card needs about that many blocks in flight); otherwise the first
// smaller tier of LOWER_TIERS that n fills as well, or the last one.
// Mirrored in sortmerge.py, as are SMEM_LEVELS and the cross_smem block
// (XS_THREADS << XS_REG_LOG2 elements); the CPU tests parse these lines.
constexpr int SORT_TILE_LOG2 = 14;
constexpr int SORT_REG_LOG2 = 5;
constexpr int SORT_KV_TILE_LOG2 = 13;
constexpr int SORT_KV_REG_LOG2 = 4;
constexpr int SORT_FUSE = 4;
constexpr int SORT_MIN_TILES = 128;
// Cross-tile levels one launch runs at most: up to SORT_FUSE of them in
// registers, more through a shared-memory block of rows (cross_smem).  The
// latter needs SORT_MIN_TILES such blocks to fill the card: smaller arrays
// keep to SORT_FUSE levels per launch.
constexpr int SORT_CROSS_LEVELS = 9;
// (tile log2, register width log2) below the top tier, largest first
constexpr int LOWER_TIERS[][2] = {{13, 4}, {12, 4}, {10, 3}};
constexpr int N_LOWER = sizeof(LOWER_TIERS) / sizeof(LOWER_TIERS[0]);
constexpr int SMEM_LEVELS = 4;  // shared-memory levels per barrier, at most
constexpr int XS_THREADS = 512;  // cross_smem's block
constexpr int XS_REG_LOG2 = 4;   // ... and the elements of each thread
constexpr int CROSS_THREADS = 256;

template <typename K>
__device__ __forceinline__ K key_max();
template <>
__device__ __forceinline__ long long key_max<long long>() {
  return 0x7fffffffffffffffLL;
}
template <>
__device__ __forceinline__ int32_t key_max<int32_t>() {
  return 0x7fffffff;
}

// The network's compare-exchange of a lower element a and an upper
// element b: swap on a strict violation of the pair's direction.  Without
// a payload a swap of equal keys changes nothing, so one comparison does.
template <typename K, bool KV>
__device__ __forceinline__ void cmpx(K& a, K& b, int32_t& va, int32_t& vb,
                                     bool asc) {
  const bool sw = KV ? (asc ? (b < a) : (a < b)) : ((b < a) == asc);
  const K ta = a;
  a = sw ? b : a;
  b = sw ? ta : b;
  if (KV) {
    const int32_t tv = va;
    va = sw ? vb : va;
    vb = sw ? tv : vb;
  }
}

// Levels h = M/2, ..., 1 of a sub-network of M = 2^R elements held in
// registers (element m pairs with m | h); one direction for all of them.
template <int R, typename K, bool KV>
__device__ __forceinline__ void subnet(K (&x)[1 << R], int32_t (&v)[1 << R],
                                       bool asc) {
  constexpr int M = 1 << R;
#pragma unroll
  for (int h = M >> 1; h >= 1; h >>= 1) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (m & h) continue;
      cmpx<K, KV>(x[m], x[m | h], v[m], v[m | h], asc);
    }
  }
}

// Shared-memory slot of tile element i: one pad slot after every 2^E_LOG2.
template <int E_LOG2>
__device__ __forceinline__ uint32_t slot(uint32_t i) {
  return i + (i >> E_LOG2);
}

// R consecutive levels j, j/2, ..., j/2^(R-1) of the tile in shared memory.
// Sub-network q has its elements at base + m*s, s = j / 2^(R-1); the
// direction of element i is (i & k) == 0, which is `basc` for k >= tile
// and (base & kk) == 0 below it (kk = k then), the same for all m.  The
// tile holds blockDim.x * 2^E_LOG2 elements, so each thread takes
// 2^(E_LOG2 - R) sub-networks.  With FROM_GLOBAL the elements are read
// from the tile at gbase in device memory (a whole tile, no padding)
// instead of shared memory: neighbouring threads read neighbouring
// addresses, and no barrier separates the loads from the levels.
template <int R, int E_LOG2, typename K, bool KV, bool FROM_GLOBAL = false>
__device__ __forceinline__ void smem_levels(K* sk, int32_t* sv, uint32_t j,
                                            bool basc, uint32_t kk,
                                            const K* gk = nullptr,
                                            const int32_t* gv = nullptr,
                                            int64_t gbase = 0) {
  constexpr int M = 1 << R;
  const uint32_t s = j >> (R - 1);
  // s is a multiple of 2^E_LOG2, so the slots step by s + s / 2^E_LOG2
  const uint32_t step = s + (s >> E_LOG2);
#pragma unroll
  for (int c = 0; c < (1 << (E_LOG2 - R)); ++c) {
    const uint32_t q = threadIdx.x + c * blockDim.x;
    const uint32_t base = ((q & ~(s - 1)) << R) | (q & (s - 1));
    const uint32_t p0 = slot<E_LOG2>(base);
    const bool asc = basc && !(base & kk);
    K x[M];
    int32_t v[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (FROM_GLOBAL) {
        x[m] = gk[gbase + base + m * s];
        if (KV) v[m] = gv[gbase + base + m * s];
      } else {
        x[m] = sk[p0 + m * step];
        if (KV) v[m] = sv[p0 + m * step];
      }
    }
    subnet<R, K, KV>(x, v, asc);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      sk[p0 + m * step] = x[m];
      if (KV) sv[p0 + m * step] = v[m];
    }
  }
}

// Global <-> shared copies of one tile of blockDim.x * 2^E_LOG2 elements:
// 16-byte loads and stores, lanes on neighbouring addresses.  Elements at
// or past n (a single tile padded to a full warp's width) read as `pad`
// and are not written back.
template <int E_LOG2, typename T>
__device__ __forceinline__ void tile_load(const T* __restrict__ g, T* s,
                                          int64_t gbase, int64_t n, T pad) {
  constexpr uint32_t V = 16 / sizeof(T);
#pragma unroll
  for (uint32_t w = 0; w < (1u << E_LOG2) / V; ++w) {
    const uint32_t c = (threadIdx.x + w * blockDim.x) * V;
    alignas(16) T e[V];
    if (gbase + c + V <= n) {
      *reinterpret_cast<uint4*>(e) =
          *reinterpret_cast<const uint4*>(g + gbase + c);
    } else {
#pragma unroll
      for (uint32_t u = 0; u < V; ++u)
        e[u] = gbase + c + u < n ? g[gbase + c + u] : pad;
    }
#pragma unroll
    for (uint32_t u = 0; u < V; ++u) s[slot<E_LOG2>(c + u)] = e[u];
  }
}

template <int E_LOG2, typename T>
__device__ __forceinline__ void tile_store(T* __restrict__ g, const T* s,
                                           int64_t gbase, int64_t n) {
  constexpr uint32_t V = 16 / sizeof(T);
#pragma unroll
  for (uint32_t w = 0; w < (1u << E_LOG2) / V; ++w) {
    const uint32_t c = (threadIdx.x + w * blockDim.x) * V;
    alignas(16) T e[V];
#pragma unroll
    for (uint32_t u = 0; u < V; ++u) e[u] = s[slot<E_LOG2>(c + u)];
    if (gbase + c + V <= n) {
      *reinterpret_cast<uint4*>(g + gbase + c) =
          *reinterpret_cast<const uint4*>(e);
    } else {
#pragma unroll
      for (uint32_t u = 0; u < V; ++u)
        if (gbase + c + u < n) g[gbase + c + u] = e[u];
    }
  }
}

// Stages k = k_lo .. k_hi of the network on tiles of `tile` elements, each
// stage from j = min(k, tile) / 2 down to 1.  k_lo = 2 is the initial sort
// of every tile; k_lo = k_hi > tile is the tail of stage k after its
// cross-tile levels.  The block has tile / E threads; thread t holds
// elements t*E .. t*E + E - 1 while it works in registers and shuffles.
template <typename K, bool KV, int T_LOG2, int E_LOG2>
__global__ void __launch_bounds__(1 << (T_LOG2 - E_LOG2))
    tile_network(K* __restrict__ keys, int32_t* __restrict__ vals, int64_t n,
                 uint32_t tile, int64_t k_lo, int64_t k_hi) {
  constexpr int E = 1 << E_LOG2;
  constexpr uint32_t WARP_SPAN = 32u << E_LOG2;  // j below: in one warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  K* sk = reinterpret_cast<K*>(smem_raw);
  int32_t* sv = reinterpret_cast<int32_t*>(
      smem_raw + (tile + (tile >> E_LOG2)) * sizeof(K));
  const int64_t gbase = static_cast<int64_t>(blockIdx.x) * tile;
  constexpr int RMAX = E_LOG2 < SMEM_LEVELS ? E_LOG2 : SMEM_LEVELS;
  // the tail of a stage (k_lo > tile) reads its tile with the first
  // shared-memory group's loads; the initial sort loads it whole
  uint32_t j_tail = tile >> 1;
  if (k_lo > static_cast<int64_t>(tile) && j_tail >= WARP_SPAN) {
    const int avail = __ffs(static_cast<int>(j_tail)) -
                      __ffs(static_cast<int>(WARP_SPAN)) + 1;
    const int r = avail < RMAX ? avail : RMAX;
    const bool basc = (gbase & k_lo) == 0;
    if (r == 1) {
      smem_levels<1, E_LOG2, K, KV, true>(sk, sv, j_tail, basc, 0u, keys,
                                          vals, gbase);
    } else if (r == 2) {
      smem_levels<2, E_LOG2, K, KV, true>(sk, sv, j_tail, basc, 0u, keys,
                                          vals, gbase);
    } else if (r == 3) {
      if constexpr (RMAX >= 3)
        smem_levels<3, E_LOG2, K, KV, true>(sk, sv, j_tail, basc, 0u, keys,
                                            vals, gbase);
    } else {
      if constexpr (RMAX >= 4)
        smem_levels<4, E_LOG2, K, KV, true>(sk, sv, j_tail, basc, 0u, keys,
                                            vals, gbase);
    }
    j_tail >>= r;
  } else {
    tile_load<E_LOG2>(keys, sk, gbase, n, key_max<K>());
    if (KV) tile_load<E_LOG2>(vals, sv, gbase, n, int32_t(0));
  }
  __syncthreads();

  const uint32_t t = threadIdx.x;
  const uint32_t lane = t & 31;
  const uint32_t mine = t << E_LOG2;  // tile index of this thread's row
  const uint32_t row = t * (E + 1);   // its first shared-memory slot
  K x[E];
  int32_t v[E];
  for (int64_t k = k_lo; k <= k_hi; k <<= 1) {
    const bool big = k >= static_cast<int64_t>(tile);
    const bool basc = big ? (gbase & k) == 0 : true;
    const uint32_t kk = big ? 0u : static_cast<uint32_t>(k);
    uint32_t j = k == k_lo && k_lo > static_cast<int64_t>(tile)
                     ? j_tail
                     : static_cast<uint32_t>(big ? tile >> 1 : k >> 1);
    if (j >= WARP_SPAN) {
      // shared-memory levels, up to SMEM_LEVELS of them per barrier; the
      // rows go back to shared memory first (the first stage finds them
      // there already)
      if (k != k_lo) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          sk[row + e] = x[e];
          if (KV) sv[row + e] = v[e];
        }
        __syncthreads();
      }
      do {
        const int avail = __ffs(static_cast<int>(j)) -
                          __ffs(static_cast<int>(WARP_SPAN)) + 1;
        const int r = avail < RMAX ? avail : RMAX;
        if (r == 1) {
          smem_levels<1, E_LOG2, K, KV>(sk, sv, j, basc, kk);
        } else if (r == 2) {
          smem_levels<2, E_LOG2, K, KV>(sk, sv, j, basc, kk);
        } else if (r == 3) {
          if constexpr (RMAX >= 3)
            smem_levels<3, E_LOG2, K, KV>(sk, sv, j, basc, kk);
        } else {
          if constexpr (RMAX >= 4)
            smem_levels<4, E_LOG2, K, KV>(sk, sv, j, basc, kk);
        }
        __syncthreads();
        j >>= r;
      } while (j >= WARP_SPAN);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        x[e] = sk[row + e];
        if (KV) v[e] = sv[row + e];
      }
    } else if (k == k_lo) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        x[e] = sk[row + e];
        if (KV) v[e] = sv[row + e];
      }
    }
    // warp levels: the partner of element mine + e is the same register of
    // lane ^ (j / E).  This lane keeps the pair's minimum iff it is the
    // lower lane of an ascending pair or the upper lane of a descending one
    for (; j >= E; j >>= 1) {
      const uint32_t lm = j >> E_LOG2;
      const bool keep_min = !(lane & lm) == (basc && !(mine & kk));
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const K o = __shfl_xor_sync(0xffffffffu, x[e], lm);
        if (KV) {
          const int32_t ov = __shfl_xor_sync(0xffffffffu, v[e], lm);
          const bool sw = keep_min ? (o < x[e]) : (x[e] < o);
          x[e] = sw ? o : x[e];
          v[e] = sw ? ov : v[e];
        } else {
          x[e] = ((o < x[e]) == keep_min) ? o : x[e];
        }
      }
    }
    // register levels j < E
#pragma unroll
    for (int h = E >> 1; h >= 1; h >>= 1) {
      if (static_cast<uint32_t>(h) > j) continue;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (e & h) continue;
        cmpx<K, KV>(x[e], x[e | h], v[e], v[e | h],
                    basc && !((mine + e) & kk));
      }
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    sk[row + e] = x[e];
    if (KV) sv[row + e] = v[e];
  }
  __syncthreads();
  tile_store<E_LOG2>(keys, sk, gbase, n);
  if (KV) tile_store<E_LOG2>(vals, sv, gbase, n);
}

// R consecutive cross-tile levels j, ..., j / 2^(R-1) of stage k through
// device memory: one sub-network of 2^R elements per thread, loaded once
// and stored once.
template <int R, typename K, bool KV>
__global__ void __launch_bounds__(CROSS_THREADS)
    cross_fused(K* __restrict__ keys, int32_t* __restrict__ vals, int64_t n,
                int64_t k, int64_t j) {
  constexpr int M = 1 << R;
  const int64_t q =
      static_cast<int64_t>(blockIdx.x) * CROSS_THREADS + threadIdx.x;
  if (q >= (n >> R)) return;
  const int64_t s = j >> (R - 1);
  const int64_t base = ((q & ~(s - 1)) << R) | (q & (s - 1));
  const bool asc = (base & k) == 0;
  K x[M];
  int32_t v[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    x[m] = keys[base + m * s];
    if (KV) v[m] = vals[base + m * s];
  }
  subnet<R, K, KV>(x, v, asc);
#pragma unroll
  for (int m = 0; m < M; ++m) {
    keys[base + m * s] = x[m];
    if (KV) vals[base + m * s] = v[m];
  }
}

template <int R, typename K, bool KV>
cudaError_t launch_cross(K* keys, int32_t* vals, int64_t n, int64_t k,
                         int64_t j, cudaStream_t stream) {
  const int64_t subnets = n >> R;
  const unsigned blocks =
      static_cast<unsigned>((subnets + CROSS_THREADS - 1) / CROSS_THREADS);
  cross_fused<R, K, KV><<<blocks, CROSS_THREADS, 0, stream>>>(keys, vals, n,
                                                              k, j);
  return cudaGetLastError();
}

// R consecutive cross-tile levels j, ..., j / 2^(R-1) of stage k,
// R > SORT_FUSE, through shared memory: the block holds W = XS_SIZE / 2^R
// neighbouring sub-networks, that is 2^R rows of W contiguous elements
// (row m at m * s, s = j / 2^(R-1)), and runs the levels as shared-memory
// groups of up to SMEM_LEVELS.  The pair directions are the block's: bit k
// lies above the rows.
constexpr uint32_t XS_SIZE = XS_THREADS << XS_REG_LOG2;
static_assert((XS_SIZE >> SORT_CROSS_LEVELS) >= (1u << XS_REG_LOG2),
              "a cross launch's rows hold a thread's elements or more");

template <typename K, bool KV>
__global__ void __launch_bounds__(XS_THREADS)
    cross_smem(K* __restrict__ keys, int32_t* __restrict__ vals, int64_t k,
               int64_t j, int r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  K* sk = reinterpret_cast<K*>(smem_raw);
  int32_t* sv = reinterpret_cast<int32_t*>(
      smem_raw + (XS_SIZE + (XS_SIZE >> XS_REG_LOG2)) * sizeof(K));
  const int64_t s = j >> (r - 1);
  const uint32_t wlog = __ffs(static_cast<int>(XS_SIZE)) - 1 - r;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) << wlog;
  const int64_t base = ((q0 & ~(s - 1)) << r) | (q0 & (s - 1));
  const bool basc = (base & k) == 0;
  // element l of the block is row l >> wlog, column l & (W - 1)
  auto at = [&](uint32_t l) {
    return base + static_cast<int64_t>(l >> wlog) * s + (l & ((1u << wlog) - 1));
  };
  constexpr uint32_t VK = 16 / sizeof(K);
  for (uint32_t c = threadIdx.x * VK; c < XS_SIZE; c += XS_THREADS * VK) {
    alignas(16) K e[VK];
    *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(keys + at(c));
#pragma unroll
    for (uint32_t u = 0; u < VK; ++u) sk[slot<XS_REG_LOG2>(c + u)] = e[u];
  }
  if (KV) {
    for (uint32_t c = threadIdx.x * 4; c < XS_SIZE; c += XS_THREADS * 4) {
      alignas(16) int32_t e[4];
      *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(vals + at(c));
#pragma unroll
      for (uint32_t u = 0; u < 4; ++u) sv[slot<XS_REG_LOG2>(c + u)] = e[u];
    }
  }
  __syncthreads();
  constexpr int RMAX = XS_REG_LOG2 < SMEM_LEVELS ? XS_REG_LOG2 : SMEM_LEVELS;
  for (uint32_t jl = (1u << wlog) << (r - 1); jl >= (1u << wlog);) {
    const int avail = __ffs(static_cast<int>(jl)) - static_cast<int>(wlog);
    const int rg = avail < RMAX ? avail : RMAX;
    if (rg == 1) {
      smem_levels<1, XS_REG_LOG2, K, KV>(sk, sv, jl, basc, 0u);
    } else if (rg == 2) {
      smem_levels<2, XS_REG_LOG2, K, KV>(sk, sv, jl, basc, 0u);
    } else if (rg == 3) {
      if constexpr (RMAX >= 3)
        smem_levels<3, XS_REG_LOG2, K, KV>(sk, sv, jl, basc, 0u);
    } else {
      if constexpr (RMAX >= 4)
        smem_levels<4, XS_REG_LOG2, K, KV>(sk, sv, jl, basc, 0u);
    }
    __syncthreads();
    jl >>= rg;
  }
  for (uint32_t c = threadIdx.x * VK; c < XS_SIZE; c += XS_THREADS * VK) {
    alignas(16) K e[VK];
#pragma unroll
    for (uint32_t u = 0; u < VK; ++u) e[u] = sk[slot<XS_REG_LOG2>(c + u)];
    *reinterpret_cast<uint4*>(keys + at(c)) = *reinterpret_cast<const uint4*>(e);
  }
  if (KV) {
    for (uint32_t c = threadIdx.x * 4; c < XS_SIZE; c += XS_THREADS * 4) {
      alignas(16) int32_t e[4];
#pragma unroll
      for (uint32_t u = 0; u < 4; ++u) e[u] = sv[slot<XS_REG_LOG2>(c + u)];
      *reinterpret_cast<uint4*>(vals + at(c)) = *reinterpret_cast<const uint4*>(e);
    }
  }
}

// Let `kernel` take `bytes` of dynamic shared memory on the current device;
// `done` (one per kernel) remembers the devices already set.
template <typename F>
cudaError_t allow_smem(F kernel, size_t bytes, uint64_t& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (done >> dev & 1)) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) done |= uint64_t(1) << dev;
  return err;
}

template <typename K, bool KV>
cudaError_t launch_cross_smem(K* keys, int32_t* vals, int64_t n, int64_t k,
                              int64_t j, int r, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(XS_SIZE + (XS_SIZE >> XS_REG_LOG2)) *
                      (sizeof(K) + (KV ? sizeof(int32_t) : 0));
  static uint64_t smem_set = 0;
  const cudaError_t err = allow_smem(cross_smem<K, KV>, smem, smem_set);
  if (err != cudaSuccess) return err;
  cross_smem<K, KV><<<static_cast<unsigned>(n / XS_SIZE), XS_THREADS, smem,
                      stream>>>(keys, vals, k, j, r);
  return cudaGetLastError();
}

static_assert(SORT_FUSE >= 1 && SORT_FUSE <= 4, "SORT_FUSE in 1..4");
static_assert(SORT_CROSS_LEVELS >= SORT_FUSE, "cross levels >= SORT_FUSE");
static_assert(SMEM_LEVELS >= 1 && SMEM_LEVELS <= 4, "SMEM_LEVELS in 1..4");

template <typename K, bool KV, int T_LOG2, int E_LOG2>
int run_network(K* keys, int32_t* vals, int64_t n, cudaStream_t stream) {
  static_assert(E_LOG2 >= 1 && E_LOG2 <= 5, "register width 2..32");
  static_assert(T_LOG2 - E_LOG2 >= 5 && T_LOG2 - E_LOG2 <= 10,
                "a tile needs 32..1024 threads");
  if (n < 2) return static_cast<int>(cudaGetLastError());
  constexpr int64_t TILE = int64_t(1) << T_LOG2;
  constexpr int64_t WARP_SPAN = int64_t(32) << E_LOG2;
  const int64_t tile = n < TILE ? n : TILE;  // the real tile
  const int64_t width = tile < WARP_SPAN ? WARP_SPAN : tile;  // in smem
  const unsigned grid = static_cast<unsigned>(n >= width ? n / width : 1);
  const int threads = static_cast<int>(width >> E_LOG2);
  const size_t smem = static_cast<size_t>(width + (width >> E_LOG2)) *
                      (sizeof(K) + (KV ? sizeof(int32_t) : 0));
  auto kernel = tile_network<K, KV, T_LOG2, E_LOG2>;
  static uint64_t smem_set = 0;
  cudaError_t err = allow_smem(
      kernel,
      static_cast<size_t>(TILE + (TILE >> E_LOG2)) *
          (sizeof(K) + (KV ? sizeof(int32_t) : 0)),
      smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int max_cross =
      n >= int64_t(SORT_MIN_TILES) * XS_SIZE ? SORT_CROSS_LEVELS : SORT_FUSE;
  kernel<<<grid, threads, smem, stream>>>(keys, vals, n,
                                          static_cast<uint32_t>(width), 2,
                                          tile);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  for (int64_t k = TILE * 2; k <= n; k <<= 1) {
    int64_t j = k >> 1;
    int levels = 0;  // cross-tile levels of this stage: j = k/2 .. TILE
    for (int64_t jj = j; jj >= TILE; jj >>= 1) ++levels;
    while (levels > 0) {
      const int r = levels < max_cross ? levels : max_cross;
      if (r > SORT_FUSE) {
        err = launch_cross_smem<K, KV>(keys, vals, n, k, j, r, stream);
      } else {
        switch (r) {
          case 1: err = launch_cross<1, K, KV>(keys, vals, n, k, j, stream); break;
          case 2: err = launch_cross<2, K, KV>(keys, vals, n, k, j, stream); break;
          case 3: err = launch_cross<3, K, KV>(keys, vals, n, k, j, stream); break;
          default: err = launch_cross<4, K, KV>(keys, vals, n, k, j, stream);
        }
      }
      if (err != cudaSuccess) return static_cast<int>(err);
      j >>= r;
      levels -= r;
    }
    kernel<<<grid, threads, smem, stream>>>(keys, vals, n,
                                            static_cast<uint32_t>(width), k,
                                            k);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The tier for n below the top one (tile 2^top_log2): the first smaller
// tile that n holds SORT_MIN_TILES times, else the last.
template <typename K, bool KV, int I>
int run_lower(K* keys, int32_t* vals, int64_t n, int top_log2,
              cudaStream_t stream) {
  constexpr int T = LOWER_TIERS[I][0];
  constexpr int E = LOWER_TIERS[I][1];
  if constexpr (I + 1 < N_LOWER) {
    if (T >= top_log2 || n < (int64_t(SORT_MIN_TILES) << T))
      return run_lower<K, KV, I + 1>(keys, vals, n, top_log2, stream);
  }
  return run_network<K, KV, T, E>(keys, vals, n, stream);
}

template <typename K, bool KV, int T0, int E0>
int sort_any(K* keys, int32_t* vals, int64_t n, cudaStream_t stream) {
  if (n >= (int64_t(SORT_MIN_TILES) << T0))
    return run_network<K, KV, T0, E0>(keys, vals, n, stream);
  return run_lower<K, KV, 0>(keys, vals, n, T0, stream);
}

}  // namespace

extern "C" {

// n must be a power of two; the buffers hold exactly n elements.
int bitonic_sort_i64(void* keys, int64_t n, void* stream) {
  return sort_any<long long, false, SORT_TILE_LOG2, SORT_REG_LOG2>(
      static_cast<long long*>(keys), nullptr, n,
      static_cast<cudaStream_t>(stream));
}

int bitonic_sort_i32(void* keys, int64_t n, void* stream) {
  return sort_any<int32_t, false, SORT_TILE_LOG2, SORT_REG_LOG2>(
      static_cast<int32_t*>(keys), nullptr, n,
      static_cast<cudaStream_t>(stream));
}

int bitonic_sort_kv_i64(void* keys, void* vals, int64_t n, void* stream) {
  return sort_any<long long, true, SORT_KV_TILE_LOG2, SORT_KV_REG_LOG2>(
      static_cast<long long*>(keys), static_cast<int32_t*>(vals), n,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
