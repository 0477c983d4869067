// First-order linear recurrence along a sequence, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference runs this step of the RG-LRU
// block as `jax.lax.associative_scan` in XLA (`_linear_scan`,
// src/repro/models/rglru.py:67), and the port ran it as ceil(log2 S)
// Hillis-Steele passes of elementwise PyTorch ops (`linear_scan_plain`,
// src/repro_torch/kernels/rglru_scan/scan.py), 12 at S = 4096, each pass
// reading and writing whole copies of a and b.  Per (batch, channel),
// float32:
//   h[t] = a[t] * h[t-1] + b[t],   h[-1] = h0 (or 0)
// with a, b, h contiguous [B, S, D], D innermost, and h0 [B, D].
//
// Bound on this card: bytes.  a and b are read once and h written once,
// 12 B S D bytes (0.403 GB at recurrentgemma-9b's prefill, B 2, S 4096,
// D 4096: 0.120 ms at 3.35 TB/s); the work is one multiply-add an element.
// Every (batch, channel) pair is an independent recurrence of S steps at
// stride D, and there are only B D = 8192 of them at that shape, so one
// thread walking one channel's S steps would leave the card waiting on
// 8192 dependent chains of 4096 FMAs.  The design:
//
// - A block takes LS_CH = 32 consecutive channels of one batch row (a
//   warp's lanes: every load and store is one 128-byte row) and walks the
//   whole sequence in tiles of LS_TILE = LS_WARPS * LS_SEG rows; warp w
//   takes the tile's segment w of LS_SEG rows.  B D / 32 = 256 blocks of
//   256 threads at the prefill shape: one wave at two blocks an SM.
// - A thread holds its segment of a and b in registers, loaded straight
//   from device memory (no shared-memory staging: nothing is read twice,
//   and a warp's loads are already whole lines).  The next tile's loads
//   are issued before the current tile is scanned, so each block keeps a
//   tile (32 KB) in flight while it computes.
// - Per tile: (1) each thread scans its segment from h = 0, keeping the
//   segment's composed decay A = prod a and its local end state H; (2) the
//   (A, H) pairs of the tile's segments go to shared memory, and each
//   thread composes those before its own onto the carry into the tile,
//   (a_l, b_l) o (a_r, b_r) = (a_l a_r, a_r b_l + b_r), the reference's
//   `combine`, which gives the state entering its segment (and, over all
//   segments, the carry out of the tile); (3) it reruns its segment from
//   that state, from the registers, and writes h.  Two shared buffers by
//   tile parity need one barrier a tile.
// - Rows past S load as the identity step (a = 1, b = 0) and are not
//   written; channels past D load nothing and write nothing.
//
// Order of work, mirrored by `linear_scan_staged` in
// src/repro_torch/kernels/rglru_scan/scan.py (test-only), whose constants
// the CPU tests hold to the ones below.
//
// Plain C interface for ctypes: launches on the given stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LS_CH = 32;     // channels a block: one warp's lanes
constexpr int LS_WARPS = 8;   // segments a tile: one warp each
constexpr int LS_SEG = 16;    // rows a segment: one thread's run
constexpr int LS_TILE = LS_WARPS * LS_SEG;
constexpr int LS_THREADS = LS_CH * LS_WARPS;

// Rows [t0, t0 + LS_SEG) of one channel (column `col` of row 0), the
// identity step where the row is past S or the channel past D.
__device__ __forceinline__ void load_segment(const float* __restrict__ a,
                                             const float* __restrict__ b,
                                             int64_t col, int64_t t0,
                                             int64_t S, int64_t D, bool live,
                                             float (&ra)[LS_SEG],
                                             float (&rb)[LS_SEG]) {
#pragma unroll
  for (int i = 0; i < LS_SEG; ++i) {
    const int64_t t = t0 + i;
    if (live && t < S) {
      ra[i] = __ldcs(a + col + t * D);
      rb[i] = __ldcs(b + col + t * D);
    } else {
      ra[i] = 1.f;
      rb[i] = 0.f;
    }
  }
}

__global__ void __launch_bounds__(LS_THREADS)
    linear_scan_kernel(const float* __restrict__ a,
                       const float* __restrict__ b,
                       const float* __restrict__ h0, float* __restrict__ h,
                       int64_t S, int64_t D, int64_t groups) {
  __shared__ float sA[2][LS_WARPS][LS_CH];
  __shared__ float sH[2][LS_WARPS][LS_CH];
  const int lane = threadIdx.x % LS_CH;
  const int w = threadIdx.x / LS_CH;
  const int64_t batch = blockIdx.x / groups;
  const int64_t c = (blockIdx.x % groups) * LS_CH + lane;
  const bool live = c < D;
  const int64_t col = batch * S * D + c;  // (batch, t = 0, c)
  float carry = (h0 != nullptr && live) ? h0[batch * D + c] : 0.f;

  float ra[LS_SEG], rb[LS_SEG], na[LS_SEG], nb[LS_SEG];
  load_segment(a, b, col, int64_t(w) * LS_SEG, S, D, live, ra, rb);
  int p = 0;
  for (int64_t t0 = 0; t0 < S; t0 += LS_TILE) {
    const int64_t seg0 = t0 + int64_t(w) * LS_SEG;
    if (t0 + LS_TILE < S)  // the next tile's loads go out first
      load_segment(a, b, col, seg0 + LS_TILE, S, D, live, na, nb);
    // (1) the segment from h = 0: its composed decay and end state
    float A = 1.f, H = 0.f;
#pragma unroll
    for (int i = 0; i < LS_SEG; ++i) {
      H = fmaf(ra[i], H, rb[i]);
      A *= ra[i];
    }
    sA[p][w][lane] = A;
    sH[p][w][lane] = H;
    __syncthreads();
    // (2) the state entering this segment, and the carry out of the tile
    float mine = carry;
#pragma unroll
    for (int j = 0; j < LS_WARPS; ++j) {
      if (j == w) mine = carry;
      carry = fmaf(sA[p][j][lane], carry, sH[p][j][lane]);
    }
    // (3) the segment again from that state
    float hv = mine;
#pragma unroll
    for (int i = 0; i < LS_SEG; ++i) {
      hv = fmaf(ra[i], hv, rb[i]);
      if (live && seg0 + i < S) h[col + (seg0 + i) * D] = hv;
    }
    if (t0 + LS_TILE < S) {
#pragma unroll
      for (int i = 0; i < LS_SEG; ++i) {
        ra[i] = na[i];
        rb[i] = nb[i];
      }
    }
    p ^= 1;
  }
}

}  // namespace

extern "C" {

// a, b, h: [B, S, D] float32, contiguous; h0: [B, D] float32 or null.
int linear_scan_f32(const void* a, const void* b, const void* h0, void* h,
                    int64_t B, int64_t S, int64_t D, void* stream) {
  if (B < 0 || S < 0 || D < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || D == 0) return static_cast<int>(cudaGetLastError());
  const int64_t groups = (D + LS_CH - 1) / LS_CH;
  if (B * groups > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  linear_scan_kernel<<<static_cast<unsigned>(B * groups), LS_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h), S, D, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
