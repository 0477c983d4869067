// GQA flash attention on Hopper's tensor cores (sm_90a): wgmma tiles fed
// by TMA, for bfloat16 and float16 at head_dim 64, 96, 128 and 256.
//
// Replaces the TPU kernel `flash_attention` (`_flash_kernel`) of
// src/repro/kernels/flash_attention/flash_attention.py:92 on the 16-bit
// path (the float32 path stays on csrc/flash_attention.cu).  It computes
// exactly what that CUDA-core kernel computes: q [B,Sq,Hq,hd], k/v
// [B,Skv,Hkv,hd] -> out [B,Sq,Hq,hd] in q's dtype; scores scaled by
// 1/sqrt(hd); float32 running max, sum and accumulator; causal and
// sliding-window masks; query row i at absolute position i + offset; keys
// at or past Skv masked; masked scores -inf with `chunked_attention`'s
// isfinite guards, so a row that sees no key comes out 0.
//
// Bound on this card: operations.  At yi-6b's prefill (B=2, S=2048, 32/4
// heads, hd=128, causal) the band is 68.7 GFLOP against 75.5 MB of
// q/k/v/out: 0.0695 ms at the 989 TFLOP/s bf16 tensor-core peak, three
// times the 0.0225 ms the bytes take.  At recurrentgemma-9b's (B=2,
// S=4096, 16/1 heads, hd=256, window 2048) the band is 206 GFLOP against
// 143 MB: 0.208 ms against 0.043; at phi-3-vision-4.2b's (B=2, S=2048,
// 32/32 heads, hd=96, causal) 51.6 GFLOP against 101 MB: 0.0521 ms
// against 0.030.  So the design keeps the tensor cores
// fed and takes everything else off their path:
//   * tiles stay 16-bit in shared memory, in wgmma's 128-byte-swizzled
//     layout, written there by TMA: q, k and v are 4-D tensor maps over
//     (hd, H, S, B) with their real strides, so a [positions x 64] box is
//     cut out of [B,S,H,hd] with no index math in the threads (hd = 128 is
//     two 64-column boxes, hd = 256 four: a swizzled box spans at most 128
//     bytes; hd = 96 two, the second half past the tensor's width).  Rows
//     past S and columns past hd come back as zeros, so keys >= Skv are
//     still masked;
//   * S = Q K^T is `wgmma.m64n{BN}k16` with A = the Q tile and B = the K
//     tile, both K-major from shared memory, hd/16 k-steps;
//   * the online softmax runs on the accumulator fragment in registers:
//     row max by quad shuffles, exp2 with log2(e)/sqrt(hd) folded into one
//     scale, the row sum kept per thread until the end; scores never touch
//     shared memory;
//   * O += P V is `wgmma.m64nNk16` (N = hd, or two N = 128 halves at
//     hd = 256) with A = P in registers (the S accumulator's fragment is
//     the A fragment: pairs of it packed to 16 bits) and B = the V tile,
//     which is MN-major for this product (trans-b); O is rescaled by
//     alpha first;
//   * a producer keeps a two-stage K/V ring in flight (full and empty
//     mbarriers) while two consumer warpgroups compute, so one
//     warpgroup's softmax overlaps the other's wgmma;
//   * kv tiles wholly outside the causal band or the window are never
//     loaded; a warpgroup skips a loaded tile none of its rows can see; the
//     element masks run only on tiles that cross the diagonal, the window
//     edge or the Skv tail.
// GQA mapping: one q-head per block, 128 query positions (two warpgroups
// of 64 rows), K/V of its kv-head reused through L2: the G blocks of a
// group run side by side (the head is the fastest grid axis) and all of
// yi's K/V is 8 MB against a 50 MB L2 (recurrentgemma's 4 MB a batch).
// Putting the G heads of a group in one 64-row tile instead would leave
// 64/G positions per tile, so each block would walk a whole band for a
// sliver of queries.  The q-tile axis is the slowest and runs from the
// last tile down, so the longest bands start first.
//
// Tiles by head dim (`Layout<HD>`; one block of 128 query rows per SM):
//   * hd 128: 128-key tiles, one producer warp (288 threads), the output
//     through padded shared memory (no bank conflicts) to 16-byte
//     coalesced stores: Q 32 KB, K and V 2 x 32 KB each, the staging
//     34 KB: 195 KB.
//   * hd 96 (192 bytes a row, one and a half boxes) takes hd 128's tiles
//     and threads over NB = 2 boxes.  The tensor maps keep the true
//     width, so TMA fills the second box's columns 96..127 with zeros and
//     reads no global bytes for them; it still credits whole boxes to the
//     barriers, so the expected bytes count whole boxes.  Q K^T runs the
//     6 k-steps of the true width.  O += P V is one m64n96k16 a k-step
//     (its B descriptor stops half-way into the second box's 128-byte
//     swizzle atoms), which never reads the zero columns, into 48 floats
//     a thread; the scale is 1/sqrt(96).  Staging rows of 104
//     elements (the fragment writes land on 32 distinct banks): Q 32 KB,
//     K and V 2 x 32 KB each, the staging 26 KB: 187 KB.
//   * hd 256: that layout would need Q 64 KB, K and V rings of 2 x 64 KB
//     each and 66 KB of staging, far over the 227 KB a block may have,
//     and an O accumulator of 128 floats a consumer thread.  So kv tiles
//     are 64 keys (S is `m64n64k16`, 32 floats a thread, over 16
//     k-steps): Q 64 KB plus K and V rings of 2 x 32 KB each is 192 KB.
//     The output is staged in the warpgroup's own Q rows once its last
//     Q K^T has completed, in the same swizzled four-box layout, and goes
//     out by TMA tensor stores of 64-row boxes, which clip rows past Sq.
//     Registers: the producer is a whole warpgroup (384 threads) that
//     gives its registers up with `setmaxnreg` (down to 40), and the
//     consumers take them (up to 232: 128 x 40 + 256 x 232 = 64,512 of
//     the SM's 65,536) for O, S and P.
//   * hd 64 (whisper-tiny's encoder and cross-attention) has a kernel of
//     its own, `flash_tc64_kernel` (`Layout64`; see the note above it):
//     there the exponentials cost as much as the products, so three
//     consumer warpgroups take turns at the tensor cores and each keeps
//     a product in flight through its softmax.
//
// Plain C interface for ctypes: launches on the given stream and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape, an alignment
// or a tensor map it refuses, or the error of a refused shared-memory
// request.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 128;        // query rows per block (two warpgroups)
constexpr int STAGES = 2;      // depth of the K/V ring
constexpr int CONSUMERS = 256;
constexpr int BOX = 64;        // head-dim columns per TMA box (128 bytes)
constexpr int OUT_ROWS = 64;   // rows of a TMA output box (one warpgroup)
constexpr float LOG2E = 1.4426950408889634f;

// What the head dim sets (see the header): hd 96 and 128 keep 128-key
// tiles, one producer warp and padded output staging; hd 256
// ("wide") takes 64-key tiles, a producer warpgroup that hands its
// registers to the consumers, and stages the output in the Q tile for TMA
// stores.  Tiles hold NB whole boxes a row.
template <int HD>
struct Layout {  // byte offsets from a 1024-aligned base
  static constexpr bool WIDE = HD > 128;
  static constexpr int NB = (HD + BOX - 1) / BOX;  // boxes a row
  static constexpr int BN = WIDE ? 64 : 128;    // keys per kv tile
  static constexpr int THREADS = CONSUMERS + (WIDE ? 128 : 32);
  static constexpr int ON = WIDE ? 64 : HD / 2;  // O floats a wgmma holds
  static constexpr int OH = HD / 2 / ON;         // O products per k-step
  static constexpr int Q_BYTES = BM * NB * BOX * 2;   // NB boxes of BM x 64
  static constexpr int KV_BYTES = BN * NB * BOX * 2;  // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int O_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int O_LD = HD + 8;           // staging row, in elements
  static constexpr int BAR_OFF = O_OFF + (WIDE ? 0 : BM * O_LD * 2);
  // barriers: q, full[STAGES], empty[STAGES]
  static constexpr int ALLOC = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};
// the register split of the wide layout (setmaxnreg; multiples of 8)
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
static_assert(128 * PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <= 65536,
              "the wide layout's registers exceed the SM's");
static_assert(Layout<256>::ALLOC <= 232448 && Layout<128>::ALLOC <= 232448 &&
                  Layout<96>::ALLOC <= 232448,
              "a layout exceeds the 227 KB a block may have");

struct Shape {
  int Sq, Skv, Hq, G, causal, window, offset;
};

// -- PTX wrappers ------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(bar) : "memory");
}

// a box from shared memory to global; elements past the tensor's extent
// are not written
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%1, %2, %3, %4}], [%5];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(src) : "memory");
}

// returns once every bulk store this thread committed has read its source
__device__ __forceinline__ void tma_store_drain() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// the thread's generic-proxy writes to shared memory become visible to
// the async proxy (TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// the named barrier `id` completes once `threads` have arrived or synced
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// returns once at most N of the thread's committed groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers to a point in the instruction stream.  Before a wgmma
// fence: the thread's own writes to an accumulator or an A fragment land
// before it.  After a wgmma wait: reads of the accumulator cannot move
// above the wait, and the registers a wgmma reads stay live until it.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int M, int N>
__device__ __forceinline__ void keep(float (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) keep(r[i]);
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define D8(i)                                                             \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define D32 D8(0), D8(8), D8(16), D8(24)
#define D48 D32, D8(32), D8(40)
#define D64 D48, D8(48), D8(56)
#define R32                                                               \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31"
#define R48                                                               \
  R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, " \
      "%45, %46, %47"
#define R64                                                               \
  R48 ", %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, " \
      "%61, %62, %63"

// d[64 x N] (+)= A[64 x 16] B[16 x N], A and B from shared memory, both
// K-major; accumulate = 0 overwrites d; N = 128 (d[64]) or 64 (d[32])
template <bool BF16>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (BF16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" R64
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : D64 : "l"(da), "l"(db), "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {" R64
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : D64 : "l"(da), "l"(db), "r"(accumulate));
  }
}
template <bool BF16>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (BF16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" R32
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : D32 : "l"(da), "l"(db), "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {" R32
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : D32 : "l"(da), "l"(db), "r"(accumulate));
  }
}

// d[64 x N] += A[64 x 16] B[16 x N], A from registers (four packed pairs
// a thread), B from shared memory MN-major (trans-b = 1); N = 128 (d[64]),
// 96 (d[48]) or 64 (d[32])
template <bool BF16>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (BF16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" R64
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : D64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {" R64
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : D64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}
template <bool BF16>
__device__ __forceinline__ void wgmma_rs(float (&d)[48],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (BF16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {" R48
        "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
        : D48
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.f16.f16 {" R48
        "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
        : D48
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}
template <bool BF16>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (BF16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" R32
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : D32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {" R32
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : D32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

#undef D8
#undef D32
#undef D48
#undef D64
#undef R32
#undef R48
#undef R64

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// -- the kernel --------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(Layout<HD>::THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap to, T* __restrict__ out,
                const Shape sh) {
  using L = Layout<HD>;
  constexpr int BN = L::BN;
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::BAR_OFF;
  const uint32_t bar_full = bar_q + 8;                 // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * STAGES;    // + 8 * stage

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;
  const int hk = h / sh.G;

  // the kv tiles this block's rows can see
  const int p_first = q0 + sh.offset;
  const int p_last = min(q0 + BM, sh.Sq) - 1 + sh.offset;
  const int k_end = sh.causal ? min(sh.Skv, p_last + 1) : sh.Skv;
  const int k_begin = sh.window > 0 ? max(0, p_first - (sh.window - 1)) : 0;
  const int t_begin = k_begin / BN;
  const int ntiles = k_end > k_begin ? (k_end + BN - 1) / BN - t_begin : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS / 32);  // one arrive a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= CONSUMERS / 32) {
    // the wide layout's producer warpgroup keeps 40 registers a thread
    if constexpr (L::WIDE) setmaxnreg_dec<PRODUCER_REGS>();
    // producer: the Q tile once, then the K/V ring
    if (warp == CONSUMERS / 32 && lane == 0) {
      mbar_expect_tx(bar_q, L::Q_BYTES);
      for (int c = 0; c < L::NB; ++c)
        tma_load_4d(base + c * BM * 128, &tq, c * BOX, h, q0, b, bar_q);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES)  // the consumers released this stage's last use
          mbar_wait(bar_empty + 8 * s, ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * L::KV_BYTES);
        const int kt = (t_begin + i) * BN;
        for (int c = 0; c < L::NB; ++c) {
          const uint32_t off = s * L::KV_BYTES + c * BN * 128;
          tma_load_4d(base + L::K_OFF + off, &tk, c * BOX, hk, kt, b,
                      bar_full + 8 * s);
          tma_load_4d(base + L::V_OFF + off, &tv, c * BOX, hk, kt, b,
                      bar_full + 8 * s);
        }
      }
    }
    return;
  }
  if constexpr (L::WIDE) setmaxnreg_inc<CONSUMER_REGS>();

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63; this
  // thread holds rows r and r + 8 of them, columns 8 n + 2 (lane % 4) + e
  const int wg = warp / 4;
  const int r = (warp % 4) * 16 + lane / 4;
  const int row0 = q0 + wg * 64;
  const int qp_lo = row0 + r + sh.offset, qp_hi = qp_lo + 8;
  const int wp_first = row0 + sh.offset;
  const int wp_last = min(row0 + 64, sh.Sq) - 1 + sh.offset;
  const float scale = LOG2E / sqrtf(static_cast<float>(HD));

  // O's columns 8 n .. 8 n + 7 are o[n / NPH][4 (n % NPH) ..]: one
  // accumulator per N = 128 product at hd 256, one in all below
  constexpr int NPH = L::ON / 4;
  float o[L::OH][L::ON];
#pragma unroll
  for (int a = 0; a < L::OH; ++a)
#pragma unroll
    for (int i = 0; i < L::ON; ++i) o[a][i] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  const uint32_t q_addr = base + wg * 64 * 128;
  mbar_wait(bar_q, 0);

  for (int i = 0; i < ntiles; ++i) {
    const int s = i % STAGES;
    const int kt = (t_begin + i) * BN;
    mbar_wait(bar_full + 8 * s, (i / STAGES) & 1);
    const bool seen = wp_last >= wp_first &&
                      (!sh.causal || kt <= wp_last) &&
                      (sh.window <= 0 || kt + BN - 1 > wp_first - sh.window);
    if (seen) {
      const uint32_t k_addr = base + L::K_OFF + s * L::KV_BYTES;
      const uint32_t v_addr = base + L::V_OFF + s * L::KV_BYTES;
      float sc[BN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t koff = (kk / 4) * BN * 128 + (kk % 4) * 32;
        wgmma_ss<BF16>(
            sc,
            sw128_desc(q_addr + (kk / 4) * BM * 128 + (kk % 4) * 32, 16,
                       1024),
            sw128_desc(k_addr + koff, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      keep(sc);

      const bool whole = kt + BN <= sh.Skv &&
                         (!sh.causal || kt + BN - 1 <= wp_first) &&
                         (sh.window <= 0 || wp_last - kt < sh.window);
      if (!whole) {
#pragma unroll
        for (int n = 0; n < BN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = kt + 8 * n + 2 * (lane % 4) + (e & 1);
            const int qp = (e & 2) ? qp_hi : qp_lo;
            const bool ok = kp < sh.Skv && (!sh.causal || kp <= qp) &&
                            (sh.window <= 0 || qp - kp < sh.window);
            if (!ok) sc[4 * n + e] = -INFINITY;
          }
      }

      // online softmax on the fragment, in the log2 domain
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        mx_lo = fmaxf(mx_lo, fmaxf(sc[4 * n], sc[4 * n + 1]));
        mx_hi = fmaxf(mx_hi, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
      }
      const float mn_lo = fmaxf(m_lo, quad_max(mx_lo) * scale);
      const float mn_hi = fmaxf(m_hi, quad_max(mx_hi) * scale);
      // a running max of -inf: nothing seen yet, alpha 0 and p 0
      const float mu_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
      const float mu_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
      const float al_lo = ex2(m_lo - mu_lo), al_hi = ex2(m_hi - mu_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        sc[4 * n] = ex2(fmaf(sc[4 * n], scale, -mu_lo));
        sc[4 * n + 1] = ex2(fmaf(sc[4 * n + 1], scale, -mu_lo));
        sc[4 * n + 2] = ex2(fmaf(sc[4 * n + 2], scale, -mu_hi));
        sc[4 * n + 3] = ex2(fmaf(sc[4 * n + 3], scale, -mu_hi));
        ps_lo += sc[4 * n] + sc[4 * n + 1];
        ps_hi += sc[4 * n + 2] + sc[4 * n + 3];
      }
      l_lo = l_lo * al_lo + ps_lo;
      l_hi = l_hi * al_hi + ps_hi;
#pragma unroll
      for (int a = 0; a < L::OH; ++a)
#pragma unroll
        for (int n = 0; n < NPH; ++n) {
          o[a][4 * n] *= al_lo;
          o[a][4 * n + 1] *= al_lo;
          o[a][4 * n + 2] *= al_hi;
          o[a][4 * n + 3] *= al_hi;
        }
      // P's fragment for k-step kk is the S fragment's columns 16 kk ..
      // 16 kk + 15: registers 8 kk .. 8 kk + 7, packed in pairs
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pa[kk][j] = pack2<T>(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);

      keep(o);
      keep(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int a = 0; a < L::OH; ++a)
          // keys 16 kk .. 16 kk + 15: rows of the V tile; the 64-column
          // boxes are the leading-dimension step, and the second N = 128
          // half of hd = 256 starts two boxes on
          wgmma_rs<BF16>(o[a], pa[kk],
                         sw128_desc(v_addr + a * 2 * BN * 128 + kk * 16 * 128,
                                    BN * 128, 1024));
      wgmma_commit();
      wgmma_wait_all();
      keep(o);
      keep(pa);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  }

  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  if constexpr (L::WIDE) {
    // normalize into the warpgroup's own Q rows (its last Q K^T has
    // completed, and the other warpgroup reads only its own), in the
    // swizzled box layout TMA loaded them in: row rr's 16-byte chunk j of
    // box c sits at chunk j ^ (rr % 8); then 64-row TMA stores, which
    // clip rows past Sq
    uint8_t* stage = sm + wg * 64 * 128;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int a = n / NPH, e = 4 * (n % NPH);
      uint8_t* chunk = stage + (n / 8) * BM * 128 + r * 128 +
                       (((n % 8) ^ (r % 8)) << 4) + 4 * (lane % 4);
      *reinterpret_cast<uint32_t*>(chunk) =
          pack2<T>(o[a][e] * inv_lo, o[a][e + 1] * inv_lo);
      *reinterpret_cast<uint32_t*>(chunk + 8 * 128) =  // row r + 8
          pack2<T>(o[a][e + 2] * inv_hi, o[a][e + 3] * inv_hi);
    }
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);
    if (threadIdx.x % 128 == 0 && row0 < sh.Sq) {
      for (int c = 0; c < L::NB; ++c)
        tma_store_4d(&to, base + c * BM * 128 + wg * 64 * 128, c * BOX, h,
                     row0, b);
      tma_store_drain();
    }
  } else {
    // stage through padded shared memory, store 16 bytes a thread
    T* stage = reinterpret_cast<T*>(sm + L::O_OFF) + wg * 64 * L::O_LD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int col = 8 * n + 2 * (lane % 4);
      *reinterpret_cast<uint32_t*>(stage + r * L::O_LD + col) =
          pack2<T>(o[0][4 * n] * inv_lo, o[0][4 * n + 1] * inv_lo);
      *reinterpret_cast<uint32_t*>(stage + (r + 8) * L::O_LD + col) =
          pack2<T>(o[0][4 * n + 2] * inv_hi, o[0][4 * n + 3] * inv_hi);
    }
    named_bar_sync(1 + wg, 128);
    constexpr int CH = HD / 8;  // 16-byte chunks a row
    for (int c = threadIdx.x % 128; c < 64 * CH; c += 128) {
      const int rr = c / CH, j = c % CH;
      const int qrow = row0 + rr;
      if (qrow < sh.Sq)
        *reinterpret_cast<uint4*>(
            out + ((static_cast<int64_t>(b) * sh.Sq + qrow) * sh.Hq + h) *
                      HD + j * 8) =
            *reinterpret_cast<const uint4*>(stage + rr * L::O_LD + j * 8);
    }
  }
}

// -- head dim 64 -------------------------------------------------------------
//
// At hd 64 a (query, key) pair costs 256 FLOP of products, 1/16 of an SM
// clock at the tensor cores' rate, and one exp2, also 1/16 of a clock on
// the MUFU (16 results a clock an SM): the softmax's exponentials alone
// take as long as the products.  A warpgroup that waits for its products,
// runs its softmax and then waits again keeps the tensor cores at most
// half busy, so this kernel overlaps the two both ways:
//   * turns: the consumer warpgroups (64 query rows each) issue their
//     products in a fixed round, handed on by named barriers: each one
//     syncs on its own barrier, issues, and arrives at the next one's.
//     While one warpgroup runs its softmax, the others' products keep the
//     tensor cores busy;
//   * a product in flight through the softmax (FlashAttention-3's
//     overlap within a warpgroup): a warpgroup issues S = Q K^T of tile
//     j and O += P V of tile j - 1 in one turn, waits for the first only
//     (`wgmma.wait_group 1`) and runs tile j's softmax while P V runs; O
//     is rescaled once that product has completed.  So a thread holds
//     one S fragment (64 floats), P of the tile before (32 registers)
//     and O (32 floats).  Q K^T of tile j + 1 in flight during tile j's
//     softmax instead would need a second S fragment, 192 registers a
//     thread with P and O: past the 160 a thread can have with three
//     consumer warpgroups;
//   * a fuller SM: three consumer warpgroups (192 query rows a
//     block) and a producer warpgroup that gives its registers up with
//     `setmaxnreg` (to 32; the consumers take 160: 128 x 32 + 384 x 160
//     = 65,536); Q 24 KB, a K/V ring of HD64_STAGES x 32 KB and the
//     padded output staging, 27 KB;
//   * one grid axis, the q-tile fastest, so the tiles of one head run
//     side by side and read its K/V through L2 at about the same time;
//     causal blocks take the last tiles (the longest bands) first.  A
//     warpgroup whose rows all lie past Sq leaves at once, and the turns
//     and the ring count only the warpgroups with rows.  The others
//     compute every tile of the block's band, the masks zeroing what
//     their rows cannot see (a causal or windowed band's edge tiles), so
//     no branch stands between a wgmma and its wait;
//   * a block whose rows fit one warpgroup (432 queries, the
//     cross-attention's, end in a tile of 48 rows) splits its kv tiles
//     instead of leaving two warpgroups idle for a whole band: every
//     warpgroup takes those rows and every third tile, holding one tile
//     at a time (P V waited for at once), and warpgroup 0 merges the
//     three partial softmaxes through the ring.
//     Such tail blocks come after every whole one in the grid's order,
//     so they fill the last wave's gaps.
// The rest is as at the other head dims: TMA tensor maps, the 128-byte
// swizzle, 128-key tiles, P as the register A operand, V MN-major, the
// element masks only on tiles that cross an edge, the padded-staging
// epilogue.
constexpr int HD64_STAGES = 4;  // depth of the K/V ring

struct Layout64 {  // byte offsets from a 1024-aligned base
  static constexpr int WGS = 3;  // consumer warpgroups, 64 query rows each
  static constexpr int STAGES = HD64_STAGES;
  static constexpr int BM = 64 * WGS;  // query rows per block
  static constexpr int BN = 128;       // keys per kv tile
  static constexpr int THREADS = 128 * (WGS + 1);
  static constexpr int Q_BYTES = BM * 128;
  static constexpr int KV_BYTES = BN * 128;  // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int O_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int O_LD = 64 + 8;  // staging row, in elements
  static constexpr int BAR_OFF = O_OFF + BM * O_LD * 2;
  // barriers: q, full[STAGES], empty[STAGES]
  static constexpr int ALLOC = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
  // named barriers: 1 + wg a warpgroup's epilogue, TURN + wg its turn,
  // MERGE the split blocks' merge
  static constexpr int TURN = 1 + WGS;
  static constexpr int MERGE = TURN + WGS;
  // a split block's partials in the ring: m, l and O, 36 floats a thread
  static constexpr int PART = 36 * 128;
  // the register split (setmaxnreg), all of the SM's registers
  static constexpr int PRODUCER_REGS = 32;
  static constexpr int CONSUMER_REGS = 160;
};
// a two-stage ring faults on an H100 (an unspecified launch failure, with
// and without the turns); three and four stages pass every check
static_assert(Layout64::STAGES >= 3, "hd 64 takes a ring of three or more");
static_assert(128 * Layout64::PRODUCER_REGS +
                      128 * Layout64::WGS * Layout64::CONSUMER_REGS <=
                  65536,
              "the hd-64 layout's registers exceed the SM's");
static_assert(Layout64::ALLOC <= 232448,
              "the hd-64 layout exceeds the 227 KB a block may have");

// S[64 x 128] = Q[64 x 64] K[128 x 64]^T, both K-major in shared memory
template <bool BF16>
__device__ __forceinline__ void qk64(float (&s)[64], uint32_t q_addr,
                                     uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<BF16>(s, sw128_desc(q_addr + kk * 32, 16, 1024),
                   sw128_desc(k_addr + kk * 32, 16, 1024), kk > 0);
}

// O[64 x 64] += P[64 x 128] V[128 x 64]: P from registers, V MN-major
template <bool BF16>
__device__ __forceinline__ void pv64(float (&o)[32], const uint32_t (&pa)[8][4],
                                     uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_rs<BF16>(o, pa[kk], sw128_desc(v_addr + kk * 16 * 128, 128 * 128,
                                         1024));
}

// a consumer warp's arrive on a stage's empty barrier
__device__ __forceinline__ void release64(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// the online softmax of a thread's two rows (r and r + 8 of its
// warpgroup), in the log2 domain: the running max and the thread's part of
// the row sums; for the last tile, the old O's factors
struct Rows64 {
  float m_lo, m_hi, l_lo, l_hi, al_lo, al_hi;
};

// one 128-key tile's S in s, keys from kt (this thread's rows at
// positions qp and qp + 8): the masks where the tile crosses an edge, the
// running max, P = 2^(S scale - m) in s, and the row sums
__device__ __forceinline__ void softmax64(float (&s)[64], Rows64& st,
                                          const Shape& sh, int kt, int qp,
                                          int wp_first, int wp_last,
                                          int lane) {
  const float scale = LOG2E / 8.f;  // log2(e) / sqrt(64)
  const bool whole = kt + 128 <= sh.Skv &&
                     (!sh.causal || kt + 127 <= wp_first) &&
                     (sh.window <= 0 || wp_last - kt < sh.window);
  if (!whole) {
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = kt + 8 * n + 2 * (lane % 4) + (e & 1);
        const int q = qp + ((e & 2) ? 8 : 0);
        const bool ok = kp < sh.Skv && (!sh.causal || kp <= q) &&
                        (sh.window <= 0 || q - kp < sh.window);
        if (!ok) s[4 * n + e] = -INFINITY;
      }
  }
  float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    mx_lo = fmaxf(mx_lo, fmaxf(s[4 * n], s[4 * n + 1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[4 * n + 2], s[4 * n + 3]));
  }
  const float mn_lo = fmaxf(st.m_lo, quad_max(mx_lo) * scale);
  const float mn_hi = fmaxf(st.m_hi, quad_max(mx_hi) * scale);
  // a running max of -inf: nothing seen yet, alpha 0 and p 0
  const float mu_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
  const float mu_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
  st.al_lo = ex2(st.m_lo - mu_lo);
  st.al_hi = ex2(st.m_hi - mu_hi);
  st.m_lo = mn_lo;
  st.m_hi = mn_hi;
  float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = fmaf(s[4 * n + e], scale, (e & 2) ? -mu_hi : -mu_lo);
      s[4 * n + e] = ex2(x);
    }
    ps_lo += s[4 * n] + s[4 * n + 1];
    ps_hi += s[4 * n + 2] + s[4 * n + 3];
  }
  st.l_lo = st.l_lo * st.al_lo + ps_lo;
  st.l_hi = st.l_hi * st.al_hi + ps_hi;
}

// once P V of the tile before has completed: O rescaled, and P packed
// from s into the A fragment of the next P V (its k-step kk is s's
// columns 16 kk .. 16 kk + 15: registers 8 kk .. 8 kk + 7, in pairs)
template <typename T>
__device__ __forceinline__ void rescale_pack64(const float (&s)[64],
                                               float (&o)[32],
                                               uint32_t (&pa)[8][4],
                                               Rows64& st) {
#pragma unroll
  for (int k = 0; k < 32; ++k) o[k] *= (k & 2) ? st.al_hi : st.al_lo;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pa[kk][j] = pack2<T>(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
}

// P V of the tile at v_addr issued and waited for, its stage released
template <bool BF16>
__device__ __forceinline__ void flush64(float (&o)[32], uint32_t (&pa)[8][4],
                                        uint32_t v_addr, uint32_t bar_empty,
                                        int lane) {
  keep(o);
  keep(pa);
  wgmma_fence();
  pv64<BF16>(o, pa, v_addr);
  wgmma_commit();
  wgmma_wait<0>();
  keep(o);
  keep(pa);
  release64(bar_empty, lane);
}

template <typename T>
__global__ void __launch_bounds__(Layout64::THREADS, 1)
flash_tc64_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  T* __restrict__ out, const Shape sh) {
  using L = Layout64;
  constexpr int BN = L::BN;
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::BAR_OFF;
  const uint32_t bar_full = bar_q + 8;                 // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * L::STAGES;  // + 8 * stage

  // one grid axis over (q-tile, head, batch), the q-tile fastest; causal
  // blocks take the last tiles first, and a split last tile (a third of
  // a band's work on each warpgroup) goes after every whole one
  const int nq = (sh.Sq + L::BM - 1) / L::BM;
  const int tail = !sh.causal && nq > 1 && sh.Sq - (nq - 1) * L::BM <= 64;
  const int whole_blocks = (nq - tail) * (gridDim.x / nq);
  int tile, hb;
  if (static_cast<int>(blockIdx.x) < whole_blocks) {
    tile = blockIdx.x % (nq - tail);
    hb = blockIdx.x / (nq - tail);
  } else {
    tile = nq - 1;
    hb = blockIdx.x - whole_blocks;
  }
  if (sh.causal) tile = nq - 1 - tile;
  const int q0 = tile * L::BM;
  const int h = hb % sh.Hq, b = hb / sh.Hq;
  const int hk = h / sh.G;
  // the warpgroups with rows below Sq, a prefix of them
  const int rows_wg = min(L::WGS, (sh.Sq - q0 + 63) / 64);

  // the kv tiles this block's rows can see
  const int p_first = q0 + sh.offset;
  const int p_last = min(q0 + L::BM, sh.Sq) - 1 + sh.offset;
  const int k_end = sh.causal ? min(sh.Skv, p_last + 1) : sh.Skv;
  const int k_begin = sh.window > 0 ? max(0, p_first - (sh.window - 1)) : 0;
  const int t_begin = k_begin / BN;
  const int ntiles = k_end > k_begin ? (k_end + BN - 1) / BN - t_begin : 0;
  // a split block: every warpgroup on the first warpgroup's rows
  const bool split = rows_wg == 1 && ntiles > 1;
  const int nwg = split ? L::WGS : rows_wg;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      // one arrive a consumer warp that uses the tile
      mbar_init(bar_empty + 8 * s, split ? 4 : 4 * nwg);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 4 * L::WGS) {
    // producer: the Q tile once, then the K/V ring
    setmaxnreg_dec<L::PRODUCER_REGS>();
    if (warp == 4 * L::WGS && lane == 0) {
      mbar_expect_tx(bar_q, L::Q_BYTES);
      tma_load_4d(base, &tq, 0, h, q0, b, bar_q);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % L::STAGES;
        if (i >= L::STAGES)  // the consumers released this stage's last use
          mbar_wait(bar_empty + 8 * s, ((i / L::STAGES) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * L::KV_BYTES);
        const int kt = (t_begin + i) * BN;
        tma_load_4d(base + L::K_OFF + s * L::KV_BYTES, &tk, 0, hk, kt, b,
                    bar_full + 8 * s);
        tma_load_4d(base + L::V_OFF + s * L::KV_BYTES, &tv, 0, hk, kt, b,
                    bar_full + 8 * s);
      }
    }
    return;
  }
  setmaxnreg_inc<L::CONSUMER_REGS>();
  const int wg = warp / 4;
  if (wg >= nwg) return;

  // warpgroup wg owns query rows q0 + 64 wg .. + 63 (split: q0 .. + 63);
  // this thread holds rows r and r + 8 of them, columns 8 n + 2 (lane %
  // 4) + e
  const int r = (warp % 4) * 16 + lane / 4;
  const int row0 = q0 + (split ? 0 : wg * 64);
  const int qp = row0 + r + sh.offset;
  const int wp_first = row0 + sh.offset;
  const int wp_last = min(row0 + 64, sh.Sq) - 1 + sh.offset;
  const uint32_t q_addr = base + (row0 - q0) * 128;
  const uint32_t k_ring = base + L::K_OFF, v_ring = base + L::V_OFF;

  // one turn a kv tile, or in a split block a round of one tile each;
  // the last warpgroup hands the first its first turn and skips its own
  // last hand-on, so every barrier ends complete
  const int rounds = split ? (ntiles + L::WGS - 1) / L::WGS : ntiles;
  const bool turns = nwg > 1;
  const int bar_mine = L::TURN + wg;
  const int bar_next = L::TURN + (wg + 1 < nwg ? wg + 1 : 0);
  if (turns && wg == nwg - 1 && rounds > 0) named_bar_arrive(L::TURN, 256);
  // whether this warpgroup hands the turn on after round k
#define HAND_ON(k) \
  if (turns && (wg != nwg - 1 || (k) != rounds - 1)) \
  named_bar_arrive(bar_next, 256)

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  Rows64 st{-INFINITY, -INFINITY, 0.f, 0.f, 0.f, 0.f};
  float sc[64];
  uint32_t pa[8][4] = {};
  mbar_wait(bar_q, 0);

  if (!split && ntiles > 0) {
    // every warpgroup computes every tile of the block's band (the masks
    // zero what its rows cannot see).  Tile 0: S alone
    mbar_wait(bar_full, 0);
    if (turns) named_bar_sync(bar_mine, 256);
    wgmma_fence();
    qk64<BF16>(sc, q_addr, k_ring);
    wgmma_commit();
    HAND_ON(0);
    wgmma_wait<0>();
    keep(sc);
    softmax64(sc, st, sh, t_begin * L::BN, qp, wp_first, wp_last, lane);
    rescale_pack64<T>(sc, o, pa, st);
    // tile j: S of tile j and P V of tile j - 1 in one turn; the softmax
    // runs while P V does
    for (int j = 1; j < ntiles; ++j) {
      const int s = j % L::STAGES, h_ = (j - 1) % L::STAGES;
      mbar_wait(bar_full + 8 * s, (j / L::STAGES) & 1);
      if (turns) named_bar_sync(bar_mine, 256);
      keep(o);
      keep(pa);
      wgmma_fence();
      qk64<BF16>(sc, q_addr, k_ring + s * L::KV_BYTES);
      wgmma_commit();
      pv64<BF16>(o, pa, v_ring + h_ * L::KV_BYTES);
      wgmma_commit();
      HAND_ON(j);
      wgmma_wait<1>();  // S has completed; P V may still run
      keep(sc);
      softmax64(sc, st, sh, (t_begin + j) * L::BN, qp, wp_first, wp_last,
                lane);
      wgmma_wait<0>();  // P V has completed: O and P are free
      keep(o);
      keep(pa);
      release64(bar_empty + 8 * h_, lane);
      rescale_pack64<T>(sc, o, pa, st);
    }
    const int s = (ntiles - 1) % L::STAGES;
    flush64<BF16>(o, pa, v_ring + s * L::KV_BYTES, bar_empty + 8 * s, lane);
  }
  if (split) {
    // this warpgroup's tiles wg, wg + WGS, ..., one at a time, a turn
    // each; then the turns of the rounds it has no tile in
    int round = 0;
    for (int j = wg; j < ntiles; j += L::WGS, ++round) {
      const int s = j % L::STAGES;
      mbar_wait(bar_full + 8 * s, (j / L::STAGES) & 1);
      if (turns) named_bar_sync(bar_mine, 256);
      keep(o);
      keep(pa);
      wgmma_fence();
      qk64<BF16>(sc, q_addr, k_ring + s * L::KV_BYTES);
      wgmma_commit();
      HAND_ON(round);
      wgmma_wait<0>();
      keep(sc);
      softmax64(sc, st, sh, (t_begin + j) * L::BN, qp, wp_first, wp_last,
                lane);
      rescale_pack64<T>(sc, o, pa, st);
      flush64<BF16>(o, pa, v_ring + s * L::KV_BYTES, bar_empty + 8 * s, lane);
    }
    for (; round < rounds; ++round) {
      if (turns) named_bar_sync(bar_mine, 256);
      HAND_ON(round);
    }
  }

#undef HAND_ON
  if (split) {
    // every product has completed and every tile was waited for by its
    // warpgroup, so the ring is free: warpgroups 1 .. WGS-1 leave their m,
    // l and O there, and warpgroup 0 merges them into its own
    float* part = reinterpret_cast<float*>(sm + L::K_OFF) + threadIdx.x % 128;
    named_bar_sync(L::MERGE, 128 * L::WGS);
    if (wg > 0) {
      float* mine = part + (wg - 1) * L::PART;
#pragma unroll
      for (int k = 0; k < 32; ++k) mine[k * 128] = o[k];
      mine[32 * 128] = st.m_lo;
      mine[33 * 128] = st.m_hi;
      mine[34 * 128] = st.l_lo;
      mine[35 * 128] = st.l_hi;
    }
    named_bar_sync(L::MERGE, 128 * L::WGS);
    if (wg > 0) return;
    float mx_lo = st.m_lo, mx_hi = st.m_hi;
    for (int w = 1; w < L::WGS; ++w) {
      mx_lo = fmaxf(mx_lo, part[(w - 1) * L::PART + 32 * 128]);
      mx_hi = fmaxf(mx_hi, part[(w - 1) * L::PART + 33 * 128]);
    }
    const float mu_lo = mx_lo == -INFINITY ? 0.f : mx_lo;
    const float mu_hi = mx_hi == -INFINITY ? 0.f : mx_hi;
    const float a_lo = ex2(st.m_lo - mu_lo), a_hi = ex2(st.m_hi - mu_hi);
    st.l_lo *= a_lo;
    st.l_hi *= a_hi;
#pragma unroll
    for (int k = 0; k < 32; ++k) o[k] *= (k & 2) ? a_hi : a_lo;
    for (int w = 1; w < L::WGS; ++w) {
      const float* theirs = part + (w - 1) * L::PART;
      const float f_lo = ex2(theirs[32 * 128] - mu_lo);
      const float f_hi = ex2(theirs[33 * 128] - mu_hi);
      st.l_lo += theirs[34 * 128] * f_lo;
      st.l_hi += theirs[35 * 128] * f_hi;
#pragma unroll
      for (int k = 0; k < 32; ++k)
        o[k] += theirs[k * 128] * ((k & 2) ? f_hi : f_lo);
    }
  }

  const float inv_lo = 1.f / fmaxf(quad_sum(st.l_lo), 1e-30f);
  const float inv_hi = 1.f / fmaxf(quad_sum(st.l_hi), 1e-30f);
  // stage through padded shared memory, store 16 bytes a thread
  T* stage = reinterpret_cast<T*>(sm + L::O_OFF) + wg * 64 * L::O_LD;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = 8 * n + 2 * (lane % 4);
    *reinterpret_cast<uint32_t*>(stage + r * L::O_LD + col) =
        pack2<T>(o[4 * n] * inv_lo, o[4 * n + 1] * inv_lo);
    *reinterpret_cast<uint32_t*>(stage + (r + 8) * L::O_LD + col) =
        pack2<T>(o[4 * n + 2] * inv_hi, o[4 * n + 3] * inv_hi);
  }
  named_bar_sync(1 + wg, 128);
  for (int c = threadIdx.x % 128; c < 64 * 8; c += 128) {
    const int rr = c / 8, j = c % 8;
    const int qrow = row0 + rr;
    if (qrow < sh.Sq)
      *reinterpret_cast<uint4*>(
          out + ((static_cast<int64_t>(b) * sh.Sq + qrow) * sh.Hq + h) * 64 +
          j * 8) = *reinterpret_cast<const uint4*>(stage + rr * L::O_LD +
                                                   j * 8);
  }
}

// -- host side ---------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda.so.1, which the process has loaded
// already (so the library needs no link-time dependency on libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// a [B,S,H,hd] tensor as a 4-D map over (hd, H, S, B), boxes of 64 x 1 x
// rows x 1, 128-byte swizzle, out-of-bounds elements read as zero
bool make_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
              int64_t B, int64_t S, int64_t H, int64_t hd, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(hd * 2),
                                 static_cast<cuuint64_t>(H * hd * 2),
                                 static_cast<cuuint64_t>(S * H * hd * 2)};
  const cuuint32_t box[4] = {BOX, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box,
            estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

CUtensorMapDataType map_type(bool bf16) {
  return bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
              : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
}

Shape make_shape(int64_t Sq, int64_t Skv, int64_t Hq, int64_t Hkv,
                 int64_t causal, int64_t window, int64_t offset) {
  Shape sh;
  sh.Sq = static_cast<int>(Sq);
  sh.Skv = static_cast<int>(Skv);
  sh.Hq = static_cast<int>(Hq);
  sh.G = static_cast<int>(Hq / Hkv);
  sh.causal = causal ? 1 : 0;
  sh.window = static_cast<int>(window);
  sh.offset = static_cast<int>(offset);
  return sh;
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out,
              int64_t B, int64_t Sq, int64_t Skv, int64_t Hq, int64_t Hkv,
              int64_t causal, int64_t window, int64_t offset,
              cudaStream_t stream) {
  using L = Layout<HD>;
  const CUtensorMapDataType type =
      map_type(std::is_same<T, __nv_bfloat16>::value);
  CUtensorMap tq, tk, tv, to{};  // `to` only for the wide layout's stores
  if (!make_map(&tq, q, type, B, Sq, Hq, HD, BM) ||
      !make_map(&tk, k, type, B, Skv, Hkv, HD, L::BN) ||
      !make_map(&tv, v, type, B, Skv, Hkv, HD, L::BN) ||
      (L::WIDE && !make_map(&to, out, type, B, Sq, Hq, HD, OUT_ROWS)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaFuncSetAttribute(
      flash_tc_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::ALLOC);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(static_cast<unsigned>(Hq), static_cast<unsigned>(B),
                  static_cast<unsigned>((Sq + BM - 1) / BM));
  flash_tc_kernel<T, HD><<<grid, L::THREADS, L::ALLOC, stream>>>(
      tq, tk, tv, to, static_cast<T*>(out),
      make_shape(Sq, Skv, Hq, Hkv, causal, window, offset));
  return static_cast<int>(cudaGetLastError());
}

// hd 64: one grid axis over (q-tiles, heads, batch)
template <typename T>
int launch_hd64(const void* q, const void* k, const void* v, void* out,
                int64_t B, int64_t Sq, int64_t Skv, int64_t Hq, int64_t Hkv,
                int64_t causal, int64_t window, int64_t offset,
                cudaStream_t stream) {
  using L = Layout64;
  const CUtensorMapDataType type =
      map_type(std::is_same<T, __nv_bfloat16>::value);
  CUtensorMap tq, tk, tv;
  const int64_t blocks = (Sq + L::BM - 1) / L::BM * Hq * B;
  if (blocks > 2147483647 || !make_map(&tq, q, type, B, Sq, Hq, 64, L::BM) ||
      !make_map(&tk, k, type, B, Skv, Hkv, 64, L::BN) ||
      !make_map(&tv, v, type, B, Skv, Hkv, 64, L::BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaFuncSetAttribute(
      flash_tc64_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::ALLOC);
  if (set != cudaSuccess) return static_cast<int>(set);
  flash_tc64_kernel<T><<<static_cast<unsigned>(blocks), L::THREADS, L::ALLOC,
                         stream>>>(
      tq, tk, tv, static_cast<T*>(out),
      make_shape(Sq, Skv, Hq, Hkv, causal, window, offset));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int64_t B,
           int64_t Sq, int64_t Skv, int64_t Hq, int64_t Hkv, int64_t hd,
           int64_t causal, int64_t window, int64_t offset, void* stream) {
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv ||
      B > 65535 || (Sq + BM - 1) / BM > 65535 || misaligned(q) ||
      misaligned(k) || misaligned(v) || misaligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch_hd64<T>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, window,
                          offset, st);
  if (hd == 96)
    return launch_hd<T, 96>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal,
                            window, offset, st);
  if (hd == 128)
    return launch_hd<T, 128>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal,
                             window, offset, st);
  if (hd == 256)
    return launch_hd<T, 256>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal,
                             window, offset, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q [B,Sq,Hq,hd], k/v [B,Skv,Hkv,hd], out [B,Sq,Hq,hd], all contiguous,
// 16-byte aligned and of one dtype; hd 64, 96, 128 or 256, Skv >= 1.
int flash_attention_tc_bf16(const void* q, const void* k, const void* v,
                            void* out, int64_t B, int64_t Sq, int64_t Skv,
                            int64_t Hq, int64_t Hkv, int64_t hd,
                            int64_t causal, int64_t window, int64_t offset,
                            void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, Hq, Hkv, hd, causal,
                               window, offset, stream);
}

int flash_attention_tc_f16(const void* q, const void* k, const void* v,
                           void* out, int64_t B, int64_t Sq, int64_t Skv,
                           int64_t Hq, int64_t Hkv, int64_t hd,
                           int64_t causal, int64_t window, int64_t offset,
                           void* stream) {
  return launch<__half>(q, k, v, out, B, Sq, Skv, Hq, Hkv, hd, causal, window,
                        offset, stream);
}

}  // extern "C"
