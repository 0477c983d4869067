// GQA flash attention on Hopper's tensor cores (sm_90a): wgmma tiles fed
// by TMA, for bfloat16 and float16 at head_dim 64 and 128.
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
// times the 0.0225 ms the bytes take.  So the design keeps the tensor
// cores fed and takes everything else off their path:
//   * tiles stay 16-bit in shared memory, in wgmma's 128-byte-swizzled
//     layout, written there by TMA: q, k and v are 4-D tensor maps over
//     (hd, H, S, B) with their real strides, so a [positions x 64] box is
//     cut out of [B,S,H,hd] with no index math in the threads (hd = 128 is
//     two 64-column boxes: a swizzled box spans at most 128 bytes).  Rows
//     past S come back as zeros, so keys >= Skv are still masked;
//   * S = Q K^T is `wgmma.m64n128k16` with A = the Q tile and B = the K
//     tile, both K-major from shared memory, hd/16 k-steps;
//   * the online softmax runs on the accumulator fragment in registers:
//     row max by quad shuffles, exp2 with log2(e)/sqrt(hd) folded into one
//     scale, the row sum kept per thread until the end; scores never touch
//     shared memory;
//   * O += P V is `wgmma.m64n{hd}k16` with A = P in registers (the S
//     accumulator's fragment is the A fragment: pairs of it packed to
//     16 bits) and B = the V tile, which is MN-major for this product
//     (trans-b); O is rescaled by alpha first;
//   * one producer warp keeps a two-stage K/V ring in flight (full and
//     empty mbarriers) while two consumer warpgroups compute, so one
//     warpgroup's softmax overlaps the other's wgmma;
//   * kv tiles wholly outside the causal band or the window are never
//     loaded; a warpgroup skips a loaded tile none of its rows can see; the
//     element masks run only on tiles that cross the diagonal, the window
//     edge or the Skv tail;
//   * the output goes through padded shared memory (no bank conflicts) to
//     16-byte coalesced stores.
// GQA mapping: one q-head per block, 128 query positions (two warpgroups
// of 64 rows), K/V of its kv-head reused through L2: the G blocks of a
// group run side by side (the head is the fastest grid axis) and all of
// yi's K/V is 8 MB against a 50 MB L2.  Putting the G heads of a group in
// one 64-row tile instead would leave 64/G positions per tile, so each
// block would walk a whole band for a sliver of queries.  The q-tile axis
// is the slowest and runs from the last tile down, so the longest bands
// start first.
// Shared memory at hd = 128: Q 32 KB, K and V 2 x 32 KB each, the output
// staging 34 KB: 195 KB, one block (288 threads) per SM.
//
// Plain C interface for ctypes: launches on the given stream and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape, an alignment
// or a tensor map it refuses.

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
constexpr int BN = 128;        // keys per kv tile
constexpr int STAGES = 2;      // depth of the K/V ring
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int BOX = 64;        // head-dim columns per TMA box (128 bytes)
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Layout {  // byte offsets from a 1024-aligned base
  static constexpr int Q_BYTES = BM * HD * 2;   // HD/64 boxes of BM x 64
  static constexpr int KV_BYTES = BN * HD * 2;  // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int O_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int O_LD = HD + 8;           // staging row, in elements
  static constexpr int BAR_OFF = O_OFF + BM * O_LD * 2;
  // barriers: q, full[STAGES], empty[STAGES]
  static constexpr int ALLOC = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

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

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
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

// Pins registers to a point in the instruction stream.  Before a wgmma
// fence: the thread's own writes to an accumulator or an A fragment land
// before it.  After a wgmma wait: reads of the accumulator cannot move
// above the wait, and the registers a wgmma reads stay live until it.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
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
#define D64 D32, D8(32), D8(40), D8(48), D8(56)
#define R32                                                               \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31"
#define R64                                                               \
  R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, " \
      "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
      "%58, %59, %60, %61, %62, %63"

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B from shared memory,
// both K-major; accumulate = 0 overwrites d
template <bool BF16>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
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

// d[64 x HD] += A[64 x 16] B[16 x HD], A from registers (four packed
// pairs a thread), B from shared memory MN-major (trans-b = 1)
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
#undef D64
#undef R32
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
__global__ void __launch_bounds__(THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, T* __restrict__ out,
                const Shape sh) {
  using L = Layout<HD>;
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
  if (warp == CONSUMERS / 32) {
    // producer: the Q tile once, then the K/V ring
    if (lane == 0) {
      mbar_expect_tx(bar_q, L::Q_BYTES);
      for (int c = 0; c < HD / BOX; ++c)
        tma_load_4d(base + c * BM * 128, &tq, c * BOX, h, q0, b, bar_q);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES)  // the consumers released this stage's last use
          mbar_wait(bar_empty + 8 * s, ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * L::KV_BYTES);
        const int kt = (t_begin + i) * BN;
        for (int c = 0; c < HD / BOX; ++c) {
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

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63; this
  // thread holds rows r and r + 8 of them, columns 8 n + 2 (lane % 4) + e
  const int wg = warp / 4;
  const int r = (warp % 4) * 16 + lane / 4;
  const int row0 = q0 + wg * 64;
  const int qp_lo = row0 + r + sh.offset, qp_hi = qp_lo + 8;
  const int wp_first = row0 + sh.offset;
  const int wp_last = min(row0 + 64, sh.Sq) - 1 + sh.offset;
  const float scale = LOG2E / sqrtf(static_cast<float>(HD));

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
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
        wgmma_ss_n128<BF16>(
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
      for (int n = 0; n < HD / 8; ++n) {
        o[4 * n] *= al_lo;
        o[4 * n + 1] *= al_lo;
        o[4 * n + 2] *= al_hi;
        o[4 * n + 3] *= al_hi;
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
        // keys 16 kk .. 16 kk + 15: rows of the V tile; the two 64-column
        // boxes of hd = 128 are the leading-dimension step
        wgmma_rs<BF16>(o, pa[kk],
                       sw128_desc(v_addr + kk * 16 * 128, BN * 128, 1024));
      wgmma_commit();
      wgmma_wait_all();
      keep(o);
      keep(pa);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  }

  // normalize, stage through shared memory, store 16 bytes a thread
  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  T* stage = reinterpret_cast<T*>(sm + L::O_OFF) + wg * 64 * L::O_LD;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int col = 8 * n + 2 * (lane % 4);
    *reinterpret_cast<uint32_t*>(stage + r * L::O_LD + col) =
        pack2<T>(o[4 * n] * inv_lo, o[4 * n + 1] * inv_lo);
    *reinterpret_cast<uint32_t*>(stage + (r + 8) * L::O_LD + col) =
        pack2<T>(o[4 * n + 2] * inv_hi, o[4 * n + 3] * inv_hi);
  }
  named_bar_sync(1 + wg, 128);
  constexpr int CH = HD / 8;  // 16-byte chunks a row
  for (int c = threadIdx.x % 128; c < 64 * CH; c += 128) {
    const int rr = c / CH, j = c % CH;
    const int qrow = row0 + rr;
    if (qrow < sh.Sq)
      *reinterpret_cast<uint4*>(
          out + ((static_cast<int64_t>(b) * sh.Sq + qrow) * sh.Hq + h) * HD +
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

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out,
              int64_t B, int64_t Sq, int64_t Skv, int64_t Hq, int64_t Hkv,
              int64_t causal, int64_t window, int64_t offset,
              cudaStream_t stream) {
  const CUtensorMapDataType type =
      std::is_same<T, __nv_bfloat16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, type, B, Sq, Hq, HD, BM) ||
      !make_map(&tk, k, type, B, Skv, Hkv, HD, BN) ||
      !make_map(&tv, v, type, B, Skv, Hkv, HD, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  Shape sh;
  sh.Sq = static_cast<int>(Sq);
  sh.Skv = static_cast<int>(Skv);
  sh.Hq = static_cast<int>(Hq);
  sh.G = static_cast<int>(Hq / Hkv);
  sh.causal = causal ? 1 : 0;
  sh.window = static_cast<int>(window);
  sh.offset = static_cast<int>(offset);
  const int bytes = Layout<HD>::ALLOC;
  cudaFuncSetAttribute(flash_tc_kernel<T, HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  const dim3 grid(static_cast<unsigned>(Hq), static_cast<unsigned>(B),
                  static_cast<unsigned>((Sq + BM - 1) / BM));
  flash_tc_kernel<T, HD><<<grid, THREADS, bytes, stream>>>(
      tq, tk, tv, static_cast<T*>(out), sh);
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
    return launch_hd<T, 64>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal,
                            window, offset, st);
  if (hd == 128)
    return launch_hd<T, 128>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal,
                             window, offset, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q [B,Sq,Hq,hd], k/v [B,Skv,Hkv,hd], out [B,Sq,Hq,hd], all contiguous,
// 16-byte aligned and of one dtype; hd 64 or 128, Skv >= 1.
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
