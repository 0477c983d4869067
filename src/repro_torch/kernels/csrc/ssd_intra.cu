// Mamba-2 SSD intra-chunk term for Hopper (sm_90a).
//
// Replaces the TPU kernel `ssd_intra` (`_ssd_intra_kernel`) of
// src/repro/kernels/ssd/ssd.py.  Per (batch b, chunk c, head h), float32:
//   y[i]  = sum_{j<=i} exp(cum[i] - cum[j]) (C[i] . B[j]) u[j]     [Q, hp]
//   st    = sum_j exp(cum[Q-1] - cum[j]) u[j] (x) B[j]            [hp, N]
// with cum [b,nc,Q,nh], u [b,nc,Q,nh,hp], B/C [b,nc,Q,N] in, and y
// [b,nc,Q,nh,hp], st [b,nc,nh,hp,N] out.
//
// What held the first design back (one block per (b, c, h, 64-row tile),
// scalar float32 FMAs; 2.02 ms at mamba2-1.3b's prefill shape, slower
// than its plain version, PERF.md §6): it formed the gram C_i . B_j over
// all N for every head although the gram depends on (b, c) only (~10.5
// MFLOP a head against ~9.4 for the two products), it ran every product
// on the CUDA cores, and it read u once per row tile and again for the
// state.  The design now:
//
// - The gram once per (b, c): `ssd_gram`, a small launch, writes the
//   64 x 64 tiles of C . B^T that the head kernel reads (those left of each
//   row tile's right edge) to scratch [b*nc, QP, QP] (QP = Q rounded up to
//   TR; 4 MB at mamba2's shape, so it stays in the 50 MB L2), as upstream
//   Mamba-2's GPU kernels split a chunk-level C . B^T from the per-head
//   scan.  It runs on `mma.sync.m16n8k8` (~0.02 ms).
// - Hopper's tensor cores for both products of the head kernel:
//   `wgmma.m64nNk8` in TF32, A from registers, B from shared memory.
//   wgmma takes 32-bit B operands K-major only, and u lies with hp
//   contiguous (N-major for M u): each column tile of u is transposed into
//   [p][j] as it is split (below), one 128-byte swizzled row of TJ = 32
//   floats per p.  The same tile serves the state when it is formed as
//   st^T = (w o B)^T u: A = (w o B)^T from registers, B = u^T again.
//   `mma.sync` with the same split ran at 0.39 ms (PERF.md §6): the
//   legacy path's TF32 products cost ~4 cycles an SM each.
// - Float32 precision in split form: a = hi + lo with hi = tf32(a) and
//   lo = tf32(a - hi) (to nearest, ties away, as cvt.rna rounds), and a.b
//   = lo.hi + hi.lo + hi.hi in three products into the float32 accumulator
//   (3xTF32; the dropped lo.lo term is ~2^-22 of a.b).  One-pass TF32
//   misses the 1e-4 gate at mamba2's width (tests/test_torch_ssd_plan.py).
// - One block per (b, c, h), two warpgroups of 64 rows, reads u once from
//   device memory: it walks the row tiles of TR = 128 rows and, for each,
//   the column tiles of TJ rows j up to its diagonal, double-buffered with
//   cp.async; u and gram tiles that an earlier row tile read come back
//   from L2.  The decay exp(cum_i - cum_j) is computed in place for j <= i
//   (never as exp(cum_i) . exp(-cum_j), which overflows when cum falls by
//   hundreds over a chunk) straight into M's A fragments.  The column tiles
//   at or past a row tile's first row are visited once each over the whole
//   walk, so the state takes them there, from the same u^T tile; its
//   accumulator lives in registers for the whole block.
//
// Bound on this card: at the LM path's prefill shape (b=2, nc=8, Q=256,
// nh=64, hp=64, N=128) the inputs and outputs are ~173 MB, 0.052 ms at
// 3.35 TB/s; the function needs ~8.8 GFLOP (the causal half of M u, the
// state product, the gram once per (b, c)), ~26 GFLOP as three TF32
// products, 0.053 ms at the 495 TFLOP/s TF32 peak: the two are even.
//
// The staged arithmetic (the gram once per (b, c), the tiles, the TF32
// split) is mirrored by `ssd_intra_staged` in
// src/repro_torch/kernels/ssd/ssd.py (test-only), which the CPU tests hold
// against the plain version and the Pallas kernel; the tile constants
// below are read by those tests.
//
// Plain C interface for ctypes: launches both kernels on the given stream
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps: two warpgroups in the head kernel
constexpr int GT = 64;        // the gram pass's square tile
constexpr int TR = 128;       // rows i of a row tile: 64 a warpgroup
constexpr int TJ = 32;        // rows j of a column tile: one 128-byte row
constexpr int HP_MAX = 128;
constexpr int N_MAX = 128;
constexpr int GS = TJ + 4;    // row stride of a gram tile in shared memory

static_assert(TR % GT == 0, "a row tile covers whole gram tiles");
static_assert(TR == 128 && TJ == 32, "two warpgroups of 64 rows; a column "
              "tile of u transposed is one 128-byte swizzle row");

struct Dims {
  int Q, nh, hp, N;
  int QP;        // Q rounded up to TR: the gram scratch's side
  int US, BS;    // row strides of the u and B tiles in shared memory
  int vec_u, vec_b;  // 16-byte copies of u rows / of B rows
};

// -- TF32 tensor-core helpers ---------------------------------------------

// float32 to TF32, to nearest with ties away from zero, as cvt.rna.tf32
// rounds: the magnitude's 13 low bits rounded off in two integer ops (the
// same result for finite x; cvt runs on a quarter-rate pipe and measured
// 6 % slower, PERF.md §6)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a . b, one m16n8k8 TF32 product (a 16 x 8 row-major, b 8 x 8)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in float32 precision: the small products first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma(d, al, h0, h1);
  mma(d, ah, l0, l1);
  mma(d, ah, h0, h1);
}

__device__ __forceinline__ void split4(const float (&a)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) split(a[k], hi[k], lo[k]);
}

// -- cp.async ----------------------------------------------------------------

// 16 or 4 bytes from device memory to shared memory; zeros when !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;");
}

template <int PENDING>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PENDING));
}

// rows [r0, r0 + rows) of a [*, width] array whose row r starts at
// src + r * rstride, into dst with row stride dstride; rows >= limit are
// zeros.  vec: 16-byte copies, L lanes a row (L >= width / 4, a power of
// two), no division; else 4-byte copies.
template <int L>
__device__ __forceinline__ void copy_rows(float* dst, int dstride,
                                          const float* src, int64_t rstride,
                                          int r0, int rows, int limit,
                                          int width, bool vec) {
  if (vec) {
    const int q = threadIdx.x & (L - 1);
    if (4 * q >= width) return;
    for (int r = threadIdx.x / L; r < rows; r += THREADS / L) {
      const bool ok = r0 + r < limit;
      cp_async16(dst + r * dstride + 4 * q,
                 ok ? src + (r0 + r) * rstride + 4 * q : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * width; e += THREADS) {
      const int r = e / width, q = e - r * width;
      const bool ok = r0 + r < limit;
      cp_async4(dst + r * dstride + q, ok ? src + (r0 + r) * rstride + q : src,
                ok);
    }
  }
}

// -- the gram pass -------------------------------------------------------------

// G[bc, i, j] = C_i . B_j for the GT x GT tiles (I, J) of each (b, c)
// that a row tile reads (those left of its row tile's right edge); rows
// and columns past Q are zeros.  One block per tile: 8 warps of 16 rows x
// 32 columns.
__global__ void __launch_bounds__(THREADS)
ssd_gram(const float* __restrict__ Bm, const float* __restrict__ Cm,
         float* __restrict__ G, int Q, int N, int QP) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int NK = (N + 7) & ~7;   // N rounded up to the mma depth
  const int NS = NK + 4;         // row stride: fragment reads hit 32 banks
  float* Cs = smem;              // [GT][NS]
  float* Bs = Cs + GT * NS;      // [GT][NS]

  const int QT = QP / GT;
  const int tile = blockIdx.x % (QT * QT);
  const int64_t bc = blockIdx.x / (QT * QT);
  const int I = tile / QT, J = tile - (tile / QT) * QT;
  if (J * GT >= (I * GT / TR + 1) * TR) return;
  const int64_t row0 = bc * Q;
  for (int e = threadIdx.x; e < GT * NK; e += THREADS) {
    const int r = e / NK, n = e - (e / NK) * NK;
    const int i = I * GT + r, j = J * GT + r;
    Cs[r * NS + n] = (i < Q && n < N) ? Cm[(row0 + i) * N + n] : 0.f;
    Bs[r * NS + n] = (j < Q && n < N) ? Bm[(row0 + j) * N + n] : 0.f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = w & 3, ch = w >> 2;
  float acc[4][4] = {};
  const float* ca = Cs + (16 * rg + g) * NS + t;
  for (int k0 = 0; k0 < NK; k0 += 8) {
    const float a[4] = {ca[k0], ca[8 * NS + k0], ca[k0 + 4],
                        ca[8 * NS + k0 + 4]};
    uint32_t ah[4], al[4];
    split4(a, ah, al);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float* bb = Bs + (32 * ch + 8 * nt + g) * NS + k0 + t;
      mma3(acc[nt], ah, al, bb[0], bb[4]);
    }
  }
  float* go = G + (bc * QP + I * GT + 16 * rg + g) * QP + J * GT + 32 * ch +
              2 * t;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    *reinterpret_cast<float2*>(go + 8 * nt) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(go + 8 * QP + 8 * nt) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
}

// -- the head kernel ----------------------------------------------------------

__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  // shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row
  // groups 1024 bytes apart
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
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
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int K>
__device__ __forceinline__ void keep(uint32_t (&r)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
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

// d[64 x 64] += A[64 x 8] B[8 x 64] in TF32, A from registers (four a
// thread, mma.m16n8k8's layout in each warp), B from shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" R64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += a . b over one column tile: the three products of each k8 step
// (a split in registers, b = the transposed u tile's hi and lo)
template <int NA>
__device__ __forceinline__ void wgmma3(float (&d)[NA],
                                       const uint32_t (&ah)[TJ / 8][4],
                                       const uint32_t (&al)[TJ / 8][4],
                                       uint32_t uh, uint32_t ul) {
#pragma unroll
  for (int kk = 0; kk < TJ / 8; ++kk) {
    wgmma_tf32(d, al[kk], sw128_desc(uh + 32 * kk));
    wgmma_tf32(d, ah[kk], sw128_desc(ul + 32 * kk));
    wgmma_tf32(d, ah[kk], sw128_desc(uh + 32 * kk));
  }
}

// One block per (b, c, h), two warpgroups.  M u: warpgroup wg takes rows
// 64 wg .. of the row tile, its warp q rows 16 q .. of those; the state,
// as st^T = (w o B)^T u: warpgroup wg takes n = 64 wg .., its warp q 16 q
// .. of those.  Both products' B operand is the column tile of u
// transposed (K-major, as wgmma takes 32-bit operands) and split into
// TF32 hi and lo, 128-byte swizzled: HPT rows of TJ = 32 floats.
// HPT: hp rounded up to 64 or 128.
template <int HPT, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
ssd_chunk(const float* __restrict__ cum, const float* __restrict__ u,
          const float* __restrict__ Bm, const float* __restrict__ G,
          float* __restrict__ y, float* __restrict__ st, Dims d) {
  constexpr int NA = HPT / 2;         // accumulators a thread, per product
  constexpr int KSUB = TJ / 8;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* smem = reinterpret_cast<float*>(smem_raw + (base - raw));
  const int Q = d.Q, nh = d.nh, hp = d.hp, N = d.N, QP = d.QP;
  const int US = d.US, BS = d.BS;
  float* Th = smem;                   // [HPT][TJ]  u^T hi, swizzled
  float* Tl = Th + HPT * TJ;          // [HPT][TJ]  u^T lo, swizzled
  float* cs = Tl + HPT * TJ;          // [QP]  cum of this head, 0 past Q
  float* ws = cs + QP;                // [QP]  state weights, 0 past Q
  float* Us = ws + QP;                // [2][TJ][US]
  float* Gs = Us + 2 * TJ * US;       // [2][TR][GS]
  float* Bs = Gs + 2 * TR * GS;       // [2][TJ][BS]
  const uint32_t th_addr = base, tl_addr = base + HPT * TJ * 4;

  const int tid = threadIdx.x;
  const int h = blockIdx.x % nh;
  const int64_t bc = blockIdx.x / nh;
  const int64_t row0 = bc * Q;
  const float* ub = u + (row0 * nh + h) * hp;  // u row j at ub + j*nh*hp
  const float* bb = Bm + row0 * N;
  const float* gb = G + bc * QP * QP;

  // the u and B buffers' pad columns stay 0; cum and the state weights
  for (int e = tid; e < 2 * TJ * US; e += THREADS) Us[e] = 0.f;
  for (int e = tid; e < 2 * TJ * BS; e += THREADS) Bs[e] = 0.f;
  for (int q = tid; q < QP; q += THREADS)
    cs[q] = q < Q ? cum[(row0 + q) * nh + h] : 0.f;
  __syncthreads();
  const float c_end = cs[Q - 1];
  for (int q = tid; q < QP; q += THREADS)
    ws[q] = q < Q ? expf(c_end - cs[q]) : 0.f;

  auto cols = [&](int I) { return (min(Q, (I + 1) * TR) + TJ - 1) / TJ; };
  auto load = [&](int I, int J, int buf) {
    const int i0 = I * TR, j0 = J * TJ;
    copy_rows<HPT / 4>(Us + buf * TJ * US, US, ub,
                       static_cast<int64_t>(nh) * hp, j0, TJ, Q, hp,
                       d.vec_u);
    copy_rows<TJ / 4>(Gs + buf * TR * GS, GS, gb + j0, QP, i0, TR, QP, TJ,
                      true);
    if (j0 >= i0)
      copy_rows<N_MAX / 4>(Bs + buf * TJ * BS, BS, bb, N, j0, TJ, Q, N,
                           d.vec_b);
    cp_commit();
  };

  const int lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wg = w >> 2, q4 = w & 3;
  float yacc[NA] = {};
  float sacc[NA] = {};

  const int RT = (Q + TR - 1) / TR;
  int I = 0, J = 0, buf = 0;
  load(0, 0, 0);
  while (I < RT) {
    int In = I, Jn = J + 1;
    if (Jn >= cols(I)) { ++In; Jn = 0; }
    if (In < RT) {
      load(In, Jn, buf ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    const int i0 = I * TR, j0 = J * TJ;
    const float* us = Us + buf * TJ * US;
    const float* gs = Gs + buf * TR * GS;
    const float* bs = Bs + buf * TJ * BS;

    // u's column tile transposed into [p][j], split, 128-byte swizzled:
    // float (p, j) at p * 32 + ((j / 4) ^ (p % 8)) * 4 + j % 4
    for (int e = tid; e < HPT * TJ; e += THREADS) {
      const int p = e % HPT, j = e / HPT;
      uint32_t hi, lo;
      split(us[j * US + p], hi, lo);
      const int o = p * TJ + ((((j >> 2) ^ (p & 7))) << 2) + (j & 3);
      Th[o] = __uint_as_float(hi);
      Tl[o] = __uint_as_float(lo);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();

    // y += M u over this column tile: warpgroup rows i0 + 64 wg ..
    const int ra = i0 + 64 * wg + 16 * q4 + g, rb = ra + 8;
    if (j0 <= i0 + 64 * wg + 63) {
      const float ca = cs[ra], cb = cs[rb];
      uint32_t ah[KSUB][4], al[KSUB][4];
#pragma unroll
      for (int kk = 0; kk < KSUB; ++kk) {
        const int ja = j0 + 8 * kk + t, jb = ja + 4;
        const float* gr = gs + (64 * wg + 16 * q4 + g) * GS + 8 * kk + t;
        const float da = cs[ja], db = cs[jb];
        const float m[4] = {ja <= ra ? __expf(ca - da) * gr[0] : 0.f,
                            ja <= rb ? __expf(cb - da) * gr[8 * GS] : 0.f,
                            jb <= ra ? __expf(ca - db) * gr[4] : 0.f,
                            jb <= rb ? __expf(cb - db) * gr[8 * GS + 4] : 0.f};
        split4(m, ah[kk], al[kk]);
      }
      keep(yacc);
      keep(ah);
      keep(al);
      wgmma_fence();
      wgmma3(yacc, ah, al, th_addr, tl_addr);
      wgmma_commit();
      wgmma_wait_all();
      keep(yacc);
      keep(ah);
      keep(al);
    }

    // st^T += (w o B)^T u over this column tile, once per tile
    if (j0 >= i0 && 64 * wg < N) {
      const int n = 64 * wg + 16 * q4 + g;
      uint32_t sh[KSUB][4], sl[KSUB][4];
#pragma unroll
      for (int kk = 0; kk < KSUB; ++kk) {
        const int ka = 8 * kk + t;
        const float wa = ws[j0 + ka], wb = ws[j0 + ka + 4];
        const float* br = bs + ka * BS + n;
        const float a[4] = {wa * br[0], wa * br[8], wb * br[4 * BS],
                            wb * br[4 * BS + 8]};
        split4(a, sh[kk], sl[kk]);
      }
      keep(sacc);
      keep(sh);
      keep(sl);
      wgmma_fence();
      wgmma3(sacc, sh, sl, th_addr, tl_addr);
      wgmma_commit();
      wgmma_wait_all();
      keep(sacc);
      keep(sh);
      keep(sl);
    }

    if (In != I) {  // the row tile is done: its y rows out
#pragma unroll
      for (int nt = 0; nt < HPT / 8; ++nt) {
        const int col = 8 * nt + 2 * t;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = half ? rb : ra;
          if (i >= Q || col >= hp) continue;
          float* yo = y + ((row0 + i) * nh + h) * hp + col;
          const float v0 = yacc[4 * nt + 2 * half];
          const float v1 = yacc[4 * nt + 2 * half + 1];
          if ((hp & 1) == 0) {
            *reinterpret_cast<float2*>(yo) = make_float2(v0, v1);
          } else {
            yo[0] = v0;
            if (col + 1 < hp) yo[1] = v1;
          }
        }
        yacc[4 * nt] = yacc[4 * nt + 1] = yacc[4 * nt + 2] =
            yacc[4 * nt + 3] = 0.f;
      }
    }
    __syncthreads();  // this buffer's and u^T's reads done before refills
    I = In;
    J = Jn;
    buf ^= 1;
  }

  // st[p, n] from st^T's accumulator: rows n, columns p
  float* so = st + (bc * nh + h) * static_cast<int64_t>(hp) * N;
#pragma unroll
  for (int nt = 0; nt < HPT / 8; ++nt) {
    const int p = 8 * nt + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = 64 * wg + 16 * q4 + g + 8 * half;
      if (n >= N) continue;
      if (p < hp) so[p * N + n] = sacc[4 * nt + 2 * half];
      if (p + 1 < hp) so[(p + 1) * N + n] = sacc[4 * nt + 2 * half + 1];
    }
  }
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

template <int HPT, int MINB>
cudaError_t launch_chunk(const float* cum, const float* u, const float* B,
                         const float* G, float* y, float* st, int64_t bcs,
                         const Dims& d, cudaStream_t s) {
  const size_t bytes = sizeof(float) * (2 * HPT * TJ +
                                        2 * static_cast<size_t>(d.QP) +
                                        2 * TJ * d.US + 2 * TR * GS +
                                        2 * TJ * d.BS) + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk<HPT, MINB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  ssd_chunk<HPT, MINB><<<static_cast<unsigned>(bcs * d.nh), THREADS, bytes,
                         s>>>(cum, u, B, G, y, st, d);
  return cudaGetLastError();
}

cudaError_t launch_gram(const float* B, const float* C, float* G, int64_t bcs,
                        int Q, int N, int QP, cudaStream_t s) {
  const size_t bytes = sizeof(float) * 2 * GT * (round_up(N, 8) + 4);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_gram, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int64_t qt = QP / GT;
  ssd_gram<<<static_cast<unsigned>(bcs * qt * qt), THREADS, bytes, s>>>(
      B, C, G, Q, N, QP);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// cum [b,nc,Q,nh], u [b,nc,Q,nh,hp], B/C [b,nc,Q,N] -> y [b,nc,Q,nh,hp],
// st [b,nc,nh,hp,N]; float32, contiguous; hp <= 128, N <= 128.  gram:
// scratch of gram_len >= b*nc*QP*QP floats, QP = Q rounded up to TR,
// 16-byte aligned.
int ssd_intra_f32(const void* cum, const void* u, const void* B,
                  const void* C, void* y, void* st, int64_t b, int64_t nc,
                  int64_t Q, int64_t nh, int64_t hp, int64_t N, void* gram,
                  int64_t gram_len, void* stream) {
  if (b <= 0 || nc <= 0 || Q <= 0 || nh <= 0 || hp <= 0 || N <= 0 ||
      hp > HP_MAX || N > N_MAX || Q > (1 << 20) || !aligned16(gram))
    return static_cast<int>(cudaErrorInvalidValue);
  Dims d;
  d.Q = static_cast<int>(Q);
  d.nh = static_cast<int>(nh);
  d.hp = static_cast<int>(hp);
  d.N = static_cast<int>(N);
  d.QP = round_up(d.Q, TR);
  d.US = round_up(d.hp, 16) + 8;  // = 8 or 24 mod 32: fragment reads
  d.BS = round_up(d.N, 16) + 8;   // hit 32 banks
  d.vec_u = hp % 4 == 0 && aligned16(u);
  d.vec_b = N % 4 == 0 && aligned16(B);
  const int64_t bcs = b * nc;
  if (gram_len < bcs * d.QP * d.QP)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaError_t err = launch_gram(f(B), f(C), static_cast<float*>(gram), bcs,
                                d.Q, d.N, d.QP, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = hp <= 64
            ? launch_chunk<64, 2>(f(cum), f(u), f(B), f(gram),
                                  static_cast<float*>(y),
                                  static_cast<float*>(st), bcs, d, s)
            : launch_chunk<128, 1>(f(cum), f(u), f(B), f(gram),
                                   static_cast<float*>(y),
                                   static_cast<float*>(st), bcs, d, s);
  return static_cast<int>(err);
}

// The gram pass alone, for timing it apart: B/C [b,nc,Q,N] -> gram as
// ssd_intra_f32 fills it.
int ssd_gram_f32(const void* B, const void* C, int64_t b, int64_t nc,
                 int64_t Q, int64_t N, void* gram, int64_t gram_len,
                 void* stream) {
  const int QP = round_up(static_cast<int>(Q), TR);
  if (b <= 0 || nc <= 0 || Q <= 0 || N <= 0 || N > N_MAX ||
      Q > (1 << 20) || !aligned16(gram) || gram_len < b * nc * QP * QP)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_gram(
      static_cast<const float*>(B), static_cast<const float*>(C),
      static_cast<float*>(gram), b * nc, static_cast<int>(Q),
      static_cast<int>(N), QP, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
