// Mamba-2 SSD intra-chunk term for Hopper (sm_90a).
//
// Replaces the TPU kernel `ssd_intra` (`_ssd_intra_kernel`) of
// src/repro/kernels/ssd/ssd.py.  Per (batch b, chunk c, head h), float32:
//   y[i]  = sum_{j<=i} exp(cum[i] - cum[j]) (C[i] . B[j]) u[j]     [Q, hp]
//   st    = sum_j exp(cum[Q-1] - cum[j]) u[j] (x) B[j]            [hp, N]
// with cum [b,nc,Q,nh], u [b,nc,Q,nh,hp], B/C [b,nc,Q,N] in, and y
// [b,nc,Q,nh,hp], st [b,nc,nh,hp,N] out.
//
// The Pallas kernel holds the whole [Q, Q] gram of a chunk in VMEM (256
// KiB at Q = 256), more than the 227 KB of shared memory a Hopper block
// can have.  So `ssd_rows_kernel` tiles the rows: one block per (b, c, h,
// 64-row tile) keeps the tile's C rows in shared memory and walks the B/u
// rows j in tiles of 32, visiting only tiles with j <= i; per tile it
// forms the gram entries C_i . B_j in registers, scales them by the decay
// exp(cum_i - cum_j) computed in place (0 above the diagonal), and
// accumulates M u into a 4 x (hp/16) register tile per thread.  The state
// is its own small product: `ssd_state_kernel`, one block per (b, c, h),
// accumulates the decay-weighted u^T B over the chunk's Q rows.
//
// Bound on this card: operations.  At the LM path's prefill shape (b=2,
// nc=8, Q=256, nh=64, hp=64, N=128) the work the function needs is ~8.7
// GFLOP (the causal half of M u, the state product, the gram once per
// (b, c)) against ~173 MB of inputs and outputs: 0.13 ms at the float32
// rate without tensor cores (67 TFLOP/s), 0.05 ms for the bytes.  The
// kernel runs float32 FMAs on the CUDA cores, as the function is float32.
//
// Like the Pallas kernel, this one recomputes the gram C . B^T for every
// head although it depends on (b, c) only (nh = 64 times the gram's FLOPs
// at mamba2-1.3b's width): sharing it across heads is the first thing a
// redesign saves, then tensor cores (TF32 or split-bf16) for both
// products.
//
// Plain C interface for ctypes: launches both kernels on the given stream
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TR = 64;          // rows i per block
constexpr int TJ = 32;          // rows j per tile
constexpr int RP = TR + 4;      // row stride of Ct and Mt (float4-aligned)
constexpr int TJP = TJ + 4;     // row stride of Bt
constexpr int HP_MAX = 128;
constexpr int N_MAX = 128;
constexpr int HC = HP_MAX / 16;  // y columns per thread
constexpr int NC = N_MAX / 16;   // state columns per thread

struct Dims {
  int Q, nh, hp, N;
};

__global__ void __launch_bounds__(THREADS)
ssd_rows_kernel(const float* __restrict__ cum, const float* __restrict__ u,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                float* __restrict__ y, Dims d) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Q = d.Q, nh = d.nh, hp = d.hp, N = d.N;
  float* Ct = smem;               // [N][RP]   C rows of the tile, transposed
  float* Bt = Ct + N * RP;        // [N][TJP]  B rows of the j tile, transposed
  float* Us = Bt + N * TJP;       // [TJ][hp]  u rows of the j tile
  float* Mt = Us + TJ * hp;       // [TJ][RP]  decayed gram, transposed
  float* cs = Mt + TJ * RP;       // [Q]       cum of this head

  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * TR;
  const int h = blockIdx.y;
  const int64_t bc = blockIdx.z;  // b * nc + c
  const int64_t row0 = bc * Q;

  for (int q = tid; q < Q; q += THREADS) cs[q] = cum[(row0 + q) * nh + h];
  for (int e = tid; e < TR * N; e += THREADS) {
    const int r = e / N, n = e - (e / N) * N;
    Ct[n * RP + r] = (i0 + r < Q) ? Cm[(row0 + i0 + r) * N + n] : 0.f;
  }

  const int rg = tid >> 4, cg = tid & 15;
  float acc[4][HC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < HC; ++j) acc[i][j] = 0.f;

  const int j_end = min(Q, i0 + TR);  // rows j <= the tile's last row
  for (int j0 = 0; j0 < j_end; j0 += TJ) {
    __syncthreads();  // C tile and cum stored / previous tile's reads done
    for (int e = tid; e < TJ * N; e += THREADS) {
      const int c = e / N, n = e - (e / N) * N;
      Bt[n * TJP + c] = (j0 + c < Q) ? Bm[(row0 + j0 + c) * N + n] : 0.f;
    }
    for (int e = tid; e < TJ * hp; e += THREADS) {
      const int c = e / hp, p = e - (e / hp) * hp;
      Us[c * hp + p] =
          (j0 + c < Q) ? u[((row0 + j0 + c) * nh + h) * hp + p] : 0.f;
    }
    __syncthreads();

    // gram entries C_i . B_j, rows rg*4.., columns cg and cg + 16
    float g[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
    for (int n = 0; n < N; ++n) {
      const float4 ca = *reinterpret_cast<const float4*>(Ct + n * RP + rg * 4);
      const float b0 = Bt[n * TJP + cg], b1 = Bt[n * TJP + cg + 16];
      g[0][0] = fmaf(ca.x, b0, g[0][0]); g[0][1] = fmaf(ca.x, b1, g[0][1]);
      g[1][0] = fmaf(ca.y, b0, g[1][0]); g[1][1] = fmaf(ca.y, b1, g[1][1]);
      g[2][0] = fmaf(ca.z, b0, g[2][0]); g[2][1] = fmaf(ca.z, b1, g[2][1]);
      g[3][0] = fmaf(ca.w, b0, g[3][0]); g[3][1] = fmaf(ca.w, b1, g[3][1]);
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int c = cg + 16 * jj, j = j0 + c;
      float m[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + rg * 4 + r;
        m[r] = (i < Q && j <= i) ? expf(cs[i] - cs[j]) * g[r][jj] : 0.f;
      }
      *reinterpret_cast<float4*>(Mt + c * RP + rg * 4) =
          make_float4(m[0], m[1], m[2], m[3]);
    }
    __syncthreads();

    // y += M u
    for (int c = 0; c < TJ; ++c) {
      const float4 ma = *reinterpret_cast<const float4*>(Mt + c * RP + rg * 4);
#pragma unroll
      for (int j = 0; j < HC; ++j) {
        const int col = cg + 16 * j;
        if (col < hp) {
          const float ux = Us[c * hp + col];
          acc[0][j] = fmaf(ma.x, ux, acc[0][j]);
          acc[1][j] = fmaf(ma.y, ux, acc[1][j]);
          acc[2][j] = fmaf(ma.z, ux, acc[2][j]);
          acc[3][j] = fmaf(ma.w, ux, acc[3][j]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + rg * 4 + r;
    if (i >= Q) continue;
    float* yo = y + ((row0 + i) * nh + h) * hp;
#pragma unroll
    for (int j = 0; j < HC; ++j) {
      const int col = cg + 16 * j;
      if (col < hp) yo[col] = acc[r][j];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
ssd_state_kernel(const float* __restrict__ cum, const float* __restrict__ u,
                 const float* __restrict__ Bm, float* __restrict__ st,
                 Dims d) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Q = d.Q, nh = d.nh, hp = d.hp, N = d.N;
  float* Ws = smem;               // [TJ][hp]  exp(cum_end - cum_j) u_j
  float* Bs = Ws + TJ * hp;       // [TJ][N]   B_j
  float* cs = Bs + TJ * N;        // [Q]

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int64_t bc = blockIdx.y;
  const int64_t row0 = bc * Q;
  for (int q = tid; q < Q; q += THREADS) cs[q] = cum[(row0 + q) * nh + h];

  // outputs p = pg + 16*a, n = ng + 16*b
  const int pg = tid >> 4, ng = tid & 15;
  float acc[HC][NC];
#pragma unroll
  for (int a = 0; a < HC; ++a)
#pragma unroll
    for (int b = 0; b < NC; ++b) acc[a][b] = 0.f;

  for (int j0 = 0; j0 < Q; j0 += TJ) {
    __syncthreads();  // cum stored / previous tile's reads done
    for (int e = tid; e < TJ * hp; e += THREADS) {
      const int c = e / hp, p = e - (e / hp) * hp, j = j0 + c;
      Ws[c * hp + p] = (j < Q) ? expf(cs[Q - 1] - cs[j]) *
                                     u[((row0 + j) * nh + h) * hp + p]
                               : 0.f;
    }
    for (int e = tid; e < TJ * N; e += THREADS) {
      const int c = e / N, n = e - (e / N) * N;
      Bs[c * N + n] = (j0 + c < Q) ? Bm[(row0 + j0 + c) * N + n] : 0.f;
    }
    __syncthreads();
    for (int c = 0; c < TJ; ++c) {
#pragma unroll
      for (int a = 0; a < HC; ++a) {
        const int p = pg + 16 * a;
        if (p >= hp) continue;
        const float w = Ws[c * hp + p];
#pragma unroll
        for (int b = 0; b < NC; ++b) {
          const int n = ng + 16 * b;
          if (n < N) acc[a][b] = fmaf(w, Bs[c * N + n], acc[a][b]);
        }
      }
    }
  }

  float* so = st + (bc * nh + h) * static_cast<int64_t>(hp) * N;
#pragma unroll
  for (int a = 0; a < HC; ++a) {
    const int p = pg + 16 * a;
    if (p >= hp) continue;
#pragma unroll
    for (int b = 0; b < NC; ++b) {
      const int n = ng + 16 * b;
      if (n < N) so[p * N + n] = acc[a][b];
    }
  }
}

}  // namespace

extern "C" {

// cum [b,nc,Q,nh], u [b,nc,Q,nh,hp], B/C [b,nc,Q,N] -> y [b,nc,Q,nh,hp],
// st [b,nc,nh,hp,N]; float32, contiguous; hp <= 128, N <= 128.
int ssd_intra_f32(const void* cum, const void* u, const void* B,
                  const void* C, void* y, void* st, int64_t b, int64_t nc,
                  int64_t Q, int64_t nh, int64_t hp, int64_t N,
                  void* stream) {
  if (b <= 0 || nc <= 0 || Q <= 0 || nh <= 0 || hp <= 0 || N <= 0 ||
      hp > HP_MAX || N > N_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  Dims d;
  d.Q = static_cast<int>(Q);
  d.nh = static_cast<int>(nh);
  d.hp = static_cast<int>(hp);
  d.N = static_cast<int>(N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  const size_t rows_bytes =
      sizeof(float) * (N * RP + N * TJP + TJ * hp + TJ * RP + Q);
  cudaFuncSetAttribute(ssd_rows_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(rows_bytes));
  const dim3 rgrid(static_cast<unsigned>((Q + TR - 1) / TR),
                   static_cast<unsigned>(nh), static_cast<unsigned>(b * nc));
  ssd_rows_kernel<<<rgrid, THREADS, rows_bytes, s>>>(
      static_cast<const float*>(cum), static_cast<const float*>(u),
      static_cast<const float*>(B), static_cast<const float*>(C),
      static_cast<float*>(y), d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t st_bytes = sizeof(float) * (TJ * hp + TJ * N + Q);
  cudaFuncSetAttribute(ssd_state_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(st_bytes));
  const dim3 sgrid(static_cast<unsigned>(nh), static_cast<unsigned>(b * nc));
  ssd_state_kernel<<<sgrid, THREADS, st_bytes, s>>>(
      static_cast<const float*>(cum), static_cast<const float*>(u),
      static_cast<const float*>(B), static_cast<float*>(st), d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
