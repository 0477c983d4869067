// GQA flash attention (online softmax) for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention` (`_flash_kernel`) of
// src/repro/kernels/flash_attention/flash_attention.py: q [B,Sq,Hq,hd],
// k/v [B,Skv,Hkv,hd] (float32, bfloat16 or float16) -> out [B,Sq,Hq,hd] in
// q's dtype, accumulated in float32, scores scaled by 1/sqrt(hd), with
// causal and sliding-window masks.  Query row i sits at absolute position
// i + offset (the wrapper passes offset = Skv - Sq, the queries at the end
// of the kv range, as `chunked_attention` places them; offset = 0 is the
// Pallas kernel's own semantics), and keys at or past Skv are masked.
//
// Masking: masked scores are -inf and take no part in the row max; their
// probability is 0, and a rescale from a running max of -inf is 0 — the
// `isfinite` guards of `chunked_attention` (models/layers.py).  The Pallas
// kernel's finite NEG_INF = -1e30 gives the same output on every row that
// sees at least one key; a row that sees none comes out 0 here, as it does
// in `chunked_attention`.
//
// Bound on this card: operations.  The causal band at the LM path's
// prefill shape is ~69 GFLOP against ~75 MB of q/k/v/out; at 989 TFLOP/s
// (bf16) against 3.35 TB/s the FLOPs are three times the bytes.  This
// first kernel runs them as float32 FMAs on the CUDA cores (67 TFLOP/s):
// `wgmma` with TMA-fed tiles is the later redesign.
//
// Design.  The Pallas grid is (B, Hkv, q-block, kv-block) with the kv axis
// sequential and (m, l, acc) in VMEM scratch.  Here one block of 256
// threads takes (batch, kv-head, q-tile) and walks the kv tiles in a loop,
// which takes the place of the sequential fourth grid axis:
//   * the block holds R = 64 query rows: all G = Hq/Hkv heads of the group
//     times BQ = 64/G positions, so each k/v tile is loaded once per group;
//   * a kv tile of BK = 32 keys is converted to float32 into shared memory
//     (K transposed, V as is), next to the q tile (transposed);
//   * S = Q K^T: each thread a 4 x 2 register tile;
//   * the online softmax: four threads per row, reduced with shuffles; the
//     running max and sum stay in those threads' registers;
//   * acc += P V: each thread a 4 x (hd/16) register tile, rescaled by the
//     row's alpha first;
//   * kv tiles wholly outside the causal band or the window are never
//     visited; ragged query and key tails are masked in the kernel.
// Shared memory: (hd*68 + hd*36 + 32*hd + 32*68 + 128) floats, 77 KB at
// hd = 128, so two blocks share an SM.
//
// Head dims.  The kernel is instantiated twice on its head-dim ceiling
// HD_MAX, which sizes the accumulator (4 x HD_MAX/16 floats a thread):
// HD_MAX = 128 for hd <= 128 (two blocks an SM, at most 128 registers a
// thread) and HD_MAX = 256 for 128 < hd <= 256 (145 KB of shared memory
// at hd = 256, so one block an SM, and up to 255 registers a thread for
// the 64-float accumulator).  `launch` picks the instantiation from hd.
// 16-bit inputs at hd 64, 96, 128 and 256 take csrc/flash_attention_tc.cu
// instead (recurrentgemma's local attention at 256 among them); this
// kernel takes float32 at every hd and 16-bit inputs at the others.
// With G query heads per kv head a block holds BQ = 64/G positions: at
// G = 16 each kv tile serves only 4 positions, which is correct but
// leaves the products short.
//
// Plain C interface for ctypes: launches on the given stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int R = 64;          // query rows per block (G heads x BQ)
constexpr int BK = 32;         // keys per kv tile
constexpr int RP = R + 4;      // row stride of Qt and St (float4-aligned)
constexpr int BKP = BK + 4;    // row stride of Kt
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

struct Shape {
  int Sq, Skv, Hq, Hkv, hd, G, BQ, causal, window, offset;
};

template <typename T, int HD_MAX>
__global__ void __launch_bounds__(THREADS, HD_MAX <= 128 ? 2 : 1)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, Shape sh) {
  constexpr int HC = HD_MAX / 16;  // accumulator columns per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int hd = sh.hd;
  float* Qt = smem;                 // [hd][RP]   q tile, transposed
  float* Kt = Qt + hd * RP;         // [hd][BKP]  k tile, transposed
  float* Vs = Kt + hd * BKP;        // [BK][hd]   v tile
  float* St = Vs + BK * hd;         // [BK][RP]   scores, then probabilities
  float* alpha_s = St + BK * RP;    // [R]
  float* l_s = alpha_s + R;         // [R]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * sh.BQ;
  const int hk = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int rows = sh.G * sh.BQ;
  const float sq = sqrtf(static_cast<float>(hd));

  // q tile: row r is head hk*G + r/BQ at position q0 + r%BQ
  for (int e = tid; e < R * hd; e += THREADS) {
    const int r = e / hd, d = e - (e / hd) * hd;
    float x = 0.f;
    if (r < rows) {
      const int qp = q0 + r % sh.BQ;
      if (qp < sh.Sq)
        x = to_f(q[((b * sh.Sq + qp) * sh.Hq + hk * sh.G + r / sh.BQ) * hd
                   + d]);
    }
    Qt[d * RP + r] = x;
  }

  // the keys this tile's queries can see
  const int q_first = q0 + sh.offset;
  const int q_last = min(q0 + sh.BQ, sh.Sq) - 1 + sh.offset;
  const int k_end = sh.causal ? min(sh.Skv, q_last + 1) : sh.Skv;
  const int k_begin = sh.window > 0 ? max(0, q_first - (sh.window - 1)) : 0;

  // softmax role: four threads per row
  const int r2 = tid >> 2, part = tid & 3;
  const bool row_ok = r2 < rows && q0 + r2 % sh.BQ < sh.Sq;
  const int qpos = q0 + r2 % sh.BQ + sh.offset;
  float m_run = -INFINITY, l_run = 0.f;

  // product role: rows rg*4 .. rg*4+3, columns cg + 16*j
  const int rg = tid >> 4, cg = tid & 15;
  float acc[4][HC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < HC; ++j) acc[i][j] = 0.f;

  for (int kt = (k_begin / BK) * BK; kt < k_end; kt += BK) {
    __syncthreads();  // q tile stored / previous tile's reads done
    for (int e = tid; e < BK * hd; e += THREADS) {
      const int c = e / hd, d = e - (e / hd) * hd;
      const int kp = kt + c;
      float kx = 0.f, vx = 0.f;
      if (kp < sh.Skv) {
        const int64_t idx = ((b * sh.Skv + kp) * sh.Hkv + hk) * hd + d;
        kx = to_f(k[idx]);
        vx = to_f(v[idx]);
      }
      Kt[d * BKP + c] = kx;
      Vs[c * hd + d] = vx;
    }
    __syncthreads();

    // S = Q K^T / sqrt(hd)
    float s[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
    for (int d = 0; d < hd; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(Qt + d * RP + rg * 4);
      const float k0 = Kt[d * BKP + cg], k1 = Kt[d * BKP + cg + 16];
      s[0][0] = fmaf(qa.x, k0, s[0][0]); s[0][1] = fmaf(qa.x, k1, s[0][1]);
      s[1][0] = fmaf(qa.y, k0, s[1][0]); s[1][1] = fmaf(qa.y, k1, s[1][1]);
      s[2][0] = fmaf(qa.z, k0, s[2][0]); s[2][1] = fmaf(qa.z, k1, s[2][1]);
      s[3][0] = fmaf(qa.w, k0, s[3][0]); s[3][1] = fmaf(qa.w, k1, s[3][1]);
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
      *reinterpret_cast<float4*>(St + (cg + 16 * jj) * RP + rg * 4) =
          make_float4(s[0][jj] / sq, s[1][jj] / sq, s[2][jj] / sq,
                      s[3][jj] / sq);
    __syncthreads();

    // online softmax over this tile, row r2, keys j*4 + part
    {
      float sv[BK / 4];
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 4; ++j) {
        const int c = j * 4 + part, kp = kt + c;
        const bool ok = row_ok && kp < sh.Skv &&
                        (!sh.causal || qpos >= kp) &&
                        (sh.window <= 0 || qpos - kp < sh.window);
        sv[j] = ok ? St[c * RP + r2] : -INFINITY;
        mt = fmaxf(mt, sv[j]);
      }
      mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 2));
      const float m_new = fmaxf(m_run, mt);
      float alpha = 1.f, psum = 0.f;
      if (m_new != -INFINITY)
        alpha = (m_run == -INFINITY) ? 0.f : expf(m_run - m_new);
#pragma unroll
      for (int j = 0; j < BK / 4; ++j) {
        const float p = (sv[j] == -INFINITY) ? 0.f : expf(sv[j] - m_new);
        St[(j * 4 + part) * RP + r2] = p;
        psum += p;
      }
      psum += __shfl_xor_sync(FULL, psum, 1);
      psum += __shfl_xor_sync(FULL, psum, 2);
      l_run = l_run * alpha + psum;
      m_run = m_new;
      if (part == 0) alpha_s[r2] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = alpha_s[rg * 4 + i];
#pragma unroll
      for (int j = 0; j < HC; ++j) acc[i][j] *= a;
    }
    for (int c = 0; c < BK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(St + c * RP + rg * 4);
#pragma unroll
      for (int j = 0; j < HC; ++j) {
        const int col = cg + 16 * j;
        if (col < hd) {
          const float vx = Vs[c * hd + col];
          acc[0][j] = fmaf(pa.x, vx, acc[0][j]);
          acc[1][j] = fmaf(pa.y, vx, acc[1][j]);
          acc[2][j] = fmaf(pa.z, vx, acc[2][j]);
          acc[3][j] = fmaf(pa.w, vx, acc[3][j]);
        }
      }
    }
  }

  if (part == 0) l_s[r2] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i;
    if (r >= rows) continue;
    const int qp = q0 + r % sh.BQ;
    if (qp >= sh.Sq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    T* o = out + ((b * sh.Sq + qp) * sh.Hq + hk * sh.G + r / sh.BQ) * hd;
#pragma unroll
    for (int j = 0; j < HC; ++j) {
      const int col = cg + 16 * j;
      if (col < hd) o[col] = from_f<T>(acc[i][j] / l);
    }
  }
}

template <typename T, int HD_MAX>
int launch_hd(const void* q, const void* k, const void* v, void* out,
              const Shape& sh, int64_t B, void* stream) {
  const int hd = sh.hd;
  const size_t bytes =
      sizeof(float) * (hd * RP + hd * BKP + BK * hd + BK * RP + 2 * R);
  const cudaError_t set = cudaFuncSetAttribute(
      flash_kernel<T, HD_MAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(static_cast<unsigned>((sh.Sq + sh.BQ - 1) / sh.BQ),
                  static_cast<unsigned>(sh.Hkv), static_cast<unsigned>(B));
  flash_kernel<T, HD_MAX>
      <<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(out), sh);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int64_t B,
           int64_t Sq, int64_t Skv, int64_t Hq, int64_t Hkv, int64_t hd,
           int64_t causal, int64_t window, int64_t offset, void* stream) {
  if (B <= 0 || Sq <= 0 || Hq <= 0 || Hkv <= 0 || hd <= 0 || hd > 256 ||
      hd % 4 != 0 || Hq % Hkv != 0 || Hq / Hkv > R)
    return static_cast<int>(cudaErrorInvalidValue);
  Shape sh;
  sh.Sq = static_cast<int>(Sq);
  sh.Skv = static_cast<int>(Skv);
  sh.Hq = static_cast<int>(Hq);
  sh.Hkv = static_cast<int>(Hkv);
  sh.hd = static_cast<int>(hd);
  sh.G = static_cast<int>(Hq / Hkv);
  sh.BQ = R / sh.G;
  sh.causal = causal ? 1 : 0;
  sh.window = static_cast<int>(window);
  sh.offset = static_cast<int>(offset);
  return hd <= 128 ? launch_hd<T, 128>(q, k, v, out, sh, B, stream)
                   : launch_hd<T, 256>(q, k, v, out, sh, B, stream);
}

}  // namespace

extern "C" {

// q [B,Sq,Hq,hd], k/v [B,Skv,Hkv,hd], out [B,Sq,Hq,hd], all contiguous and
// of one dtype; hd <= 256 and a multiple of 4, Hq/Hkv <= 64.
int flash_attention_f32(const void* q, const void* k, const void* v,
                        void* out, int64_t B, int64_t Sq, int64_t Skv,
                        int64_t Hq, int64_t Hkv, int64_t hd, int64_t causal,
                        int64_t window, int64_t offset, void* stream) {
  return launch<float>(q, k, v, out, B, Sq, Skv, Hq, Hkv, hd, causal, window,
                       offset, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, int64_t B, int64_t Sq, int64_t Skv,
                         int64_t Hq, int64_t Hkv, int64_t hd, int64_t causal,
                         int64_t window, int64_t offset, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, Hq, Hkv, hd, causal,
                               window, offset, stream);
}

int flash_attention_f16(const void* q, const void* k, const void* v,
                        void* out, int64_t B, int64_t Sq, int64_t Skv,
                        int64_t Hq, int64_t Hkv, int64_t hd, int64_t causal,
                        int64_t window, int64_t offset, void* stream) {
  return launch<__half>(q, k, v, out, B, Sq, Skv, Hq, Hkv, hd, causal, window,
                        offset, stream);
}

}  // extern "C"
