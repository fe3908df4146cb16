// Flash KDE pass (kernel B2) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/flash_kde.py, flash_kde_pallas (bodies
// _kde_kernel and _kde_kernel_x2).
//
// Computes the unnormalized Gaussian kernel sums at query rows
//     out_j = sum_i exp(-max(|y_j|^2 + |x_i|^2 - 2 y_j.x_i, 0) * inv2h2)
// for y (m, d) against the train columns xt (d, n).  Norms are inputs,
// computed by the caller from the tier-cast operands.
//
// Tiers, chosen by the operand type and whether the lo planes are given:
//   f32     y, xt float;                   Gram in f32.
//   bf16    y, xt bf16;                    bf16 products, summed in f32.
//   bf16x2  y, xt bf16 hi plus bf16 lo;    g = hi.hi + hi.lo + lo.hi + lo.lo,
//                                          four f32 partial sums added in
//                                          that order.
// Norms, sq, exp and the accumulator are f32 at every tier.  exp is expf
// (full precision, <= 2 ulp), not __expf, so the kernel agrees with its
// plain PyTorch version to f32 summation order (bar: rtol 1e-5 plus
// 1e-6 of the peak).
//
// Bound on this card: operations.  Per (query, train) pair the kernel
// does 2d flops of Gram, a few of distance, one exp and one add, on a
// few bytes per pair that stay in shared memory; the bytes it must move
// (the operands once, the sums once) are a few MB.  At d = 16 the f32
// tier's floor is the FP32 rate (67 TFLOP/s), the exp floor is the SFU
// rate (16 per clock per SM).
//
// Design, simple first: one thread per query row, block_m rows per
// block.  The row and its accumulator live in registers.  The block
// loops over ALL column tiles of block_n train points, staged through
// shared memory as f32 (bf16 converts exactly), and every thread reads
// each staged column as float4 broadcasts, so one shared load feeds
// four FMAs.  The loop over column tiles inside one block replaces the
// TPU's sequential inner grid axis: each output is written once by one
// thread, with no atomics, so sums are deterministic.  As on the TPU, a
// tile's terms are summed into a partial that is then added to the
// running total: one f32 accumulator over all n terms would round like
// sqrt(n)·eps (6e-5 against float64 at n = 32768 on an H100, 20x the
// plain path's error).  Padded rows and
// columns follow the caller's sentinel padding; a ragged last tile is
// masked by the loop bound.  Later work: wgmma Gram tiles, TMA staging,
// and split-column parallelism for small query batches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxD = 64;
constexpr int kMaxRows = 256;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most one block may use

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, bool X2, int DMAX>
__global__ void __launch_bounds__(kMaxRows)
kde_kernel(const T* __restrict__ y, const T* __restrict__ y_lo,
           const float* __restrict__ nrm_y, const T* __restrict__ xt,
           const T* __restrict__ xt_lo, const float* __restrict__ nrm_x,
           const float* __restrict__ inv2h2_ptr, float* __restrict__ out,
           int m, int n, int d, int block_n) {
  extern __shared__ float4 smem4[];
  float* s_hi = reinterpret_cast<float*>(smem4);     // [block_n][DMAX]
  float* s_lo = s_hi + (size_t)block_n * DMAX;       // [block_n][DMAX] (X2)
  float* s_nrm = s_hi + (size_t)(X2 ? 2 : 1) * block_n * DMAX;

  const int tid = threadIdx.x;
  const int row = blockIdx.x * blockDim.x + tid;
  const bool live = row < m;

  float r_hi[DMAX];
  float r_lo[X2 ? DMAX : 1];
#pragma unroll
  for (int k = 0; k < DMAX; ++k) {
    const bool in = live && k < d;
    r_hi[k] = in ? to_f32(y[(size_t)row * d + k]) : 0.f;
    if constexpr (X2) r_lo[k] = in ? to_f32(y_lo[(size_t)row * d + k]) : 0.f;
  }
  const float nrm_r = live ? nrm_y[row] : 0.f;
  const float inv2h2 = *inv2h2_ptr;

  // Coordinates past d stay zero for the whole launch: they add nothing.
  for (int e = tid; e < block_n * DMAX; e += blockDim.x) {
    s_hi[e] = 0.f;
    if constexpr (X2) s_lo[e] = 0.f;
  }

  float acc = 0.f;
  for (int j0 = 0; j0 < n; j0 += block_n) {
    float part = 0.f;
    const int cols = min(block_n, n - j0);
    __syncthreads();
    for (int k = 0; k < d; ++k) {
      for (int c = tid; c < cols; c += blockDim.x) {
        const size_t src = (size_t)k * n + j0 + c;
        s_hi[c * DMAX + k] = to_f32(xt[src]);
        if constexpr (X2) s_lo[c * DMAX + k] = to_f32(xt_lo[src]);
      }
    }
    for (int c = tid; c < cols; c += blockDim.x) s_nrm[c] = nrm_x[j0 + c];
    __syncthreads();

    for (int c = 0; c < cols; ++c) {
      const float4* ch = reinterpret_cast<const float4*>(s_hi + c * DMAX);
      float g;
      if constexpr (X2) {
        const float4* cl = reinterpret_cast<const float4*>(s_lo + c * DMAX);
        float ghh = 0.f, ghl = 0.f, glh = 0.f, gll = 0.f;
#pragma unroll
        for (int q = 0; q < DMAX / 4; ++q) {
          const float4 h = ch[q], l = cl[q];
          ghh += r_hi[4 * q] * h.x + r_hi[4 * q + 1] * h.y +
                 r_hi[4 * q + 2] * h.z + r_hi[4 * q + 3] * h.w;
          ghl += r_hi[4 * q] * l.x + r_hi[4 * q + 1] * l.y +
                 r_hi[4 * q + 2] * l.z + r_hi[4 * q + 3] * l.w;
          glh += r_lo[4 * q] * h.x + r_lo[4 * q + 1] * h.y +
                 r_lo[4 * q + 2] * h.z + r_lo[4 * q + 3] * h.w;
          gll += r_lo[4 * q] * l.x + r_lo[4 * q + 1] * l.y +
                 r_lo[4 * q + 2] * l.z + r_lo[4 * q + 3] * l.w;
        }
        g = ((ghh + ghl) + glh) + gll;
      } else {
        g = 0.f;
#pragma unroll
        for (int q = 0; q < DMAX / 4; ++q) {
          const float4 h = ch[q];
          g += r_hi[4 * q] * h.x + r_hi[4 * q + 1] * h.y +
               r_hi[4 * q + 2] * h.z + r_hi[4 * q + 3] * h.w;
        }
      }
      const float sq = fmaxf(nrm_r + s_nrm[c] - 2.f * g, 0.f);
      part += expf(-sq * inv2h2);
    }
    acc += part;
  }
  if (live) out[row] = acc;
}

template <typename T, bool X2, int DMAX>
cudaError_t launch(const void* y, const void* y_lo, const void* nrm_y,
                   const void* xt, const void* xt_lo, const void* nrm_x,
                   const void* inv2h2, void* out, int m, int n, int d,
                   int block_m, int block_n, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(X2 ? 2 : 1) * block_n * DMAX + block_n);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = kde_kernel<T, X2, DMAX>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int grid = (m + block_m - 1) / block_m;
  kernel<<<grid, block_m, smem, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(y_lo),
      static_cast<const float*>(nrm_y), static_cast<const T*>(xt),
      static_cast<const T*>(xt_lo), static_cast<const float*>(nrm_x),
      static_cast<const float*>(inv2h2), static_cast<float*>(out), m, n, d,
      block_n);
  return cudaGetLastError();
}

template <typename T, bool X2>
cudaError_t launch_d(const void* y, const void* y_lo, const void* nrm_y,
                     const void* xt, const void* xt_lo, const void* nrm_x,
                     const void* inv2h2, void* out, int m, int n, int d,
                     int block_m, int block_n, cudaStream_t s) {
#define KDE_LAUNCH(DM)                                                      \
  return launch<T, X2, DM>(y, y_lo, nrm_y, xt, xt_lo, nrm_x, inv2h2, out, \
                           m, n, d, block_m, block_n, s)
  if (d <= 4) KDE_LAUNCH(4);
  if (d <= 8) KDE_LAUNCH(8);
  if (d <= 16) KDE_LAUNCH(16);
  if (d <= 32) KDE_LAUNCH(32);
  KDE_LAUNCH(64);
#undef KDE_LAUNCH
}

}  // namespace

// tier: 0 = f32, 1 = bf16, 2 = bf16x2.  Returns a cudaError_t code.
extern "C" int flash_kde_launch(const void* y, const void* y_lo,
                                const void* nrm_y, const void* xt,
                                const void* xt_lo, const void* nrm_x,
                                const void* inv2h2, void* out, int m, int n,
                                int d, int tier, int block_m, int block_n,
                                void* stream) {
  if (m <= 0 || n <= 0 || d < 1 || d > kMaxD || block_m < 1 ||
      block_m > kMaxRows || block_n < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tier) {
    case 0:
      return launch_d<float, false>(y, y_lo, nrm_y, xt, xt_lo, nrm_x, inv2h2,
                                    out, m, n, d, block_m, block_n, s);
    case 1:
      return launch_d<__nv_bfloat16, false>(y, y_lo, nrm_y, xt, xt_lo,
                                            nrm_x, inv2h2, out, m, n, d,
                                            block_m, block_n, s);
    case 2:
      return launch_d<__nv_bfloat16, true>(y, y_lo, nrm_y, xt, xt_lo, nrm_x,
                                           inv2h2, out, m, n, d, block_m,
                                           block_n, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_kde_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
