// Shared device code of the flash kernels for Hopper, sm_90a: the score
// pass of B1 and B3 and the KDE pass of B5 and B6 (B2 and B4 run the
// split-column body of flash_kde_pass.cuh, which includes this header).
//
// One kernel template per pass, parameterised on the column tiles a block
// streams:
//   AllTiles   every column tile in order: the dense kernels B1 (score),
//              B5 (fused Laplace) and B6 (square moment), flash_score.cu
//              and flash_laplace.cu, and B2 (KDE, flash_kde.cu);
//   VisitList  a row tile's visit list, counts[i] entries of
//              tile_map[i, :]: the pruned kernels B3 and B4,
//              flash_pruned.cu.  The block reads its own count and tile
//              indices (the TPU scalar-prefetched them); the visit slots
//              past the count are never run.  A row tile that visits
//              nothing still writes its (zero) sums.
//
// Tiers, chosen by the operand type and whether the lo planes are given:
//   f32     Gram and phi.[X|1] in f32.
//   bf16    bf16 operands, products summed in f32; the score pass rounds
//           phi to bf16 (round to nearest even) BEFORE it multiplies [X|1].
//   bf16x2  Gram: hi.hi + hi.lo + lo.hi + lo.lo as four f32 partial sums
//           added in that order; the score pass splits phi into bf16 hi
//           and lo and runs the same four-product sum, in f32.
// Norms are inputs computed by the caller from the tier-cast operands;
// sq, exp and the accumulators are f32 at every tier.  exp is expf (full
// precision, <= 2 ulp), not __expf, so a kernel agrees with its plain
// PyTorch version to f32 summation order.
//
// Design of the two bodies here, simple first: one thread per row,
// block_m rows per block (so block_m <= kMaxRows); the row (d values, two
// planes at bf16x2) and its accumulators live in registers.  The block
// loops over its column tiles of block_n points, staged through shared
// memory as f32 (bf16 widens exactly), and every thread reads each staged
// column as float4 broadcasts.  That loop takes the place of the TPU's
// sequential inner grid axis: each output row is written once by one
// thread, no atomics, deterministic sums.  As on the TPU, a tile's terms
// go into a partial that is added to the running total once per tile: one
// f32 accumulator over all n terms would round like sqrt(n)·eps (6e-5
// against float64 at n = 32768 on an H100).  Padding is the caller's
// sentinel padding; a ragged last dense tile is masked by the loop bound.
// Coordinates past d stay zero in shared memory for the whole launch, so
// any d <= DMAX uses one instantiation.  One block per row tile leaves a
// small request on one SM walking every column; flash_kde_pass.cuh's
// body (split columns, register and tensor-core tiles, cp.async staging)
// is the redesign, so far for B2 and B4.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace flash {

constexpr int kMaxD = 64;
constexpr int kMaxRows = 256;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most one block may use

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Every column tile of an n-column set, in order.  count_at / tile_at
// take the row tile (the same for every row tile here); count / tile are
// those of the row tile blockIdx.x, for one block per row tile.
struct AllTiles {
  int n_tiles;
  __device__ __forceinline__ int count_at(int) const { return n_tiles; }
  __device__ __forceinline__ int tile_at(int, int v) const { return v; }
  __device__ __forceinline__ int count() const { return n_tiles; }
  __device__ __forceinline__ int tile(int v) const { return v; }
};

// The visit list of row tile i: counts[i] entries of tile_map[i, :].
struct VisitList {
  const int* counts;    // (mt,)
  const int* tile_map;  // (mt, max_visits)
  int max_visits;
  __device__ __forceinline__ int count_at(int i) const { return counts[i]; }
  __device__ __forceinline__ int tile_at(int i, int v) const {
    return tile_map[(size_t)i * max_visits + v];
  }
  __device__ __forceinline__ int count() const { return count_at(blockIdx.x); }
  __device__ __forceinline__ int tile(int v) const {
    return tile_at(blockIdx.x, v);
  }
};

// ---------------------------------------------------------------------------
// KDE pass: out_j = sum_i w_ji exp(-scaled_ji) over the block's column
// tiles, scaled = sq * inv2h2, with the per-pair weight w_ji one of:
// ---------------------------------------------------------------------------

enum class Weight : int {
  kOne = 0,       // w = 1: the KDE sums (B2, B4 on flash_kde_pass.cuh)
  kLaplace = 1,   // w = 1 + d/2 - scaled: fused Laplace (B5; B4's flag)
  kSqMoment = 2,  // w = sq, unscaled: the non-fused second pass (B6)
};

template <typename T, bool X2, int DMAX, Weight W, typename Tiles>
__global__ void __launch_bounds__(kMaxRows)
kde_kernel(const T* __restrict__ y, const T* __restrict__ y_lo,
           const float* __restrict__ nrm_y, const T* __restrict__ xt,
           const T* __restrict__ xt_lo, const float* __restrict__ nrm_x,
           const float* __restrict__ inv2h2_ptr, float* __restrict__ out,
           int m, int n, int d, int block_n, Tiles tiles) {
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
  const float half_d1 = 1.f + 0.5f * d;  // exact for d <= kMaxD

  for (int e = tid; e < block_n * DMAX; e += blockDim.x) {
    s_hi[e] = 0.f;
    if constexpr (X2) s_lo[e] = 0.f;
  }

  float acc = 0.f;
  const int visits = tiles.count();
  for (int v = 0; v < visits; ++v) {
    const int j0 = tiles.tile(v) * block_n;
    const int cols = min(block_n, n - j0);
    float part = 0.f;
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
      const float scaled = sq * inv2h2;
      if constexpr (W == Weight::kLaplace) {
        part += expf(-scaled) * (half_d1 - scaled);
      } else if constexpr (W == Weight::kSqMoment) {
        part += expf(-scaled) * sq;
      } else {
        part += expf(-scaled);
      }
    }
    acc += part;
  }
  if (live) out[row] = acc;
}

template <typename T, bool X2, int DMAX, Weight W, typename Tiles>
cudaError_t kde_launch(const void* y, const void* y_lo, const void* nrm_y,
                       const void* xt, const void* xt_lo, const void* nrm_x,
                       const void* inv2h2, void* out, int m, int n, int d,
                       int block_m, int block_n, Tiles tiles,
                       cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(X2 ? 2 : 1) * block_n * DMAX + block_n);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = kde_kernel<T, X2, DMAX, W, Tiles>;
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
      block_n, tiles);
  return cudaGetLastError();
}

template <typename T, bool X2, Weight W, typename Tiles>
cudaError_t kde_launch_d(const void* y, const void* y_lo, const void* nrm_y,
                         const void* xt, const void* xt_lo,
                         const void* nrm_x, const void* inv2h2, void* out,
                         int m, int n, int d, int block_m, int block_n,
                         Tiles tiles, cudaStream_t s) {
#define FLASH_KDE_LAUNCH(DM)                                              \
  return kde_launch<T, X2, DM, W, Tiles>(                                 \
      y, y_lo, nrm_y, xt, xt_lo, nrm_x, inv2h2, out, m, n, d, block_m, \
      block_n, tiles, s)
  if (d <= 4) FLASH_KDE_LAUNCH(4);
  if (d <= 8) FLASH_KDE_LAUNCH(8);
  if (d <= 16) FLASH_KDE_LAUNCH(16);
  if (d <= 32) FLASH_KDE_LAUNCH(32);
  FLASH_KDE_LAUNCH(64);
#undef FLASH_KDE_LAUNCH
}

// tier: 0 = f32, 1 = bf16, 2 = bf16x2.  Returns a cudaError_t code.
template <Weight W, typename Tiles>
cudaError_t kde_dispatch(const void* y, const void* y_lo, const void* nrm_y,
                         const void* xt, const void* xt_lo,
                         const void* nrm_x, const void* inv2h2, void* out,
                         int m, int n, int d, int tier, int block_m,
                         int block_n, Tiles tiles, void* stream) {
  if (m <= 0 || n <= 0 || d < 1 || d > kMaxD || block_m < 1 ||
      block_m > kMaxRows || block_n < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tier) {
    case 0:
      return kde_launch_d<float, false, W>(
          y, y_lo, nrm_y, xt, xt_lo, nrm_x, inv2h2, out, m, n, d, block_m,
          block_n, tiles, s);
    case 1:
      return kde_launch_d<__nv_bfloat16, false, W>(
          y, y_lo, nrm_y, xt, xt_lo, nrm_x, inv2h2, out, m, n, d, block_m,
          block_n, tiles, s);
    case 2:
      return kde_launch_d<__nv_bfloat16, true, W>(
          y, y_lo, nrm_y, xt, xt_lo, nrm_x, inv2h2, out, m, n, d, block_m,
          block_n, tiles, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Score pass: S1aug_i = sum_j phi_ij [x_j | 1] over the block's column
// tiles, phi_ij = exp(-max(|x_i|^2 + |x_j|^2 - 2 x_i.x_j, 0) * inv2h2).
// ---------------------------------------------------------------------------

// Shared-memory row widths, in floats: Gram columns hold DMAX values,
// [X|1] columns DMAX + 1, padded to a float4 multiple.
template <int DMAX>
struct Widths {
  static constexpr int kG = DMAX;
  static constexpr int kA = DMAX + 4;
};

template <typename T, bool X2, int DMAX, typename Tiles>
__global__ void __launch_bounds__(kMaxRows)
score_kernel(const T* __restrict__ x, const T* __restrict__ x_lo,
             const float* __restrict__ nrm, const T* __restrict__ xt,
             const T* __restrict__ xt_lo, const T* __restrict__ xaug,
             const T* __restrict__ xaug_lo,
             const float* __restrict__ inv2h2_ptr, float* __restrict__ out,
             int n, int d, int block_n, Tiles tiles) {
  constexpr int WG = Widths<DMAX>::kG;
  constexpr int WA = Widths<DMAX>::kA;
  constexpr int P = X2 ? 2 : 1;
  extern __shared__ float4 smem4[];
  float* s_gh = reinterpret_cast<float*>(smem4);  // [block_n][WG]
  float* s_gl = s_gh + (size_t)block_n * WG;      // (X2)
  float* s_ah = s_gh + (size_t)P * block_n * WG;  // [block_n][WA]
  float* s_al = s_ah + (size_t)block_n * WA;      // (X2)
  float* s_nrm = s_ah + (size_t)P * block_n * WA;

  const int tid = threadIdx.x;
  const int row = blockIdx.x * blockDim.x + tid;
  const bool live = row < n;
  const int w = d + 1;

  float r_hi[DMAX];
  float r_lo[X2 ? DMAX : 1];
#pragma unroll
  for (int k = 0; k < DMAX; ++k) {
    const bool in = live && k < d;
    r_hi[k] = in ? to_f32(x[(size_t)row * d + k]) : 0.f;
    if constexpr (X2) r_lo[k] = in ? to_f32(x_lo[(size_t)row * d + k]) : 0.f;
  }
  const float nrm_r = live ? nrm[row] : 0.f;
  const float inv2h2 = *inv2h2_ptr;

  // Slots past d (Gram) and past d+1 ([X|1]) stay zero for the launch.
  for (int e = tid; e < block_n * WG; e += blockDim.x) {
    s_gh[e] = 0.f;
    if constexpr (X2) s_gl[e] = 0.f;
  }
  for (int e = tid; e < block_n * WA; e += blockDim.x) {
    s_ah[e] = 0.f;
    if constexpr (X2) s_al[e] = 0.f;
  }

  float acc[DMAX + 1];
  float part[DMAX + 1];
#pragma unroll
  for (int k = 0; k <= DMAX; ++k) acc[k] = 0.f;

  const int visits = tiles.count();
  for (int v = 0; v < visits; ++v) {
    const int j0 = tiles.tile(v) * block_n;
    const int cols = min(block_n, n - j0);
#pragma unroll
    for (int k = 0; k <= DMAX; ++k) part[k] = 0.f;
    __syncthreads();
    for (int k = 0; k < d; ++k) {
      for (int c = tid; c < cols; c += blockDim.x) {
        const size_t src = (size_t)k * n + j0 + c;
        s_gh[c * WG + k] = to_f32(xt[src]);
        if constexpr (X2) s_gl[c * WG + k] = to_f32(xt_lo[src]);
      }
    }
    const size_t base = (size_t)j0 * w;
    for (int e = tid; e < cols * w; e += blockDim.x) {
      const int c = e / w;
      const int k = e - c * w;
      s_ah[c * WA + k] = to_f32(xaug[base + e]);
      if constexpr (X2) s_al[c * WA + k] = to_f32(xaug_lo[base + e]);
    }
    for (int c = tid; c < cols; c += blockDim.x) s_nrm[c] = nrm[j0 + c];
    __syncthreads();

    for (int c = 0; c < cols; ++c) {
      const float4* gh = reinterpret_cast<const float4*>(s_gh + c * WG);
      float g;
      if constexpr (X2) {
        const float4* gl = reinterpret_cast<const float4*>(s_gl + c * WG);
        float ghh = 0.f, ghl = 0.f, glh = 0.f, gll = 0.f;
#pragma unroll
        for (int q = 0; q < DMAX / 4; ++q) {
          const float4 h = gh[q], l = gl[q];
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
          const float4 h = gh[q];
          g += r_hi[4 * q] * h.x + r_hi[4 * q + 1] * h.y +
               r_hi[4 * q + 2] * h.z + r_hi[4 * q + 3] * h.w;
        }
      }
      const float sq = fmaxf(nrm_r + s_nrm[c] - 2.f * g, 0.f);
      const float phi = expf(-sq * inv2h2);

      const float* ah = s_ah + c * WA;
      const float4* ah4 = reinterpret_cast<const float4*>(ah);
      if constexpr (X2) {
        const float* al = s_al + c * WA;
        const float4* al4 = reinterpret_cast<const float4*>(al);
        const float p_hi = round_bf16(phi);
        const float p_lo = round_bf16(phi - p_hi);
#pragma unroll
        for (int q = 0; q < DMAX / 4; ++q) {
          const float4 h = ah4[q], l = al4[q];
          part[4 * q] +=
              ((p_hi * h.x + p_hi * l.x) + p_lo * h.x) + p_lo * l.x;
          part[4 * q + 1] +=
              ((p_hi * h.y + p_hi * l.y) + p_lo * h.y) + p_lo * l.y;
          part[4 * q + 2] +=
              ((p_hi * h.z + p_hi * l.z) + p_lo * h.z) + p_lo * l.z;
          part[4 * q + 3] +=
              ((p_hi * h.w + p_hi * l.w) + p_lo * h.w) + p_lo * l.w;
        }
        part[DMAX] +=
            ((p_hi * ah[DMAX] + p_hi * al[DMAX]) + p_lo * ah[DMAX]) +
            p_lo * al[DMAX];
      } else {
        // bf16 tier: phi rounded to bf16 before the product (both
        // operands of the second GEMM are bf16); f32 tier: phi as is.
        const float p = (sizeof(T) == 2) ? round_bf16(phi) : phi;
#pragma unroll
        for (int q = 0; q < DMAX / 4; ++q) {
          const float4 h = ah4[q];
          part[4 * q] += p * h.x;
          part[4 * q + 1] += p * h.y;
          part[4 * q + 2] += p * h.z;
          part[4 * q + 3] += p * h.w;
        }
        part[DMAX] += p * ah[DMAX];
      }
    }
#pragma unroll
    for (int k = 0; k <= DMAX; ++k) acc[k] += part[k];
  }
  if (live) {
#pragma unroll
    for (int k = 0; k <= DMAX; ++k)
      if (k <= d) out[(size_t)row * w + k] = acc[k];
  }
}

template <typename T, bool X2, int DMAX, typename Tiles>
cudaError_t score_launch(const void* x, const void* x_lo, const void* nrm,
                         const void* xt, const void* xt_lo, const void* xaug,
                         const void* xaug_lo, const void* inv2h2, void* out,
                         int n, int d, int block_m, int block_n, Tiles tiles,
                         cudaStream_t stream) {
  constexpr int P = X2 ? 2 : 1;
  const size_t smem =
      sizeof(float) * ((size_t)P * block_n *
                           (Widths<DMAX>::kG + Widths<DMAX>::kA) +
                       block_n);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = score_kernel<T, X2, DMAX, Tiles>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int grid = (n + block_m - 1) / block_m;
  kernel<<<grid, block_m, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(x_lo),
      static_cast<const float*>(nrm), static_cast<const T*>(xt),
      static_cast<const T*>(xt_lo), static_cast<const T*>(xaug),
      static_cast<const T*>(xaug_lo), static_cast<const float*>(inv2h2),
      static_cast<float*>(out), n, d, block_n, tiles);
  return cudaGetLastError();
}

template <typename T, bool X2, typename Tiles>
cudaError_t score_launch_d(const void* x, const void* x_lo, const void* nrm,
                           const void* xt, const void* xt_lo,
                           const void* xaug, const void* xaug_lo,
                           const void* inv2h2, void* out, int n, int d,
                           int block_m, int block_n, Tiles tiles,
                           cudaStream_t s) {
#define FLASH_SCORE_LAUNCH(DM)                                            \
  return score_launch<T, X2, DM, Tiles>(x, x_lo, nrm, xt, xt_lo, xaug,    \
                                        xaug_lo, inv2h2, out, n, d,       \
                                        block_m, block_n, tiles, s)
  if (d <= 4) FLASH_SCORE_LAUNCH(4);
  if (d <= 8) FLASH_SCORE_LAUNCH(8);
  if (d <= 16) FLASH_SCORE_LAUNCH(16);
  if (d <= 32) FLASH_SCORE_LAUNCH(32);
  FLASH_SCORE_LAUNCH(64);
#undef FLASH_SCORE_LAUNCH
}

// tier: 0 = f32, 1 = bf16, 2 = bf16x2.  Returns a cudaError_t code.
template <typename Tiles>
cudaError_t score_dispatch(const void* x, const void* x_lo, const void* nrm,
                           const void* xt, const void* xt_lo,
                           const void* xaug, const void* xaug_lo,
                           const void* inv2h2, void* out, int n, int d,
                           int tier, int block_m, int block_n, Tiles tiles,
                           void* stream) {
  if (n <= 0 || d < 1 || d > kMaxD || block_m < 1 || block_m > kMaxRows ||
      block_n < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tier) {
    case 0:
      return score_launch_d<float, false>(x, x_lo, nrm, xt, xt_lo, xaug,
                                          xaug_lo, inv2h2, out, n, d,
                                          block_m, block_n, tiles, s);
    case 1:
      return score_launch_d<__nv_bfloat16, false>(
          x, x_lo, nrm, xt, xt_lo, xaug, xaug_lo, inv2h2, out, n, d,
          block_m, block_n, tiles, s);
    case 2:
      return score_launch_d<__nv_bfloat16, true>(
          x, x_lo, nrm, xt, xt_lo, xaug, xaug_lo, inv2h2, out, n, d,
          block_m, block_n, tiles, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace flash
