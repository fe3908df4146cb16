// Shared device code of the flash kernels for Hopper, sm_90a: the tile
// sets, the tiers' conventions, and the one-thread-per-row KDE-pass body
// that B5 and B6 still run (flash_laplace.cu).  B2 and B4 run the
// split-column KDE-pass body of flash_kde_pass.cuh, B1 and B3 the
// split-column score-pass body of flash_score_pass.cuh; both include
// this header.
//
// The bodies are parameterised on the column tiles a block streams:
//   AllTiles   every column tile in order: the dense kernels B1 (score),
//              B2 (KDE), B5 (fused Laplace) and B6 (square moment),
//              flash_score.cu, flash_kde.cu and flash_laplace.cu;
//   VisitList  a row tile's visit list, counts[i] entries of
//              tile_map[i, :]: the pruned kernels B3 and B4,
//              flash_pruned.cu.  A block reads its own count and tile
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
// kde_kernel, simple first: one thread per row, block_m rows per block
// (so block_m <= kMaxRows); the row (d values, two planes at bf16x2)
// and its accumulator live in registers.  The block loops over its
// column tiles of block_n points, staged through shared memory as f32
// (bf16 widens exactly), and every thread reads each staged column as
// float4 broadcasts.  That loop takes the place of the TPU's sequential
// inner grid axis: each output row is written once by one thread, no
// atomics, deterministic sums.  As on the TPU, a tile's terms go into a
// partial that is added to the running total once per tile: one f32
// accumulator over all n terms would round like sqrt(n)·eps (6e-5
// against float64 at n = 32768 on an H100).  Padding is the caller's
// sentinel padding; a ragged last dense tile is masked by the loop
// bound.  Coordinates past d stay zero in shared memory for the whole
// launch, so any d <= DMAX uses one instantiation.  One block per row
// tile leaves a small request on one SM walking every column; the
// split-column bodies are the redesign, which B5 and B6 have not had yet.

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

// Every column tile of an n-column set, in order.  count_at / tile_at
// take the row tile (the same for every row tile here); count / tile
// serve kde_kernel (B5, B6), whose block is one row tile.
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

}  // namespace flash
