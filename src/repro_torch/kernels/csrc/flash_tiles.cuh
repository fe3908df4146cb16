// Shared device code of the flash kernels for Hopper, sm_90a: the tile
// sets, the KDE pass's weights and the tiers' conventions.  It holds no
// kernel body: B2, B4, B5 and B6 run the split-column KDE-pass body of
// flash_kde_pass.cuh, B1 and B3 the split-column score-pass body of
// flash_score_pass.cuh; both include this header.
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
//   f32     Gram and phi.[X|1] in f32: the KDE pass on FP32 FMAs, the
//           score pass on the tensor cores as six bf16 products of three
//           exact planes a side (no TF32).
//   bf16    bf16 operands, products summed in f32; the score pass rounds
//           phi to bf16 (round to nearest even) BEFORE it multiplies [X|1].
//   bf16x2  Gram: hi.hi + hi.lo + lo.hi + lo.lo as four f32 partial sums
//           added in that order; the score pass splits phi into bf16 hi
//           and lo and runs the same four-product sum, in f32.
// Norms are inputs computed by the caller from the tier-cast operands;
// sq, exp and the accumulators are f32 at every tier.  exp is expf (full
// precision, <= 2 ulp), not __expf, so a kernel agrees with its plain
// PyTorch version to f32 summation order.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace flash {

constexpr int kMaxD = 64;
constexpr int kMaxRows = 256;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most one block may use

// Every column tile of an n-column set, in order.  count_at / tile_at
// take the row tile (the same for every row tile here).
struct AllTiles {
  int n_tiles;
  __device__ __forceinline__ int count_at(int) const { return n_tiles; }
  __device__ __forceinline__ int tile_at(int, int v) const { return v; }
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
  kOne = 0,       // w = 1: the KDE sums (B2, B4)
  kLaplace = 1,   // w = 1 + d/2 - scaled: fused Laplace (B5; B4's flag)
  kSqMoment = 2,  // w = sq, unscaled: the non-fused second pass (B6)
};

}  // namespace flash
