// Pruned flash kernels (B3 score, B4 KDE / fused Laplace) for Hopper,
// sm_90a.
//
// Replaces: src/repro/kernels/flash_pruned.py, flash_score_pallas_pruned
// (body _make_score_kernel) and flash_kde_pallas_pruned (body
// _make_eval_kernel, with its laplace flag).
//
// Computes B1's S1aug (flash_pruned_score_launch) or B2's sums
// (flash_pruned_kde_launch; with laplace != 0 the fused Laplace sums
// sum_i phi (1 + d/2 - sq/2h^2)) over each row tile's visit list only:
// row tile i streams the column tiles tile_map[i, 0 .. counts[i]) of
// block_n points, in that order.  Rows arrive in the cluster-aligned
// layout of kernels/spatial.py, so m (n for the score pass) is a
// multiple of block_m and n a multiple of block_n.
//
// Bound on this card: operations on the VISITED pairs,
// sum_i counts[i] * block_m * block_n of them, at B1's or B2's cost per
// pair (FP32 rate for the products at the f32 tier, the SFU for exp).
// The bytes are the operands once plus the outputs, as for B1/B2; the
// counts and tile_map are (mt) and (mt, max_visits) int32.
//
// Design: flash_tiles.cuh's kernels with a VisitList in place of
// AllTiles.  One block per row tile (blockIdx.x = i, block_m threads);
// the block reads counts[i] and walks tile_map[i, k] for k < counts[i],
// staging each column tile through shared memory as the dense kernels do.
// This replaces the TPU's scalar-prefetched (mt, max_visits) grid: the
// padded visit slots are simply not run, and a row tile with no visits
// writes zeros (the TPU initialised its output at k == 0).  Each visited
// tile's terms go into a partial added to the running total, as in B1/B2.
// Cost is proportional to occupancy; blocks with short lists finish early
// and free their SM for the next row tile.

#include "flash_tiles.cuh"

// tier: 0 = f32, 1 = bf16, 2 = bf16x2.  Returns a cudaError_t code.
extern "C" int flash_pruned_kde_launch(
    const void* counts, const void* tile_map, int max_visits, const void* y,
    const void* y_lo, const void* nrm_y, const void* xt, const void* xt_lo,
    const void* nrm_x, const void* inv2h2, void* out, int m, int n, int d,
    int tier, int block_m, int block_n, int laplace, void* stream) {
  if (max_visits < 1 || block_m < 1 || block_n < 1 || m % block_m ||
      n % block_n)
    return cudaErrorInvalidValue;
  const flash::VisitList tiles{static_cast<const int*>(counts),
                               static_cast<const int*>(tile_map),
                               max_visits};
  if (laplace)
    return flash::kde_dispatch<flash::Weight::kLaplace>(
        y, y_lo, nrm_y, xt, xt_lo, nrm_x, inv2h2, out, m, n, d, tier,
        block_m, block_n, tiles, stream);
  return flash::kde_dispatch<flash::Weight::kOne>(
      y, y_lo, nrm_y, xt, xt_lo, nrm_x, inv2h2, out, m, n, d, tier, block_m,
      block_n, tiles, stream);
}

// tier: 0 = f32, 1 = bf16, 2 = bf16x2.  Returns a cudaError_t code.
extern "C" int flash_pruned_score_launch(
    const void* counts, const void* tile_map, int max_visits, const void* x,
    const void* x_lo, const void* nrm, const void* xt, const void* xt_lo,
    const void* xaug, const void* xaug_lo, const void* inv2h2, void* out,
    int n, int d, int tier, int block_m, int block_n, void* stream) {
  if (max_visits < 1 || block_m < 1 || block_n < 1 || n % block_m ||
      n % block_n)
    return cudaErrorInvalidValue;
  const flash::VisitList tiles{static_cast<const int*>(counts),
                               static_cast<const int*>(tile_map),
                               max_visits};
  return flash::score_dispatch(x, x_lo, nrm, xt, xt_lo, xaug, xaug_lo,
                               inv2h2, out, n, d, tier, block_m, block_n,
                               tiles, stream);
}

extern "C" const char* flash_pruned_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
