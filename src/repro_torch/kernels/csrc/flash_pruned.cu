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
// pair.  For B4 at the main shape (32768 x 32768 x 16, h 0.78): the FP32
// rate at the f32 tier, the SFU's exp at the bf16 tiers (B2's 0.577 and
// 0.257 ms times the occupancy).  The bytes are the operands once plus
// the outputs, as for B1/B2; the counts and tile_map are (mt) and
// (mt, max_visits) int32.
//
// Design: the split-column bodies, flash_kde_pass.cuh (B4) and
// flash_score_pass.cuh (B3), with a VisitList: block (b, s) takes 64
// rows of row tile i and visit slots [s * per_split, (s + 1) * per_split)
// of its list, reads counts[i] and the tile indices itself (the TPU
// scalar-prefetched them), one slot ahead of the copies that need them,
// stages the visited tiles with cp.async and writes partial sums; a
// block whose slots start past counts[i] writes zeros, so a row tile
// with no visits sums to zero and the longest list is walked by many
// blocks at once.  The second pass adds the splits in order (no
// atomics).

#include "flash_kde_pass.cuh"
#include "flash_score_pass.cuh"

// tier: 0 = f32, 1 = bf16, 2 = bf16x2.  part is the (splits, m) f32
// scratch; the splits of per_split slots cover the max_visits slots.
// Returns a cudaError_t code.
extern "C" int flash_pruned_kde_launch(
    const void* counts, const void* tile_map, int max_visits, const void* y,
    const void* y_lo, const void* nrm_y, const void* xt, const void* xt_lo,
    const void* nrm_x, const void* inv2h2, void* part, void* out, int m,
    int n, int d, int tier, int block_m, int block_n, int laplace,
    int per_split, int splits, void* stream) {
  if (max_visits < 1 || block_m < 1 || block_n < 1 || m % block_m ||
      n % block_n || per_split < 1 ||
      (long long)splits * per_split < max_visits ||
      (long long)(splits - 1) * per_split >= max_visits)
    return cudaErrorInvalidValue;
  const flash::VisitList tiles{static_cast<const int*>(counts),
                               static_cast<const int*>(tile_map),
                               max_visits};
  if (laplace)
    return flash::kde_pass_dispatch<flash::Weight::kLaplace>(
        y, y_lo, nrm_y, xt, xt_lo, nrm_x, inv2h2, part, out, m, n, d, tier,
        block_m, block_n, per_split, splits, tiles, stream);
  return flash::kde_pass_dispatch<flash::Weight::kOne>(
      y, y_lo, nrm_y, xt, xt_lo, nrm_x, inv2h2, part, out, m, n, d, tier,
      block_m, block_n, per_split, splits, tiles, stream);
}

// tier: 0 = f32, 1 = bf16, 2 = bf16x2.  part is the (splits, n, d+1)
// f32 scratch (unused, may be null, with one split); the splits of
// per_split slots cover the max_visits slots.  Returns a cudaError_t
// code.
extern "C" int flash_pruned_score_launch(
    const void* counts, const void* tile_map, int max_visits, const void* x,
    const void* x_lo, const void* nrm, const void* xt, const void* xt_lo,
    const void* xaug, const void* xaug_lo, const void* inv2h2, void* part,
    void* out, int n, int d, int tier, int block_m, int block_n,
    int per_split, int splits, void* stream) {
  if (max_visits < 1 || block_m < 1 || block_n < 1 || n % block_m ||
      n % block_n || per_split < 1 ||
      (long long)splits * per_split < max_visits ||
      (long long)(splits - 1) * per_split >= max_visits)
    return cudaErrorInvalidValue;
  const flash::VisitList tiles{static_cast<const int*>(counts),
                               static_cast<const int*>(tile_map),
                               max_visits};
  // the square pass: rows and columns are the one train set
  return flash::score_pass_dispatch(x, x_lo, nrm, nrm, xt, xt_lo, xaug,
                                    xaug_lo, inv2h2, part, out, n, n, d,
                                    tier, block_m, block_n, per_split,
                                    splits, tiles, stream);
}

extern "C" const char* flash_pruned_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
