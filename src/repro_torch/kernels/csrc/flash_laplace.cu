// Flash Laplace kernels (B5 fused Laplace, B6 square moment) for Hopper,
// sm_90a.
//
// Replaces: src/repro/kernels/flash_laplace.py, flash_laplace_pallas (body
// _make_laplace_kernel) and sq_moment_pallas (body _make_sq_moment_kernel).
// On the TPU each was a grid of (row tile, column tile) steps whose inner
// column axis ran in order, adding each tile's sums into the row tile's
// output block.
//
// B5 (flash_laplace_launch) computes the fused Laplace-corrected sums
//     out_j = sum_i phi_ji (1 + d/2 - scaled_ji),
//     scaled = sq * inv2h2,  phi = exp(-scaled),
// in one quadratic pass: the Laplace factor reuses the scaled distance
// the exponential already needed.  B6 (sq_moment_launch) computes
//     out_j = sum_i phi_ji sq_ji,
// the second pass of the non-fused baseline, which the caller combines
// with B2's sums S as (1 + d/2) S - M / (2h^2).  B6 recomputes the
// distances on purpose: it is the baseline the fusion is measured against.
// Both take y (m, d) against the train columns xt (d, n) at the f32, bf16
// or bf16x2 tier, as B2 does; sq is clamped at 0.
//
// Bound on this card: operations, as B2.  Per (query, train) pair: 2d
// flops of Gram (8d at bf16x2), a few of distance, one exp, and two more
// (B5: subtract, multiply) or one (B6: multiply) for the weight; the
// bytes they must move are the operands once and the sums once.  At the
// main shape (32768 x 32768 x 16, h 0.78) the f32 tier is bounded by the
// FP32 rate, the bf16 tiers by the SFU's exp; as for B2, what the body
// reaches at the bf16 tiers is set by instruction issue in the epilogue.
//
// Design: B2's split-column body (flash_kde_pass.cuh) over every column
// tile (AllTiles) with the Laplace (Weight::kLaplace) or square-moment
// (Weight::kSqMoment) weight: 64-row blocks x column splits into the
// (splits, m) f32 scratch part, FP32 register tiles at f32 and mma.sync
// tensor-core tiles at the bf16 tiers, and a second pass that adds each
// row's splits in order.  The splits are planned from n and block_n only
// (kernels/flash_kde.py, plan_splits), so fused and non-fused run one
// body, and a row's sum does not depend on its batch.  B4's laplace flag
// is the same body over visit lists.  The Laplace sum is signed; nothing
// in the kernel depends on its sign.

#include "flash_kde_pass.cuh"

// tier: 0 = f32, 1 = bf16, 2 = bf16x2.  part is the (splits, m) f32
// scratch.  Returns a cudaError_t code.
extern "C" int flash_laplace_launch(const void* y, const void* y_lo,
                                    const void* nrm_y, const void* xt,
                                    const void* xt_lo, const void* nrm_x,
                                    const void* inv2h2, void* part,
                                    void* out, int m, int n, int d, int tier,
                                    int block_m, int block_n, int per_split,
                                    int splits, void* stream) {
  return flash::kde_pass_dense<flash::Weight::kLaplace>(
      y, y_lo, nrm_y, xt, xt_lo, nrm_x, inv2h2, part, out, m, n, d, tier,
      block_m, block_n, per_split, splits, stream);
}

extern "C" const char* flash_laplace_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// tier: 0 = f32, 1 = bf16, 2 = bf16x2.  part is the (splits, m) f32
// scratch.  Returns a cudaError_t code.
extern "C" int sq_moment_launch(const void* y, const void* y_lo,
                                const void* nrm_y, const void* xt,
                                const void* xt_lo, const void* nrm_x,
                                const void* inv2h2, void* part, void* out,
                                int m, int n, int d, int tier, int block_m,
                                int block_n, int per_split, int splits,
                                void* stream) {
  return flash::kde_pass_dense<flash::Weight::kSqMoment>(
      y, y_lo, nrm_y, xt, xt_lo, nrm_x, inv2h2, part, out, m, n, d, tier,
      block_m, block_n, per_split, splits, stream);
}

extern "C" const char* sq_moment_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
