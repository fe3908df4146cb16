// Flash Laplace kernels (B5 fused Laplace, B6 square moment) for Hopper,
// sm_90a.
//
// Replaces: src/repro/kernels/flash_laplace.py, flash_laplace_pallas (body
// _make_laplace_kernel) and sq_moment_pallas (body _make_sq_moment_kernel).
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
// flops of Gram, a few of distance, one exp, and two more (B5: subtract,
// multiply) or one (B6: multiply) for the weight; the bytes they must
// move are the operands once and the sums once.
//
// Design: flash_tiles.cuh's kde_kernel streaming every column tile
// (AllTiles) with the Laplace or the square-moment weight: one thread
// per query row, the column tiles staged through shared memory, a
// per-tile partial added to the running sum.  B4's laplace flag is the
// same body over visit lists.  The Laplace sum is signed; nothing in the
// kernel depends on its sign.

#include "flash_tiles.cuh"

namespace {

template <flash::Weight W>
int launch_all_tiles(const void* y, const void* y_lo, const void* nrm_y,
                     const void* xt, const void* xt_lo, const void* nrm_x,
                     const void* inv2h2, void* out, int m, int n, int d,
                     int tier, int block_m, int block_n, void* stream) {
  if (block_n < 1) return cudaErrorInvalidValue;
  return flash::kde_dispatch<W>(
      y, y_lo, nrm_y, xt, xt_lo, nrm_x, inv2h2, out, m, n, d, tier,
      block_m, block_n, flash::AllTiles{(n + block_n - 1) / block_n},
      stream);
}

}  // namespace

// tier: 0 = f32, 1 = bf16, 2 = bf16x2.  Returns a cudaError_t code.
extern "C" int flash_laplace_launch(const void* y, const void* y_lo,
                                    const void* nrm_y, const void* xt,
                                    const void* xt_lo, const void* nrm_x,
                                    const void* inv2h2, void* out, int m,
                                    int n, int d, int tier, int block_m,
                                    int block_n, void* stream) {
  return launch_all_tiles<flash::Weight::kLaplace>(
      y, y_lo, nrm_y, xt, xt_lo, nrm_x, inv2h2, out, m, n, d, tier,
      block_m, block_n, stream);
}

extern "C" const char* flash_laplace_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// tier: 0 = f32, 1 = bf16, 2 = bf16x2.  Returns a cudaError_t code.
extern "C" int sq_moment_launch(const void* y, const void* y_lo,
                                const void* nrm_y, const void* xt,
                                const void* xt_lo, const void* nrm_x,
                                const void* inv2h2, void* out, int m, int n,
                                int d, int tier, int block_m, int block_n,
                                void* stream) {
  return launch_all_tiles<flash::Weight::kSqMoment>(
      y, y_lo, nrm_y, xt, xt_lo, nrm_x, inv2h2, out, m, n, d, tier,
      block_m, block_n, stream);
}

extern "C" const char* sq_moment_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
