// Flash score pass (kernel B1) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/flash_score.py, flash_score_pallas (bodies
// _score_kernel and _score_kernel_x2).
//
// Computes, for every row i against every column j,
//     phi_ij  = exp(-max(|x_i|^2 + |x_j|^2 - 2 x_i.x_j, 0) * inv2h2)
//     S1aug_i = sum_j phi_ij * [x_j | 1]                 (m, d+1), f32
// i.e. the score numerator and denominator of SD-KDE in one pass.  The
// Gram operands are x (rows, m x d, norms nrm_y) and xt (columns, d x n,
// norms nrm_x); the second product's operand is [x_cols | 1]: xaug
// (n x (d+1)) at the bf16 tiers, made in the kernel from xt at f32
// (xaug null).  The fit's pass over one train set is m = n with nrm_y ==
// nrm_x; the ring (distributed/ring.py, ring2d.py) pairs a rank's
// resident rows with a visiting block of other points.
//
// Bound on this card: operations.  Per pair the kernel does 2d flops of
// Gram, 2(d+1) of the weighted sum and one exp; the bytes it must move
// are the operands once and S1aug once, a few MB at n = 32768.  Every
// tier runs both products on the tensor cores: the f32 tier as six bf16
// products of three exact planes a side (its floor the tensor-core rate
// on 24d + 6 flops a pair), the bf16 tiers' floor the SFU's exp.
//
// Design: flash_score_pass.cuh's split-column body over every column
// tile (AllTiles): a grid of 64-row blocks x column splits (x output
// coordinate groups at bf16x2, d > 16), wgmma on three exact bf16 planes
// of both products (f32) or mma.sync bf16 tiles (bf16, bf16x2), cp.async
// staging of the columns, their norms and (bf16 tiers) their [X|1] rows,
// and a second pass that adds each value's split partials in order.  part is the (splits, m, d+1) f32 scratch the
// wrapper allocates (none with one split, where the kernel writes out).

#include "flash_score_pass.cuh"

// tier: 0 = f32, 1 = bf16, 2 = bf16x2.  Returns a cudaError_t code.
extern "C" int flash_score_launch(const void* x, const void* x_lo,
                                  const void* nrm_y, const void* nrm_x,
                                  const void* xt, const void* xt_lo,
                                  const void* xaug, const void* xaug_lo,
                                  const void* inv2h2, void* part, void* out,
                                  int m, int n, int d, int tier, int block_m,
                                  int block_n, int per_split, int splits,
                                  void* stream) {
  if (block_n < 1 || n % block_n) return cudaErrorInvalidValue;
  const int tiles = n / block_n;
  if (per_split < 1 || (long long)splits * per_split < tiles ||
      (long long)(splits - 1) * per_split >= tiles)
    return cudaErrorInvalidValue;
  return flash::score_pass_dispatch(
      x, x_lo, nrm_y, nrm_x, xt, xt_lo, xaug, xaug_lo, inv2h2, part, out, m,
      n, d, tier, block_m, block_n, per_split, splits,
      flash::AllTiles{tiles}, stream);
}

extern "C" const char* flash_score_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
