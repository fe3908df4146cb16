// Flash score pass (kernel B1) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/flash_score.py, flash_score_pallas (bodies
// _score_kernel and _score_kernel_x2).
//
// Computes, for every train row i against every train column j,
//     phi_ij  = exp(-max(|x_i|^2 + |x_j|^2 - 2 x_i.x_j, 0) * inv2h2)
//     S1aug_i = sum_j phi_ij * [x_j | 1]                 (n, d+1), f32
// i.e. the score numerator and denominator of SD-KDE in one pass.  The
// Gram operands are x (rows, n x d) and xt (columns, d x n); the second
// product's operand is xaug = [x | 1] (n x (d+1)).
//
// Bound on this card: operations.  Per pair the kernel does 2d flops of
// Gram, 2(d+1) of the weighted sum and one exp; the bytes it must move
// are the operands once and S1aug once, a few MB at n = 32768.  The f32
// tier's floor is the FP32 rate (67 TFLOP/s); the exp floor is the SFU.
//
// Design: flash_tiles.cuh's score_kernel streaming every column tile
// (AllTiles): one thread per train row with its d+1 accumulators in
// registers, the column tiles staged through shared memory, a per-tile
// partial added to the running sums.

#include "flash_tiles.cuh"

// tier: 0 = f32, 1 = bf16, 2 = bf16x2.  Returns a cudaError_t code.
extern "C" int flash_score_launch(const void* x, const void* x_lo,
                                  const void* nrm, const void* xt,
                                  const void* xt_lo, const void* xaug,
                                  const void* xaug_lo, const void* inv2h2,
                                  void* out, int n, int d, int tier,
                                  int block_m, int block_n, void* stream) {
  if (block_n < 1) return cudaErrorInvalidValue;
  return flash::score_dispatch(
      x, x_lo, nrm, xt, xt_lo, xaug, xaug_lo, inv2h2, out, n, d, tier,
      block_m, block_n, flash::AllTiles{(n + block_n - 1) / block_n},
      stream);
}

extern "C" const char* flash_score_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
