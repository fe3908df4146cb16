// Flash KDE pass (kernel B2) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/flash_kde.py, flash_kde_pallas (bodies
// _kde_kernel and _kde_kernel_x2).
//
// Computes the unnormalized Gaussian kernel sums at query rows
//     out_j = sum_i exp(-max(|y_j|^2 + |x_i|^2 - 2 y_j.x_i, 0) * inv2h2)
// for y (m, d) against the train columns xt (d, n), at the f32, bf16 or
// bf16x2 tier.
//
// Bound on this card: operations.  Per (query, train) pair the kernel
// does 2d flops of Gram (8d at bf16x2), a few of distance, one exp and
// one add; the bytes it must move (the operands once, the sums once) are
// a few MB.  At the main shape (32768 x 32768 x 16, h 0.78) the f32 tier
// is bounded by the FP32 rate (67 TFLOP/s: 0.577 ms), the bf16 tiers by
// the SFU's exp (16 per clock per SM: 0.257 ms).
//
// Design: flash_kde_pass.cuh's split-column body over every column tile
// (AllTiles, Weight::kOne): a grid of 64-row blocks x column splits,
// 4 x 8 FP32 register tiles (f32) or mma.sync bf16 tensor-core tiles
// (bf16, bf16x2), cp.async staging three chunks deep, and a second pass
// that adds each row's split partials in order.  part is the
// (splits, m) f32 scratch the wrapper allocates.

#include "flash_kde_pass.cuh"

// tier: 0 = f32, 1 = bf16, 2 = bf16x2.  Returns a cudaError_t code.
extern "C" int flash_kde_launch(const void* y, const void* y_lo,
                                const void* nrm_y, const void* xt,
                                const void* xt_lo, const void* nrm_x,
                                const void* inv2h2, void* part, void* out,
                                int m, int n, int d, int tier, int block_m,
                                int block_n, int per_split, int splits,
                                void* stream) {
  return flash::kde_pass_dense<flash::Weight::kOne>(
      y, y_lo, nrm_y, xt, xt_lo, nrm_x, inv2h2, part, out, m, n, d, tier,
      block_m, block_n, per_split, splits, stream);
}

extern "C" const char* flash_kde_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
