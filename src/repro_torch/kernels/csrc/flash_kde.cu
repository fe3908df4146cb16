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
// does 2d flops of Gram, a few of distance, one exp and one add, on a
// few bytes per pair that stay in shared memory; the bytes it must move
// (the operands once, the sums once) are a few MB.  At d = 16 the f32
// tier's floor is the FP32 rate (67 TFLOP/s), the exp floor is the SFU
// rate (16 per clock per SM).
//
// Design: flash_tiles.cuh's kde_kernel streaming every column tile
// (AllTiles): one thread per query row, the column tiles staged through
// shared memory, a per-tile partial added to the running sum.

#include "flash_tiles.cuh"

// tier: 0 = f32, 1 = bf16, 2 = bf16x2.  Returns a cudaError_t code.
extern "C" int flash_kde_launch(const void* y, const void* y_lo,
                                const void* nrm_y, const void* xt,
                                const void* xt_lo, const void* nrm_x,
                                const void* inv2h2, void* out, int m, int n,
                                int d, int tier, int block_m, int block_n,
                                void* stream) {
  if (block_n < 1) return cudaErrorInvalidValue;
  return flash::kde_dispatch<flash::Weight::kOne>(
      y, y_lo, nrm_y, xt, xt_lo, nrm_x, inv2h2, out, m, n, d, tier,
      block_m, block_n, flash::AllTiles{(n + block_n - 1) / block_n},
      stream);
}

extern "C" const char* flash_kde_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
