// The KDE-pass body of kernels B2, B5 and B6 (dense) and B4 (visit lists)
// for Hopper, sm_90a.
//
//   out_j = sum_i w_ji exp(-scaled_ji),  scaled = sq * inv2h2,
//   sq = max(|y_j|^2 + |x_i|^2 - 2 y_j.x_i, 0),
//
// over the column tiles of an AllTiles (B2, B5, B6) or of row tile j's
// VisitList (B4), with the weight w = 1 (Weight::kOne: B2, B4), the
// Laplace factor 1 + d/2 - scaled (Weight::kLaplace: B5, B4's flag) or
// the squared distance sq (Weight::kSqMoment: B6).
//
// Bound: the operations.  At the main shape (32768 x 32768 x 16, h 0.78)
// the f32 tier is bounded by FP32 operations (the Gram's 2d flops and a
// few more per pair: 0.577 ms for B2 at 67 TFLOP/s), the bf16 tiers by
// the SFU's exp, one per pair (0.257 ms at 16 per clock per SM).  The
// bytes (operands once, sums once) are a few MB.
//
// Design, for that bound:
//  * Split-column grid.  Block (b, s) sums 64 query rows (kRows) of one
//    block_m row tile over split s: the per_split column tiles (B2) or
//    visit slots (B4) [s * per_split, (s + 1) * per_split), and writes
//    its row of partial sums to part[s, :].  combine_kernel then adds the
//    splits of each row in split order.  No atomics: two launches give
//    the same bits.  per_split is planned from n and block_n only
//    (kernels/flash_kde.py, plan_splits), and every row's sum runs the
//    same instructions in the same order wherever the row sits in the
//    batch, so a row's sum does not depend on the other rows of its
//    request.  A 128-row request at n = 32768 spreads over 2 x 128
//    blocks.  A B4 block whose slots start past counts[i] writes zeros.
//  * Threads are not rows.  128 threads (kThreads) share the 64-row tile;
//    block_m is only the row tile the visit lists and padding are made
//    for (a block_m that is not a multiple of 64 leaves some of a block's
//    rows idle).
//  * 2-D register tiles.  f32 tier: each thread owns 4 rows x 8 columns
//    of each 64 x 64 pair tile; per coordinate one float4 of rows and two
//    of columns from shared memory feed 32 FMAs (IEEE f32, no TF32).
//    bf16 tiers: each warp owns 16 rows, and the Gram runs on the tensor
//    cores, mma.sync m16n8k16 bf16 with f32 accumulation, d padded with
//    zeros to a multiple of 16 (exact); bf16x2 runs the four chains
//    hi.hi, hi.lo, lo.hi, lo.lo into four accumulators added in that
//    order.  The epilogue works on the accumulator fragments in
//    registers: sq, scale, expf, the weight, and a per-row sum whose
//    lanes are added by shuffles at the end of each column tile.
//  * Overlapped staging.  The block walks its column tiles in chunks of
//    128 columns (kCols) through a ring of kStages shared-memory buffers
//    filled with cp.async (16-byte copies where n, block_n and the
//    pointers allow, else element copies), kStages - 1 chunks in flight
//    while one computes.  B4 reads its tile indices from the visit list,
//    one slot ahead of the copies that need them.
//  * What is left (times in PERF.md): the epilogue's ~14 instructions
//    per pair (norm sum, clamp, scale, expf's 8, the add) make the bf16
//    tiers bound by instruction issue, not by the SFU's exp, and the f32
//    tier adds the Gram's 16 FMAs per pair.
//  * Shared with the score pass (flash_score_pass.cuh, B1 and B3): the
//    staging cursor, the chunk loop (walk), the column staging and the
//    Gram of each tier, defined below, so each tier has one
//    implementation.
//  * As in every kernel of the port: expf (not __expf), the caller's far
//    sentinels for padding, the sq clamp, norms computed by the caller
//    from the tier-cast operands, and each column tile's terms summed
//    into a partial that is added to the running total (never one
//    accumulator over all n terms).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "flash_tiles.cuh"

namespace flash {

constexpr int kThreads = 128;  // 4 warps
constexpr int kRows = 64;      // query rows per block
constexpr int kCols = 128;     // columns per staged chunk
constexpr int kStages = 3;     // chunks in the shared-memory ring
constexpr int kMaxSplits = 65535;
// f32 Gram: coordinates unrolled 8 at a time (a full unroll at d > 16
// keeps too many loads in flight and spills)
constexpr int kKUnroll = 8;

// Shared-memory geometry of one instantiation.  Rows of a staged chunk
// hold kCols values plus 16 bytes of padding, so the 8 rows an ldmatrix
// reads fall on distinct banks.
template <typename T, bool X2, int DMAX>
struct PassSmem {
  static constexpr bool kTensor = !std::is_same<T, float>::value;
  // staged coordinates: d padded to the MMA's k of 16 on the bf16 tiers
  static constexpr int kK = kTensor ? (DMAX < 16 ? 16 : DMAX) : DMAX;
  static constexpr int kLd = kCols + 16 / (int)sizeof(T);
  static constexpr int kPlanes = X2 ? 2 : 1;
  static constexpr size_t kPlane = (size_t)kK * kLd * sizeof(T);
  static constexpr size_t kStage = kPlanes * kPlane + kCols * sizeof(float);
  // f32 tier: the block's rows, coordinate-major [DMAX][kRows]
  static constexpr size_t kRowsBytes =
      kTensor ? 0 : (size_t)DMAX * kRows * sizeof(float);
  static constexpr size_t kBytes = kStages * kStage + kRowsBytes;
  // blocks per SM the registers are sized for (ptxas caps each thread):
  // at most 4 (128 registers) at f32, whose 4 x 8 tile spills below
  // that, and at the bf16 tiers' d > 32, which hold four k-steps of A
  // fragments, else 5 (102); and never more than the shared memory lets
  // in (228 KB an SM, 1 KB reserved a block: 3 at f32 DMAX 32, 1 at f32
  // DMAX 64, 2 at bf16x2 DMAX 64), where the weights' epilogues would
  // otherwise spill for nothing
  static constexpr int kBySmem = (int)(233472 / (kBytes + 1024));
  static constexpr int kMaxBlocks = kTensor && DMAX <= 32 ? 5 : 4;
  static constexpr int kMinBlocks =
      kBySmem < 1 ? 1 : (kBySmem > kMaxBlocks ? kMaxBlocks : kBySmem);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 bf16 matrices, transposed: the B fragments of two m16n8k16
// products from a [k][n] tile.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Two 8x8 bf16 matrices, transposed: the B fragment of one m16n8k16
// product from a [k][n] tile (lanes 0..15 give the 16 row addresses).
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// c += a . b, 16x8 f32 += 16x16 bf16 . 16x8 bf16.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// One pair's term: exp(-scaled), times the Laplace factor (kLaplace) or
// the unscaled squared distance (kSqMoment), each product rounded once as
// the plain versions round it.
template <Weight W>
__device__ __forceinline__ float pass_term(float sq, float inv2h2,
                                           float half_d1) {
  const float scaled = sq * inv2h2;
  if constexpr (W == Weight::kLaplace) {
    return __fmul_rn(expf(-scaled), half_d1 - scaled);
  } else if constexpr (W == Weight::kSqMoment) {
    return __fmul_rn(expf(-scaled), sq);
  } else {
    return expf(-scaled);
  }
}

// ---------------------------------------------------------------------------
// Pieces shared by the KDE pass (below) and the score pass
// (flash_score_pass.cuh): the staging cursor, the chunk loop, the staging
// of a chunk's columns, and the Gram of each tier.
// ---------------------------------------------------------------------------

// Where a block's staging stands: the next chunk to copy is chunk c of
// slot v (column tile `tile`) into ring buffer buf; the slot after it
// (`next`) is read one slot ahead, so a visit list's index load is not
// waited on.  Built only for a block with slots to walk (nv >= 1).
template <typename Tiles>
struct Cursor {
  Tiles tiles;
  int tile_row, v0, nv, cpt;
  int v = 0, c = 0, buf = 0, tile, next;
  __device__ __forceinline__ Cursor(Tiles t, int tile_row_, int v0_, int nv_,
                                    int cpt_)
      : tiles(t), tile_row(tile_row_), v0(v0_), nv(nv_), cpt(cpt_) {
    tile = tiles.tile_at(tile_row, v0);
    next = nv > 1 ? tiles.tile_at(tile_row, v0 + 1) : 0;
  }
  // The first column of the chunk to copy next.
  __device__ __forceinline__ int column(int block_n) const {
    return tile * block_n + c * kCols;
  }
  // After a chunk is copied: the next ring buffer, chunk and slot.
  template <int Stages>
  __device__ __forceinline__ void advance() {
    buf = buf + 1 == Stages ? 0 : buf + 1;
    if (++c == cpt) {
      c = 0;
      tile = next;
      if (++v + 1 < nv) next = tiles.tile_at(tile_row, v0 + v + 1);
    }
  }
};

// The chunk loop: Stages - 1 chunks in flight (stage_next copies one)
// while compute(buf, c) runs on chunk c of a column tile in ring buffer
// buf; flush() ends each column tile of cpt chunks.
template <int Stages, typename Stage, typename Compute, typename Flush>
__device__ __forceinline__ void walk(int nq, int cpt, Stage stage_next,
                                     Compute compute, Flush flush) {
  static_assert(Stages >= 2, "a ring of at least two buffers");
#pragma unroll
  for (int s = 0; s < Stages - 1; ++s) {
    if (s < nq) stage_next();
    cp_async_commit();
  }
  int c = 0, buf = 0;
  for (int q = 0; q < nq; ++q) {
    cp_async_wait<Stages - 2>();
    __syncthreads();
    if (q + Stages - 1 < nq) stage_next();
    cp_async_commit();
    compute(buf, c);
    buf = buf + 1 == Stages ? 0 : buf + 1;
    if (++c == cpt) {
      c = 0;
      flush();
    }
  }
  cp_async_wait<0>();
}

// Copy columns j .. j + cols of xt (d coordinates, and their norms) into
// the stage at `base`: coordinate-major planes [kK][kLd] (hi, then lo at
// bf16x2) and kCols norms after them.  16-byte cp.async copies where
// `vector` (n, block_n and the pointers allow it), else element copies;
// coordinates past d are left as they are.
template <typename S, typename T, bool X2, int DMAX>
__device__ __forceinline__ void stage_columns(
    unsigned char* base, const T* __restrict__ xt,
    const T* __restrict__ xt_lo, const float* __restrict__ nrm_x, int n,
    int d, int j, int cols, int vector, int tid) {
  constexpr int V = 16 / (int)sizeof(T);  // elements per 16-byte copy
  T* hi = reinterpret_cast<T*>(base);
  T* lo = hi + (size_t)S::kK * S::kLd;
  float* nrm = reinterpret_cast<float*>(base + S::kPlanes * S::kPlane);
  if (vector) {
    constexpr int kVecs = kCols / V;  // 16-byte copies per coordinate
#pragma unroll
    for (int i = 0; i < (DMAX * kVecs + kThreads - 1) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int k = e / kVecs;
      const int c = (e % kVecs) * V;
      if (k < d && c < cols) {
        const size_t src = (size_t)k * n + j + c;
        cp_async16(hi + k * S::kLd + c, xt + src);
        if constexpr (X2) cp_async16(lo + k * S::kLd + c, xt_lo + src);
      }
    }
    if (tid * 4 < cols) cp_async16(nrm + tid * 4, nrm_x + j + tid * 4);
  } else {
    for (int e = tid; e < d * kCols; e += kThreads) {
      const int k = e / kCols;
      const int c = e - k * kCols;
      if (c < cols) {
        const size_t src = (size_t)k * n + j + c;
        hi[k * S::kLd + c] = xt[src];
        if constexpr (X2) lo[k * S::kLd + c] = xt_lo[src];
      }
    }
    for (int c = tid; c < cols; c += kThreads) nrm[c] = nrm_x[j + c];
  }
}

// Zero coordinates d .. kK of the column planes of every ring buffer, for
// the launch: the products over the padded k then add exact zeros.
template <typename S, typename T>
__device__ __forceinline__ void zero_pad_columns(unsigned char* smem,
                                                 size_t stage, int stages,
                                                 int d, int tid) {
  for (int buf = 0; buf < stages; ++buf) {
    T* hi = reinterpret_cast<T*>(smem + (size_t)buf * stage);
    for (int e = tid; e < (S::kK - d) * S::kLd * S::kPlanes; e += kThreads) {
      const int p = e / ((S::kK - d) * S::kLd);
      const int r = e - p * (S::kK - d) * S::kLd;
      hi[(size_t)p * S::kK * S::kLd + (size_t)d * S::kLd + r] = T(0.f);
    }
  }
}

// f32 tier: the block's 64 rows, coordinate-major [DMAX][kRows], zero
// past d and past row_end.
template <int DMAX>
__device__ __forceinline__ void load_rows_f32(float* s_rows,
                                              const float* __restrict__ y,
                                              int row0, int row_end, int d,
                                              int tid) {
  for (int e = tid; e < DMAX * kRows; e += kThreads) {
    const int k = e / kRows;
    const int r = e - k * kRows;
    const int row = row0 + r;
    s_rows[e] = (k < d && row < row_end) ? y[(size_t)row * d + k] : 0.f;
  }
}

// f32 tier: the Gram of a thread's 4 rows (4 tr .. 4 tr + 3) and 8
// columns (4 tc .. + 3 and 32 + 4 tc .. + 3) of the 64-column half of a
// staged chunk that starts at s_col, on IEEE FP32 FMAs.
template <int DMAX, int LD>
__device__ __forceinline__ void gram_4x8(float (&g)[4][8],
                                         const float* s_rows,
                                         const float* s_col, int tr, int tc) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) g[i][c] = 0.f;
#pragma unroll kKUnroll
  for (int k = 0; k < DMAX; ++k) {
    const float4 r4 = reinterpret_cast<const float4*>(s_rows + k * kRows)[tr];
    const float4* c4 = reinterpret_cast<const float4*>(s_col + k * LD);
    const float4 ca = c4[tc];
    const float4 cb = c4[8 + tc];
    const float rv[4] = {r4.x, r4.y, r4.z, r4.w};
    const float cv[8] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) g[i][c] = fmaf(rv[i], cv[c], g[i][c]);
  }
}

// bf16 tiers: the A fragments of a warp's 16 rows (rbase ..), KS k-steps
// of 16 coordinates, zero past d and past row_end.
template <int KS, bool X2>
__device__ __forceinline__ void load_rows_mma(
    uint32_t (&a_hi)[KS][4], uint32_t (&a_lo)[X2 ? KS : 1][4],
    const __nv_bfloat16* __restrict__ y,
    const __nv_bfloat16* __restrict__ y_lo, int rbase, int row_end, int d,
    int lane) {
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const __nv_bfloat16 zero = __ushort_as_bfloat16(0);
  auto y_at = [&](const __nv_bfloat16* src, int r, int k) {
    const int row = rbase + r;
    return (row < row_end && k < d) ? src[(size_t)row * d + k] : zero;
  };
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int r = gid + (f & 1) * 8;
      const int k = ks * 16 + 2 * tig + (f >> 1) * 8;
      a_hi[ks][f] = pack_bf16(y_at(y, r, k), y_at(y, r, k + 1));
      if constexpr (X2)
        a_lo[ks][f] = pack_bf16(y_at(y_lo, r, k), y_at(y_lo, r, k + 1));
    }
  }
}

// bf16 tiers: the Gram of a warp's 16 rows and the 16 columns nn * 16 ..
// of a staged chunk, two n8 tiles from one ldmatrix per k-step, on the
// tensor cores.  bf16x2 runs hi.hi, hi.lo, lo.hi and lo.lo into four
// accumulators added in that order.  hi_addr / lo_addr: the planes'
// shared addresses plus this lane's ldmatrix row offset.
template <int KS, bool X2, int LD>
__device__ __forceinline__ void gram_mma16(
    float (&g)[2][4], const uint32_t (&a_hi)[KS][4],
    const uint32_t (&a_lo)[X2 ? KS : 1][4], uint32_t hi_addr,
    uint32_t lo_addr, int nn) {
  float hh[2][4] = {};
  float hl[2][4] = {};
  float lh[2][4] = {};
  float ll[2][4] = {};
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const uint32_t off =
        (uint32_t)((ks * 16 * LD + nn * 16) * sizeof(__nv_bfloat16));
    uint32_t bh[4];
    ldsm_x4_trans(bh, hi_addr + off);
    mma_bf16(hh[0], a_hi[ks], bh[0], bh[1]);
    mma_bf16(hh[1], a_hi[ks], bh[2], bh[3]);
    if constexpr (X2) {
      uint32_t bl[4];
      ldsm_x4_trans(bl, lo_addr + off);
      mma_bf16(hl[0], a_hi[ks], bl[0], bl[1]);
      mma_bf16(hl[1], a_hi[ks], bl[2], bl[3]);
      mma_bf16(lh[0], a_lo[ks], bh[0], bh[1]);
      mma_bf16(lh[1], a_lo[ks], bh[2], bh[3]);
      mma_bf16(ll[0], a_lo[ks], bl[0], bl[1]);
      mma_bf16(ll[1], a_lo[ks], bl[2], bl[3]);
    }
  }
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      g[t][e] = X2 ? ((hh[t][e] + hl[t][e]) + lh[t][e]) + ll[t][e]
                   : hh[t][e];
}

// ---------------------------------------------------------------------------
// The KDE pass.
// ---------------------------------------------------------------------------

template <typename T, bool X2, int DMAX, Weight W, typename Tiles>
__global__ void __launch_bounds__(kThreads, PassSmem<T, X2, DMAX>::kMinBlocks)
kde_pass_kernel(const T* __restrict__ y, const T* __restrict__ y_lo,
                const float* __restrict__ nrm_y, const T* __restrict__ xt,
                const T* __restrict__ xt_lo,
                const float* __restrict__ nrm_x,
                const float* __restrict__ inv2h2_ptr,
                float* __restrict__ part, int m, int n, int d, int block_m,
                int block_n, int per_split, int vector, Tiles tiles) {
  using S = PassSmem<T, X2, DMAX>;
  static_assert(kCols % 64 == 0 && kCols / 4 <= kThreads, "chunk width");
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int subs = (block_m + kRows - 1) / kRows;
  const int tile_row = blockIdx.x / subs;
  const int row0 = tile_row * block_m + (blockIdx.x - tile_row * subs) * kRows;
  const int row_end = min(min(row0 + kRows, (tile_row + 1) * block_m), m);
  float* out = part + (size_t)blockIdx.y * m;

  // The block's slots: v0 .. v0 + nv of its row tile's column tiles (or
  // visit list), each walked in cpt chunks of kCols columns.
  const int v0 = blockIdx.y * per_split;
  const int nv = max(0, min(v0 + per_split, tiles.count_at(tile_row)) - v0);
  const int cpt = (block_n + kCols - 1) / kCols;
  const int nq = nv * cpt;
  if (nq == 0) {  // past the visit list's count: a zero partial
    for (int r = row0 + tid; r < row_end; r += kThreads) out[r] = 0.f;
    return;
  }

  auto stage_ptr = [&](int buf) { return smem + (size_t)buf * S::kStage; };
  // n is a multiple of block_n (the entry points check it), so a chunk's
  // width depends on its place in the tile alone.
  auto chunk_cols = [&](int c) { return min(kCols, block_n - c * kCols); };

  Cursor<Tiles> cur(tiles, tile_row, v0, nv, cpt);
  auto stage_next = [&]() {
    stage_columns<S, T, X2, DMAX>(stage_ptr(cur.buf), xt, xt_lo, nrm_x, n,
                                  d, cur.column(block_n), chunk_cols(cur.c),
                                  vector, tid);
    cur.template advance<kStages>();
  };
  zero_pad_columns<S, T>(smem, S::kStage, kStages, d, tid);

  const float inv2h2 = *inv2h2_ptr;
  const float half_d1 = 1.f + 0.5f * d;  // exact for d <= kMaxD

  if constexpr (!S::kTensor) {
    // ---- f32 tier: FP32 FMAs on 4 x 8 register tiles -----------------
    float* s_rows = reinterpret_cast<float*>(smem + kStages * S::kStage);
    load_rows_f32<DMAX>(s_rows, y, row0, row_end, d, tid);
    const int tr = tid >> 3;  // rows 4 tr .. 4 tr + 3
    const int tc = tid & 7;   // columns 4 tc .. + 3 and 32 + 4 tc .. + 3
                              // of each 64-column half of a chunk
    float nrm_r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + 4 * tr + i;
      nrm_r[i] = row < row_end ? nrm_y[row] : 0.f;
    }
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    float tile_part[4] = {0.f, 0.f, 0.f, 0.f};

    auto compute = [&](int buf, int chunk) {
      const unsigned char* base = stage_ptr(buf);
      const int cols = chunk_cols(chunk);
      const float* s_nrm =
          reinterpret_cast<const float*>(base + S::kPlanes * S::kPlane);
#pragma unroll
      for (int half = 0; half < kCols / 64; ++half) {
        float g[4][8];
        gram_4x8<DMAX, S::kLd>(
            g, s_rows, reinterpret_cast<const float*>(base) + half * 64, tr,
            tc);
        const float4* n4 = reinterpret_cast<const float4*>(s_nrm + half * 64);
        const float4 na = n4[tc];
        const float4 nb = n4[8 + tc];
        const float nc[8] = {na.x, na.y, na.z, na.w, nb.x, nb.y, nb.z, nb.w};
        auto epilogue = [&](auto masked) {
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const bool live =
                !decltype(masked)::value ||
                half * 64 + (c < 4 ? 4 * tc + c : 28 + 4 * tc + c) < cols;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float sq =
                  fmaxf(fmaf(-2.f, g[i][c], nrm_r[i] + nc[c]), 0.f);
              const float t = pass_term<W>(sq, inv2h2, half_d1);
              tile_part[i] += live ? t : 0.f;
            }
          }
        };
        if (cols == kCols)
          epilogue(std::false_type{});
        else
          epilogue(std::true_type{});
      }
    };
    auto flush = [&]() {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = tile_part[i];
        p += __shfl_xor_sync(0xffffffffu, p, 1);
        p += __shfl_xor_sync(0xffffffffu, p, 2);
        p += __shfl_xor_sync(0xffffffffu, p, 4);
        acc[i] += p;
        tile_part[i] = 0.f;
      }
    };
    walk<kStages>(nq, cpt, stage_next, compute, flush);
    if (tc == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + 4 * tr + i;
        if (row < row_end) out[row] = acc[i];
      }
    }
  } else {
    // ---- bf16 tiers: the Gram on the tensor cores ---------------------
    constexpr int KS = S::kK / 16;  // k-steps of 16
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int gid = lane >> 2;  // fragment row (and row + 8)
    const int tig = lane & 3;   // fragment column pair
    const int rbase = row0 + warp * 16;
    uint32_t a_hi[KS][4];
    uint32_t a_lo[X2 ? KS : 1][4];
    load_rows_mma<KS, X2>(a_hi, a_lo, y, y_lo, rbase, row_end, d, lane);
    float nrm_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rbase + gid + 8 * h;
      nrm_r[h] = row < row_end ? nrm_y[row] : 0.f;
    }
    float acc[2] = {0.f, 0.f};
    float tile_part[2] = {0.f, 0.f};
    // ldmatrix row address of this lane: k = lane & 15, columns + 8
    // for lanes 16..31 (the second n8 tile)
    const uint32_t lane_off =
        (uint32_t)(((lane & 15) * S::kLd + (lane >> 4) * 8) * sizeof(T));

    auto compute = [&](int buf, int chunk) {
      const unsigned char* base = stage_ptr(buf);
      const int cols = chunk_cols(chunk);
      const uint32_t hi_addr = smem_addr(base) + lane_off;
      const uint32_t lo_addr = hi_addr + (uint32_t)S::kPlane;
      const float* s_nrm =
          reinterpret_cast<const float*>(base + S::kPlanes * S::kPlane);
#pragma unroll
      for (int nn = 0; nn < kCols / 16; ++nn) {
        float g[2][4];
        gram_mma16<KS, X2, S::kLd>(g, a_hi, a_lo, hi_addr, lo_addr, nn);
        auto epilogue = [&](auto masked) {
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const int c0 = nn * 16 + t * 8 + 2 * tig;
            const float2 nc = *reinterpret_cast<const float2*>(s_nrm + c0);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float sq = fmaxf(
                  fmaf(-2.f, g[t][e],
                       nrm_r[e >> 1] + ((e & 1) ? nc.y : nc.x)),
                  0.f);
              const float term = pass_term<W>(sq, inv2h2, half_d1);
              tile_part[e >> 1] +=
                  (!decltype(masked)::value || c0 + (e & 1) < cols) ? term
                                                                    : 0.f;
            }
          }
        };
        if (cols == kCols)
          epilogue(std::false_type{});
        else
          epilogue(std::true_type{});
      }
    };
    auto flush = [&]() {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p = tile_part[h];
        p += __shfl_xor_sync(0xffffffffu, p, 1);
        p += __shfl_xor_sync(0xffffffffu, p, 2);
        acc[h] += p;
        tile_part[h] = 0.f;
      }
    };
    walk<kStages>(nq, cpt, stage_next, compute, flush);
    if (tig == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rbase + gid + 8 * h;
        if (row < row_end) out[row] = acc[h];
      }
    }
  }
}

// out_j = sum over s of part[s, j], in split order.
__global__ void combine_kernel(const float* __restrict__ part,
                               float* __restrict__ out, int m, int splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= m) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * m + row];
  out[row] = s;
}

template <typename T, bool X2, int DMAX, Weight W, typename Tiles>
cudaError_t kde_pass_launch(const void* y, const void* y_lo,
                            const void* nrm_y, const void* xt,
                            const void* xt_lo, const void* nrm_x,
                            const void* inv2h2, void* part, void* out, int m,
                            int n, int d, int block_m, int block_n,
                            int per_split, int splits, Tiles tiles,
                            cudaStream_t stream) {
  using S = PassSmem<T, X2, DMAX>;
  static_assert(S::kBytes <= kMaxSmem, "shared memory");
  auto kernel = kde_pass_kernel<T, X2, DMAX, W, Tiles>;
  if (S::kBytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)S::kBytes);
    if (err != cudaSuccess) return err;
  }
  constexpr int V = 16 / (int)sizeof(T);
  auto aligned = [](const void* p) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vector = n % V == 0 && block_n % V == 0 && aligned(xt) &&
                     aligned(xt_lo) && aligned(nrm_x);
  const int subs = (block_m + kRows - 1) / kRows;
  const dim3 grid((unsigned)((m / block_m) * subs), (unsigned)splits);
  kernel<<<grid, kThreads, S::kBytes, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(y_lo),
      static_cast<const float*>(nrm_y), static_cast<const T*>(xt),
      static_cast<const T*>(xt_lo), static_cast<const float*>(nrm_x),
      static_cast<const float*>(inv2h2), static_cast<float*>(part), m, n, d,
      block_m, block_n, per_split, vector, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine_kernel<<<(m + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(out), m, splits);
  return cudaGetLastError();
}

// tier: 0 = f32, 1 = bf16, 2 = bf16x2.  m must be a multiple of block_m
// and the splits must cover the slots: splits * per_split >= the column
// tiles (AllTiles) or the visit width (VisitList), checked by the caller.
// Returns a cudaError_t code.
template <Weight W, typename Tiles>
cudaError_t kde_pass_dispatch(const void* y, const void* y_lo,
                              const void* nrm_y, const void* xt,
                              const void* xt_lo, const void* nrm_x,
                              const void* inv2h2, void* part, void* out,
                              int m, int n, int d, int tier, int block_m,
                              int block_n, int per_split, int splits,
                              Tiles tiles, void* stream) {
  if (m <= 0 || n <= 0 || d < 1 || d > kMaxD || block_m < 1 ||
      block_m > kMaxRows || block_n < 1 || m % block_m || per_split < 1 ||
      splits < 1 || splits > kMaxSplits)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_PASS(TT, X, DM)                                            \
  return kde_pass_launch<TT, X, DM, W, Tiles>(                           \
      y, y_lo, nrm_y, xt, xt_lo, nrm_x, inv2h2, part, out, m, n, d,      \
      block_m, block_n, per_split, splits, tiles, s)
  switch (tier) {
    case 0:
      if (d <= 4) FLASH_PASS(float, false, 4);
      if (d <= 8) FLASH_PASS(float, false, 8);
      if (d <= 16) FLASH_PASS(float, false, 16);
      if (d <= 32) FLASH_PASS(float, false, 32);
      FLASH_PASS(float, false, 64);
    case 1:
      if (d <= 16) FLASH_PASS(__nv_bfloat16, false, 16);
      if (d <= 32) FLASH_PASS(__nv_bfloat16, false, 32);
      FLASH_PASS(__nv_bfloat16, false, 64);
    case 2:
      if (d <= 16) FLASH_PASS(__nv_bfloat16, true, 16);
      if (d <= 32) FLASH_PASS(__nv_bfloat16, true, 32);
      FLASH_PASS(__nv_bfloat16, true, 64);
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_PASS
}

// The dense passes (B2, B5, B6): every column tile of n columns, n a
// multiple of block_n, split into runs of per_split tiles that cover the
// tiles exactly (splits - 1 runs fall short of them).  Returns a
// cudaError_t code.
template <Weight W>
cudaError_t kde_pass_dense(const void* y, const void* y_lo,
                           const void* nrm_y, const void* xt,
                           const void* xt_lo, const void* nrm_x,
                           const void* inv2h2, void* part, void* out, int m,
                           int n, int d, int tier, int block_m, int block_n,
                           int per_split, int splits, void* stream) {
  if (block_n < 1 || n % block_n) return cudaErrorInvalidValue;
  const int tiles = n / block_n;
  if (per_split < 1 || (long long)splits * per_split < tiles ||
      (long long)(splits - 1) * per_split >= tiles)
    return cudaErrorInvalidValue;
  return kde_pass_dispatch<W>(y, y_lo, nrm_y, xt, xt_lo, nrm_x, inv2h2,
                              part, out, m, n, d, tier, block_m, block_n,
                              per_split, splits, AllTiles{tiles}, stream);
}

}  // namespace flash
