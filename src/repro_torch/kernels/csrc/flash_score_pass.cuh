// The score-pass body of kernels B1 (dense) and B3 (visit lists) for
// Hopper, sm_90a.
//
//   S1aug_i = sum_j phi_ij [x_j | 1],
//   phi_ij = exp(-max(|x_i|^2 + |x_j|^2 - 2 x_i.x_j, 0) * inv2h2),
//
// over the column tiles of an AllTiles (B1) or of row tile i's VisitList
// (B3): the score numerator and denominator of SD-KDE in one pass.  The
// rows i (m of them, their norms nrm_y) and the columns j (n, their norms
// nrm_x) are two point sets: B1's ring blocks pair a rank's resident rows
// with a visiting block.  The square pass over one train set is the case
// m = n with one norm vector passed for both, as B3 always runs.
//
// Bound: the operations.  Per pair 2d flops of Gram, 2(d+1) of the
// second product phi.[X|1] and one exp.  At the main shape (32768 x
// 32768 x 16) that is 1.106 ms at the FP32 rate for the f32 tier; the
// bf16 tiers run both products on the tensor cores and are bounded by
// the SFU's exp (0.257 ms).  The bytes (operands once, S1aug once) are a
// few MB.
//
// Design (the KDE pass's, flash_kde_pass.cuh, whose cursor, chunk loop,
// staging and Gram it shares):
//  * Split-column grid.  Block (b, s, g) takes 64 rows (kRows) of one
//    block_m row tile and split s: the per_split column tiles (B1) or
//    visit slots (B3) [s * per_split, (s + 1) * per_split), and writes
//    its rows of S1aug partials to part[s] (m x (d+1) f32), or straight
//    to out when there is one split.  score_combine_kernel then adds the
//    splits of each value in split order: no atomics, two launches give
//    the same bits.  The splits are planned from m, n, block_n, d and
//    the visit width (kernels/flash_score.py, plan_score_splits), with
//    the scratch capped.  A B3 block whose slots start past counts[i] writes
//    zeros; it reads the next tile index one slot ahead.
//  * Staging.  Each cp.async chunk of 128 columns (kCols) carries the
//    columns of xt (the Gram's B operand, as in the KDE pass), their
//    norms (nrm_x) and their [X|1] rows.  A chunk's rows of xaug, (n, d+1)
//    row-major, are one contiguous run of 128 (d+1) values, copied as
//    is (16-byte copies where aligned) into the stage.  A row of d+1
//    values is not 16 bytes wide, so the bf16 tiers relay the rows kLa
//    apart (d+1 padded to a multiple of 8) in a second buffer after the
//    chunk lands, one row a thread, for ldmatrix; the f32 tier reads
//    them where they lie.
//  * f32 tier: IEEE FP32 FMAs, no TF32.  The Gram runs on the KDE pass's
//    4 x 8 register tiles; the epilogue writes phi to shared memory
//    (64 rows x 128 columns, 34 KB) and sums phi per row for the
//    denominator, as B2 sums it: the ones column would be a 17th
//    coordinate that the 4-wide register tiles of the second product do
//    not divide, and summing phi costs one add a pair.  Then a second
//    register-tile product, phi.X: each thread owns 4 rows x kC
//    coordinates of one k-group (a run of the chunk's columns) for the
//    whole walk, so the running sums stay within the register cap
//    (4 rows x 17 values and their partials would be 136 registers).  The
//    k-groups' sums are added in order at the end.
//  * bf16 and bf16x2 tiers: both products on mma.sync m16n8k16 (bf16
//    inputs, f32 accumulation).  The Gram is the KDE pass's; phi goes
//    from its C fragments straight into the A fragments of the second
//    product in registers (two n8 C tiles make one k16 A step).  bf16
//    rounds phi to nearest even; bf16x2 splits it, p_hi = bf16(phi),
//    p_lo = bf16(phi - p_hi), and runs four chains hh, hl, lh, ll against
//    the hi and lo planes of [X|1], added in that order per column tile
//    (precision.weighted_accum -> gram_compensated).  The output width
//    d+1 is padded to n8 tiles (24 at d = 16); the ones column rides in
//    the last tile, read from xaug like the rest.  bf16x2 keeps at most
//    three n8 tiles (kNTG) of four chains a block, and further tiles go
//    to further blocks on the grid's z axis (two at d = 32, three at
//    d = 64), which repeat the Gram: the four chains over 9 tiles would
//    not fit the registers.
//  * As in every kernel of the port: expf (not __expf), the caller's far
//    sentinels for padding, the sq clamp, norms computed by the caller
//    from the tier-cast operands, and each column tile's terms summed
//    into a partial that is added to the running total.

#pragma once

#include "flash_kde_pass.cuh"

namespace flash {

// Shared-memory geometry and thread tiling of one instantiation.
template <typename T, bool X2, int DMAX>
struct ScoreSmem {
  using P = PassSmem<T, X2, DMAX>;  // the staged columns' planes, norms
  static constexpr bool kTensor = P::kTensor;
  static constexpr int kPlanes = P::kPlanes;
  static constexpr int kW = DMAX + 1;  // the widest [X|1] row
  // chunks in the ring: three where they fit beside the other buffers
  static constexpr int kStages = kTensor && DMAX <= 16 ? 3 : 2;
  // a chunk's [X|1] rows as they lie in memory, d+1 apart, with DMAX
  // values of slack that the f32 product reads past the last row
  static constexpr size_t kRawPlane =
      (((size_t)kCols * kW + DMAX) * sizeof(T) + 15) / 16 * 16;
  static constexpr size_t kAugOff =
      kPlanes * P::kPlane + kCols * sizeof(float);
  static constexpr size_t kStage = kAugOff + kPlanes * kRawPlane;
  // bf16 tiers: the rows relaid kLa apart for ldmatrix.  kLa is an odd
  // multiple of 8 elements (24, 40, 72), so the 8 rows of one 8x8
  // matrix fall on distinct banks; kNT n8 tiles of output coordinates.
  static constexpr int kLa = (kW + 7) / 8 * 8;
  static constexpr int kNT = kLa / 8;
  static constexpr size_t kPadPlane = (size_t)kCols * kLa * sizeof(T);
  static constexpr size_t kPad = kTensor ? kPlanes * kPadPlane : 0;
  // f32 tier: the block's rows [DMAX][kRows] and phi [kCols][kPhiLd]
  // (4 rows past 64: a warp's float4 stores take the fewest wavefronts)
  static constexpr int kPhiLd = kRows + 4;
  static constexpr size_t kRowsBytes =
      kTensor ? 0 : (size_t)DMAX * kRows * sizeof(float);
  static constexpr size_t kPhi =
      kTensor ? 0 : (size_t)kCols * kPhiLd * sizeof(float);
  static constexpr size_t kBytes =
      kStages * kStage + kPad + kRowsBytes + kPhi;
  // blocks per SM the shared memory allows (228 KB an SM, 1 KB reserved
  // a block), at most 4 at the bf16 tiers and 3 at f32 (whose two
  // register tiles spill under 4 blocks' 128 registers); ptxas sizes
  // the registers for them
  static constexpr int kBySmem = (int)(233472 / (kBytes + 1024));
  static constexpr int kMaxBlocks = kTensor ? 4 : 3;
  static constexpr int kMinBlocks =
      kBySmem < 1 ? 1 : (kBySmem > kMaxBlocks ? kMaxBlocks : kBySmem);
  // bf16 tiers: the n8 output tiles one block carries
  static constexpr int kNTG = X2 && kNT > 3 ? 3 : kNT;
  // f32 second product: 4 rows x kC coordinates a thread, 16 row groups
  // x kCG coordinate groups x kKG k-groups = 128 threads
  static constexpr int kC = DMAX <= 32 ? 4 : 8;
  static constexpr int kCG = DMAX < kC ? 1 : DMAX / kC;
  static constexpr int kKG = kThreads / (16 * kCG);
};

// Copy a chunk's [X|1] rows, len = cols (d+1) contiguous values from
// src (and src_lo at bf16x2), into the raw planes at raw_base; the rest
// of the chunk's kCols rows is zeroed (a partial chunk's dead columns
// then add exact zeros).  16-byte cp.async copies where `vector`.
template <typename S, typename T, bool X2>
__device__ __forceinline__ void stage_aug(unsigned char* raw_base,
                                          const T* __restrict__ src,
                                          const T* __restrict__ src_lo,
                                          int len, int full, int vector,
                                          int tid) {
  constexpr int V = 16 / (int)sizeof(T);
  T* raw = reinterpret_cast<T*>(raw_base);
  T* raw_lo = reinterpret_cast<T*>(raw_base + S::kRawPlane);
  if (vector) {
    for (int e = tid * V; e < len; e += kThreads * V) {
      cp_async16(raw + e, src + e);
      if constexpr (X2) cp_async16(raw_lo + e, src_lo + e);
    }
  } else {
    for (int e = tid; e < len; e += kThreads) {
      raw[e] = src[e];
      if constexpr (X2) raw_lo[e] = src_lo[e];
    }
  }
  for (int e = len + tid; e < full; e += kThreads) {
    raw[e] = T(0.f);
    if constexpr (X2) raw_lo[e] = T(0.f);
  }
}

// bf16 tiers: relay a landed chunk's [X|1] rows (d+1 apart) kLa apart,
// zero past d+1, for ldmatrix (whose rows must be 16-byte aligned).
// Thread c moves row c.
template <typename S>
__device__ __forceinline__ void relayout_aug(const unsigned char* raw_base,
                                             unsigned char* pad_base, int w,
                                             int tid) {
  static_assert(kCols == kThreads, "one row a thread");
#pragma unroll
  for (int p = 0; p < S::kPlanes; ++p) {
    const uint16_t* raw =
        reinterpret_cast<const uint16_t*>(raw_base + p * S::kRawPlane) +
        (size_t)tid * w;
    uint4* dst = reinterpret_cast<uint4*>(pad_base + p * S::kPadPlane +
                                          (size_t)tid * S::kLa * 2);
#pragma unroll
    for (int q = 0; q < S::kLa / 8; ++q) {
      uint32_t v[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int k = q * 8 + 2 * h;
        const uint32_t lo = k < w ? raw[k] : 0u;
        const uint32_t hi = k + 1 < w ? raw[k + 1] : 0u;
        v[h] = lo | (hi << 16);
      }
      dst[q] = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <typename T, bool X2, int DMAX, typename Tiles>
__global__ void __launch_bounds__(kThreads, ScoreSmem<T, X2, DMAX>::kMinBlocks)
score_pass_kernel(const T* __restrict__ x, const T* __restrict__ x_lo,
                  const float* __restrict__ nrm_y,
                  const float* __restrict__ nrm_x, const T* __restrict__ xt,
                  const T* __restrict__ xt_lo, const T* __restrict__ xaug,
                  const T* __restrict__ xaug_lo,
                  const float* __restrict__ inv2h2_ptr,
                  float* __restrict__ dst, int m, int n, int d, int block_m,
                  int block_n, int per_split, int vector, Tiles tiles) {
  using S = ScoreSmem<T, X2, DMAX>;
  using P = typename S::P;
  constexpr int Stages = S::kStages;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int w = d + 1;
  const int subs = (block_m + kRows - 1) / kRows;
  const int tile_row = blockIdx.x / subs;
  const int row0 = tile_row * block_m + (blockIdx.x - tile_row * subs) * kRows;
  const int row_end = min(min(row0 + kRows, (tile_row + 1) * block_m), m);
  float* out = dst + (size_t)blockIdx.y * m * w;

  // The block's slots, as in the KDE pass.
  const int v0 = blockIdx.y * per_split;
  const int nv = max(0, min(v0 + per_split, tiles.count_at(tile_row)) - v0);
  const int cpt = (block_n + kCols - 1) / kCols;
  const int nq = nv * cpt;
  if (nq == 0) {  // past the visit list's count: zero partials
    const int k0 = S::kTensor ? blockIdx.z * S::kNTG * 8 : 0;
    const int kw = (S::kTensor ? min(w, k0 + S::kNTG * 8) : w) - k0;
    for (int e = tid; e < (row_end - row0) * kw; e += kThreads) {
      const int r = e / kw;
      out[(size_t)(row0 + r) * w + k0 + (e - r * kw)] = 0.f;
    }
    return;
  }

  auto stage_ptr = [&](int buf) { return smem + (size_t)buf * S::kStage; };
  auto chunk_cols = [&](int c) { return min(kCols, block_n - c * kCols); };

  Cursor<Tiles> cur(tiles, tile_row, v0, nv, cpt);
  auto stage_next = [&]() {
    unsigned char* base = stage_ptr(cur.buf);
    const int j = cur.column(block_n);
    const int cols = chunk_cols(cur.c);
    stage_columns<P, T, X2, DMAX>(base, xt, xt_lo, nrm_x, n, d, j, cols,
                                  vector, tid);
    stage_aug<S, T, X2>(base + S::kAugOff, xaug + (size_t)j * w,
                        X2 ? xaug_lo + (size_t)j * w : nullptr, cols * w,
                        kCols * w, vector, tid);
    cur.template advance<Stages>();
  };
  zero_pad_columns<P, T>(smem, S::kStage, Stages, d, tid);
  // the raw planes' slack past kCols rows stays zero for the launch
  for (int buf = 0; buf < Stages; ++buf) {
    for (int p = 0; p < S::kPlanes; ++p) {
      T* raw = reinterpret_cast<T*>(stage_ptr(buf) + S::kAugOff +
                                    p * S::kRawPlane);
      for (int e = kCols * w + tid; e < kCols * S::kW + DMAX; e += kThreads)
        raw[e] = T(0.f);
    }
  }

  const float inv2h2 = *inv2h2_ptr;

  if constexpr (!S::kTensor) {
    // ---- f32 tier: FP32 FMAs on register tiles, phi through shared ----
    float* s_rows = reinterpret_cast<float*>(smem + Stages * S::kStage);
    float* s_phi = s_rows + DMAX * kRows;  // [kCols][kPhiLd]
    load_rows_f32<DMAX>(s_rows, x, row0, row_end, d, tid);
    // Gram and epilogue: rows 4 tr .., columns 4 tc .. and 32 + 4 tc ..
    // of each 64-column half
    const int tr = tid >> 3;
    const int tc = tid & 7;
    float nrm_r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + 4 * tr + i;
      nrm_r[i] = row < row_end ? nrm_y[row] : 0.f;
    }
    float den[4] = {0.f, 0.f, 0.f, 0.f};
    float tile_den[4] = {0.f, 0.f, 0.f, 0.f};
    // second product: rows 4 rg .., coordinates cg kC .., and the
    // chunk's columns kg KW .. KW - 1 (KW = kCols / kKG)
    constexpr int C = S::kC;
    constexpr int KW = kCols / S::kKG;
    const int rg = tid & 15;
    const int cg = (tid >> 4) % S::kCG;
    const int kg = tid / (16 * S::kCG);
    float acc[4][C] = {};
    float part[4][C] = {};

    auto compute = [&](int buf, int chunk) {
      const unsigned char* base = stage_ptr(buf);
      const int cols = chunk_cols(chunk);
      const float* s_nrm =
          reinterpret_cast<const float*>(base + P::kPlanes * P::kPlane);
#pragma unroll
      for (int half = 0; half < kCols / 64; ++half) {
        float g[4][8];
        gram_4x8<DMAX, P::kLd>(
            g, s_rows, reinterpret_cast<const float*>(base) + half * 64, tr,
            tc);
        const float4* n4 = reinterpret_cast<const float4*>(s_nrm + half * 64);
        const float4 na = n4[tc];
        const float4 nb = n4[8 + tc];
        const float nc[8] = {na.x, na.y, na.z, na.w, nb.x, nb.y, nb.z, nb.w};
        auto epilogue = [&](auto masked) {
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int col = half * 64 + (c < 4 ? 4 * tc + c : 28 + 4 * tc + c);
            const bool live = !decltype(masked)::value || col < cols;
            float ph[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float sq =
                  fmaxf(fmaf(-2.f, g[i][c], nrm_r[i] + nc[c]), 0.f);
              const float p = expf(-sq * inv2h2);
              ph[i] = live ? p : 0.f;
              tile_den[i] += ph[i];
            }
            *reinterpret_cast<float4*>(s_phi + col * S::kPhiLd + 4 * tr) =
                make_float4(ph[0], ph[1], ph[2], ph[3]);
          }
        };
        if (cols == kCols)
          epilogue(std::false_type{});
        else
          epilogue(std::true_type{});
      }
      __syncthreads();  // phi complete
      // phi.X over the k-group's columns; a dead column's phi and row
      // are zero
      const float* raw =
          reinterpret_cast<const float*>(base + S::kAugOff) + cg * C +
          (size_t)kg * KW * w;
      const float* phi = s_phi + kg * KW * S::kPhiLd + 4 * rg;
#pragma unroll 4
      for (int k = 0; k < KW; ++k) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(phi + k * S::kPhiLd);
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
        float av[C];
#pragma unroll
        for (int j = 0; j < C; ++j) av[j] = raw[(size_t)k * w + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < C; ++j)
            part[i][j] = fmaf(pv[i], av[j], part[i][j]);
      }
    };
    auto flush = [&]() {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = tile_den[i];
        p += __shfl_xor_sync(0xffffffffu, p, 1);
        p += __shfl_xor_sync(0xffffffffu, p, 2);
        p += __shfl_xor_sync(0xffffffffu, p, 4);
        den[i] += p;
        tile_den[i] = 0.f;
#pragma unroll
        for (int j = 0; j < C; ++j) {
          acc[i][j] += part[i][j];
          part[i][j] = 0.f;
        }
      }
    };
    walk<Stages>(nq, cpt, stage_next, compute, flush);
    if (tc == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + 4 * tr + i;
        if (row < row_end) out[(size_t)row * w + d] = den[i];
      }
    }
    // the k-groups' sums, added in k-group order through shared memory
    __syncthreads();
    float* red = s_phi;  // [kKG][kRows][DMAX]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j)
        red[((size_t)kg * kRows + 4 * rg + i) * DMAX + cg * C + j] =
            acc[i][j];
    __syncthreads();
    for (int e = tid; e < kRows * DMAX; e += kThreads) {
      const int r = e / DMAX;
      const int k = e - r * DMAX;
      const int row = row0 + r;
      if (row < row_end && k < d) {
        float s = red[e];
#pragma unroll
        for (int q = 1; q < S::kKG; ++q) s += red[q * kRows * DMAX + e];
        out[(size_t)row * w + k] = s;
      }
    }
  } else {
    // ---- bf16 tiers: both products on the tensor cores ----------------
    constexpr int KS = P::kK / 16;  // Gram k-steps of 16
    constexpr int NTG = S::kNTG;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int gid = lane >> 2;  // fragment row (and row + 8)
    const int tig = lane & 3;   // fragment column pair
    const int rbase = row0 + warp * 16;
    const int t0 = blockIdx.z * NTG;  // the block's first output n8 tile
    uint32_t a_hi[KS][4];
    uint32_t a_lo[X2 ? KS : 1][4];
    load_rows_mma<KS, X2>(a_hi, a_lo, x, x_lo, rbase, row_end, d, lane);
    float nrm_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rbase + gid + 8 * h;
      nrm_r[h] = row < row_end ? nrm_y[row] : 0.f;
    }
    // running sums and the column tile's chains hh (or the one chain at
    // bf16), hl, lh, ll of each n8 tile
    float acc[NTG][4] = {};
    float ch[X2 ? 4 : 1][NTG][4] = {};
    const uint32_t lane_off =
        (uint32_t)(((lane & 15) * P::kLd + (lane >> 4) * 8) * sizeof(T));
    unsigned char* pad = smem + Stages * S::kStage;
    // ldmatrix row of this lane in the relaid rows: column k = lane & 15
    // of a k-step
    const uint32_t pad_addr =
        smem_addr(pad) + (uint32_t)((lane & 15) * S::kLa * sizeof(T));

    auto compute = [&](int buf, int chunk) {
      const unsigned char* base = stage_ptr(buf);
      const int cols = chunk_cols(chunk);
      relayout_aug<S>(base + S::kAugOff, pad, w, tid);
      __syncthreads();  // relaid rows complete
      const uint32_t hi_addr = smem_addr(base) + lane_off;
      const uint32_t lo_addr = hi_addr + (uint32_t)P::kPlane;
      const float* s_nrm =
          reinterpret_cast<const float*>(base + P::kPlanes * P::kPlane);
#pragma unroll 2
      for (int nn = 0; nn < kCols / 16; ++nn) {
        float g[2][4];
        gram_mma16<KS, X2, P::kLd>(g, a_hi, a_lo, hi_addr, lo_addr, nn);
        float ph[2][4];
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
              const float p = expf(-sq * inv2h2);
              ph[t][e] = (!decltype(masked)::value || c0 + (e & 1) < cols)
                             ? p
                             : 0.f;
            }
          }
        };
        if (cols == kCols)
          epilogue(std::false_type{});
        else
          epilogue(std::true_type{});
        // phi as the A fragments of a 16-row x 16-column k-step: C tile t
        // gives columns 8 t .. 8 t + 7
        uint32_t p_hi[4];
        uint32_t p_lo[4];
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const float v0f = ph[f >> 1][(f & 1) * 2];
          const float v1f = ph[f >> 1][(f & 1) * 2 + 1];
          const __nv_bfloat16 h0 = __float2bfloat16_rn(v0f);
          const __nv_bfloat16 h1 = __float2bfloat16_rn(v1f);
          p_hi[f] = pack_bf16(h0, h1);
          if constexpr (X2)
            p_lo[f] =
                pack_bf16(__float2bfloat16_rn(v0f - __bfloat162float(h0)),
                          __float2bfloat16_rn(v1f - __bfloat162float(h1)));
        }
        const uint32_t koff =
            (uint32_t)(nn * 16 * S::kLa * sizeof(T));
#pragma unroll
        for (int u = 0; u < NTG; ++u) {
          if (t0 + u >= S::kNT) break;
          const uint32_t a =
              pad_addr + koff + (uint32_t)((t0 + u) * 8 * sizeof(T));
          uint32_t bh[2];
          ldsm_x2_trans(bh, a);
          mma_bf16(ch[0][u], p_hi, bh[0], bh[1]);
          if constexpr (X2) {
            uint32_t bl[2];
            ldsm_x2_trans(bl, a + (uint32_t)S::kPadPlane);
            mma_bf16(ch[1][u], p_hi, bl[0], bl[1]);
            mma_bf16(ch[2][u], p_lo, bh[0], bh[1]);
            mma_bf16(ch[3][u], p_lo, bl[0], bl[1]);
          }
        }
      }
    };
    auto flush = [&]() {
#pragma unroll
      for (int u = 0; u < NTG; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (X2) {
            acc[u][e] +=
                ((ch[0][u][e] + ch[1][u][e]) + ch[2][u][e]) + ch[3][u][e];
            ch[1][u][e] = ch[2][u][e] = ch[3][u][e] = 0.f;
          } else {
            acc[u][e] += ch[0][u][e];
          }
          ch[0][u][e] = 0.f;
        }
    };
    walk<Stages>(nq, cpt, stage_next, compute, flush);
#pragma unroll
    for (int u = 0; u < NTG; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rbase + gid + 8 * (e >> 1);
        const int k = (t0 + u) * 8 + 2 * tig + (e & 1);
        if (row < row_end && k < w) out[(size_t)row * w + k] = acc[u][e];
      }
  }
}

// out[e] = sum over s of part[s, e], in split order.
__global__ void score_combine_kernel(const float* __restrict__ part,
                                     float* __restrict__ out, size_t count,
                                     int splits) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * count + e];
  out[e] = s;
}

template <typename T, bool X2, int DMAX, typename Tiles>
cudaError_t score_pass_launch(const void* x, const void* x_lo,
                              const void* nrm_y, const void* nrm_x,
                              const void* xt, const void* xt_lo,
                              const void* xaug, const void* xaug_lo,
                              const void* inv2h2, void* part, void* out,
                              int m, int n, int d, int block_m, int block_n,
                              int per_split, int splits, Tiles tiles,
                              cudaStream_t stream) {
  using S = ScoreSmem<T, X2, DMAX>;
  static_assert(S::kBytes <= kMaxSmem, "shared memory");
  auto kernel = score_pass_kernel<T, X2, DMAX, Tiles>;
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
                     aligned(xt_lo) && aligned(nrm_x) && aligned(xaug) &&
                     aligned(xaug_lo);
  const int subs = (block_m + kRows - 1) / kRows;
  // bf16 tiers: runs of kNTG n8 tiles of the d+1 output coordinates
  const int groups =
      S::kTensor ? ((d + 1 + 7) / 8 + S::kNTG - 1) / S::kNTG : 1;
  const dim3 grid((unsigned)((m / block_m) * subs), (unsigned)splits,
                  (unsigned)groups);
  float* dst = static_cast<float*>(splits > 1 ? part : out);
  kernel<<<grid, kThreads, S::kBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(x_lo),
      static_cast<const float*>(nrm_y), static_cast<const float*>(nrm_x),
      static_cast<const T*>(xt), static_cast<const T*>(xt_lo),
      static_cast<const T*>(xaug), static_cast<const T*>(xaug_lo),
      static_cast<const float*>(inv2h2), dst, m, n, d, block_m, block_n,
      per_split, vector, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t count = (size_t)m * (d + 1);
  score_combine_kernel<<<(unsigned)((count + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(out), count,
      splits);
  return cudaGetLastError();
}

// tier: 0 = f32, 1 = bf16, 2 = bf16x2.  m rows (norms nrm_y) against n
// columns (norms nrm_x; the same pointer for the square pass): m must be
// a multiple of block_m and n of block_n, and the splits must cover the
// slots: splits * per_split >= the column tiles (AllTiles) or the visit
// width (VisitList), checked by the caller.  part is the (splits, m, d+1)
// f32 scratch, unused (and may be null) when splits == 1.  Returns a
// cudaError_t code.
template <typename Tiles>
cudaError_t score_pass_dispatch(const void* x, const void* x_lo,
                                const void* nrm_y, const void* nrm_x,
                                const void* xt, const void* xt_lo,
                                const void* xaug, const void* xaug_lo,
                                const void* inv2h2, void* part, void* out,
                                int m, int n, int d, int tier, int block_m,
                                int block_n, int per_split, int splits,
                                Tiles tiles, void* stream) {
  if (m <= 0 || n <= 0 || d < 1 || d > kMaxD || block_m < 1 ||
      block_m > kMaxRows || block_n < 1 || m % block_m || n % block_n ||
      per_split < 1 || splits < 1 || splits > kMaxSplits ||
      (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_SCORE(TT, X, DM)                                            \
  return score_pass_launch<TT, X, DM, Tiles>(                             \
      x, x_lo, nrm_y, nrm_x, xt, xt_lo, xaug, xaug_lo, inv2h2, part, out, \
      m, n, d, block_m, block_n, per_split, splits, tiles, s)
  switch (tier) {
    case 0:
      if (d <= 4) FLASH_SCORE(float, false, 4);
      if (d <= 8) FLASH_SCORE(float, false, 8);
      if (d <= 16) FLASH_SCORE(float, false, 16);
      if (d <= 32) FLASH_SCORE(float, false, 32);
      FLASH_SCORE(float, false, 64);
    case 1:
      if (d <= 16) FLASH_SCORE(__nv_bfloat16, false, 16);
      if (d <= 32) FLASH_SCORE(__nv_bfloat16, false, 32);
      FLASH_SCORE(__nv_bfloat16, false, 64);
    case 2:
      if (d <= 16) FLASH_SCORE(__nv_bfloat16, true, 16);
      if (d <= 32) FLASH_SCORE(__nv_bfloat16, true, 32);
      FLASH_SCORE(__nv_bfloat16, true, 64);
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_SCORE
}

}  // namespace flash
