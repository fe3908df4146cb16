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
// second product phi.[X|1] and one exp.  Every tier runs both products
// on the tensor cores.  The f32 tier runs them as six bf16 products of
// three exact planes a side (below), 24d + 6 tensor flops a pair: 0.42
// ms at the main shape (32768 x 32768 x 16) at 989 TFLOP/s, beside the
// SFU's exp (0.257 ms, tuning.EXP_RATE).  What it takes is instruction
// issue: its epilogue's ~21 instructions a pair (the norm sum, the
// clamp, the scale, expf's 8, phi's split into three planes) alone
// would take 0.7 ms; with the waits between the wgmma groups it runs at
// ~45 issue slots a pair, ~1.5 ms (tuning.SPLIT_INSTR, fitted).  The
// bf16 tiers are bounded by the SFU's exp (0.257 ms).  The bytes
// (operands once, S1aug once) are a few MB.
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
//    zeros; it reads the next tile index one slot ahead.  At bf16x2,
//    grid axis g carries runs of kNTG n8 tiles of output coordinates
//    where one block cannot hold them all; each run repeats the Gram.
//  * Staging.  Each cp.async chunk of 128 columns (kCols) carries the
//    columns of xt (the Gram's B operand, as in the KDE pass) and their
//    norms (nrm_x); at the bf16 tiers also their [X|1] rows.  A chunk's
//    rows of xaug, (n, d+1) row-major, are one contiguous run of 128 (d+1)
//    values, copied as is (16-byte copies where aligned) into the stage.
//    A row of d+1 values is not 16 bytes wide, so the bf16 tiers relay
//    the rows kLa apart (d+1 padded to a multiple of 8) in a second
//    buffer after the chunk lands, one row a thread, for ldmatrix.
//  * f32 tier: three exact bf16 planes on wgmma, no TF32.  An f32 value
//    v is h + m + l exactly, h = bf16(v), m = bf16(v - h),
//    l = bf16(v - h - m) (round to nearest even; 24 bits of significand
//    in three of 8, and bf16 has f32's exponent range;
//    precision.split_three mirrors the split).
//    - The block is one warpgroup: its 64 rows are the M of
//      wgmma.mma_async m64nNk16, A from registers.  The rows split into
//      A fragments once a block.  When a chunk of columns lands, thread c
//      splits column c into the planes h, m, l, 8 x 8 core matrices as
//      wgmma reads them without a swizzle: its d coordinates, the ones
//      column of [X|1] at d (1 + 0 + 0, written into the stage's padding
//      once a launch), zeros past it.  The planes serve both products:
//      the Gram's B K-major (columns as n), the second product's B
//      MN-major (columns as k).  So the f32 tier reads the columns once,
//      from xt; its wrappers pass no xaug (null).
//    - Gram, NC columns at a time (64 up to DMAX 16, else 32): six of
//      the nine plane products, hl + mm + lh (weight 2^-16), hm + mh
//      (2^-8) and hh, into one accumulator, smallest weight first, so
//      the small terms are summed before the large ones reach it.  The
//      three dropped products weigh 2^-24 or less, f32's own rounding.
//      Every product of two bf16 values is exact in the f32 accumulator.
//    - phi goes from the Gram's accumulators into A fragments in
//      registers (two n8 tiles make one k16 step), split into its three
//      planes there, and multiplies the three planes of [X|1] (N = the
//      d coordinates and the ones column, padded to n8 tiles) with the
//      same six products into three chains by weight.  The chains run
//      over a column tile, its first product starting them from zero,
//      and are added smallest first into the running sums at its end,
//      compensated (Kahan; the compensations in shared memory).
//      S1 feeds score = (S1 - x S0) / (h^2 S0), which cancels, so it
//      keeps f32's relative accuracy; S0 is the ones column, summed like
//      S1.  Plain f32 running sums lose each tile's low bits, an error
//      that grows with the tiles (~7,500 a row in B3 at 1M) and leaves
//      the shift ten times less accurate there than at 32k; compensated,
//      it is as accurate at 1M as at 32k.
//    - Overlap: the Gram of the next NC columns is issued before this
//      NC columns' exp epilogue, and waited for after it, so the tensor
//      cores work through the epilogue; three blocks an SM (two past
//      DMAX 16) overlap each other's splits and waits.  Only wgmma
//      writes its accumulators (no stores into a chain), so ptxas keeps
//      the wgmmas in flight.
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
  static constexpr bool kTensor = P::kTensor;  // the bf16 tiers
  static constexpr int kPlanes = P::kPlanes;
  static constexpr int kW = DMAX + 1;  // the widest [X|1] row
  // chunks in the ring: three where they fit beside the other buffers
  static constexpr int kStages = DMAX <= 16 ? 3 : 2;
  // bf16 tiers: a chunk's [X|1] rows as they lie in memory, d+1 apart,
  // with DMAX values of slack
  static constexpr size_t kRawPlane =
      (((size_t)kCols * kW + DMAX) * sizeof(T) + 15) / 16 * 16;
  static constexpr size_t kAugOff =
      kPlanes * P::kPlane + kCols * sizeof(float);
  static constexpr size_t kStage =
      kTensor ? kAugOff + kPlanes * kRawPlane : P::kStage;
  static constexpr int kK = DMAX < 16 ? 16 : DMAX;  // the Gram's k
  // bf16 tiers: kNT n8 tiles of output coordinates (d+1 padded), the
  // [X|1] rows relaid kLa apart for ldmatrix, an odd multiple of 8
  // elements (24, 40, 72), so the 8 rows of one 8x8 matrix fall on
  // distinct banks.  f32: kNO n8 tiles of output coordinates (DMAX and
  // the ones column), and kKG groups of 8 coordinates a split column,
  // enough for the Gram's k and for the output tiles; a plane holds
  // kCols x kLa bf16.
  static constexpr int kNT = (kK + 8) / 8;
  static constexpr int kNO = kTensor ? kNT : (DMAX + 8) / 8;
  static constexpr int kKG = kTensor ? kNT : (kK / 8 > kNO ? kK / 8 : kNO);
  static constexpr int kLa = 8 * kKG;
  static constexpr size_t kPadPlane =
      (size_t)kCols * kLa * sizeof(__nv_bfloat16);
  static constexpr size_t kPad = (kTensor ? kPlanes : 3) * kPadPlane;
  // f32: each thread's compensations of its running sums (kNO n8 tiles,
  // four values a thread each), one value apart for each thread
  static constexpr size_t kComp =
      kTensor ? 0 : (size_t)kThreads * 4 * kNO * sizeof(float);
  static constexpr size_t kBytes = kStages * kStage + kPad + kComp;
  // blocks per SM the shared memory allows (228 KB an SM, 1 KB reserved
  // a block), at most 4 at the bf16 tiers and 3 (2 past DMAX 16) at f32,
  // whose three chains, two Grams in flight, phi's planes and three
  // planes of row fragments spill under 4 blocks' 128 registers; ptxas
  // sizes the registers for them
  static constexpr int kBySmem = (int)(233472 / (kBytes + 1024));
  static constexpr int kMaxBlocks = kTensor ? 4 : (DMAX <= 16 ? 3 : 2);
  static constexpr int kMinBlocks =
      kBySmem < 1 ? 1 : (kBySmem > kMaxBlocks ? kMaxBlocks : kBySmem);
  // the n8 output tiles one block carries
  static constexpr int kNTG = X2 && kNT > 3 ? 3 : (kTensor ? kNT : kNO);
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

// Two f32 values as packed bf16, lo in the lower half, each rounded to
// nearest even (one cvt), and each half back as f32 (exact).
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ float lo_f32(uint32_t p) {
  return __uint_as_float(p << 16);
}

__device__ __forceinline__ float hi_f32(uint32_t p) {
  return __uint_as_float(p & 0xffff0000u);
}

// f32 tier: v0 and v1 (the lower and upper half of each word) as three
// packed bf16 planes, v = h + m + l exactly: h = bf16(v), m = bf16(v - h),
// l = bf16(v - h - m), each rounded to nearest even.  Both differences
// are exact in f32, and the last has at most 8 significant bits.
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& h,
                                       uint32_t& m, uint32_t& l) {
  h = pack_rn(v0, v1);
  const float r0 = v0 - lo_f32(h);
  const float r1 = v1 - hi_f32(h);
  m = pack_rn(r0, r1);
  l = pack_rn(r0 - lo_f32(m), r1 - hi_f32(m));
}

// f32 tier: the three planes of the A fragments of a warp's 16 rows
// (rbase ..), KS k-steps of 16 coordinates, zero past d and past row_end.
template <int KS>
__device__ __forceinline__ void load_rows_split(uint32_t (&a)[3][KS][4],
                                                const float* __restrict__ y,
                                                int rbase, int row_end,
                                                int d, int lane) {
  const int gid = lane >> 2;
  const int tig = lane & 3;
  auto y_at = [&](int r, int k) {
    const int row = rbase + r;
    return (row < row_end && k < d) ? y[(size_t)row * d + k] : 0.f;
  };
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int r = gid + (f & 1) * 8;
      const int k = ks * 16 + 2 * tig + (f >> 1) * 8;
      split3(y_at(r, k), y_at(r, k + 1), a[0][ks][f], a[1][ks][f],
             a[2][ks][f]);
    }
  }
}

// f32 tier: coordinates d .. DMAX of every ring buffer's column plane,
// for the launch: the ones column of [X|1] at d, zeros past it (the copies
// write coordinates below d only).
template <typename P>
__device__ __forceinline__ void pad_columns_ones(unsigned char* smem,
                                                 size_t stage, int stages,
                                                 int d, int tid) {
  for (int buf = 0; buf < stages; ++buf) {
    float* c = reinterpret_cast<float*>(smem + (size_t)buf * stage) +
               (size_t)d * P::kLd;
    for (int e = tid; e < (P::kK - d) * P::kLd; e += kThreads)
      c[e] = e < P::kLd ? 1.f : 0.f;
  }
}

// f32 tier: split the landed chunk's columns (coordinate-major in the
// stage at `base`: the coordinates, 1 at d, zeros past it) into the three
// planes h, m, l at `planes`, zeros for a partial chunk's dead columns.
// A plane holds 8 x 8 core matrices of 128 contiguous bytes, as wgmma
// reads shared memory without a swizzle: core matrix (g, q) holds
// coordinates 8q .. 8q + 7 of columns 8g .. 8g + 7, a column's eight
// values 16 bytes apart, at (g * kKG + q) * 128 bytes.  It is the Gram's
// B operand K-major (columns as n) and the second product's MN-major
// (columns as k).  Thread c splits column c.
template <typename S, int DMAX>
__device__ __forceinline__ void split_columns(const unsigned char* base,
                                              unsigned char* planes, int d,
                                              int cols, int tid) {
  static_assert(kCols == kThreads, "one column a thread");
  const float* col = reinterpret_cast<const float*>(base) + tid;
  uint4* dst = reinterpret_cast<uint4*>(
      planes + (size_t)((tid >> 3) * S::kKG * 8 + (tid & 7)) * 16);
  constexpr int kPlane = (int)(S::kPadPlane / 16);
  if (tid >= cols) {
#pragma unroll
    for (int q = 0; q < S::kKG; ++q)
      dst[8 * q] = dst[kPlane + 8 * q] = dst[2 * kPlane + 8 * q] =
          make_uint4(0, 0, 0, 0);
    return;
  }
#pragma unroll
  for (int q = 0; q < S::kKG; ++q) {
    uint32_t h[4], m[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = q * 8 + 2 * e;
      if (k < DMAX) {  // (k + 1 < DMAX too: DMAX is even)
        split3(col[k * S::P::kLd], col[(k + 1) * S::P::kLd], h[e], m[e],
               l[e]);
      } else {  // past DMAX: the ones column where d == DMAX, exact in h
        h[e] = k == d ? 0x3f80u : 0u;
        m[e] = l[e] = 0u;
      }
    }
    dst[8 * q] = make_uint4(h[0], h[1], h[2], h[3]);
    dst[kPlane + 8 * q] = make_uint4(m[0], m[1], m[2], m[3]);
    dst[2 * kPlane + 8 * q] = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// A wgmma shared-memory descriptor without a swizzle: the start address,
// the byte offsets between core matrices along K (lbo) and along M or N
// (sbo), all multiples of 16.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Generic-proxy writes to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Registers a wgmma in flight reads or writes: held where they are until
// here (after its wait), so the compiler neither reads an accumulator
// early nor gives an operand's register to another value.
template <int K>
__device__ __forceinline__ void hold(float (&r)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(r[i]));
}

template <int K>
__device__ __forceinline__ void hold(uint32_t (&r)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+r"(r[i]));
}

// wgmma.mma_async m64nNk16, f32 += bf16 (A from registers, the rows
// of this warp as mma.sync's m16n8k16 A fragment; B from shared memory
// through `desc`): d holds the warp's N/2 accumulators, four per n8 tile
// as mma.sync's C fragment.  scale_d 0 starts from zero.  TB: B is
// MN-major (1) or K-major (0).
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs<32, 0>(
    float (&d)[16], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64, 0>(
    float (&d)[32], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<8, 1>(
    float (&d)[4], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16, 1>(
    float (&d)[8], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<24, 1>(
    float (&d)[12], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<40, 1>(
    float (&d)[20], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19}, "
      "{%20, %21, %22, %23}, %24, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<72, 1>(
    float (&d)[36], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35}, "
      "{%36, %37, %38, %39}, %40, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
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
    const int k0 = blockIdx.z * S::kNTG * 8;
    const int kw = min(w, k0 + S::kNTG * 8) - k0;
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
    if constexpr (S::kTensor)
      stage_aug<S, T, X2>(base + S::kAugOff, xaug + (size_t)j * w,
                          X2 ? xaug_lo + (size_t)j * w : nullptr, cols * w,
                          kCols * w, vector, tid);
    cur.template advance<Stages>();
  };
  if constexpr (S::kTensor)
    zero_pad_columns<P, T>(smem, S::kStage, Stages, d, tid);
  else
    pad_columns_ones<P>(smem, S::kStage, Stages, d, tid);
  // the raw planes' slack past kCols rows stays zero for the launch
  if constexpr (S::kTensor) {
    for (int buf = 0; buf < Stages; ++buf) {
      for (int p = 0; p < S::kPlanes; ++p) {
        T* raw = reinterpret_cast<T*>(stage_ptr(buf) + S::kAugOff +
                                      p * S::kRawPlane);
        for (int e = kCols * w + tid; e < kCols * S::kW + DMAX;
             e += kThreads)
          raw[e] = T(0.f);
      }
    }
  }

  const float inv2h2 = *inv2h2_ptr;

  if constexpr (!S::kTensor) {
    // ---- f32 tier: three exact bf16 planes on wgmma -------------------
    constexpr int KS = S::kK / 16;   // Gram k-steps of 16
    constexpr int NC = DMAX <= 16 ? 64 : 32;  // columns a Gram
    constexpr int NH = kCols / NC;   // Grams a chunk
    constexpr int KH = NC / 16;      // second-product k-steps a Gram
    constexpr int NO = 8 * S::kNO;   // output coordinates, the ones column's
    constexpr uint32_t kCM = 128;    // bytes of an 8 x 8 core matrix
    constexpr uint32_t kGroup = S::kKG * kCM;  // bytes of 8 split columns
    constexpr uint32_t kPlane = (uint32_t)S::kPadPlane;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int gid = lane >> 2;  // fragment row (and row + 8)
    const int tig = lane & 3;   // fragment column pair
    const int rbase = row0 + warp * 16;
    uint32_t a[3][KS][4];
    load_rows_split<KS>(a, x, rbase, row_end, d, lane);
    float nrm_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rbase + gid + 8 * h;
      nrm_r[h] = row < row_end ? nrm_y[row] : 0.f;
    }
    // running sums, and the column tile's chains by weight: hh, then
    // hm + mh, then hl + mm + lh
    float acc[NO / 2] = {};
    float ch[3][NO / 2] = {};
    unsigned char* planes = smem + Stages * S::kStage;
    const uint32_t planes_addr = smem_addr(planes);
    // the running sums' compensations (Kahan), in shared memory: in
    // registers they would spill the body at DMAX 16
    float* comp = reinterpret_cast<float*>(planes + S::kPad);
#pragma unroll
    for (int i = 0; i < NO / 2; ++i) comp[i * kThreads + tid] = 0.f;

    // The Gram of the block's rows and split columns c * NC .. + NC - 1:
    // six products a k-step into g, smallest weight first.  B K-major:
    // the next 8 coordinates kCM on, the next 8 columns kGroup on.
    auto gram = [&](float (&g)[NC / 2], int c) {
      const uint32_t at = planes_addr + (uint32_t)(c * NC / 8) * kGroup;
      auto b = [&](int p, int ks) {
        return wgmma_desc(at + p * kPlane + 2 * ks * kCM, kCM, kGroup);
      };
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        wgmma_rs<NC, 0>(g, a[0][ks], b(2, ks), ks > 0);
        wgmma_rs<NC, 0>(g, a[1][ks], b(1, ks), 1);
        wgmma_rs<NC, 0>(g, a[2][ks], b(0, ks), 1);
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        wgmma_rs<NC, 0>(g, a[0][ks], b(1, ks), 1);
        wgmma_rs<NC, 0>(g, a[1][ks], b(0, ks), 1);
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wgmma_rs<NC, 0>(g, a[0][ks], b(0, ks), 1);
    };
    // phi's planes pa (KH k-steps of 16 columns) times the three planes of
    // the same columns' [X|1]: six products a k-step into the chains,
    // which a column tile's first product starts from zero (`fresh`): only
    // wgmma writes them, so ptxas keeps the wgmmas in flight.  B MN-major:
    // the next 8 coordinates kCM on, the next 8 columns kGroup on.
    auto second = [&](const uint32_t (&pa)[KH][3][4], int c, bool fresh) {
#pragma unroll
      for (int s = 0; s < KH; ++s) {
        const uint32_t at =
            planes_addr + (uint32_t)((c * NC + 16 * s) / 8) * kGroup;
        auto b = [&](int p) {
          return wgmma_desc(at + p * kPlane, kGroup, kCM);
        };
        const int keep = s > 0 || !fresh;
        wgmma_rs<NO, 1>(ch[2], pa[s][0], b(2), keep);
        wgmma_rs<NO, 1>(ch[2], pa[s][1], b(1), 1);
        wgmma_rs<NO, 1>(ch[2], pa[s][2], b(0), 1);
        wgmma_rs<NO, 1>(ch[1], pa[s][0], b(1), keep);
        wgmma_rs<NO, 1>(ch[1], pa[s][1], b(0), 1);
        wgmma_rs<NO, 1>(ch[0], pa[s][0], b(0), keep);
      }
    };

    auto compute = [&](int buf, int chunk) {
      const unsigned char* base = stage_ptr(buf);
      const int cols = chunk_cols(chunk);
      split_columns<S, DMAX>(base, planes, d, cols, tid);
      fence_proxy_async();
      __syncthreads();  // split planes complete
      const float* s_nrm =
          reinterpret_cast<const float*>(base + P::kPlanes * P::kPlane);
      auto run = [&](auto masked) {
        // Grams in flight one ahead of the exp epilogue: the Gram of
        // columns c + 1 runs on the tensor cores while phi of columns c
        // is made, split and sent to the second product
        float g[2][NC / 2];
        uint32_t pa[KH][3][4];
        wgmma_fence();
        gram(g[0], 0);
        wgmma_commit();
#pragma unroll
        for (int c = 0; c < NH; ++c) {
          float(&gc)[NC / 2] = g[c & 1];
          if (c + 1 < NH) {
            wgmma_fence();
            gram(g[(c + 1) & 1], c + 1);
            wgmma_commit();
            wgmma_wait<1>();  // Gram c and the second product of c - 1
          } else {
            wgmma_wait<0>();
          }
          hold(gc);
#pragma unroll
          for (int s = 0; s < KH; ++s)
#pragma unroll
            for (int p = 0; p < 3; ++p) hold(pa[s][p]);
#pragma unroll
          for (int j = 0; j < NC / 8; ++j) {
            const int c0 = c * NC + 8 * j + 2 * tig;
            const float2 nc = *reinterpret_cast<const float2*>(s_nrm + c0);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float sq = fmaxf(
                  fmaf(-2.f, gc[4 * j + e],
                       nrm_r[e >> 1] + ((e & 1) ? nc.y : nc.x)),
                  0.f);
              const float p = expf(-sq * inv2h2);
              gc[4 * j + e] =
                  (!decltype(masked)::value || c0 + (e & 1) < cols) ? p
                                                                    : 0.f;
            }
          }
          // phi's planes as the A fragments of 16-column k-steps: n8
          // tile 2 s gives columns 0 .. 7 of k-step s, tile 2 s + 1 the
          // rest
#pragma unroll
          for (int s = 0; s < KH; ++s)
#pragma unroll
            for (int f = 0; f < 4; ++f) {
              const int i = 4 * (2 * s + (f >> 1)) + (f & 1) * 2;
              split3(gc[i], gc[i + 1], pa[s][0][f], pa[s][1][f],
                     pa[s][2][f]);
            }
          wgmma_fence();
          second(pa, c, c == 0 && chunk == 0);
          wgmma_commit();
        }
        wgmma_wait<0>();
#pragma unroll
        for (int s = 0; s < KH; ++s)
#pragma unroll
          for (int p = 0; p < 3; ++p) hold(pa[s][p]);
#pragma unroll
        for (int q = 0; q < 3; ++q) hold(ch[q]);
      };
      if (cols == kCols)
        run(std::false_type{});
      else
        run(std::true_type{});
    };
    // the end of a column tile: its chains, smallest first, into the
    // running sums, compensated (Kahan): B3 at 1M adds ~7,500 tiles a
    // row, and plain f32 sums lose each tile's low bits, an error that
    // grows with the tiles and does not average out
    auto flush = [&]() {
#pragma unroll
      for (int i = 0; i < NO / 2; ++i) {
        float& c = comp[i * kThreads + tid];
        const float y = ((ch[2][i] + ch[1][i]) + ch[0][i]) - c;
        const float t = acc[i] + y;
        c = (t - acc[i]) - y;
        acc[i] = t;
      }
    };
    walk<Stages>(nq, cpt, stage_next, compute, flush);
#pragma unroll
    for (int i = 0; i < NO / 2; ++i) {
      const int row = rbase + gid + 8 * ((i & 3) >> 1);
      const int k = 8 * (i >> 2) + 2 * tig + (i & 1);
      if (row < row_end && k < w) out[(size_t)row * w + k] = acc[i];
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
  // runs of kNTG n8 tiles of the d+1 output coordinates
  const int groups = ((d + 1 + 7) / 8 + S::kNTG - 1) / S::kNTG;
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
