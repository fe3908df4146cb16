"""Cost model of the Hopper kernels and the launch-tile sweep.

The counterpart of ``repro.kernels.tuning``, written for one NVIDIA H100
SXM and for what the port's kernels really launch (none of the TPU's
surfaces carry over).  A pairwise pass (B1-B6) is priced on the padded
problem and the launch geometry:

  * rows padded to ``block_m`` (the score pass pads train rows to
    lcm(block_m, block_n)), columns to ``block_n``;
  * blocks of 128 threads that each sum 64 rows (``ROWS``) of one row
    tile over one column split, so a ``block_m`` that is not a multiple
    of 64 leaves rows idle; the splits come from the kernels' own plans,
    ``flash_kde.plan_splits`` and ``flash_score.plan_score_splits``
    (bf16x2 score passes also spread the output's n8 tiles over the
    grid's z axis);
  * waves of blocks over 132 SMs, as many a block an SM as the
    instantiation's shared memory and register cap allow (``PassSmem``
    and ``ScoreSmem`` of ``csrc/``, mirrored below);
  * the pruned passes (B3, B4) walk ``visits`` visit slots of
    ``block_n`` columns a row tile.

Resources, each a time over the pass (the slowest one bounds it):

    t_hbm    = bytes / 3.35 TB/s      (operands, split scratch, sums)
    t_fp32   = f32 Gram flops / 67 TFLOP/s (the f32 KDE passes)
    t_tensor = tensor-core flops × products / 989 TFLOP/s (the bf16
               tiers, and the f32 score pass: six products of three exact
               bf16 planes a side, ``SPLIT_PRODUCTS``)
    t_sfu    = exps / (16 a clock an SM × 132 × 1.98 GHz)
    t_issue  = instructions / (128 a clock an SM × 132 × 1.98 GHz)

The issue term counts the epilogue's ~14 instructions a pair (norm sum,
clamp, scale, expf's 8, the add), at the f32 KDE passes the Gram's d
FMAs and their shared-memory loads, and at the f32 score pass the
split's instructions (``SPLIT_INSTR``): B1-B6 are bound by instruction
issue there (PERF.md §6).  Wave quantisation, a fixed cost a block and a
launch's cost come on top, and no pass is priced below its bound
(:func:`pair_bound`): the least time the card could take for the work,
the same definition ``chip_smoke.py`` reports beside each kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional, Tuple

from repro_torch.kernels import flash_kde, flash_score
from repro_torch.kernels import precision as prec

# H100 SXM, NVIDIA data sheet (dense, at the 700 W limit); exp on the SFU
# at 16 results a clock an SM (CUDA C++ Programming Guide, compute
# capability 9.0); instruction issue at 4 schedulers × 32 lanes a clock
# an SM; the 1980 MHz boost clock.
HBM_BW = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
SMS = 132
CLOCK_HZ = 1.98e9
EXP_RATE = 16 * SMS * CLOCK_HZ
ISSUE_RATE = 128 * SMS * CLOCK_HZ
SMEM_SM = 233472                  # 228 KB of shared memory an SM
SMEM_BLOCK = 232448               # 227 KB, the most one block may use
SMEM_RESERVED = 1024              # reserved a block

# The kernels' launch geometry (csrc/flash_kde_pass.cuh).
ROWS = 64                         # rows a block sums
CHUNK = 128                       # columns a staged chunk
STAGES = 3                        # chunks in the KDE pass's ring

# Epilogue instructions a pair, by weight (PERF.md §6: expf lowers to 8
# of ~14): the Laplace factor adds two, the square moment's multiply one.
EPILOGUE_INSTR = {"kde": 14, "laplace": 16, "sq_moment": 15, "score": 14}
# The f32 score pass (csrc/flash_score_pass.cuh): each operand and phi
# split into three exact bf16 planes, six of the nine plane products a
# GEMM on wgmma (three for the ones column, exact in its h plane).  Its
# issue slots a pair beyond the epilogue's: SPLIT_INSTR, plus
# SPLIT_INSTR_PER_COORD for each coordinate of the Gram's k (padded to
# 16) and of the output tiles (d and the ones column in n8 tiles).  Both
# are fitted, least squares, to B1's CUDA-graph times at 32768 x 32768
# and d = 1, 4, 8, 16, 24 on one H100 80GB HBM3 at 700 W (1.243, 1.224,
# 1.333, 1.475, 2.101 ms): the model lands within 2.5% of each.  At
# d = 64 (DMAX 64, whose build spills) it gives 3.26 ms against 5.24.
SPLIT_PRODUCTS = 6
SPLIT_INSTR = 9.1
SPLIT_INSTR_PER_COORD = 0.55
# Fixed costs: a block's prologue, zero fill and partial write, and one
# kernel launch on the stream.
BLOCK_OVERHEAD_S = 1.5e-6
LAUNCH_S = 4e-6

KINDS = ("score", "kde", "laplace", "sq_moment")


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def on_tensor_cores(kind: str, precision: str) -> bool:
    """Whether a pass's products run on the tensor cores: the bf16 tiers
    of every pass, and the f32 score pass (three exact bf16 planes)."""
    return precision != "f32" or kind == "score"


def pair_operations(kind: str, precision: str, d: int) -> Tuple[int, int]:
    """(Gram flops, elementwise FP32 flops) of one (row, column) pair:
    the Gram's 2d (and the score pass's φ·[X|1], 2(d+1)), four products
    at bf16x2, and the elementwise work (score 3, kde 4, laplace 6,
    sq_moment 5); one exp a pair comes on top, on the SFU.  The f32
    score pass runs its products as ``SPLIT_PRODUCTS`` products of bf16
    planes (the ones column, exact in one plane, as three) on the tensor
    cores, 24d + 6 flops, and its elementwise work adds φ's split, two
    subtractions."""
    if kind not in KINDS:
        raise ValueError(f"unknown pass kind {kind!r} (choose from {KINDS})")
    prec.validate(precision)
    elementwise = {"score": 3, "kde": 4, "laplace": 6, "sq_moment": 5}[kind]
    if kind == "score" and precision == "f32":
        return SPLIT_PRODUCTS * 4 * d + 3 * 2, elementwise + 2
    gemm = 2 * d + (2 * (d + 1) if kind == "score" else 0)
    return gemm * prec.gram_products(precision), elementwise


def pair_bound(kind: str, precision: str, pairs: float, d: int,
               moved: float) -> Tuple[float, str]:
    """(seconds, "bytes" | "operations"): the least time the card could
    take for a pass over ``pairs`` (row, column) pairs that must move
    ``moved`` bytes (each input read once, each output written once).

    Operations (:func:`pair_operations`): the products as tensor-core
    flops where they run there (:func:`on_tensor_cores`: the bf16 tiers
    and the f32 score pass), else as FP32 flops, the elementwise work as
    FP32 flops, and one exp a pair on the SFU; the larger of the
    operations and the bytes over their peak rates.  ``chip_smoke.py``'s
    bounds and the tuner's floor are this function."""
    gemm, elementwise = pair_operations(kind, precision, d)
    if on_tensor_cores(kind, precision):
        ops_s = max(pairs * gemm / BF16_FLOPS,
                    pairs * elementwise / FP32_FLOPS)
    else:
        ops_s = pairs * (gemm + elementwise) / FP32_FLOPS
    ops_s = max(ops_s, pairs / EXP_RATE)
    bytes_s = moved / HBM_BW
    return (max(ops_s, bytes_s),
            "operations" if ops_s >= bytes_s else "bytes")


def _dmax(d: int, precision: str) -> int:
    """The instantiation's DMAX for d at a tier (the dispatch switches)."""
    sizes = (4, 8, 16, 32, 64) if precision == "f32" else (16, 32, 64)
    for s in sizes:
        if d <= s:
            return s
    return 64


def kde_pass_smem(d: int, precision: str) -> Tuple[int, int]:
    """(bytes, blocks an SM) of the KDE pass at d (``PassSmem``)."""
    tensor = precision != "f32"
    size = 4 if precision == "f32" else 2
    dm = _dmax(d, precision)
    k = max(16, dm) if tensor else dm
    ld = CHUNK + 16 // size
    planes = 2 if precision == "bf16x2" else 1
    stage = planes * k * ld * size + CHUNK * 4
    rows = 0 if tensor else dm * ROWS * 4
    nbytes = STAGES * stage + rows
    by_smem = SMEM_SM // (nbytes + SMEM_RESERVED)
    cap = 5 if tensor and dm <= 32 else 4
    return nbytes, max(1, min(by_smem, cap))


def score_pass_smem(d: int, precision: str) -> Tuple[int, int]:
    """(bytes, blocks an SM) of the score pass at d (``ScoreSmem``): the
    ring of staged chunks (the bf16 tiers' with their [X|1] rows) and the
    planes the products read (the bf16 tiers' [X|1] rows relaid for
    ldmatrix, the f32 tier's three split planes of the columns), and at
    f32 the running sums' compensations, four values a thread for each
    n8 output tile."""
    tensor = precision != "f32"
    size = 4 if precision == "f32" else 2
    dm = _dmax(d, precision)
    k = max(16, dm) if tensor else dm
    ld = CHUNK + 16 // size
    planes = 2 if precision == "bf16x2" else 1
    w = dm + 1
    stages = 3 if dm <= 16 else 2
    stage = planes * k * ld * size + CHUNK * 4
    if tensor:
        stage += planes * (((CHUNK * w + dm) * size + 15) // 16 * 16)
    k16 = max(16, dm)
    # the bf16 tiers' relaid [X|1] rows, the f32 tier's split planes: the
    # Gram's k and the output tiles (the ones column's too) in groups of 8
    groups = (k16 + 8) // 8 if tensor else max(k16 // 8, (dm + 8) // 8)
    pad = (planes if tensor else 3) * CHUNK * 8 * groups * 2
    # 128 threads a block, four f32 values a thread an n8 tile
    comp = 0 if tensor else 128 * 4 * ((dm + 8) // 8) * 4
    nbytes = stages * stage + pad + comp
    by_smem = SMEM_SM // (nbytes + SMEM_RESERVED)
    cap = 4 if tensor else (3 if dm <= 16 else 2)
    return nbytes, max(1, min(by_smem, cap))


def score_groups(d: int, precision: str) -> int:
    """Blocks on the grid's z axis: runs of n8 output tiles (three at
    most at bf16x2), each repeating the Gram."""
    if precision == "f32":
        return 1
    nt = (_dmax(d, precision) + 1 + 7) // 8
    ntg = 3 if precision == "bf16x2" and nt > 3 else nt
    return -(-((d + 1 + 7) // 8) // ntg)


def infeasible(d: int, *, block_m: int, block_n: int,
               precision: str = "f32", out_width: int = 1) -> Optional[str]:
    """Why the kernels would refuse this launch (None: they take it).

    The kernels' own limits: ``MAX_D``, ``MAX_BLOCK_M`` and the shared
    memory one block may use, for the KDE pass or (``out_width`` > 1)
    the score pass."""
    if not 1 <= d <= flash_kde.MAX_D:
        return f"d={d} outside [1, {flash_kde.MAX_D}]"
    if not 1 <= block_m <= flash_kde.MAX_BLOCK_M:
        return f"block_m={block_m} outside [1, {flash_kde.MAX_BLOCK_M}]"
    if block_n < 1:
        return f"block_n={block_n} < 1"
    smem = (score_pass_smem if out_width > 1 else kde_pass_smem)(
        d, precision)[0]
    if smem > SMEM_BLOCK:
        return f"{smem} bytes of shared memory > {SMEM_BLOCK}"
    return None


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """One pass at one launch: the work it does and what it costs."""

    block_m: int
    block_n: int
    kind: str
    precision: str
    pairs: float               # (row, column) pairs the blocks compute
    hbm_bytes: float
    fp32_flops: float
    tensor_flops: float
    exp_count: float
    instructions: float        # thread instructions
    blocks: int
    blocks_per_sm: int
    smem_bytes: int
    splits: int
    floor_s: float             # pair_bound of the pass's real work
    floor_by: str

    @property
    def t_hbm(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_fp32(self) -> float:
        return self.fp32_flops / FP32_FLOPS

    @property
    def t_tensor(self) -> float:
        return self.tensor_flops / BF16_FLOPS

    @property
    def t_sfu(self) -> float:
        return self.exp_count / EXP_RATE

    @property
    def t_issue(self) -> float:
        return self.instructions / ISSUE_RATE

    @property
    def waves(self) -> float:
        return self.blocks / (SMS * self.blocks_per_sm)

    def _terms(self) -> dict:
        return {"hbm": self.t_hbm, "fp32": self.t_fp32,
                "tensor": self.t_tensor, "sfu": self.t_sfu,
                "issue": self.t_issue}

    @property
    def step_time(self) -> float:
        """Modeled seconds of the whole pass: the slowest resource over
        the waves the grid really takes, plus the blocks' fixed costs and
        the launches, never below the floor."""
        w = self.waves
        quant = max(1.0, math.ceil(w)) / w if w > 0 else 1.0
        t = (max(self._terms().values()) * quant
             + math.ceil(w) * BLOCK_OVERHEAD_S
             + LAUNCH_S * (2 if self.splits > 1 else 1))
        return max(t, self.floor_s)

    @property
    def bound(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)


def pair_pass_cost(rows: int, cols: int, d: int, *, block_m: int,
                   block_n: int, out_width: Optional[int] = None,
                   precision: str = "f32", kind: Optional[str] = None,
                   visits: Optional[int] = None) -> KernelCost:
    """One pairwise pass as the kernels launch it.

    ``rows`` query (or train) rows, ``cols`` train columns, ``out_width``
    d+1 for the score pass (B1/B3: rows and columns are the same train
    set), 1 for the KDE passes; ``kind`` the pass's weight ("kde",
    "laplace", "sq_moment"; "score" when ``out_width`` > 1); ``visits``
    the visit slots a row tile walks in the pruned passes (B3/B4), None
    for the dense ones (every column tile)."""
    prec.validate(precision)
    ow = out_width if out_width is not None else 1
    score = ow > 1
    kind = kind or ("score" if score else "kde")
    if kind not in KINDS:
        raise ValueError(f"unknown pass kind {kind!r} (choose from {KINDS})")
    if score:
        mult = math.lcm(block_m, block_n)
        rows_p = cols_p = _round_up(max(rows, cols), mult)
        plan = flash_score.plan_score_splits(cols_p, block_n, d, visits)
        smem, per_sm = score_pass_smem(d, precision)
        groups = score_groups(d, precision)
    else:
        rows_p = _round_up(rows, block_m)
        cols_p = _round_up(cols, block_n)
        plan = flash_kde.plan_splits(cols_p, block_n, visits)
        smem, per_sm = kde_pass_smem(d, precision)
        groups = 1
    tiles = cols_p // block_n
    slots = tiles if visits is None else min(visits, tiles)
    row_blocks = (rows_p // block_m) * -(-block_m // ROWS)
    blocks = row_blocks * plan.splits * groups
    pairs = float(row_blocks * ROWS) * slots * block_n

    ib = prec.operand_bytes(precision)
    aug = cols_p * (d + 1) * ib if score else 0
    moved = rows_p * (d * ib + 4) + cols_p * (d * ib + 4) + aug \
        + rows_p * ow * 4
    scratch = 2 * plan.splits * rows_p * ow * 4 if plan.splits > 1 else 0

    products = prec.gram_products(precision)
    if score and precision == "f32":
        # six products of the planes on wgmma: the Gram over k, padded to
        # the MMA's 16, and phi.[X|1] over the n8 tiles of the
        # coordinates and the ones column; a wgmma covers 64 rows, so its
        # issue is the split's and the epilogue's alone
        dm = _dmax(d, precision)
        fp32 = 0.0
        tensor = pairs * SPLIT_PRODUCTS * 2 * (max(16, dm)
                                               + 8 * ((dm + 8) // 8))
        gram_instr = SPLIT_INSTR + SPLIT_INSTR_PER_COORD * (
            max(16, dm) + 8 * ((dm + 8) // 8))
    elif precision == "f32":
        fp32 = pairs * 2 * d + (pairs * 2 * (d + 1) if score else 0.0)
        tensor = 0.0
        # d FMAs a pair plus 3 shared-memory loads per 32 of them, for the
        # Gram and (score) the second product
        gram_instr = d * (1 + 3 / 32) * (2 if score else 1)
    else:
        k = max(16, _dmax(d, precision))
        fp32 = 0.0
        tensor = products * pairs * (2 * k + (2 * k if score else 0))
        # one warp mma.sync m16n8k16 covers 128 pairs of 16 coordinates,
        # with an ldmatrix beside it: ~0.5 thread instructions a pair a
        # k-step a product
        gram_instr = 0.5 * (k // 16) * products * (2 if score else 1)
    instr = pairs * (EPILOGUE_INSTR[kind] + gram_instr)
    real_pairs = float(rows) * (cols if visits is None
                                else slots * block_n)
    floor_s, floor_by = pair_bound(kind, precision, real_pairs, d, moved)
    return KernelCost(
        block_m=block_m, block_n=block_n, kind=kind, precision=precision,
        pairs=pairs, hbm_bytes=float(moved + scratch), fp32_flops=fp32,
        tensor_flops=tensor, exp_count=pairs, instructions=instr,
        blocks=blocks, blocks_per_sm=per_sm, smem_bytes=smem,
        splits=plan.splits, floor_s=floor_s, floor_by=floor_by)


def sdkde_device_cost(n: int, m: int, d: int, *, block_m: int = 128,
                      block_n: int = 128, precision: str = "f32"
                      ) -> Tuple[KernelCost, KernelCost]:
    """(score pass, KDE pass) of one SD-KDE fit and evaluation on one
    card: B1 over n × n, B2 over m queries against n columns."""
    score = pair_pass_cost(n, n, d, block_m=block_m, block_n=block_n,
                           out_width=d + 1, precision=precision)
    kde = pair_pass_cost(m, n, d, block_m=block_m, block_n=block_n,
                         out_width=1, precision=precision)
    return score, kde


def selective_scan_bytes(bsz: int, s: int, d: int, n: int,
                         itemsize: int = 2) -> Tuple[float, float]:
    """(kernel HBM bytes, eager-path HBM bytes) for the Mamba selective
    scan.

    Kernel (B7): stream xi/Δ/B/C in, y out — the (S, d, N) state never
    leaves the SM.  The associative branch of ``models/ssm.py``
    materializes decay and drive (B, S, d, N) f32 and re-reads them; we
    count the minimal 2 tensors × (write + read), a lower bound on its
    traffic."""
    kernel = bsz * s * (2 * d * itemsize + 2 * n * itemsize + 4 * d)
    eager = 2 * 2 * bsz * s * d * n * 4
    return float(kernel), float(eager)


def sweep_blocks(rows: int, cols: int, d: int, *,
                 block_ms: Iterable[int] = (64, 128, 256),
                 block_ns: Iterable[int] = (128, 256, 512, 1024, 2048),
                 out_width: Optional[int] = None, precision: str = "f32"):
    """Every launch the kernels accept, sorted by modeled time."""
    ow = out_width if out_width is not None else 1
    out = []
    for bm in block_ms:
        for bn in block_ns:
            if infeasible(d, block_m=bm, block_n=bn, precision=precision,
                          out_width=ow) is None:
                out.append(pair_pass_cost(rows, cols, d, block_m=bm,
                                          block_n=bn, out_width=ow,
                                          precision=precision))
    return sorted(out, key=lambda c: c.step_time)


def best_blocks(rows: int, cols: int, d: int, **kw) -> KernelCost:
    return sweep_blocks(rows, cols, d, **kw)[0]


def rff_eval_cost(rows: int, d: int, *, n_features: int, n_pilot: int = 0,
                  precision: str = "f32", groups: int = 32) -> float:
    """Modeled seconds of one RFF evaluation of ``rows`` queries
    (``flash_rff.eval_density``): the (rows × d)@(d × D/2) phase product
    (FP32, or tensor flops at the bf16 tiers), cos and sin of each phase
    (~20 instructions each), and ~11 passes of plain PyTorch over the f32
    (rows, D/2) phase plane (the product's write, cos, sin, the two
    weightings, their sum, the group means), each a launch; ``n_pilot``
    adds the (rows, K) pilot pass."""
    prec.validate(precision)
    half = n_features // 2
    plane = float(rows) * half
    flops = 2.0 * plane * d * prec.gram_products(precision)
    t_gemm = flops / (FP32_FLOPS if precision == "f32" else BF16_FLOPS)
    t_trig = 2 * 20 * plane / ISSUE_RATE
    t_bytes = 11 * plane * 4 / HBM_BW
    t = max(t_gemm, t_trig, t_bytes) + 15 * LAUNCH_S
    if n_pilot > 0:
        pilot = float(rows) * n_pilot
        t += max(2.0 * pilot * d / FP32_FLOPS, 6 * pilot * 4 / HBM_BW,
                 pilot / EXP_RATE) + 8 * LAUNCH_S
    return t


__all__ = [
    "HBM_BW", "FP32_FLOPS", "BF16_FLOPS", "SMS", "CLOCK_HZ", "EXP_RATE",
    "ISSUE_RATE", "SMEM_BLOCK", "ROWS", "EPILOGUE_INSTR", "KINDS",
    "SPLIT_PRODUCTS", "SPLIT_INSTR", "SPLIT_INSTR_PER_COORD", "KernelCost",
    "on_tensor_cores",
    "pair_operations", "pair_bound", "kde_pass_smem", "score_pass_smem",
    "score_groups", "infeasible", "pair_pass_cost", "sdkde_device_cost",
    "selective_scan_bytes", "sweep_blocks", "best_blocks", "rff_eval_cost",
]
