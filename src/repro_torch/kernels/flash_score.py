"""Flash score pass (kernel B1): the SD-KDE empirical-score statistics.

Computes, for every row i, ``S1aug_i = Σ_j φ_ij · [x_j | 1]`` with
``φ_ij = exp(-‖x_i - x_j‖²/(2h²))`` — the score numerator ``Φ X`` and the
denominator ``Φ 1`` in one pass.  Three functions:

  * ``flash_score_cuda`` launches the hand-written CUDA kernel
    (``csrc/flash_score.cu``) on CUDA tensors and counts the launch;
  * ``flash_score_plain`` is the same function in plain PyTorch,
    streaming column blocks of ``block_n`` so n×n is never materialized;
  * ``flash_score`` takes the plain version for CPU tensors and the
    kernel for CUDA tensors — no fallback between them.

Arguments follow ``repro.kernels.flash_score.flash_score_pallas``: x
(m, d), nrm (m, 1) f32, xt (d, n), xaug (n, d+1), ``inv2h2`` a (1, 1) f32
tensor, and for bf16x2 the three lo planes.  The result is (m, d+1) f32.
The rows and the columns may be two point sets (the ring pairs a rank's
resident rows with a visiting block): ``nrm_x`` then holds the columns'
n norms.  Without it the call is the fit's square pass over one train
set (m = n, ``nrm`` for both sides), the only form ``repro`` has.
At the bf16 tiers xaug is ``[xt^T | 1]`` cast to the tier, as
``ops._score_operands`` makes it.  At f32 the kernel reads the columns
once, from xt, and makes the ones column itself, so it takes
``xaug=None`` and refuses any other; the plain version takes None as
``[xt^T | 1]`` (``ones_augmented``) and multiplies by a given xaug, as
the absolute-mass checks use it.  The f32 kernel runs both products on
the tensor cores as six bf16 products of three exact planes a side
(``precision.split_three``), f32-accurate and without TF32.  At the
bf16 tiers φ is rounded (bf16) or split (bf16x2) before it multiplies
``[X|1]``, as ``precision.weighted_accum`` does.

The kernel splits the columns, as the KDE pass does: each block sums 64
rows over one split of ``plan_score_splits(n, block_n, d, rows=m)
.per_split`` column tiles into an (splits, m, d+1) f32 scratch, and a
second pass in the same launch adds each value's splits in order.  The
plan follows the rows m, the columns n, block_n and d (and, for B3, the
visit width): enough splits for about eight blocks per SM, the scratch
held to ``SCORE_SCRATCH_BYTES``, and one split, with no scratch and no
second pass, once the row blocks alone fill the card (m = 1M).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import precision as prec
from repro_torch.kernels.flash_kde import TIER_CODES, SplitPlan, check_cuda

_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_void_p]

#: Rows a block of the score pass sums (the kernel's kRows).
SCORE_ROWS = 64
#: Blocks the score pass aims for: eight per SM of the H100's 132, two
#: waves or more at the 2-4 blocks an SM holds.
SCORE_TARGET_BLOCKS = 8 * 132
#: The most bytes the (splits, m, d+1) f32 scratch may take.
SCORE_SCRATCH_BYTES = 256 << 20

#: Kernel launches made by ``flash_score_cuda``; set to 0 to start a count.
launches = 0


@dataclasses.dataclass(frozen=True)
class ScorePlan(SplitPlan):
    """How the score pass splits one row tile's column tiles (B1) or
    visit slots (B3), and the width d+1 of the partial sums."""

    width: int = 1

    def scratch_shape(self, m: int) -> Optional[Tuple[int, int, int]]:
        """The (splits, m, d+1) f32 partial sums of m rows the wrapper
        allocates; None with one split, where the kernel writes S1aug
        itself."""
        return (self.splits, m, self.width) if self.splits > 1 else None


def plan_score_splits(n: int, block_n: int, d: int,
                      visits: Optional[int] = None,
                      rows: Optional[int] = None) -> ScorePlan:
    """The column splits of the score pass of ``rows`` rows (n, the
    square pass, by default) against n columns of d coordinates in
    column tiles of ``block_n``, over the n/block_n column tiles (B1) or
    ``visits`` visit slots, the visit lists' width (B3).

    Splits are added until the rows/64 row blocks times the splits reach
    ``SCORE_TARGET_BLOCKS``, within the slots and within the scratch cap
    of (splits, rows, d+1) f32; n = 32768 square gets 3 (1536 blocks),
    n = 1M one."""
    m = n if rows is None else rows
    if (n < 1 or m < 1 or block_n < 1 or d < 1
            or (visits is not None and visits < 1)):
        raise ValueError(f"bad split plan input n={n} rows={m} "
                         f"block_n={block_n} d={d} visits={visits}")
    slots = -(-n // block_n) if visits is None else visits
    width = d + 1
    want = -(-SCORE_TARGET_BLOCKS // -(-m // SCORE_ROWS))
    cap = SCORE_SCRATCH_BYTES // (m * width * 4)
    splits = max(1, min(want, slots, cap))
    per_split = -(-slots // splits)
    return ScorePlan(per_split, -(-slots // per_split), slots, width)


def ones_augmented(xt: torch.Tensor) -> torch.Tensor:
    """``[xt^T | 1]`` (n, d+1): the second product's operand that the f32
    kernel makes from xt itself."""
    return torch.cat([xt.T, xt.new_ones((xt.shape[-1], 1))], dim=1)


def _check(x, nrm, xt, xaug, inv2h2, x_lo, xt_lo, xaug_lo, block_m,
           block_n, nrm_x=None):
    """(m, n, d) of a launch: m rows of x against the n columns of xt;
    without ``nrm_x`` the square pass (n = m).  ``xaug`` may be None at
    f32 alone (``[xt^T | 1]``)."""
    m, d = x.shape
    n = m if nrm_x is None else xt.shape[-1]
    if m % block_m or n % block_n:
        raise ValueError(f"rows m={m} must be a multiple of block_m="
                         f"{block_m} and columns n={n} of block_n={block_n}")
    if xaug is None and x.dtype != torch.float32:
        raise ValueError("the bf16 tiers need xaug, [xt^T | 1] cast to the "
                         "tier")
    if tuple(xt.shape) != (d, n) or (xaug is not None and
                                     tuple(xaug.shape) != (n, d + 1)):
        raise ValueError(f"xt {tuple(xt.shape)} / xaug "
                         f"{None if xaug is None else tuple(xaug.shape)} "
                         f"do not match x {tuple(x.shape)} and n={n}")
    if tuple(nrm.shape) != (m, 1) or inv2h2.numel() != 1:
        raise ValueError("nrm must be (m, 1) and inv2h2 hold one value")
    if nrm_x is not None and (nrm_x.numel() != n
                              or not nrm_x.is_contiguous()):
        raise ValueError(f"nrm_x must hold the n={n} column norms "
                         f"(contiguous), got {tuple(nrm_x.shape)}")
    los = (x_lo, xt_lo, xaug_lo)
    if not (all(v is None for v in los) or all(v is not None for v in los)):
        raise ValueError("bf16x2 needs all three lo planes")
    return m, n, d


def flash_score_plain(
    x: torch.Tensor,
    nrm: torch.Tensor,
    xt: torch.Tensor,
    xaug: Optional[torch.Tensor],
    inv2h2: torch.Tensor,
    x_lo: Optional[torch.Tensor] = None,
    xt_lo: Optional[torch.Tensor] = None,
    xaug_lo: Optional[torch.Tensor] = None,
    *,
    nrm_x: Optional[torch.Tensor] = None,
    block_n: int = 128,
) -> torch.Tensor:
    """Plain PyTorch B1, one column block of ``block_n`` at a time: m rows
    against the n columns of ``xt`` (norms ``nrm_x``, or ``nrm`` for the
    square pass); ``xaug=None`` is ``[xt^T | 1]``."""
    m, d = x.shape
    n = xt.shape[-1]
    if xaug is None:
        xaug = ones_augmented(xt)
    out = torch.zeros((m, d + 1), dtype=torch.float32, device=x.device)
    nrm_col = (nrm if nrm_x is None else nrm_x).reshape(1, -1)
    for j0 in range(0, n, block_n):
        cols = slice(j0, j0 + block_n)
        if x_lo is None:
            g = prec.dot_f32(x, xt[:, cols])
        else:
            g = prec.gram_compensated(x, x_lo, xt[:, cols], xt_lo[:, cols])
        sq = torch.clamp(nrm + nrm_col[:, cols] - 2.0 * g, min=0.0)
        phi = torch.exp(-sq * inv2h2)
        out += prec.weighted_accum(
            phi, xaug[cols], None if xaug_lo is None else xaug_lo[cols])
    return out


def flash_score_cuda(
    x: torch.Tensor,
    nrm: torch.Tensor,
    xt: torch.Tensor,
    xaug: Optional[torch.Tensor],
    inv2h2: torch.Tensor,
    x_lo: Optional[torch.Tensor] = None,
    xt_lo: Optional[torch.Tensor] = None,
    xaug_lo: Optional[torch.Tensor] = None,
    *,
    nrm_x: Optional[torch.Tensor] = None,
    block_m: int = 128,
    block_n: int = 128,
) -> torch.Tensor:
    """Launch kernel B1 (both of its passes) on the current stream;
    returns (m, d+1) f32.  The column tiles are split as
    ``plan_score_splits(n, block_n, d, rows=m)`` plans them; without
    ``nrm_x`` the square pass, one norm pointer for both sides."""
    global launches
    m, n, d = _check(x, nrm, xt, xaug, inv2h2, x_lo, xt_lo, xaug_lo,
                     block_m, block_n, nrm_x)
    tier = prec.tier_of(x, x_lo)
    if tier == "f32" and xaug is not None:
        raise ValueError("flash_score_cuda: the f32 kernel makes [xt^T | 1] "
                         "from xt; pass xaug=None")
    nrm_col = nrm if nrm_x is None else nrm_x
    dev = check_cuda("flash_score_cuda", tier,
                     (x, xt, xaug, x_lo, xt_lo, xaug_lo),
                     (nrm, nrm_col, inv2h2), d, block_m)
    plan = plan_score_splits(n, block_n, d, rows=m)
    launch, error = _build.load("flash_score", _ARGTYPES)
    shape = plan.scratch_shape(m)
    part = None if shape is None else torch.empty(
        shape, dtype=torch.float32, device=dev)
    out = torch.empty((m, d + 1), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(ptr(x), ptr(x_lo), ptr(nrm), ptr(nrm_col), ptr(xt),
                    ptr(xt_lo), ptr(xaug), ptr(xaug_lo), ptr(inv2h2),
                    ptr(part), ptr(out), m, n, d, TIER_CODES[tier], block_m,
                    block_n, plan.per_split, plan.splits, stream)
    if rc != 0:
        raise RuntimeError(f"flash_score kernel launch failed ({rc}): "
                           f"{error(rc).decode()} [m={m} n={n} d={d} "
                           f"tier={tier} block_m={block_m} "
                           f"block_n={block_n} splits={plan.splits}]")
    launches += 1
    return out


def flash_score(
    x: torch.Tensor,
    nrm: torch.Tensor,
    xt: torch.Tensor,
    xaug: Optional[torch.Tensor],
    inv2h2: torch.Tensor,
    x_lo: Optional[torch.Tensor] = None,
    xt_lo: Optional[torch.Tensor] = None,
    xaug_lo: Optional[torch.Tensor] = None,
    *,
    nrm_x: Optional[torch.Tensor] = None,
    block_m: int = 128,
    block_n: int = 128,
) -> torch.Tensor:
    """B1 on the tensors' device: plain PyTorch on the CPU, the kernel on
    the card.  Returns S1aug (m, d+1) f32: the square pass, or with
    ``nrm_x`` m rows against n other columns."""
    if x.device.type == "cpu":
        _check(x, nrm, xt, xaug, inv2h2, x_lo, xt_lo, xaug_lo, block_m,
               block_n, nrm_x)
        return flash_score_plain(x, nrm, xt, xaug, inv2h2, x_lo, xt_lo,
                                 xaug_lo, nrm_x=nrm_x, block_n=block_n)
    return flash_score_cuda(x, nrm, xt, xaug, inv2h2, x_lo, xt_lo, xaug_lo,
                            nrm_x=nrm_x, block_m=block_m, block_n=block_n)


__all__ = ["SCORE_ROWS", "SCORE_TARGET_BLOCKS", "SCORE_SCRATCH_BYTES",
           "ScorePlan", "plan_score_splits", "ones_augmented", "flash_score",
           "flash_score_cuda", "flash_score_plain"]
