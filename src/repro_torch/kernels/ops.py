"""Public wrappers around the Flash-SD-KDE kernels (dense main path).

The counterpart of ``repro.kernels.ops`` with ``prune="off"``: pad point
sets to tile multiples with far sentinels (whose kernel weight underflows
to exactly 0.0, so padding never changes a real row's sum), precompute
squared norms and the transposed (d, n) column layout, cast operands to
the precision tier, launch B1 / B2, slice off padding and normalize.

Two launch knobs thread through every wrapper:

  * ``precision`` — the GEMM-operand tier (``"f32"`` / ``"bf16"`` /
    ``"bf16x2"``, ``kernels/precision.py``).  Norms come from the
    tier-cast operands; distances, ``exp`` and sums stay f32.
  * ``block_m`` / ``block_n`` — the kernels' row tile (threads per block)
    and column tile (train points staged per shared-memory pass), both
    explicit ints.  Rows are padded to ``block_m`` and columns to
    ``block_n`` multiples, as the JAX wrappers pad.

Each wrapper runs where its tensors are: the kernels on the card, their
plain PyTorch versions on the CPU (``flash_score.flash_score``,
``flash_kde.flash_kde``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core.bandwidth import gaussian_norm_const
from repro_torch.kernels import precision as prec
from repro_torch.kernels.flash_kde import flash_kde as _kde_kernel
from repro_torch.kernels.flash_score import flash_score as _score_kernel

PAD_VALUE = 1.0e6


def check_blocks(block_m, block_n) -> None:
    """Both tiles must be explicit positive ints."""
    for name, b in (("block_m", block_m), ("block_n", block_n)):
        if b == "auto":
            raise NotImplementedError(
                f"{name}='auto' needs the Hopper launch tuner, which is not "
                "ported yet (ROADMAP A6); pass an int")
        if not (isinstance(b, int) and not isinstance(b, bool) and b > 0):
            raise ValueError(f"bad {name} {b!r} (a positive int)")


def _pad_to(x: torch.Tensor, mult: int,
            value: float = PAD_VALUE) -> torch.Tensor:
    rem = (-x.shape[0]) % mult
    if rem == 0:
        return x
    fill = x.new_full((rem,) + tuple(x.shape[1:]), value)
    return torch.cat([x, fill], dim=0)


def _norms(x: torch.Tensor) -> torch.Tensor:
    x32 = x.to(torch.float32)
    return torch.sum(x32 * x32, dim=-1, keepdim=True)


def _tier_norms(hi: torch.Tensor, lo: Optional[torch.Tensor]) -> torch.Tensor:
    """f32 squared norms of the points the tier-cast operands represent."""
    return _norms(prec.reconstruct(hi, lo))


def _inv2h2(h, device: torch.device) -> torch.Tensor:
    """1/(2h²) as a (1, 1) f32 tensor on ``device``, computed in f32."""
    h = torch.as_tensor(h, dtype=torch.float32).to(device)
    return (1.0 / (2.0 * h * h)).reshape(1, 1)


def _t(x: torch.Tensor) -> torch.Tensor:
    """Contiguous transpose: the (d, n) column layout the kernels read."""
    return x.T.contiguous()


def _normalize(sums: torch.Tensor, n: int, d: int, h) -> torch.Tensor:
    h = torch.as_tensor(h, dtype=torch.float32).to(sums.device)
    return sums / (n * gaussian_norm_const(d, 1.0) * h**d)


# ---------------------------------------------------------------------------
# Score statistics / SD-KDE shift.
# ---------------------------------------------------------------------------


def _score_operands(xp: torch.Tensor, precision: str):
    """(x_ops, xt_ops, xaug_ops, nrm, xrec) for a padded train set."""
    npad = xp.shape[0]
    xaug = torch.cat([xp, xp.new_ones((npad, 1))], dim=1)
    if precision == "f32":
        x_ops = (xp.contiguous(), None)
        xt_ops = (_t(xp), None)
        xaug_ops = (xaug, None)
        xrec = xp.to(torch.float32)
    else:
        x_ops = prec.cast_operand(xp.to(torch.float32), precision)
        xt_ops = (_t(x_ops[0]), None if x_ops[1] is None else _t(x_ops[1]))
        xaug_ops = prec.cast_operand(xaug.to(torch.float32), precision)
        xrec = prec.reconstruct(*x_ops)
    return x_ops, xt_ops, xaug_ops, _norms(xrec), xrec


def flash_score_stats(x: torch.Tensor, h, *, precision: str = "f32",
                      block_m: int = 128, block_n: int = 128):
    """(S0, S1) score statistics over the train set via kernel B1."""
    prec.validate(precision)
    check_blocks(block_m, block_n)
    n, d = x.shape
    xp = _pad_to(x, math.lcm(block_m, block_n))
    x_ops, xt_ops, xaug_ops, nrm, _ = _score_operands(xp, precision)
    s1aug = _score_kernel(
        x_ops[0], nrm, xt_ops[0], xaug_ops[0], _inv2h2(h, x.device),
        x_ops[1], xt_ops[1], xaug_ops[1], block_m=block_m, block_n=block_n,
    )
    return s1aug[:n, d], s1aug[:n, :d]


def _apply_score_shift(x32: torch.Tensor, s0, s1, h, sh) -> torch.Tensor:
    """x^SD = x + (h²/2)·ŝ(x) from the fused statistics (rows aligned)."""
    sh = torch.as_tensor(sh, dtype=torch.float32).to(x32.device)
    h = torch.as_tensor(h, dtype=torch.float32).to(x32.device)
    score = (s1 - x32 * s0[:, None]) / (sh * sh * s0[:, None])
    return x32 + 0.5 * h * h * score


def flash_sdkde_shift(x: torch.Tensor, h, *, score_h=None,
                      precision: str = "f32", block_m: int = 128,
                      block_n: int = 128) -> torch.Tensor:
    """Debiased samples x^SD = x + (h²/2)·ŝ(x), score via kernel B1."""
    sh = h if score_h is None else score_h
    s0, s1 = flash_score_stats(x, sh, precision=precision, block_m=block_m,
                               block_n=block_n)
    return _apply_score_shift(x.to(torch.float32), s0, s1, h, sh)


# ---------------------------------------------------------------------------
# KDE evaluation.
# ---------------------------------------------------------------------------


def _prep_eval(x, y, block_m, block_n, precision):
    """Pad, transpose, norm and tier-cast one (train, queries) pair."""
    yp = _pad_to(y, block_m)
    xp = _pad_to(x, block_n)
    if precision == "f32":
        y_ops = (yp.contiguous(), None)
        xt_ops = (_t(xp), None)
        nrm_y, nrm_x = _norms(yp), _norms(xp).reshape(1, -1)
    else:
        y_ops = prec.cast_operand(yp.to(torch.float32), precision)
        x_ops = prec.cast_operand(xp.to(torch.float32), precision)
        xt_ops = (_t(x_ops[0]), None if x_ops[1] is None else _t(x_ops[1]))
        nrm_y = _tier_norms(*y_ops)
        nrm_x = _tier_norms(*x_ops).reshape(1, -1)
    return y_ops, xt_ops, nrm_y, nrm_x


def flash_kde(x: torch.Tensor, y: torch.Tensor, h, *,
              precision: str = "f32", block_m: int = 128,
              block_n: int = 128) -> torch.Tensor:
    """Normalized Gaussian KDE densities at ``y`` (train set ``x``)."""
    prec.validate(precision)
    check_blocks(block_m, block_n)
    n, d = x.shape
    m = y.shape[0]
    y_ops, xt_ops, nrm_y, nrm_x = _prep_eval(x, y, block_m, block_n,
                                             precision)
    sums = _kde_kernel(
        y_ops[0], nrm_y, xt_ops[0], nrm_x, _inv2h2(h, y.device), y_ops[1],
        xt_ops[1], block_m=block_m, block_n=block_n,
    )
    return _normalize(sums[:m, 0], n, d, h)


# ---------------------------------------------------------------------------
# Prepared fast path (serving).
# ---------------------------------------------------------------------------


class TrainColumns(NamedTuple):
    """Fit-time prepared train tensors for one precision tier."""

    xt: torch.Tensor                 # (d, n_padded) tier-cast hi plane
    xt_lo: Optional[torch.Tensor]    # (d, n_padded) bf16 lo plane (bf16x2)
    nrm_x: torch.Tensor              # (1, n_padded) f32 column norms
    block_n: int = 0                 # prepare-time column-tile width


def prepare_train_columns(x: torch.Tensor, *, block_n: int = 128,
                          precision: str = "f32") -> TrainColumns:
    """One-time train-side prep for repeated evaluation against one set.

    Pads the (debiased) train set to a ``block_n`` multiple with sentinel
    points, builds the transposed (d, n) layout cast to the tier (both
    planes for bf16x2) and the f32 column norms of the cast points.
    """
    prec.validate(precision)
    check_blocks(1, block_n)
    xp = _pad_to(x, block_n)
    if precision == "f32":
        xt, xt_lo = _t(xp), None
        nrm_x = _norms(xp).reshape(1, -1)
    else:
        x_hi, x_lo = prec.cast_operand(xp.to(torch.float32), precision)
        xt, xt_lo = _t(x_hi), None if x_lo is None else _t(x_lo)
        nrm_x = _norms(prec.reconstruct(x_hi, x_lo)).reshape(1, -1)
    return TrainColumns(xt, xt_lo, nrm_x, block_n)


def _cast_queries(yp: torch.Tensor, precision: str):
    """(y_hi, y_lo, nrm_y) for a padded query block at one tier."""
    if precision == "f32":
        return yp.contiguous(), None, _norms(yp)
    y_hi, y_lo = prec.cast_operand(yp.to(torch.float32), precision)
    return y_hi, y_lo, _tier_norms(y_hi, y_lo)


def flash_kde_prepared(yp: torch.Tensor, xt: torch.Tensor,
                       nrm_x: torch.Tensor, h,
                       xt_lo: Optional[torch.Tensor] = None, *,
                       precision: str = "f32", block_m: int = 128,
                       block_n: int = 128) -> torch.Tensor:
    """Unnormalized kernel sums (m,) for queries already padded to a
    ``block_m`` multiple against prepared columns; the caller divides by
    ``n_true · (2π)^{d/2} h^d`` and slices off padding rows."""
    prec.validate(precision)
    check_blocks(block_m, block_n)
    if (precision == "bf16x2") != (xt_lo is not None):
        raise ValueError(
            "bf16x2 needs prepared lo planes (and other tiers must not "
            f"pass them): precision={precision} xt_lo={xt_lo is not None}"
        )
    y_hi, y_lo, nrm_y = _cast_queries(yp, precision)
    sums = _kde_kernel(y_hi, nrm_y, xt, nrm_x, _inv2h2(h, yp.device), y_lo,
                       xt_lo, block_m=block_m, block_n=block_n)
    return sums[:, 0]


# ---------------------------------------------------------------------------
# Full pipeline.
# ---------------------------------------------------------------------------


def flash_sdkde(x: torch.Tensor, y: torch.Tensor, h, *, score_h=None,
                precision: str = "f32", block_m: int = 128,
                block_n: int = 128) -> torch.Tensor:
    """Full Flash-SD-KDE: score pass (B1) → shift → KDE at queries (B2),
    normalized.  The shifted set flows through ``prepare_train_columns``."""
    prec.validate(precision)
    check_blocks(block_m, block_n)
    n, d = x.shape
    m = y.shape[0]
    x32 = x.to(torch.float32)
    x_sd = flash_sdkde_shift(x32, h, score_h=score_h, precision=precision,
                             block_m=block_m, block_n=block_n)
    cols = prepare_train_columns(x_sd, block_n=block_n, precision=precision)
    yp = _pad_to(y, block_m)
    sums = flash_kde_prepared(yp, cols.xt, cols.nrm_x, h, cols.xt_lo,
                              precision=precision, block_m=block_m,
                              block_n=block_n)[:m]
    return _normalize(sums, n, d, h)


__all__ = [
    "PAD_VALUE", "check_blocks", "flash_score_stats", "flash_sdkde_shift",
    "flash_kde", "TrainColumns", "prepare_train_columns",
    "flash_kde_prepared", "flash_sdkde",
]
