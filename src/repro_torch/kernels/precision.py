"""Input-precision tiers for the Flash-SD-KDE kernels.

Three GEMM-operand tiers:

  * ``f32``    — operands as given (full precision);
  * ``bf16``   — Gram / φ@[X|1] operands cast to bfloat16, products summed
                 in f32 (~1e-2 relative on the densities);
  * ``bf16x2`` — split-hi–lo compensated bf16: each f32 operand A becomes
                 ``A_hi = bf16(A)`` and ``A_lo = bf16(A − A_hi)``, and each
                 GEMM runs as the four-product sum
                 ``A_hi·B_hi + A_hi·B_lo + A_lo·B_hi + A_lo·B_lo`` in f32
                 (~1e-4 relative).

Invariant across every tier: squared norms, ``sq = ‖y‖² + ‖x‖² − 2g``, the
exponential and all accumulators stay f32; only GEMM operands shrink.  At
a reduced tier the norms are computed from the tier-cast operands, so
``sq`` is the exact squared distance of slightly perturbed points rather
than a cancellation error in the exponent.

Casts round to nearest even, as JAX's do, so both packages produce the
same bits.  The products here are the plain versions the kernels are
held against: f32 matrix products with TF32 off (``device.resolve``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

PRECISIONS = ("f32", "bf16", "bf16x2")
Precision = str  # one of PRECISIONS


def validate(precision: Precision) -> Precision:
    if precision not in PRECISIONS:
        raise ValueError(
            f"unknown precision tier {precision!r} (choose from {PRECISIONS})"
        )
    return precision


def operand_bytes(precision: Precision) -> int:
    """Bytes per element of GEMM operand storage (bf16x2 keeps two planes)."""
    validate(precision)
    return {"f32": 4, "bf16": 2, "bf16x2": 4}[precision]


def gram_products(precision: Precision) -> int:
    """Products per logical GEMM (bf16x2 runs the four-product sum)."""
    validate(precision)
    return 4 if precision == "bf16x2" else 1


def split_hi_lo(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compensated split: f32 ``x`` → (bf16 hi, bf16 lo) with x ≈ hi + lo."""
    x32 = x.to(torch.float32)
    hi = x32.to(torch.bfloat16)
    lo = (x32 - hi.to(torch.float32)).to(torch.bfloat16)
    return hi, lo


def split_three(
    x: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact three-plane split: f32 ``x`` → bf16 (h, m, l) with
    h + m + l == x: h = bf16(x), m = bf16(x − h), l = bf16(x − h − m),
    each rounded to nearest even.  Both differences are exact in f32 and
    the last has at most 8 significant bits, so the sum is exact wherever
    l is a normal bf16 (|x| ≥ 2^-110; bf16 has f32's exponent range).

    The f32 score pass splits its operands and φ so on the card
    (``csrc/flash_score_pass.cuh``, ``split3``) and runs each product as
    six bf16 products of the planes; this is its mirror for the tests.
    """
    x32 = x.to(torch.float32)
    h = x32.to(torch.bfloat16)
    r = x32 - h.to(torch.float32)
    m = r.to(torch.bfloat16)
    l = (r - m.to(torch.float32)).to(torch.bfloat16)
    return h, m, l


def cast_operand(
    x: torch.Tensor, precision: Precision
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(hi, lo) GEMM operand pair for a tier; ``lo`` is None below bf16x2.

    ``f32`` keeps the tensor's own dtype.
    """
    validate(precision)
    if precision == "f32":
        return x, None
    if precision == "bf16":
        return x.to(torch.bfloat16), None
    return split_hi_lo(x)


def tier_of(hi: torch.Tensor, lo: Optional[torch.Tensor]) -> Precision:
    """The tier a (hi, lo) operand pair is at: a lo plane means bf16x2,
    a bf16 hi plane bf16, anything else f32."""
    if lo is not None:
        return "bf16x2"
    return "bf16" if hi.dtype == torch.bfloat16 else "f32"


def reconstruct(hi: torch.Tensor, lo: Optional[torch.Tensor]) -> torch.Tensor:
    """The f32 points a (hi, lo) operand pair actually represents."""
    r = hi.to(torch.float32)
    if lo is not None:
        r = r + lo.to(torch.float32)
    return r


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with f32 output.  bf16 operands widen exactly to f32 first, so
    their products are exact and only the sums round, as on tensor cores."""
    return a.to(torch.float32) @ b.to(torch.float32)


def gram_compensated(
    a_hi: torch.Tensor, a_lo: torch.Tensor,
    b_hi: torch.Tensor, b_lo: torch.Tensor,
) -> torch.Tensor:
    """Four-product compensated GEMM with f32 accumulation (bf16x2 tier)."""
    g = dot_f32(a_hi, b_hi)
    g = g + dot_f32(a_hi, b_lo)
    g = g + dot_f32(a_lo, b_hi)
    g = g + dot_f32(a_lo, b_lo)
    return g


def weighted_accum(phi: torch.Tensor, w_hi: torch.Tensor,
                   w_lo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The φ@[X|1] GEMM at the tier implied by the operands.

    ``phi`` arrives f32; the weight's dtype (plus a lo plane) selects the
    tier: bf16 rounds φ to bf16, bf16x2 splits φ into hi and lo.
    """
    if w_lo is not None:
        p_hi, p_lo = split_hi_lo(phi)
        return gram_compensated(p_hi, p_lo, w_hi, w_lo)
    if w_hi.dtype == torch.bfloat16:
        return dot_f32(phi.to(torch.bfloat16), w_hi)
    return dot_f32(phi, w_hi)


__all__ = [
    "PRECISIONS", "Precision", "validate", "operand_bytes", "gram_products",
    "split_hi_lo", "split_three", "cast_operand", "tier_of", "reconstruct", "dot_f32",
    "gram_compensated", "weighted_accum",
]
