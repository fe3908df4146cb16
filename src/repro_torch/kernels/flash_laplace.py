"""Flash Laplace kernels: B5 (fused Laplace sums) and B6 (square moment).

B5 computes the Laplace-corrected kernel sums in one quadratic pass,

    L_j = Σ_i φ_ji · (1 + d/2 − scaled_ji),  scaled = sq/(2h²),
    φ = exp(−scaled),

applying the correction factor to the scaled distances the exponential
already needed (the paper's §5 fusion).  B6 computes ``M_j = Σ_i φ_ji ·
sq_ji``, the second pass of the non-fused baseline, which recomputes the
distances on purpose; the caller combines ``(1 + d/2)·S − M/(2h²)`` with
B2's sums ``S``.  Three functions per kernel:

  * ``flash_laplace_cuda`` / ``sq_moment_cuda`` launch the hand-written
    CUDA kernels (``csrc/flash_laplace.cu`` over B2's split-column body,
    ``csrc/flash_kde_pass.cuh``) on CUDA tensors and count the launch;
  * ``flash_laplace_plain`` / ``sq_moment_plain`` are the same functions
    in plain PyTorch, streaming column blocks of ``block_n``;
  * ``flash_laplace`` / ``sq_moment`` take the plain version for CPU
    tensors and the kernel for CUDA tensors — no fallback between them.

Arguments follow ``repro.kernels.flash_laplace``: padded operands, norms
(m, 1) and (1, n) in f32, ``inv2h2`` a (1, 1) f32 tensor, the bf16x2 tier
given by both lo planes; the result is (m, 1) f32 sums.  The kernels
split the columns as B2 does (``flash_kde.plan_splits``, from n and
block_n only), so a row's sum does not depend on its batch.

The Laplace sum is signed and crosses zero, so its error is bounded per
row against an absolute mass rather than against the sum.  With
``mass=True`` the plain versions also return that mass, (m, 1) f32:

  * B5: ``A_j = Σ_i φ_ji · (2 + d/2 + scaled_ji)``;
  * B6: ``A_j = Σ_i φ_ji · (sq_ji + 2h²)``.

If φ carries a relative error ρ and ``scaled`` an absolute error Δ (the
f32 norm-trick rounding, ``8·eps·max‖x‖²/(2h²)``), a term moves by at
most ``(ρ + Δ)`` times its share of ``A_j`` — in B5 through φ and through
the factor, which ``scaled`` enters too.  B5's mass also covers the
non-fused combination's rounding, ``ρ·Σφ·(1 + d/2 + scaled)``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_kde as _kde
from repro_torch.kernels import precision as prec

_ARGTYPES = _kde._ARGTYPES   # B2's C signature: part, per_split, splits

#: Kernel launches made by ``flash_laplace_cuda`` (B5) and
#: ``sq_moment_cuda`` (B6); set to 0 to start a count.
laplace_launches = 0
sq_moment_launches = 0


def _plain(weight, y, nrm_y, xt, nrm_x, inv2h2, y_lo, xt_lo, block_n, mass):
    m, d = y.shape
    n = xt.shape[1]
    out = torch.zeros((m, 1), dtype=torch.float32, device=y.device)
    amass = torch.zeros_like(out) if mass else None
    for j0 in range(0, n, block_n):
        cols = slice(j0, j0 + block_n)
        if y_lo is None:
            g = prec.dot_f32(y, xt[:, cols])
        else:
            g = prec.gram_compensated(y, y_lo, xt[:, cols], xt_lo[:, cols])
        sq = torch.clamp(nrm_y + nrm_x[:, cols] - 2.0 * g, min=0.0)
        scaled = sq * inv2h2
        phi = torch.exp(-scaled)
        if weight == "laplace":
            out += (phi * (1.0 + d / 2.0 - scaled)).sum(dim=1, keepdim=True)
            if mass:
                amass += (phi * (2.0 + d / 2.0 + scaled)).sum(dim=1,
                                                                keepdim=True)
        else:
            out += (phi * sq).sum(dim=1, keepdim=True)
            if mass:
                amass += (phi * (sq + 1.0 / inv2h2)).sum(dim=1, keepdim=True)
    return (out, amass) if mass else out


def flash_laplace_plain(
    y: torch.Tensor,
    nrm_y: torch.Tensor,
    xt: torch.Tensor,
    nrm_x: torch.Tensor,
    inv2h2: torch.Tensor,
    y_lo: Optional[torch.Tensor] = None,
    xt_lo: Optional[torch.Tensor] = None,
    *,
    block_n: int = 128,
    mass: bool = False,
):
    """Plain PyTorch B5, one column block of ``block_n`` at a time;
    ``mass=True`` returns (sums, absolute mass)."""
    return _plain("laplace", y, nrm_y, xt, nrm_x, inv2h2, y_lo, xt_lo,
                  block_n, mass)


def sq_moment_plain(
    y: torch.Tensor,
    nrm_y: torch.Tensor,
    xt: torch.Tensor,
    nrm_x: torch.Tensor,
    inv2h2: torch.Tensor,
    y_lo: Optional[torch.Tensor] = None,
    xt_lo: Optional[torch.Tensor] = None,
    *,
    block_n: int = 128,
    mass: bool = False,
):
    """Plain PyTorch B6, one column block of ``block_n`` at a time;
    ``mass=True`` returns (sums, absolute mass)."""
    return _plain("sq_moment", y, nrm_y, xt, nrm_x, inv2h2, y_lo, xt_lo,
                  block_n, mass)


def flash_laplace_cuda(
    y: torch.Tensor,
    nrm_y: torch.Tensor,
    xt: torch.Tensor,
    nrm_x: torch.Tensor,
    inv2h2: torch.Tensor,
    y_lo: Optional[torch.Tensor] = None,
    xt_lo: Optional[torch.Tensor] = None,
    *,
    block_m: int = 128,
    block_n: int = 128,
) -> torch.Tensor:
    """Launch kernel B5 (both of its passes) on the current stream;
    returns (m, 1) f32 sums."""
    global laplace_launches
    out = _kde.launch_dense_pass(
        "flash_laplace",
        lambda: _build.load("flash_laplace", _ARGTYPES,
                            prefix="flash_laplace"),
        y, nrm_y, xt, nrm_x, inv2h2, y_lo, xt_lo, block_m, block_n)
    laplace_launches += 1
    return out


def sq_moment_cuda(
    y: torch.Tensor,
    nrm_y: torch.Tensor,
    xt: torch.Tensor,
    nrm_x: torch.Tensor,
    inv2h2: torch.Tensor,
    y_lo: Optional[torch.Tensor] = None,
    xt_lo: Optional[torch.Tensor] = None,
    *,
    block_m: int = 128,
    block_n: int = 128,
) -> torch.Tensor:
    """Launch kernel B6 (both of its passes) on the current stream;
    returns (m, 1) f32 sums."""
    global sq_moment_launches
    out = _kde.launch_dense_pass(
        "sq_moment",
        lambda: _build.load("flash_laplace", _ARGTYPES, prefix="sq_moment"),
        y, nrm_y, xt, nrm_x, inv2h2, y_lo, xt_lo, block_m, block_n)
    sq_moment_launches += 1
    return out


def flash_laplace(
    y: torch.Tensor,
    nrm_y: torch.Tensor,
    xt: torch.Tensor,
    nrm_x: torch.Tensor,
    inv2h2: torch.Tensor,
    y_lo: Optional[torch.Tensor] = None,
    xt_lo: Optional[torch.Tensor] = None,
    *,
    block_m: int = 128,
    block_n: int = 128,
) -> torch.Tensor:
    """B5 on the tensors' device: plain PyTorch on the CPU, the kernel on
    the card.  Returns unnormalized Laplace sums (m, 1) f32."""
    if y.device.type == "cpu":
        _kde._check(y, nrm_y, xt, nrm_x, inv2h2, y_lo, xt_lo, block_m,
                    block_n)
        return flash_laplace_plain(y, nrm_y, xt, nrm_x, inv2h2, y_lo, xt_lo,
                                   block_n=block_n)
    return flash_laplace_cuda(y, nrm_y, xt, nrm_x, inv2h2, y_lo, xt_lo,
                              block_m=block_m, block_n=block_n)


def sq_moment(
    y: torch.Tensor,
    nrm_y: torch.Tensor,
    xt: torch.Tensor,
    nrm_x: torch.Tensor,
    inv2h2: torch.Tensor,
    y_lo: Optional[torch.Tensor] = None,
    xt_lo: Optional[torch.Tensor] = None,
    *,
    block_m: int = 128,
    block_n: int = 128,
) -> torch.Tensor:
    """B6 on the tensors' device: plain PyTorch on the CPU, the kernel on
    the card.  Returns Σφ·sq (m, 1) f32."""
    if y.device.type == "cpu":
        _kde._check(y, nrm_y, xt, nrm_x, inv2h2, y_lo, xt_lo, block_m,
                    block_n)
        return sq_moment_plain(y, nrm_y, xt, nrm_x, inv2h2, y_lo, xt_lo,
                               block_n=block_n)
    return sq_moment_cuda(y, nrm_y, xt, nrm_x, inv2h2, y_lo, xt_lo,
                          block_m=block_m, block_n=block_n)


__all__ = ["flash_laplace", "flash_laplace_cuda", "flash_laplace_plain",
           "sq_moment", "sq_moment_cuda", "sq_moment_plain"]
