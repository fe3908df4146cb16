"""Untiled PyTorch oracles for the kernels (``repro.kernels.ref``).

Each ``ref_*`` computes what the corresponding kernel computes (same
inputs, same outputs) in one f32 pass with no tiling — the ground truth
the tests hold the tiled paths against.
"""

from __future__ import annotations

import torch


def _sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    an = torch.sum(a**2, dim=-1)[:, None]
    bn = torch.sum(b**2, dim=-1)[None, :]
    return an + bn - 2.0 * (a @ b.T)


def ref_score_stats(x: torch.Tensor, h: float):
    """(S0, S1): S0_i = Σ_j φ_ij, S1_i = Σ_j φ_ij x_j (train×train)."""
    phi = torch.exp(-_sqdist(x, x) / (2.0 * h * h))
    return torch.sum(phi, dim=1), phi @ x.to(torch.float32)


def ref_kde_sums(x: torch.Tensor, y: torch.Tensor, h: float) -> torch.Tensor:
    """Unnormalized KDE sums at queries: p_j = Σ_i φ(y_j, x_i)."""
    return torch.sum(torch.exp(-_sqdist(y, x) / (2.0 * h * h)), dim=1)


def ref_laplace_sums(x: torch.Tensor, y: torch.Tensor,
                     h: float) -> torch.Tensor:
    """Unnormalized Laplace-corrected sums: Σ_i φ·(1 + d/2 − sqd/(2h²))."""
    d = x.shape[-1]
    sq = _sqdist(y, x)
    phi = torch.exp(-sq / (2.0 * h * h))
    return torch.sum(phi * (1.0 + d / 2.0 - sq / (2.0 * h * h)), dim=1)


def ref_sdkde_shift(x: torch.Tensor, h: float, score_h: float | None = None):
    """Debiased samples via the empirical score (as ops.flash_sdkde_shift)."""
    sh = h if score_h is None else score_h
    s0, s1 = ref_score_stats(x, sh)
    x32 = x.to(torch.float32)
    score = (s1 - x32 * s0[:, None]) / (sh * sh * s0[:, None])
    return x32 + 0.5 * h * h * score


def ref_selective_scan(xi, dt, b, c, a, h0):
    """Oracle for kernel B7: the plain sequential recurrence in f32.

    h_t = exp(Δ_t A) ⊙ h_{t-1} + (Δ_t x_t)·B_t ;  y_t = C_t · h_t.
    Shapes: xi/dt (B,S,D), b/c (B,S,N), a (D,N), h0 (B,D,N).
    Returns (y (B,S,D) f32, h_final (B,D,N) f32).
    """
    xi, dt, b, c, a = (t.to(torch.float32) for t in (xi, dt, b, c, a))
    h = h0.to(torch.float32)
    ys = []
    for t in range(xi.shape[1]):
        decay = torch.exp(dt[:, t, :, None] * a[None])          # (B,D,N)
        h = decay * h + (dt[:, t] * xi[:, t])[:, :, None] * b[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, c[:, t]))
    return torch.stack(ys, dim=1), h


__all__ = ["ref_score_stats", "ref_kde_sums", "ref_laplace_sums",
           "ref_sdkde_shift", "ref_selective_scan"]
