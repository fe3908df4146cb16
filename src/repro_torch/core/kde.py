"""Streaming GEMM-form KDE / SD-KDE in plain PyTorch (the ``torch`` backend).

The counterpart of ``repro.core.kde``: the paper's computation as matrix
products with a streaming accumulation over column blocks of the train
set, so the n×m pairwise matrices are never materialized.

  p̂(y)  = 1/(n (2π)^{d/2} h^d) · Σ_i exp(-‖y-x_i‖²/(2h²))
  ŝ(x)  = (S1(x) - x·S0(x)) / (h² S0(x)),   S0 = Σφ, S1 = Σφx_j
  x^SD  = x + (h²/2)·ŝ(x)
  p̂^LC(y) = 1/(n (2π)^{d/2} h^d) · Σ_i φ_i·(1 + d/2 - ‖y-x_i‖²/(2h²))

The train set is padded with far sentinels (``PAD_VALUE``) to a block
multiple; their kernel weight underflows to exactly 0.0.  Matrix products
run in f32 with TF32 off (``repro_torch.device.resolve``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.bandwidth import gaussian_norm_const

# Far-away coordinate used to pad point sets: exp(-‖pad - x‖²/(2h²)) == 0.0
# exactly in f32 for any realistic data scale.
PAD_VALUE = 1.0e6


def pad_rows(x: torch.Tensor, block: int,
             value: float = PAD_VALUE) -> torch.Tensor:
    """Pad the leading axis of ``x`` up to a multiple of ``block``."""
    rem = (-x.shape[0]) % block
    if rem == 0:
        return x
    fill = x.new_full((rem,) + tuple(x.shape[1:]), value)
    return torch.cat([x, fill], dim=0)


def sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """GEMM-form pairwise squared distances (n, m), clamped at 0."""
    xn = torch.sum(x * x, dim=-1)[:, None]
    yn = torch.sum(y * y, dim=-1)[None, :]
    g = x @ y.T
    return torch.clamp(xn + yn - 2.0 * g, min=0.0)


def _phi(sq: torch.Tensor, h) -> torch.Tensor:
    return torch.exp(-sq / (2.0 * h * h))


def _blocks(x_train: torch.Tensor, block: int):
    """Column blocks (block, d) of the sentinel-padded train set."""
    xp = pad_rows(x_train, block)
    return xp.split(block, dim=0)


def kde_eval(x_train: torch.Tensor, y_query: torch.Tensor, h, *,
             block: int = 1024) -> torch.Tensor:
    """Gaussian KDE densities at ``y_query`` — streaming GEMM form."""
    n, d = x_train.shape
    s = torch.zeros(y_query.shape[0], dtype=y_query.dtype,
                    device=y_query.device)
    for xblk in _blocks(x_train, block):
        s += torch.sum(_phi(sqdist(y_query, xblk), h), dim=1)
    return s / (n * gaussian_norm_const(d, 1.0) * h**d)


def kde_eval_naive(x_train: torch.Tensor, y_query: torch.Tensor,
                   h) -> torch.Tensor:
    """Naive O(n·m·d) elementwise KDE (no GEMM re-ordering)."""
    n, d = x_train.shape
    diff = y_query[:, None, :] - x_train[None, :, :]
    sq = torch.sum(diff * diff, dim=-1)
    s = torch.sum(_phi(sq, h), dim=1)
    return s / (n * gaussian_norm_const(d, 1.0) * h**d)


def score_stats(x_eval: torch.Tensor, x_train: torch.Tensor, h, *,
                block: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming (S0, S1) = (Σ_j φ_ij, Σ_j φ_ij x_j) for rows ``x_eval``."""
    m, d = x_eval.shape
    s0 = torch.zeros(m, dtype=x_eval.dtype, device=x_eval.device)
    s1 = torch.zeros((m, d), dtype=x_eval.dtype, device=x_eval.device)
    for xblk in _blocks(x_train, block):
        phi = _phi(sqdist(x_eval, xblk), h)
        s0 += torch.sum(phi, dim=1)
        s1 += phi @ xblk
    return s0, s1


def empirical_score(x_eval: torch.Tensor, x_train: torch.Tensor, h, *,
                    block: int = 1024, eps: float = 1e-30) -> torch.Tensor:
    """Empirical KDE score ŝ(x) = (S1 - x·S0) / (h² S0)."""
    s0, s1 = score_stats(x_eval, x_train, h, block=block)
    return (s1 - x_eval * s0[:, None]) / (h * h * s0[:, None] + eps)


def sdkde_shift(x_train: torch.Tensor, h, *, score_h=None,
                block: int = 1024) -> torch.Tensor:
    """Debiased samples x^SD = x + (h²/2)·ŝ(x); ``score_h`` defaults to h."""
    sh = h if score_h is None else score_h
    s = empirical_score(x_train, x_train, sh, block=block)
    return x_train + 0.5 * h * h * s


def sdkde_eval(x_train: torch.Tensor, y_query: torch.Tensor, h, *,
               score_h=None, block: int = 1024) -> torch.Tensor:
    """Full empirical SD-KDE: score pass + shift + KDE on debiased samples."""
    x_sd = sdkde_shift(x_train, h, score_h=score_h, block=block)
    return kde_eval(x_sd, y_query, h, block=block)


def sdkde_eval_oracle(x_train: torch.Tensor, y_query: torch.Tensor, h,
                      oracle_score_fn, *, block: int = 1024) -> torch.Tensor:
    """SD-KDE with an oracle score (ablation: removes score-estimation
    error); ``oracle_score_fn`` maps (n, d) points to ∇log p there."""
    x_sd = x_train + 0.5 * h * h * oracle_score_fn(x_train)
    return kde_eval(x_sd, y_query, h, block=block)


# ---------------------------------------------------------------------------
# Laplace-corrected KDE (Section 5).
# ---------------------------------------------------------------------------


def laplace_kde_eval(x_train: torch.Tensor, y_query: torch.Tensor, h, *,
                     block: int = 1024) -> torch.Tensor:
    """Fused Laplace-corrected KDE: K^LC(u) = K_h(u)·(1 + d/2 − ‖u‖²/(2h²)),
    the factor applied in the same streaming pass as the distances and
    exponentials.  Signed: it may be slightly negative in the tails."""
    n, d = x_train.shape
    c0 = 1.0 + d / 2.0
    s = torch.zeros(y_query.shape[0], dtype=y_query.dtype,
                    device=y_query.device)
    for xblk in _blocks(x_train, block):
        sq = sqdist(y_query, xblk)
        s += torch.sum(_phi(sq, h) * (c0 - sq / (2.0 * h * h)), dim=1)
    return s / (n * gaussian_norm_const(d, 1.0) * h**d)


def laplace_kde_eval_nonfused(x_train: torch.Tensor, y_query: torch.Tensor,
                              h, *, block: int = 1024) -> torch.Tensor:
    """Non-fused Laplace correction: the plain KDE, then a second pass that
    recomputes the distances for Σφ·‖u‖², combined as
    (1 + d/2)·p̂ − Σφ·‖u‖²/(2h²) (normalized).  The same estimator as the
    fused one, at two quadratic passes — the Fig. 4 baseline."""
    n, d = x_train.shape
    base = kde_eval(x_train, y_query, h, block=block)
    m2 = torch.zeros(y_query.shape[0], dtype=y_query.dtype,
                     device=y_query.device)
    for xblk in _blocks(x_train, block):
        sq = sqdist(y_query, xblk)
        m2 += torch.sum(_phi(sq, h) * sq, dim=1)
    m2 = m2 / (n * gaussian_norm_const(d, 1.0) * h**d)
    return base * (1.0 + d / 2.0) - m2 / (2.0 * h * h)


__all__ = ["PAD_VALUE", "pad_rows", "sqdist", "kde_eval", "kde_eval_naive",
           "score_stats", "empirical_score", "sdkde_shift", "sdkde_eval",
           "sdkde_eval_oracle", "laplace_kde_eval",
           "laplace_kde_eval_nonfused"]
