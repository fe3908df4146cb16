"""Bandwidth selection rules for KDE / SD-KDE (``repro.core.bandwidth``).

Silverman's rule scales as ``n^{-1/(d+4)}``; SD-KDE's improved AMISE is
attained with the wider ``n^{-1/(d+8)}`` scaling; the score-estimation
convention ``t' = h²/2`` gives ``h_score = h/sqrt(2)``.  Standard
deviations are population ones (``correction=0``), as ``jnp.std``.
"""

from __future__ import annotations

import math

import torch


def silverman_bandwidth(x: torch.Tensor) -> torch.Tensor:
    """``h = (4 / (d + 2))^{1/(d+4)} · n^{-1/(d+4)} · sigma_bar``."""
    n, d = x.shape
    sigma = torch.std(x, dim=0, correction=0).mean()
    factor = (4.0 / (d + 2.0)) ** (1.0 / (d + 4.0))
    return factor * (n ** (-1.0 / (d + 4.0))) * sigma


def sdkde_bandwidth(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """SD-KDE-rate bandwidth ``h ∝ n^{-1/(d+8)}`` (Silverman's constant)."""
    n, d = x.shape
    sigma = torch.std(x, dim=0, correction=0).mean()
    factor = (4.0 / (d + 2.0)) ** (1.0 / (d + 4.0))
    return scale * factor * (n ** (-1.0 / (d + 8.0))) * sigma


def score_bandwidth(h):
    """Bandwidth of the empirical-score KDE: ``h / sqrt(2)``."""
    return h / math.sqrt(2.0)


def gaussian_norm_const(d: int, h: float) -> float:
    """Normalizer ``(2*pi)^{d/2} * h^d`` of the isotropic Gaussian kernel."""
    return (2.0 * math.pi) ** (d / 2.0) * float(h) ** d


__all__ = ["silverman_bandwidth", "sdkde_bandwidth", "score_bandwidth",
           "gaussian_norm_const"]
