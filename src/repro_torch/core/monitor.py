"""Serving-time activation-density monitor (``repro.core.monitor``).

The paper's estimator as an operations tool: fit SD-KDE over a reference
sample of pooled decoder activations, projected to a low dimension, then
score incoming requests' activations at serve time — a low density
flags an out-of-distribution input.  The score pass (kernel B1 on the
card) runs once at ``fit``; each ``score`` is one KDE pass (B2) against
the debiased reference set.

The projection is a fixed random Gaussian map drawn from a
``torch.Generator`` seeded with ``seed``, and the fit/held-out split a
permutation from ``seed + 1``; both differ from ``repro``'s for the same
seed, so tests set ``_proj`` and ``_perm`` from numpy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core.estimator import SDKDE, EstimatorConfig


def pool_activations(hidden: torch.Tensor) -> torch.Tensor:
    """(B, S, d) hidden states -> (B, d) mean-pooled, f32."""
    return torch.mean(hidden.to(torch.float32), dim=1)


@dataclasses.dataclass
class ActivationMonitor:
    """OOD scorer over (projected) activations: ``fit`` on a reference
    corpus of pooled activations; ``score`` returns log-densities,
    ``flag`` thresholds them at a reference quantile."""

    proj_dim: int = 16
    quantile: float = 0.01          # flag below the 1st percentile
    config: EstimatorConfig = dataclasses.field(
        default_factory=EstimatorConfig)
    seed: int = 0
    _proj: Optional[torch.Tensor] = None
    _perm: Optional[torch.Tensor] = None
    _est: Optional[SDKDE] = None
    _threshold: float = float("-inf")

    def _generator(self, seed: int, device) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(seed)

    def _project(self, acts: torch.Tensor) -> torch.Tensor:
        acts = acts.to(torch.float32)
        if self._proj is None:
            d = acts.shape[-1]
            self._proj = torch.randn(
                (d, self.proj_dim), generator=self._generator(
                    self.seed, acts.device), device=acts.device
            ) / math.sqrt(self.proj_dim)
        return acts @ self._proj.to(acts.device)

    def split(self, z: torch.Tensor):
        """(fit rows, held-out rows) of the projected reference ``z``: 80%
        and 20% of a permutation drawn once."""
        n = z.shape[0]
        split = max(1, int(0.8 * n))
        if self._perm is None:
            self._perm = torch.randperm(
                n, generator=self._generator(self.seed + 1, z.device),
                device=z.device)
        perm = self._perm.to(z.device)
        return z[perm[:split]], z[perm[split:]]

    def fit(self, reference_acts: torch.Tensor) -> "ActivationMonitor":
        """Fit on 80% of the reference; threshold on the held-out 20%
        (scoring the fit points themselves inflates their density)."""
        fit_z, held_z = self.split(self._project(reference_acts))
        self._est = SDKDE(config=self.config).fit(fit_z)
        held = torch.log(torch.clamp(self._est.evaluate(held_z),
                                     min=1e-300))
        self._threshold = float(torch.quantile(held, self.quantile))
        return self

    def score(self, acts: torch.Tensor) -> torch.Tensor:
        """Log-density of each (pooled) activation row."""
        if self._est is None:
            raise RuntimeError("call fit() first")
        p = self._est.evaluate(self._project(acts))
        return torch.log(torch.clamp(p, min=1e-300))

    def flag(self, acts: torch.Tensor) -> torch.Tensor:
        """True where the activation is OOD (below the fit quantile)."""
        return self.score(acts) < self._threshold


__all__ = ["pool_activations", "ActivationMonitor"]
