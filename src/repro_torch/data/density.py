"""SD-KDE density weighting: the paper's estimator as a data-pipeline stage.

The counterpart of ``repro.data.density``.  Given per-example embeddings
(any pooled representation projected to a low dimension), fit SD-KDE
over the corpus sample and weight examples by ``p̂^{-alpha}``: low-density
tail examples are weighted up, near-duplicates down.  The quadratic
passes run on the estimator's backend (the kernels B1/B2, or B3/B4 when
pruning engages, on the card by default).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.estimator import SDKDE, EstimatorConfig


def density_weights(embeddings, *, alpha: float = 0.5,
                    h: Optional[float] = None,
                    config: EstimatorConfig | None = None,
                    eps: float = 1e-12) -> torch.Tensor:
    """w_i ∝ p̂(e_i)^{-alpha}, normalized to mean 1 over the sample."""
    est = SDKDE(h, config or EstimatorConfig()).fit(embeddings)
    p = torch.clamp(est.evaluate(embeddings), min=eps)
    w = p ** (-alpha)
    return w / torch.mean(w)


@dataclasses.dataclass
class DensityWeighting:
    """Stateful pipeline stage: fit on a corpus sample, weight every batch.

    ``fit`` runs the SD-KDE score pass once on a representative sample;
    ``__call__`` evaluates the debiased KDE on a batch's embeddings and
    returns sampling weights on the estimator's device.
    """

    alpha: float = 0.5
    h: Optional[float] = None
    config: EstimatorConfig = dataclasses.field(
        default_factory=EstimatorConfig)
    eps: float = 1e-12
    _est: Optional[SDKDE] = None
    _norm: float = 1.0

    def fit(self, corpus_embeddings) -> "DensityWeighting":
        self._est = SDKDE(self.h, self.config).fit(corpus_embeddings)
        p = torch.clamp(self._est.evaluate(corpus_embeddings), min=self.eps)
        self._norm = float(torch.mean(p ** (-self.alpha)))
        return self

    def __call__(self, batch_embeddings) -> torch.Tensor:
        if self._est is None:
            raise RuntimeError("call fit() first")
        p = torch.clamp(self._est.evaluate(batch_embeddings), min=self.eps)
        return (p ** (-self.alpha)) / self._norm

    def resample_indices(self, batch_embeddings, generator: torch.Generator,
                         k: int) -> torch.Tensor:
        """Importance-resample ``k`` batch rows by density weight, without
        replacement, drawn with ``generator`` (on the weights' device)."""
        w = self(batch_embeddings)
        return torch.multinomial(w / torch.sum(w), k, replacement=False,
                                 generator=generator)


__all__ = ["density_weights", "DensityWeighting"]
