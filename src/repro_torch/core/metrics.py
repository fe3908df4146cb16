"""Oracle-error metrics: MISE, MIAE and the negative-mass diagnostic.

The counterpart of ``repro.core.metrics``.  The paper reports the Mean
Integrated Squared Error and Mean Integrated Absolute Error against the
known mixture density ("oracle error", Figs. 2-3), computed on the
*signed* estimate, because the Laplace-corrected kernel can go negative;
the integrated negative mass ∫ max(−p̂, 0) is logged beside them.

In 1-D the integrals are sums on a uniform grid.  In 16-D a grid is out
of reach, so they are importance-sampling estimates with the oracle
mixture widened as the proposal q:

    ∫ f(x) dx ≈ (1/m) Σ_k f(z_k) / q(z_k),   z_k ~ q,

the plain (not self-normalised) estimate ``repro`` computes, since q is
a normalised density.  Samples come from an explicit ``torch.Generator``;
JAX draws other numbers from the same seed, so ``oracle_errors_at``
takes the samples themselves when two runs must see the same points.

Precision: the points handed to the estimator are float32, as the
estimators take them.  The oracle densities p and q, the weights 1/q and
the integrands are float64, with the estimate widened to float64: in 16-D
q spans tens of orders of magnitude over the samples, and ``repro``'s
floor ``max(q, 1e-300)`` exists only in float64 (in float32 it is 0).
``repro`` evaluates all of it in float32, so the two agree to float32
rounding of p and q, about 1e-6 relative on each term.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch import device as device_mod
from repro_torch.core.mixtures import GaussianMixture

EstimateFn = Callable[[torch.Tensor], torch.Tensor]
Q_FLOOR = 1e-300


@dataclasses.dataclass(frozen=True)
class OracleErrors:
    mise: float
    miae: float
    neg_mass: float


def widened_proposal(mix: GaussianMixture,
                     widen: float = 1.5) -> GaussianMixture:
    """Proposal q = the oracle mixture with its stds widened (covers the
    tails)."""
    return GaussianMixture(means=mix.means, stds=mix.stds * widen,
                           weights=mix.weights)


def _estimate(estimate_fn: EstimateFn, z32: torch.Tensor) -> torch.Tensor:
    p_hat = torch.as_tensor(estimate_fn(z32))
    return p_hat.reshape(-1).to(device=z32.device, dtype=torch.float64)


def oracle_errors_grid(estimate_fn: EstimateFn, mix: GaussianMixture,
                       lo: float, hi: float, n_grid: int = 2048, *,
                       device: str = "cuda") -> OracleErrors:
    """1-D grid sums of (p̂ − p)², |p̂ − p| and max(−p̂, 0), times dx."""
    if mix.dim != 1:
        raise ValueError(f"grid integration is 1-D; the mixture is "
                         f"{mix.dim}-D")
    dev = device_mod.resolve(device)
    grid = torch.linspace(lo, hi, n_grid, dtype=torch.float32,
                          device=dev)[:, None]
    dx = (hi - lo) / (n_grid - 1)
    p_hat = _estimate(estimate_fn, grid)
    err = p_hat - mix.pdf(grid.to(torch.float64))
    return OracleErrors(
        mise=float(torch.sum(err**2) * dx),
        miae=float(torch.sum(torch.abs(err)) * dx),
        neg_mass=float(torch.sum(torch.clamp(-p_hat, min=0.0)) * dx),
    )


def oracle_errors_at(estimate_fn: EstimateFn, mix: GaussianMixture,
                     z: torch.Tensor, widen: float = 1.5) -> OracleErrors:
    """Importance-sampling errors at given samples ``z`` (m, d) drawn
    from ``widened_proposal(mix, widen)``."""
    q = widened_proposal(mix, widen)
    z32 = z.to(torch.float32)
    z64 = z32.to(torch.float64)
    inv_q = 1.0 / torch.clamp(q.pdf(z64), min=Q_FLOOR)
    p_hat = _estimate(estimate_fn, z32)
    err = p_hat - mix.pdf(z64)
    return OracleErrors(
        mise=float(torch.mean(err**2 * inv_q)),
        miae=float(torch.mean(torch.abs(err) * inv_q)),
        neg_mass=float(torch.mean(torch.clamp(-p_hat, min=0.0) * inv_q)),
    )


def oracle_errors_importance(estimate_fn: EstimateFn, mix: GaussianMixture,
                             generator: torch.Generator, n_mc: int = 8192,
                             widen: float = 1.5) -> OracleErrors:
    """High-dimensional oracle errors: ``n_mc`` samples of the widened
    proposal, drawn from ``generator`` on its device."""
    z = widened_proposal(mix, widen).sample(n_mc, generator)
    return oracle_errors_at(estimate_fn, mix, z, widen)


def oracle_errors(estimate_fn: EstimateFn, mix: GaussianMixture,
                  generator: Optional[torch.Generator] = None, *,
                  device: str = "cuda", **kw) -> OracleErrors:
    """Grid in 1-D (±6 of the widest std past the outer means),
    importance sampling otherwise (a generator seeded 0 on ``device``
    when none is given)."""
    if mix.dim == 1:
        span = float(mix.stds.max()) * 6.0
        lo = float(mix.means.min()) - span
        hi = float(mix.means.max()) + span
        return oracle_errors_grid(estimate_fn, mix, lo, hi, device=device,
                                  **kw)
    if generator is None:
        generator = torch.Generator(device=device_mod.resolve(device))
        generator.manual_seed(0)
    return oracle_errors_importance(estimate_fn, mix, generator, **kw)


__all__ = ["OracleErrors", "Q_FLOOR", "widened_proposal",
           "oracle_errors_grid", "oracle_errors_at",
           "oracle_errors_importance", "oracle_errors"]
