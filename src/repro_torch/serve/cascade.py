"""Certificate-gated accuracy cascade: RFF fast tier, exact escalation.

The counterpart of ``repro.serve.cascade``.  A request with an
``accuracy_target`` first runs the random-feature tier
(``kernels/flash_rff.py``): one small phase product whatever the train
size.  Rows whose band fits their target are answered there; the rest
escalate through the engine's normal bucket dispatch (B4 under
``prune="auto"`` at scale, B2 under ``"off"``).  A ``precision="rff"``
pin answers everything at the fast tier (band reported as is); an exact
pin skips the fast tier.

Bounds compose per row: fast-tier rows carry their band, escalated rows
the exact tier's rtol (``plan.planner.TIER_RTOL``) plus any explicit
prune epsilon.

On the card the densities and bands stay on the device; one dispatch
reads the band to the host once (the routing mask and the per-row
bounds come from it), not ``repro``'s (p, band) pair, and uploads the
escalated rows' indices pinned and non-blocking.

Instruments (``repro``'s names): counters ``serve.cascade_hits`` and
``serve.cascade_escalations``, the band histogram ``serve.cascade_band``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels import flash_rff, spatial
from repro_torch.plan.planner import TIER_RTOL
from repro_torch.serve.api import RFF_TIER

#: Band rows sampled into the width histogram per dispatch.
_BAND_SAMPLE = 32


class CascadeResult(NamedTuple):
    """What one cascade dispatch resolved to."""

    value: torch.Tensor         # (m,) densities, on the engine's device
    bounds: np.ndarray          # (m,) certified relative-error bounds
    hits: int                   # rows answered at the RFF tier
    escalated: int              # rows escalated to the exact tier
    path: Tuple[str, ...]       # tiers visited, in order
    esc_rows: np.ndarray        # (m,) bool: which rows escalated


def exact_bound(tier: str, prune) -> float:
    """Certified relative bound of one exact-tier dispatch: the tier's
    rtol plus an explicit prune-epsilon budget (exact "auto" pruning
    drops only tiles whose terms underflow: no budget)."""
    eps = float(prune) if isinstance(prune, (int, float)) \
        and not isinstance(prune, bool) else 0.0
    return TIER_RTOL.get(tier, TIER_RTOL["f32"]) + eps


def engaged(cfg, prep, tier: str, target: Optional[np.ndarray]) -> bool:
    """Whether a request routes through the cascade: an ``"rff"`` pin
    always; otherwise the tier enabled, supported by the estimator, and
    a target to gate on."""
    if getattr(cfg, "rff", "off") == "off":
        return tier == RFF_TIER
    if not flash_rff.supports(cfg.method, cfg.backend):
        return False
    return tier == RFF_TIER or target is not None


def evaluate(cfg, serving, y: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fast-tier evaluation: ``(p, band)`` (m,) on the device."""
    return flash_rff.eval_density(serving, y, precision=cfg.rff_precision)


def run(engine, prep, y: torch.Tensor, tier: str,
        target: Optional[np.ndarray], *, snap=None
        ) -> Optional[CascadeResult]:
    """Route one (possibly fused) query batch through the cascade.

    ``tier`` is the precedence-resolved tier (``"rff"`` pins the fast
    tier, anything else is the escalation tier); ``target`` the per-row
    target vector (fused ``query_many`` members carry their own), or
    None when only a pin engaged.  Returns None when the RFF state is
    unavailable (the caller answers exact, or raises for an "rff" pin).
    """
    cfg = prep.config
    serving = engine.registry.rff_serving(prep, snap=snap)
    if serving is None:
        return None
    pinned = tier == RFF_TIER
    exact_tier = cfg.exact_precision if pinned else tier
    m = int(y.shape[0])
    p, band_dev = evaluate(cfg, serving, y)
    band = band_dev.to(torch.float64).cpu().numpy()   # the one read
    if pinned or target is None:
        mask = np.zeros(m, bool)                      # a pin: no escalation
    else:
        mask = band > target
    esc = int(mask.sum())
    hits = m - esc
    value = p
    bounds = band.copy()
    path: Tuple[str, ...] = (RFF_TIER,)
    if esc:
        rows = spatial.upload(np.flatnonzero(mask), y.device)
        dens = engine._dispatch(prep, y.index_select(0, rows), exact_tier,
                                snap)
        value = p.index_copy(0, rows, dens.to(p.dtype))
        bounds[mask] = exact_bound(exact_tier, cfg.prune)
        path = (RFF_TIER, exact_tier)

    obs.counter("serve.cascade_hits",
                "query rows answered at the RFF fast tier").inc(hits)
    if esc:
        obs.counter("serve.cascade_escalations",
                    "query rows escalated to the exact tier").inc(esc)
    hist = obs.histogram("serve.cascade_band",
                         "certified RFF band width per sampled query row",
                         lo=1e-6, hi=1e2)
    for b in band[:: max(1, m // _BAND_SAMPLE)]:
        if np.isfinite(b):
            hist.observe(max(float(b), 1e-6))
    return CascadeResult(value=value, bounds=bounds, hits=hits,
                         escalated=esc, path=path, esc_rows=mask)


__all__ = ["CascadeResult", "exact_bound", "engaged", "evaluate", "run"]
