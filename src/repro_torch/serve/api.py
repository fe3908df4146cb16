"""The typed query API: one request object, one answer object.

The counterpart of ``repro.serve.api``.  A :class:`QueryRequest` carries
the points, a relative deadline and an optional precision pin; every
engine call returns an :class:`Answer` with the densities, the certified
per-row relative error bound of the exact tier that answered, and the
tier path.  Precedence for the serving tier: request pin > config.

Not carried over: the deprecated positional-API shims of ``repro``
(``warn_legacy``), deliberately; the per-request ``accuracy_target`` and
the RFF tier arrive with the cascade (ROADMAP A7/A9), and
``allow_degraded`` with the resilient layer (ROADMAP A12).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.precision import PRECISIONS

#: Certified relative error of one exact-tier dispatch, per tier — the
#: accuracy ladder of ``repro.plan.planner.TIER_RTOL``.
TIER_RTOL = {"f32": 1e-5, "bf16x2": 5e-4, "bf16": 5e-2}


@dataclasses.dataclass(frozen=True)
class QueryRequest:
    """Everything one request asks for.

    ``deadline_s`` is relative seconds from submission; ``precision``
    pins an exact tier for this request.
    """

    key: str
    points: Any                              # (m, d) array-like
    deadline_s: Optional[float] = None       # relative seconds
    precision: Optional[str] = None          # pin; one of PRECISIONS

    def __post_init__(self):
        if not self.key:
            raise ValueError("QueryRequest.key must be a non-empty string")
        if self.precision is not None and self.precision not in PRECISIONS:
            raise ValueError(f"unknown precision pin {self.precision!r} "
                             f"(choose from {PRECISIONS})")
        if self.deadline_s is not None and not (self.deadline_s > 0):
            raise ValueError(f"deadline_s is relative seconds and must be "
                             f"> 0, got {self.deadline_s!r}")


@dataclasses.dataclass
class Answer:
    """One answer: densities ``value`` (on the engine's device), the tier
    that answered and the tiers visited (``path``), the max and per-row
    certified relative error bounds, how many generations behind live a
    streaming estimator answered (``staleness``), and the dispatch's
    latency."""

    value: torch.Tensor
    key: str = ""
    tier: str = "f32"
    path: Tuple[str, ...] = ()
    rel_err_bound: float = 0.0
    rel_err_bounds: Optional[np.ndarray] = None
    batch_requests: int = 1
    staleness: int = 0                  # generations behind live
    latency_s: float = 0.0


def resolve_tier(pin: Optional[str], cfg_precision: str) -> str:
    """Precedence for one request: a pin wins over the config's tier."""
    return cfg_precision if pin is None else pin


def exact_bound(tier: str) -> float:
    """Certified relative bound of one exact-tier dispatch (the tier's
    rtol; ``repro.serve.cascade.exact_bound`` with pruning off)."""
    return TIER_RTOL[tier]


__all__ = ["TIER_RTOL", "QueryRequest", "Answer", "resolve_tier",
           "exact_bound"]
