"""The typed query API: one request object, one answer object.

The counterpart of ``repro.serve.api``.  A :class:`QueryRequest` carries
the points, an optional certified accuracy target, a relative deadline
and an optional precision pin; every engine call returns an
:class:`Answer` with the densities, the per-row certified relative error
bounds, the tier path, how many rows the RFF fast tier answered and how
many escalated, and the plan that shaped the estimator.

Precedence for the serving tier: request pin > explicit config >
planner (``plan.resolve_config`` folds the last two at fit time).
``precision="rff"`` pins the random-feature fast tier
(``kernels/flash_rff.py``); a request with an ``accuracy_target`` and no
pin enters the accuracy cascade (``serve/cascade.py``).

Every layer speaks these two types: ``ServeEngine.query`` /
``query_many``, ``ResilientEngine.query`` (which reads
``allow_degraded`` and fills the shard fields of the answer) and
``AsyncFrontend.submit`` (which fills the admission fields).  Not carried
over, deliberately: ``repro``'s deprecated positional-API shims
(``warn_legacy``) and the answer's ``densities``/``precision`` views.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.precision import PRECISIONS
from repro_torch.plan.planner import TIER_RTOL

#: The pinnable serving tiers: the exact GEMM-operand tiers plus the
#: random-feature fast tier.
RFF_TIER = "rff"
PINNABLE_TIERS = PRECISIONS + (RFF_TIER,)


@dataclasses.dataclass(frozen=True)
class QueryRequest:
    """Everything one request asks for.

    ``accuracy_target`` is the certified relative-error budget that
    drives cascade routing (None inherits the config's, and no target at
    all keeps the request exact); ``deadline_s`` is relative seconds from
    submission; ``precision`` pins a tier outright: an exact tier skips
    the cascade, ``"rff"`` forces the fast tier, its band reported as is.
    """

    key: str
    points: Any                              # (m, d) array-like
    accuracy_target: Optional[float] = None
    deadline_s: Optional[float] = None       # relative seconds
    precision: Optional[str] = None          # pin; one of PINNABLE_TIERS
    allow_degraded: Optional[bool] = None    # None = the layer's default

    def __post_init__(self):
        if not self.key:
            raise ValueError("QueryRequest.key must be a non-empty string")
        if self.precision is not None \
                and self.precision not in PINNABLE_TIERS:
            raise ValueError(f"unknown precision pin {self.precision!r} "
                             f"(choose from {PINNABLE_TIERS})")
        if self.accuracy_target is not None \
                and not (self.accuracy_target > 0):
            raise ValueError(f"accuracy_target must be > 0, got "
                             f"{self.accuracy_target!r}")
        if self.deadline_s is not None and not (self.deadline_s > 0):
            raise ValueError(f"deadline_s is relative seconds and must be "
                             f"> 0, got {self.deadline_s!r}")


@dataclasses.dataclass
class Answer:
    """One answer: densities ``value`` (on the engine's device), the tier
    that answered the final rows and the tiers visited (``path``, e.g.
    ``("rff",)``, ``("rff", "f32")``, ``("bf16",)``), the max and per-row
    certified relative error bounds (the RFF band on fast-tier rows, the
    tier rtol plus any prune epsilon on exact rows), the rows answered at
    the fast tier (``rff_hits``) and escalated (``escalated``), how many
    generations behind live a streaming estimator answered
    (``staleness``), the plan's id, and the dispatch's latency.  The
    resilient layer fills ``degraded`` / ``shed`` and the shards that
    answered or were missing, with its retries and hedges; the admission
    front end fills ``browned``, ``state`` (its admission state at
    dispatch) and ``queued_ms``."""

    value: torch.Tensor
    key: str = ""
    tier: str = "f32"
    path: Tuple[str, ...] = ()
    rel_err_bound: float = 0.0
    rel_err_bounds: Optional[np.ndarray] = None
    rff_hits: int = 0                   # rows answered at the RFF tier
    escalated: int = 0                  # rows escalated to an exact tier
    degraded: bool = False              # a certified partial-shard answer
    shed: bool = False                  # served at a load-shed tier
    browned: bool = False               # tier lowered by queue pressure
    state: str = ""                     # admission state at dispatch
    staleness: int = 0                  # generations behind live
    plan_id: str = ""
    queued_ms: float = 0.0
    batch_requests: int = 1
    live_shards: Tuple[int, ...] = ()
    missing_shards: Tuple[int, ...] = ()
    retries: int = 0
    hedges: int = 0
    hedge_wins: int = 0
    latency_s: float = 0.0


def resolve_tier(pin: Optional[str], cfg_precision: str,
                 plan: object = None) -> Tuple[str, bool]:
    """Precedence for one request: ``(tier, pin_overrode_plan)``.  The
    config's tier already folds "explicit config beats planner", so only
    the pin is left, and whether taking it departs from a planned tier
    (the event the engine counts)."""
    if pin is None:
        return cfg_precision, False
    overrode = (plan is not None
                and getattr(plan, "precision", None) is not None
                and getattr(plan, "precision") != pin)
    return pin, overrode


__all__ = ["TIER_RTOL", "RFF_TIER", "PINNABLE_TIERS", "QueryRequest",
           "Answer", "resolve_tier"]
