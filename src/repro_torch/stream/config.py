"""Streaming configuration and the rebuild policy (``repro.stream.config``).

A streaming estimator degrades as it drifts from its last full build:
appends pile into nearest-centroid clusters (inflating covering radii and
with them every certified pruning bound), evictions hollow tiles out, and
eventually some cluster's slack slots run dry.  ``StreamConfig`` sets the
slack and the staleness budget, the module constants below the rebuild
budgets; ``RebuildPolicy`` turns the drift counters into a single
"re-cluster now" decision with a reason (surfaced in telemetry and tests).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

#: GEMM chunk (rows) of the delta score pass.
DELTA_BLOCK = 4096
#: Rebuild-policy budgets, as fractions of the live-set size at the last
#: build.
MAX_APPEND_FRAC = 0.5
MAX_EVICT_FRAC = 0.5
#: Rebuild when the mean covering radius of non-empty tiles exceeds this
#: multiple of its value at the last build — radius inflation is exactly
#: what loosens every certified pruning bound.
MAX_RADIUS_INFLATION = 2.0


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Static knobs of a streaming estimator (hashable, like ServeConfig).

    ``slack`` is the per-cluster append headroom fraction reserved at every
    (re)build — ``ceil(cluster_size · slack)`` extra sentinel slots before
    block rounding (``kernels.spatial.cluster_capacities``).
    ``staleness_budget`` is how many applied-but-unpublished update
    generations a query may be served across before the engine must
    publish a fresh snapshot; 0 = always fresh.  ``background=True``
    publishes snapshots on a worker thread so queries keep serving
    generation ``g`` while ``g+1`` builds.
    """

    slack: float = 0.5              # per-cluster append headroom fraction
    staleness_budget: int = 0       # generations a query may lag (0 = fresh)
    background: bool = False        # build snapshots on a worker thread

    def __post_init__(self):
        if self.slack < 0:
            raise ValueError(f"slack must be >= 0, got {self.slack}")
        if self.staleness_budget < 0:
            raise ValueError("staleness_budget must be >= 0")


class RebuildPolicy:
    """Decides when incremental maintenance must give way to a full build.

    Tracks drift since the last re-cluster; ``reason()`` returns why a
    rebuild is due (``None`` = keep streaming).  Slack overflow is sticky:
    once an append found no free slot the layout *cannot* represent the
    live set and the next snapshot must rebuild regardless of budgets.
    """

    def __init__(self):
        self.reset(0)

    def reset(self, base_size: int) -> None:
        self.base_size = max(int(base_size), 1)
        self.appends = 0
        self.evicts = 0
        self.base_mean_radius: Optional[float] = None
        self.overflowed = False

    def note_append(self, count: int) -> None:
        self.appends += int(count)

    def note_evict(self, count: int) -> None:
        self.evicts += int(count)

    def note_overflow(self) -> None:
        self.overflowed = True

    def note_mean_radius(self, mean_radius: float) -> Optional[str]:
        """Feed the published tile geometry; returns a drift reason."""
        if self.base_mean_radius is None:
            self.base_mean_radius = float(mean_radius)
            return None
        if (self.base_mean_radius > 0.0
                and mean_radius > MAX_RADIUS_INFLATION
                * self.base_mean_radius):
            return "radius-drift"
        return None

    def reason(self) -> Optional[str]:
        if self.overflowed:
            return "slack-overflow"
        if self.appends > MAX_APPEND_FRAC * self.base_size:
            return "append-budget"
        if self.evicts > MAX_EVICT_FRAC * self.base_size:
            return "evict-budget"
        return None


__all__ = ["StreamConfig", "RebuildPolicy"]
