"""Bounded log-bucketed histograms (``repro.obs.metrics``, in part).

Only what ``serve/stats.py`` needs is here: ``log_bucket_bounds`` and
``Histogram``.  A histogram keeps fixed log-spaced bucket counts plus
(count, sum, min, max) — never a sample list — so a long-lived server
holds as much telemetry state as a fresh one.  Quantiles are geometric
interpolation inside the winning bucket, clamped to the exact [min, max]:
exact for 0/1 samples, within one edge ratio ``10^(1/per_decade)``
otherwise.  The process-wide registry and the Prometheus exposition wait
for ROADMAP A10.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Tuple


def log_bucket_bounds(lo: float, hi: float,
                      per_decade: int = 6) -> Tuple[float, ...]:
    """Fixed log-spaced upper bucket edges covering [lo, hi].

    Edge ``i`` is ``lo · 10^(i/per_decade)``; the last edge is the first
    one ≥ ``hi``.
    """
    if not (lo > 0 and hi > lo and per_decade >= 1):
        raise ValueError(f"bad histogram range lo={lo} hi={hi} "
                         f"per_decade={per_decade}")
    n = math.ceil(math.log10(hi / lo) * per_decade)
    return tuple(lo * 10.0 ** (i / per_decade) for i in range(n + 1))


class Histogram:
    """Fixed log-spaced-bucket histogram: bounded state, estimated tails.

    ``observe(v, k)`` folds ``k`` identical samples in O(log buckets).
    """

    def __init__(self, name: str, *, lo: float = 1e-6, hi: float = 1e3,
                 per_decade: int = 6):
        self.name = name
        self.bounds = log_bucket_bounds(lo, hi, per_decade)
        self._lock = threading.Lock()
        self._zero()

    def _zero(self) -> None:
        self.counts = [0] * (len(self.bounds) + 1)  # +1 = overflow bucket
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float, k: int = 1) -> None:
        if k <= 0:
            return
        v = float(v)
        idx = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self.counts[idx] += k
            self.count += k
            self.sum += v * k
            self.min = min(self.min, v)
            self.max = max(self.max, v)

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (0 when empty)."""
        with self._lock:
            if self.count == 0:
                return 0.0
            rank = max(1, math.ceil(q * self.count))
            acc = 0
            for i, c in enumerate(self.counts):
                acc += c
                if acc >= rank:
                    break
            lo = self.bounds[i - 1] if i > 0 else max(self.min, 1e-300)
            hi = self.bounds[i] if i < len(self.bounds) else max(
                self.max, self.bounds[-1])
            est = math.sqrt(max(lo, 1e-300) * max(hi, 1e-300))
            return min(max(est, self.min), self.max)

    @property
    def mean(self) -> float:
        with self._lock:
            return self.sum / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        with self._lock:
            nonzero = [[self.bounds[i] if i < len(self.bounds) else "+Inf",
                        c] for i, c in enumerate(self.counts) if c]
            snap = {"type": "histogram", "count": self.count,
                    "sum": self.sum,
                    "min": self.min if self.count else 0.0,
                    "max": self.max if self.count else 0.0,
                    "buckets": nonzero}
        for q, key in ((0.5, "p50"), (0.99, "p99")):
            snap[key] = self.quantile(q)
        return snap


__all__ = ["log_bucket_bounds", "Histogram"]
