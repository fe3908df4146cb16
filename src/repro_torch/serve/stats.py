"""Serving telemetry: per-request latency percentiles and throughput.

Backed by a bounded log-bucketed ``Histogram`` from 10µs to 1000s, so
telemetry state does not grow with request count.  Percentiles are
bucket estimates (exact for 0/1 samples, within 10^(1/6) ≈ 1.47×
otherwise).  Summaries are JSON-safe: an empty recorder reports zeros.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict

from repro_torch.obs.metrics import Histogram

#: Latency histogram range: 10µs .. 1000s, 6 buckets per decade.
LATENCY_LO_S = 1e-5
LATENCY_HI_S = 1e3


@dataclasses.dataclass
class LatencySummary:
    count: int
    queries: int
    qps: float
    p50_ms: float
    p99_ms: float
    mean_ms: float

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


class LatencyRecorder:
    """Accumulates (seconds, n_queries) samples; summarizes on demand.

    A coalesced dispatch records one sample per request it served, each
    at the full dispatch latency — what every client of it saw.
    """

    def __init__(self):
        # a private (unregistered) histogram: an engine resets its recorder
        # without zeroing the process-wide obs registry
        self._hist = Histogram("serve.latency_s", lo=LATENCY_LO_S,
                               hi=LATENCY_HI_S)
        self._lock = threading.Lock()
        self._queries = 0

    def record(self, seconds: float, n_queries: int, n_requests: int = 1):
        self._hist.observe(seconds, k=n_requests)
        with self._lock:
            self._queries += n_queries

    def reset(self) -> None:
        self._hist.reset()
        with self._lock:
            self._queries = 0

    def summary(self) -> LatencySummary:
        h = self._hist
        busy_s = h.sum
        return LatencySummary(
            count=h.count,
            queries=self._queries,
            qps=self._queries / busy_s if busy_s > 0 else 0.0,
            p50_ms=1e3 * h.quantile(0.50),
            p99_ms=1e3 * h.quantile(0.99),
            mean_ms=1e3 * h.mean,
        )

    def histogram_snapshot(self) -> dict:
        return self._hist.snapshot()


__all__ = ["LatencyRecorder", "LatencySummary"]
