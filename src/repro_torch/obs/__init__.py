"""Unified observability for the port: metrics, trace spans, profiler
ranges (``repro.obs``'s counterpart, same names and exports).

    from repro_torch import obs

    obs.counter("serve.requests").inc()
    obs.histogram("serve.latency_s", lo=1e-5, hi=100).observe(dt)
    with obs.span("serve.dispatch", key=key, bucket=bucket) as sp:
        sp.set(cache="hit")
        ...

Metrics (counters / gauges / fixed log-bucketed histograms — bounded
state, no sample lists) are ON by default; trace spans (bounded ring
buffer, parent ids, monotonic µs timestamps, each also a
``torch.profiler.record_function`` range) are OFF by default and cost
one branch per ``span()`` call while off.  ``obs.configure(metrics=...,
trace=...)`` flips either plane at runtime.

Export surfaces:

  * ``obs.metrics_snapshot()`` — JSON-safe dict of every instrument;
  * ``obs.prometheus_text()`` — Prometheus text exposition
    (``lint_prometheus`` / ``python -m repro_torch.obs`` validate it);
  * ``obs.trace_events()`` / ``obs.span_tree()`` — buffered span events
    and their parent-id reconstruction.

Instrumented layers: ``serve/frontend.py`` (batch, idle, straggler-wait
and finish spans; admission counters, queue-depth and admit-rate gauges,
queue-wait histogram), ``serve/engine.py`` (request → dispatch → bucket →
compile spans, coalesce / split spans, latency + staleness + pad-ratio +
compile-seconds histograms), ``serve/batching.py`` (bucket-cache
hit/miss/eviction counters), ``stream/estimator.py``
(append/evict/flush/rebuild spans, dirty-tile and slack-occupancy
gauges), ``core/estimator.py`` (fit / evaluate spans),
``kernels/ops.py`` (wrapper, prepass and pruned-launch spans, the
launches' streamed and real row counts, prune visit fraction,
certificate budgets), ``kernels/spatial.py`` (index, assignment,
layout, tile-metadata, tile-map and visit-list spans).  A ``sync.<site>``
span surrounds each call on these paths that waits for the card
(``sync.bandwidth``, ``sync.inv2h2``, ``sync.engine``, ...); one that
waits more than once carries ``syncs`` (only k-means' Lloyd loop, whose
bincounts each read back twice).  ``tools/sync_audit.py`` checks on the
card that every wait lies in one and that each span's count is right.
"""

from repro_torch.obs import state
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    counter,
    gauge,
    histogram,
    lint_prometheus,
    log_bucket_bounds,
    metrics_snapshot,
    prometheus_text,
    registry,
)
from repro_torch.obs.state import configure, enabled
from repro_torch.obs.trace import (
    Span,
    annotate,
    clear_trace,
    set_trace_capacity,
    span,
    span_tree,
    trace_events,
)

__all__ = [
    "state", "configure", "enabled",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
    "counter", "gauge", "histogram",
    "log_bucket_bounds", "lint_prometheus",
    "metrics_snapshot", "prometheus_text",
    "Span", "span", "annotate",
    "trace_events", "clear_trace", "set_trace_capacity", "span_tree",
]
