"""Process-wide observability switches (``repro.obs.state``).

Two independent planes, both togglable at runtime:

  * **metrics** (default ON) — counters / gauges / histograms.  Each
    mutation is one flag check + one locked scalar update; a disabled
    plane short-circuits at the flag check.
  * **tracing** (default OFF) — structured spans into a bounded ring
    buffer, each also a ``torch.profiler.record_function`` range.
    Disabled tracing returns a shared no-op context manager, so the hot
    serve loop pays a single attribute read per ``span()`` call.

The flags live here (not on a registry object) so the fast-path check is
a module-attribute load, with no import cycle between the metric and
trace modules.
"""

from __future__ import annotations

from typing import Optional

metrics_on: bool = True
trace_on: bool = False


def configure(metrics: Optional[bool] = None,
              trace: Optional[bool] = None) -> None:
    """Flip either observability plane (None leaves it unchanged)."""
    global metrics_on, trace_on
    if metrics is not None:
        metrics_on = bool(metrics)
    if trace is not None:
        trace_on = bool(trace)


def enabled() -> dict:
    return {"metrics": metrics_on, "trace": trace_on}


__all__ = ["configure", "enabled", "metrics_on", "trace_on"]
