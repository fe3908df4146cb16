"""Structured trace spans: lightweight, bounded, reconstructable.

The counterpart of ``repro.obs.trace``.  ``span(name, **attrs)`` is a
context manager that records one event per exit into a process-wide
**ring buffer** (``collections.deque(maxlen)``, so a long-lived server
keeps the most recent window and nothing grows).  Each event carries:

  * monotonic timestamps (``perf_counter_ns``-based start + duration, µs),
  * a process-unique span id and its **parent id** (a thread-local stack,
    so nested spans — request → dispatch → bucket → kernel — reconstruct
    into a tree; the stream's background-flush thread gets its own stack),
  * the caller's attributes (JSON-safe-coerced), plus any added mid-span
    via ``sp.set(...)`` — how the engine attaches "cache hit/miss" after
    the lookup resolves.

An enabled span also opens a profiler range of the same name, so a
``torch.profiler`` capture shows it beside the kernels it launched: the
C++ ``RecordFunctionFast`` range where PyTorch has it (about a
microsecond, and nothing while no profiler records; the Python
``record_function`` costs ~10 µs a span and ~0.3 ms at its first use),
``record_function`` elsewhere.  A span's clock starts before its range
opens and stops after it closes, so a span's interval holds its own
cost, and the first span after tracing starts is stamped when it was
entered.  When tracing is disabled (the default) ``span()`` returns one
shared no-op context manager: the hot loop pays an attribute read and a
branch.  ``annotate(name)`` is the ``record_function`` range alone,
opened only while tracing is on.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import torch
from torch.profiler import record_function

from repro_torch.obs import state

#: The profiler range a span opens: the C++ fast range where this PyTorch
#: build has it, else ``record_function``.
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", record_function)

#: Default ring capacity — ~a few MB of events at worst, never more.
DEFAULT_CAPACITY = 8192

_ORIGIN_NS = time.perf_counter_ns()
_SEQ = itertools.count(1)
_EVENTS: Deque[dict] = deque(maxlen=DEFAULT_CAPACITY)
_TLS = threading.local()


def _stack() -> List[int]:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def _safe(v):
    """JSON-safe attribute value (numpy / torch scalars → python, else
    str)."""
    if isinstance(v, (int, float, str, bool)) or v is None:
        return v
    try:
        return v.item()
    except (AttributeError, ValueError, RuntimeError):
        return str(v)


class _NullSpan:
    """The shared disabled-tracing fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NULL_SPAN = _NullSpan()


class Span:
    """One live span; use via ``with obs.span("serve.dispatch", ...):``."""

    __slots__ = ("name", "attrs", "id", "parent", "_t0", "_range")

    def __init__(self, name: str, attrs: Dict):
        self.name = name
        self.attrs = {k: _safe(v) for k, v in attrs.items()}
        self.id = next(_SEQ)
        self.parent: Optional[int] = None
        self._t0 = 0
        self._range = _RANGE(name)

    def set(self, **attrs) -> "Span":
        """Attach attributes discovered mid-span (e.g. cache hit/miss)."""
        for k, v in attrs.items():
            self.attrs[k] = _safe(v)
        return self

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter_ns()
        st = _stack()
        self.parent = st[-1] if st else None
        st.append(self.id)
        self._range.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._range.__exit__(exc_type, exc, tb)
        dur_ns = time.perf_counter_ns() - self._t0
        st = _stack()
        if st and st[-1] == self.id:
            st.pop()
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        _EVENTS.append({
            "name": self.name,
            "id": self.id,
            "parent": self.parent,
            "ts_us": (self._t0 - _ORIGIN_NS) / 1e3,
            "dur_us": dur_ns / 1e3,
            "thread": threading.current_thread().name,
            "attrs": self.attrs,
        })
        return False


def span(name: str, **attrs):
    """A trace span (the shared no-op when tracing is disabled)."""
    if not state.trace_on:
        return _NULL_SPAN
    return Span(name, attrs)


def trace_events() -> List[dict]:
    """The buffered events, oldest first (each is a JSON-safe dict)."""
    return list(_EVENTS)


def clear_trace() -> None:
    _EVENTS.clear()


def set_trace_capacity(capacity: int) -> None:
    """Re-bound the ring buffer (drops buffered events)."""
    global _EVENTS
    if capacity < 1:
        raise ValueError("trace capacity must be >= 1")
    _EVENTS = deque(maxlen=int(capacity))


def span_tree(events: Optional[List[dict]] = None
              ) -> Dict[Optional[int], List[dict]]:
    """Events grouped by parent id — the reconstruction helper tests and
    trace readers use to walk request → dispatch → kernel chains."""
    by_parent: Dict[Optional[int], List[dict]] = {}
    for ev in (trace_events() if events is None else events):
        by_parent.setdefault(ev["parent"], []).append(ev)
    return by_parent


def annotate(name: str):
    """A ``record_function`` range named ``name`` while tracing is on
    (a kernel launch lines up with the device timeline in a
    ``torch.profiler`` capture), the shared no-op otherwise."""
    if not state.trace_on:
        return _NULL_SPAN
    return record_function(name)


__all__ = [
    "DEFAULT_CAPACITY", "Span", "span", "annotate",
    "trace_events", "clear_trace", "set_trace_capacity", "span_tree",
]
