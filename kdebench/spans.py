"""The harness's own spans: host-clock intervals around calls into a layer.

Off by default (the measured runs record nothing); the traced run turns
them on.  Times are ``time.perf_counter()`` seconds, the clock every
other interval of the harness is put on.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import List


class SpanLog:
    """A list of ``(name, t0, t1, attrs)`` spans, appended from any
    thread."""

    def __init__(self, on: bool = False):
        self.on = on
        self.events: List[tuple] = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def _record(self, name: str, attrs: dict):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.events.append((name, t0, t1, attrs))

    def span(self, name: str, **attrs):
        """A span named ``name`` while recording, else a no-op."""
        if not self.on:
            return contextlib.nullcontext()
        return self._record(name, attrs)


__all__ = ["SpanLog"]
