"""Typed serve-layer errors (``repro.serve.errors``, the request path's).

``UnknownKey`` also subclasses ``KeyError`` and ``BadRequest`` also
subclasses ``ValueError``, so callers guarding with the builtin types keep
working.  ``Overloaded`` and ``Degraded`` are the resilient layer's and the
admission front end's: a shed request and an answer whose certificate
misses its target are told apart from a malformed one.
"""

from __future__ import annotations


class ServeError(Exception):
    """Base class for every error raised by the serve request path."""


class UnknownKey(ServeError, KeyError):
    """No estimator fitted under the requested key."""

    def __str__(self) -> str:  # KeyError.__str__ repr-quotes; keep prose
        return Exception.__str__(self)


class BadRequest(ServeError, ValueError):
    """Malformed query: wrong dimensionality or an empty batch."""


class DeadlineExceeded(ServeError, TimeoutError):
    """The request's deadline expired before it was answered."""


class Overloaded(ServeError):
    """The service shed the request instead of queueing it unboundedly.

    Raised by the resilient layer when no live replica can take a
    dispatch, and by the admission front end at admit time (queue full,
    token bucket empty, shedding, draining) or after its chaos retries;
    ``reason`` is the machine-readable shed cause.
    """

    def __init__(self, msg: str, *, reason: str = "overload"):
        super().__init__(msg)
        self.reason = reason


class Degraded(ServeError):
    """A degraded (partial-shard) answer exists but its certified relative
    error bound exceeds the configured accuracy target."""

    def __init__(self, msg: str, *, bound: float = float("inf"),
                 target: float = 0.0):
        super().__init__(msg)
        self.bound = bound
        self.target = target


__all__ = ["ServeError", "UnknownKey", "BadRequest", "DeadlineExceeded",
           "Overloaded", "Degraded"]
