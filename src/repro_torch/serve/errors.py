"""Typed serve-layer errors (``repro.serve.errors``, the request path's).

``UnknownKey`` also subclasses ``KeyError`` and ``BadRequest`` also
subclasses ``ValueError``, so callers guarding with the builtin types keep
working.  The shed/deadline/degraded errors of the resilient and
admission layers come with those layers (ROADMAP A12).
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


__all__ = ["ServeError", "UnknownKey", "BadRequest", "DeadlineExceeded"]
