"""Serving configuration: backend, estimator method, batching policy.

The counterpart of ``repro.serve.config``, with the knobs this port
implements.  Ragged query traffic is coalesced into a geometric ladder of
padded batch shapes (``bucket_sizes``); on the ``flash`` backend every
bucket is a multiple of the kernels' row tile ``block_m``.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional, Tuple

from repro_torch.core.estimator import check_backend
from repro_torch.kernels import ops
from repro_torch.kernels.precision import validate as _validate_precision

Backend = Literal["flash", "torch"]
Method = Literal["kde", "sdkde", "laplace"]
METHODS = ("kde", "sdkde", "laplace")


def _round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Static serving configuration.

    Batching: a query batch of ``m`` rows is padded up to the smallest
    shape bucket ≥ m.  Buckets double from ``min_batch`` to ``max_batch``
    and are rounded up to the row multiple; larger batches are chunked at
    the top bucket.
    """

    backend: Backend = "flash"
    method: Method = "sdkde"

    # estimator knobs (mirror repro_torch.core.estimator.EstimatorConfig)
    block: int = 1024            # torch-backend streaming column block
    block_m: int = 128           # kernel row tile = bucket row multiple
    block_n: int = 128           # kernel column tile
    score_h: Optional[float] = None
    # Default serving tier (a QueryRequest pin overrides per request); the
    # registry prepares train columns per tier on first use.
    precision: str = "f32"
    # Tier of the one-time O(n²·d) debias fit: full precision by default,
    # since a reduced fit bakes its error into every later answer.
    fit_precision: str = "f32"
    # cluster pruning: "auto" = exact pruning once the train set reaches
    # ops.PRUNE_AUTO_MIN_COLS, "off" = dense, float = epsilon >= 0
    prune: "str | float" = "auto"

    # micro-batching policy
    min_batch: int = 128         # smallest shape bucket
    max_batch: int = 4096        # largest shape bucket (larger batches chunk)
    cache_buckets: int = 8       # LRU capacity of per-bucket callables

    # streaming (repro_torch.stream): maintain the registered dataset
    # incrementally under registry.append()/evict_ids()/slide() instead of
    # refitting.  ``staleness_budget`` is how many applied update
    # generations a query may be served across before the engine must
    # publish a fresh snapshot (0 = always fresh); ``stream_slack`` is the
    # per-cluster append headroom of the flash layout;
    # ``stream_background`` builds snapshots on a worker thread so queries
    # keep serving generation g while g+1 prepares.
    stream: bool = False
    staleness_budget: int = 0
    stream_slack: float = 0.5
    stream_background: bool = False

    device: str = "cuda"         # "cuda" (raises without a card) or "cpu"

    def __post_init__(self):
        check_backend(self.backend)
        if self.method not in METHODS:
            raise ValueError(f"unknown method {self.method!r} (choose from "
                             f"{METHODS})")
        ops.check_prune(self.prune)
        ops.check_blocks(self.block_m, self.block_n)
        for p in (self.precision, self.fit_precision):
            _validate_precision(p)
        if self.min_batch <= 0 or self.max_batch < self.min_batch:
            raise ValueError(
                f"bad bucket range [{self.min_batch}, {self.max_batch}]")
        if self.cache_buckets < 1:
            raise ValueError("cache_buckets must be >= 1")
        if self.block < 1:
            raise ValueError(f"bad block {self.block!r}")
        if self.staleness_budget < 0:
            raise ValueError("staleness_budget must be >= 0")
        if self.stream_slack < 0:
            raise ValueError("stream_slack must be >= 0")

    def row_multiple(self) -> int:
        """Row-count multiple every dispatched batch honors: the kernels'
        row tile on ``flash``; 1 on the shape-agnostic ``torch`` path."""
        return self.block_m if self.backend == "flash" else 1

    def bucket_sizes(self) -> Tuple[int, ...]:
        """The geometric ladder of padded batch shapes this config serves."""
        mult = self.row_multiple()
        sizes, b = [], self.min_batch
        while True:
            sizes.append(_round_up(min(b, self.max_batch), mult))
            if b >= self.max_batch:
                break
            b *= 2
        return tuple(dict.fromkeys(sizes))

    def bucket_for(self, m: int) -> int:
        """Smallest shape bucket that fits an ``m``-row query batch."""
        if m <= 0:
            raise ValueError(f"empty query batch (m={m})")
        sizes = self.bucket_sizes()
        for b in sizes:
            if m <= b:
                return b
        return sizes[-1]  # chunked by the engine


__all__ = ["Backend", "Method", "METHODS", "ServeConfig"]
