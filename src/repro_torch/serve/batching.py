"""Micro-batching: coalesce ragged query traffic into a few fixed shapes.

  * **shape buckets** — pad each batch up to a geometric ladder of sizes
    (multiples of the kernels' row tile ``block_m``), bounding the number
    of distinct launch shapes per estimator;
  * **an LRU of bucket callables** — the engine's per-(estimator, bucket)
    callables, evicted least-recently-used.

Padding uses the kernels' far sentinel (``PAD_VALUE``): padded query rows
get kernel weight exactly 0.0 from every real train point, and their
densities are sliced off before the answer is split back per request.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Hashable, List, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.core.kde import PAD_VALUE, pad_rows  # noqa: F401 - PAD_VALUE
# is re-exported for serve users building their own padded batches.


def pad_queries(y: torch.Tensor, bucket: int) -> torch.Tensor:
    """Pad a (m, d) query batch up to ``bucket`` rows with sentinel points."""
    if y.shape[0] > bucket:
        raise ValueError(
            f"batch of {y.shape[0]} rows does not fit bucket {bucket}")
    return pad_rows(y, bucket)


def coalesce(batches: Sequence[torch.Tensor]
             ) -> Tuple[torch.Tensor, List[int]]:
    """Concatenate per-request (m_i, d) batches into one dispatch; returns
    the fused (Σm_i, d) tensor and the row counts ``split`` undoes."""
    if not batches:
        raise ValueError("no query batches to coalesce")
    d = batches[0].shape[-1]
    for a in batches:
        if a.shape[-1] != d:
            raise ValueError(f"dimension mismatch: {a.shape[-1]} != {d}")
    return torch.cat(list(batches), dim=0), [int(a.shape[0]) for a in batches]


def split(fused: torch.Tensor, sizes: Sequence[int]) -> List[torch.Tensor]:
    """Inverse of ``coalesce`` for the fused density vector."""
    return list(torch.split(fused, list(sizes)))


class ShapeBucketCache:
    """LRU cache of per-(estimator, bucket) callables, with hit, miss and
    eviction counts (also fed to the process-wide ``serve.bucket_cache.*``
    counters, so a rebuild storm under streaming shows in any metrics
    snapshot)."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._entries: "OrderedDict[Hashable, Callable]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._hit_counter = obs.counter("serve.bucket_cache.hits")
        self._miss_counter = obs.counter("serve.bucket_cache.misses")
        self._evict_counter = obs.counter("serve.bucket_cache.evictions")

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._entries

    def get_or_build(self, key: Hashable, build: Callable[[], Callable]):
        """Return the cached callable for ``key``, building on miss."""
        if key in self._entries:
            self.hits += 1
            self._hit_counter.inc()
            self._entries.move_to_end(key)
            return self._entries[key]
        self.misses += 1
        self._miss_counter.inc()
        fn = build()
        self._entries[key] = fn
        if len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1
            self._evict_counter.inc()
        return fn

    def invalidate(self, predicate: Callable[[Hashable], bool]) -> None:
        """Drop entries whose key matches (e.g. after an estimator refit)."""
        for k in [k for k in self._entries if predicate(k)]:
            del self._entries[k]


__all__ = ["pad_queries", "coalesce", "split", "ShapeBucketCache"]
