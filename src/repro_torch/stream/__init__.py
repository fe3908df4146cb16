"""Streaming (online-update) SD-KDE: the port's incremental-fit layer.

The counterpart of ``repro.stream``.  Static Flash-SD-KDE amortizes the
O(n²·d) debias pass across queries; this package amortizes it across
*dataset updates* too.  A ``StreamingSDKDE`` maintains the score
statistics, debiased positions and the cluster-aligned serving layout
incrementally under ``append`` / ``evict`` / ``slide``, publishing
immutable generational ``StreamSnapshot``s that the serving engine reads
under a staleness budget.

    from repro_torch.stream import StreamConfig, StreamingSDKDE

    s = StreamingSDKDE(x0, h=0.5, method="sdkde", backend="flash")
    ids = s.append(x_new)          # O(n·b·d) delta pass, no refit
    s.evict(ids[:4])
    snap = s.ensure(budget=0)      # freshest published generation
"""

from repro_torch.stream import delta
from repro_torch.stream.config import RebuildPolicy, StreamConfig
from repro_torch.stream.estimator import StreamingSDKDE, StreamSnapshot

__all__ = [
    "delta",
    "RebuildPolicy", "StreamConfig",
    "StreamingSDKDE", "StreamSnapshot",
]
