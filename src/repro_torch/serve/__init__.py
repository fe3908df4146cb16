"""Query serving for the port: fit once per dataset, answer ragged query
traffic through shape buckets on the ``flash`` or ``torch`` backend.

    from repro_torch.serve import QueryRequest, ServeConfig, ServeEngine

    eng = ServeEngine(ServeConfig(backend="flash", method="sdkde"))
    eng.register("my-dataset", x_train)          # O(n²·d) debias, once
    ans = eng.query(QueryRequest(key="my-dataset", points=y_queries))
"""

from repro_torch.serve.api import Answer, QueryRequest
from repro_torch.serve.batching import (ShapeBucketCache, coalesce,
                                        pad_queries, split)
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.errors import BadRequest, ServeError, UnknownKey
from repro_torch.serve.registry import EstimatorRegistry, PreparedEstimator
from repro_torch.serve.stats import LatencyRecorder, LatencySummary

__all__ = [
    "QueryRequest", "Answer", "ServeConfig", "ServeEngine",
    "EstimatorRegistry", "PreparedEstimator",
    "ServeError", "UnknownKey", "BadRequest",
    "ShapeBucketCache", "coalesce", "pad_queries", "split",
    "LatencyRecorder", "LatencySummary",
]
