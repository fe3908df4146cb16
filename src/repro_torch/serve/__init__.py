"""Query serving for the port: fit once per dataset, answer ragged query
traffic through shape buckets on the ``flash`` or ``torch`` backend;
replicated shards (``ResilientEngine``) and an admission front end
(``AsyncFrontend``) in front of it.

    from repro_torch.serve import QueryRequest, ServeConfig, ServeEngine

    eng = ServeEngine(ServeConfig(backend="flash", method="sdkde"))
    eng.register("my-dataset", x_train)          # O(n²·d) debias, once
    ans = eng.query(QueryRequest(key="my-dataset", points=y_queries))
"""

from repro_torch.serve.api import RFF_TIER, Answer, QueryRequest
from repro_torch.serve.batching import (ShapeBucketCache, coalesce,
                                        pad_queries, split)
from repro_torch.serve.cascade import CascadeResult
from repro_torch.serve.config import Backend, Method, ServeConfig, ServeTier
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.errors import (BadRequest, DeadlineExceeded, Degraded,
                                      Overloaded, ServeError, UnknownKey)
from repro_torch.serve.frontend import (AdmissionStateMachine, AimdController,
                                        AsyncFrontend, FrontendConfig,
                                        TokenBucket)
from repro_torch.serve.registry import EstimatorRegistry, PreparedEstimator
from repro_torch.serve.resilience import ResilienceConfig, ResilientEngine
from repro_torch.serve.stats import LatencyRecorder, LatencySummary

__all__ = [
    "QueryRequest", "Answer", "RFF_TIER", "CascadeResult",
    "Backend", "Method", "ServeConfig", "ServeTier",
    "EstimatorRegistry", "PreparedEstimator",
    "ServeEngine",
    "ResilienceConfig", "ResilientEngine",
    "AsyncFrontend", "FrontendConfig",
    "AdmissionStateMachine", "AimdController", "TokenBucket",
    "ServeError", "UnknownKey", "BadRequest", "DeadlineExceeded",
    "Overloaded", "Degraded",
    "ShapeBucketCache", "coalesce", "pad_queries", "split",
    "LatencyRecorder", "LatencySummary",
]
