"""Cost-model execution planning for the port.

``repro_torch.plan`` turns a (shape, accuracy target, backend hint)
request into one validated :class:`ExecutionPlan` — precision tier,
prune mode, launch tiles, backend, stream-staleness policy and the RFF
fast tier — from the H100 cost model and measured cells
(``planner.py``); ``golden.py`` pins its decisions for the port's
regimes.
"""

from repro_torch.plan.golden import (
    GOLDEN_ACCURACIES,
    GOLDEN_CELLS,
    GOLDEN_SHAPES,
    default_golden_path,
    golden_bench,
    golden_entries,
    golden_requests,
    load_golden,
    request_key,
    write_golden,
)
from repro_torch.plan.planner import (
    DEFAULT_ACCURACY,
    DEFAULT_Q,
    EPS_SAFETY,
    FLASH_MIN_COLS,
    TIER_ORDER,
    TIER_RTOL,
    BenchModel,
    ExecutionPlan,
    PlanRequest,
    default_bench_paths,
    plan,
    plan_for,
    resolve_config,
)

__all__ = [
    "DEFAULT_ACCURACY", "DEFAULT_Q", "EPS_SAFETY", "FLASH_MIN_COLS",
    "TIER_ORDER", "TIER_RTOL", "BenchModel", "ExecutionPlan",
    "PlanRequest", "default_bench_paths", "plan", "plan_for",
    "resolve_config", "GOLDEN_ACCURACIES", "GOLDEN_CELLS", "GOLDEN_SHAPES",
    "default_golden_path", "golden_bench", "golden_entries",
    "golden_requests", "load_golden", "request_key", "write_golden",
]
