"""The port's golden-decision fixture: pinned plans for its own regimes.

``repro``'s fixture (``tests/golden_plans.json``) pins decisions of the
TPU model for the TPU's benchmark cells, and stays as it is.  The port
pins its planner's decisions over a fixed list of the port's shapes
(:data:`GOLDEN_SHAPES`: the main path, the clustered check, paper scale,
Fig. 3's 1-D set, the streaming scale and one train set under
``FLASH_MIN_COLS``) at the accuracies :data:`GOLDEN_ACCURACIES`, priced
with one explicit :class:`~repro_torch.plan.planner.BenchModel` of stated
cells (:data:`GOLDEN_CELLS`) so that the epsilon and RFF branches are
pinned too.  Those cells are fixture inputs, not measurements.

``python -m repro_torch.plan --regen-golden`` is the only way the fixture
(``golden_plans.json`` beside this module) changes.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from repro_torch.plan.planner import BenchModel, ExecutionPlan, PlanRequest, plan

#: (label, n, d, q, stream): the regimes the fixture pins.
GOLDEN_SHAPES: Tuple[Tuple[str, int, int, int, bool], ...] = (
    ("main", 32768, 16, 16384, False),
    ("clustered", 32768, 16, 4096, False),
    ("paper", 1048576, 16, 131072, False),
    ("fig3_1d", 8192, 1, 1024, False),
    ("stream", 262144, 16, 4096, True),
    ("small", 1024, 4, 4096, False),
)
GOLDEN_ACCURACIES = (1e-5, 5e-4, 5e-2)

#: Stated cells for the fixture's BenchModel (inputs that exercise the
#: epsilon-promotion and RFF branches, not measurements): a pruning
#: regime at 32768 x 16 with a small and a large epsilon, and RFF hit
#: fractions at Fig. 3's 1-D shape (where the modeled exact pass is
#: cheaper than the RFF pass, so the tier is not planned) and at paper
#: scale (where it pays at the loose target).
GOLDEN_CELLS = (
    {"cell": "pruning", "n": 32768, "d": 16, "epsilon": 1e-7,
     "block_n": 128, "occupancy": 0.06, "prune_rel_err": 1e-6},
    {"cell": "pruning", "n": 32768, "d": 16, "epsilon": 1e-5,
     "block_n": 128, "occupancy": 0.03, "prune_rel_err": 2e-4},
    {"cell": "rff_cascade", "n": 8192, "d": 1, "accuracy_target": 5e-4,
     "rff_hit_frac": 0.95},
    {"cell": "rff_cascade", "n": 1048576, "d": 16, "accuracy_target": 5e-2,
     "rff_hit_frac": 0.5},
)


def default_golden_path() -> Path:
    """``golden_plans.json`` beside this module."""
    return Path(__file__).resolve().parent / "golden_plans.json"


def golden_bench() -> BenchModel:
    """The fixture's BenchModel, built from :data:`GOLDEN_CELLS`."""
    return BenchModel([{"cells": list(GOLDEN_CELLS)}])


def golden_requests() -> List[Tuple[str, PlanRequest]]:
    """(label, request) for every pinned regime and accuracy; every
    request is cascade-eligible (sdkde with the RFF tier enabled)."""
    return [(label, PlanRequest(n=n, d=d, q=q, accuracy=acc, stream=stream,
                                rff=True))
            for label, n, d, q, stream in GOLDEN_SHAPES
            for acc in GOLDEN_ACCURACIES]


def request_key(req: PlanRequest) -> str:
    """Stable fixture key for one request."""
    key = (f"n={req.n} d={req.d} q={req.q} accuracy={req.accuracy:g} "
           f"backend={req.backend} stream={req.stream}")
    return key + " rff=True" if req.rff else key


def golden_entries() -> Dict[str, dict]:
    """key → {"label", "request", "plan"} for every pinned request."""
    bench = golden_bench()
    out: Dict[str, dict] = {}
    for label, req in golden_requests():
        p: ExecutionPlan = plan(req, bench=bench)
        out[request_key(req)] = {"label": label, "request": req.as_dict(),
                                 "plan": p.as_dict()}
    return out


def write_golden(path: Optional[Path] = None) -> Tuple[Path, int]:
    """(Re)write the fixture: the deliberate regeneration path."""
    path = Path(path) if path is not None else default_golden_path()
    entries = golden_entries()
    doc = {
        "meta": {
            "regen": "python -m repro_torch.plan --regen-golden",
            "description": "pinned H100-model planner decisions for the "
                           "port's regimes (plan/golden.py)",
            "entries": len(entries),
        },
        "plans": {k: entries[k] for k in sorted(entries)},
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")
    return path, len(entries)


def load_golden(path: Optional[Path] = None) -> dict:
    path = Path(path) if path is not None else default_golden_path()
    with open(path) as f:
        return json.load(f)


__all__ = [
    "GOLDEN_SHAPES", "GOLDEN_ACCURACIES", "GOLDEN_CELLS",
    "default_golden_path", "golden_bench", "golden_requests", "request_key",
    "golden_entries", "write_golden", "load_golden",
]
