"""Planner CLI.

* ``python -m repro_torch.plan --regen-golden`` rewrites the port's
  golden-decision fixture (``src/repro_torch/plan/golden_plans.json``).
* ``python -m repro_torch.plan --n 262144 --d 16 [--q --accuracy
  --backend --stream --rff]`` prints the plan one request resolves to, as
  JSON (default measured cells: none, so no epsilon > 0 and no RFF tier).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.plan.golden import default_golden_path, write_golden
from repro_torch.plan.planner import DEFAULT_ACCURACY, DEFAULT_Q, plan_for


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.plan",
        description="Resolve execution plans / regenerate the port's "
                    "golden decision fixture.")
    ap.add_argument("--regen-golden", action="store_true",
                    help="rewrite the golden-decision fixture")
    ap.add_argument("--golden", type=Path, default=None,
                    help=f"fixture path (default: {default_golden_path()})")
    ap.add_argument("--n", type=int, default=None, help="train rows")
    ap.add_argument("--d", type=int, default=None, help="feature dim")
    ap.add_argument("--q", type=int, default=DEFAULT_Q, help="query rows")
    ap.add_argument("--accuracy", type=float, default=DEFAULT_ACCURACY,
                    help="relative accuracy target")
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "torch", "flash"))
    ap.add_argument("--stream", action="store_true",
                    help="plan for a streaming estimator")
    ap.add_argument("--rff", action="store_true",
                    help="the request is cascade-eligible")
    args = ap.parse_args(argv)

    if args.regen_golden:
        path, count = write_golden(args.golden)
        print(f"wrote {count} golden plans to {path}")
        return 0
    if args.n is None or args.d is None:
        ap.error("either --regen-golden or both --n and --d are required")
    p = plan_for(args.n, args.d, q=args.q, accuracy=args.accuracy,
                 backend=args.backend, stream=args.stream, rff=args.rff)
    json.dump({"request": p.request.as_dict(), "plan": p.as_dict(),
               "plan_id": p.plan_id}, sys.stdout, indent=2)
    print()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
