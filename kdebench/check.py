"""What every kind's check shares: the densities' errors, the limits and
the judgement that decides ``correct``.

After the window has closed and the program's state is freed, each
traffic kind's ``check`` (``kinds/<kind>.py``) has the float64 reference
(``reference/sdkde.py``) work out again, from the same inputs drawn from
the same seed, what the timed path produced, and compares the two with
:func:`density_numbers`:

* ``density_rel_err``: the largest |p − r| / r over the checked
  densities, p the program's float32 answer and r the reference's
  float64 one (a NaN or a missing answer reads as infinite);
* ``density_median_rel_err``: the median of the same errors.  The
  largest error sits on a few rows of low density, where float32
  rounding alone reaches it; the median is set by the typical row, and
  tells products computed below float32 (the program's own bf16x2 tier)
  from float32 ones where the largest does not.

Each number is held against its limit in ``limits/<workload>.json``.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List, Tuple

import torch


def rel_errs(p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """|p − r| / r for every row, in float64; a NaN reads as infinite, and
    an answer of the wrong shape as one infinite error."""
    p64 = p.to(torch.float64).reshape(-1)
    r64 = r.to(torch.float64).reshape(-1).to(p64.device)
    if p64.shape != r64.shape:
        return torch.full((1,), math.inf, dtype=torch.float64)
    err = (p64 - r64).abs() / r64
    return torch.where(torch.isnan(err), math.inf, err).cpu()


def density_numbers(errs: List[torch.Tensor]
                    ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """``(numbers, more)`` of the checked rows' errors: the numbers
    compared, and the mean and 99th percentile for the lines on standard
    error.  No rows at all read as infinite."""
    if not errs:
        inf = math.inf
        return ({"density_rel_err": inf, "density_median_rel_err": inf},
                {"mean": inf, "p99": inf})
    e = torch.cat(errs).sort().values
    at = lambda q: float(e[min(e.numel() - 1, int(q * e.numel()))])  # noqa: E731
    return ({"density_rel_err": float(e[-1]),
             "density_median_rel_err": at(0.5)},
            {"mean": float(e.mean()), "p99": at(0.99)})


def load_limits(root: Path, workload: str) -> Dict[str, dict]:
    """``limits/<workload>.json``: per number, its ``limit`` and the
    readings it was set from."""
    return json.loads((root / "kdebench" / "limits" /
                       f"{workload}.json").read_text())["numbers"]


def judge(numbers: Dict[str, float], limits: Dict[str, dict]
          ) -> Tuple[bool, Dict[str, dict]]:
    """``correct`` and each number beside its limit.  A number without a
    limit, or a limit without a number, is not correct."""
    shown, ok = {}, set(numbers) == set(limits)
    for name in sorted(set(numbers) | set(limits)):
        value = numbers.get(name, float("inf"))
        limit = limits.get(name, {}).get("limit", -1.0)
        shown[name] = {"value": value, "limit": limit}
        ok = ok and value <= limit
    return ok, shown


__all__ = ["rel_errs", "density_numbers", "load_limits", "judge"]
