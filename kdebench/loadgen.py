"""What the traffic kinds share: the window's record, the size and gap
tables of an open loop, and the lines a window prints.

A traffic file, ``traffic/<mix>.json``, names its ``kind`` and holds its
numbers; the kind is a module of its own, ``kinds/<kind>.py``, that the
harness finds by that name.  It defines ``Driver`` (``setup``,
``window(seconds)``, ``release``, built from the configuration, the
traffic, the seed, the device, the harness's spans and a synchronize)
and ``check(driver, window, reference=None, **kw)``, which returns the
numbers compared and the work the reference counted.  A new kind of
traffic is a new file there; a new mix of a kind is a new data file.

Every input comes from ``--seed`` through named generator streams
(``reference.mixture.generator``), so a check can draw the same tensors
again after the window.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import torch

#: A request's answer that takes longer than this ends the run.
RESULT_TIMEOUT_S = 120.0


@dataclasses.dataclass
class Window:
    """What a measured window produced."""

    t0: float
    t1: float
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    records: list                    # per task or per request
    kept: list                       # what the check compares


def sync_device() -> None:
    torch.cuda.synchronize()


def size_table(rows_min: int, rows_max: int, count: int) -> List[int]:
    """``count`` request sizes, log-uniform from ``rows_min`` to
    ``rows_max`` inclusive."""
    if count == 1:
        return [int(rows_min)]
    ratio = rows_max / rows_min
    return [int(round(rows_min * ratio ** (k / (count - 1))))
            for k in range(count)]


def gap_table(count: int) -> List[float]:
    """``count`` gaps between arrivals of a Poisson stream of rate 1: the
    exponential distribution's quantiles at (k + 1/2) / count, scaled to
    a mean of exactly 1."""
    g = [-math.log(1.0 - (k + 0.5) / count) for k in range(count)]
    return [x * count / sum(g) for x in g]


def summary(window: Window) -> List[str]:
    """Lines for standard error: the spread of the window's tasks or
    requests (ms), and the failures by reason."""
    recs = window.records
    times = sorted(1e3 * (r["t1"] - r["t0"]) for r in recs)
    pick = lambda q: times[min(len(times) - 1, int(q * len(times)))]  # noqa: E731
    out = [f"window: {len(recs)} done, ms min {times[0]:.3f} p50 "
           f"{pick(0.5):.3f} p95 {pick(0.95):.3f} max {times[-1]:.3f}"]
    late = [r["sent"] - r["t0"] for r in recs if "sent" in r]
    if late:
        out.append(f"window: offered {len(recs) / (window.t1 - window.t0):.2f}"
                   f" requests/s, generator late by max {1e3 * max(late):.3f}"
                   " ms")
    why = sorted({r.get("why", "") for r in recs} - {""})
    if why:
        out.append(f"window: failed {window.failed} ({', '.join(why)})")
    return out
