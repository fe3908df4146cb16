"""The traced window: device intervals from ``torch.profiler`` on the host
clock, the host spans beside them, and the arithmetic the readers share.

The profiler records CUDA activity only (kernels, copies, fills): a
serving window launches hundreds of thousands of host operations, and
recording each would cost more than the window.  What the host was doing
comes from the spans instead: the harness's own (``spans.SpanLog``) and
the program's (``repro_torch.obs`` trace events, enabled for the traced
run), both on ``time.perf_counter``.

Device timestamps are put on that clock by two marker kernels
(``torch.cuda._sleep``) launched right after a synchronize at either end
of the profile: the first marker's device start minus the host time of
its launch is the offset; the second one shows the drift, which
``drift_s`` reports.  A marker starts a launch latency (a few µs) after
its host time, so device intervals read that much early.  The end
marker stands in where the first was not recorded, and the last device
interval where neither was.

``union_length`` is a copy of the program's
``analysis/profile.py`` accounting, kept here so that the yardstick does
not move with the program.
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

#: Cycles of the marker kernel (a few µs on the card).
MARK_CYCLES = 10_000
#: Seconds between the profile's edges and its markers.
MARK_PAD_S = 0.05
#: Entries of each breakdown list.
TOP = 10

Interval = Tuple[str, float, float]          # (name, t0 s, t1 s)


def union_length(spans: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    return busy


def gaps(spans: Iterable[Tuple[float, float]], t0: float,
         t1: float) -> List[Tuple[float, float]]:
    """The intervals of ``[t0, t1]`` that no span covers."""
    out, cur = [], t0
    for a, b in sorted(spans):
        if a > cur:
            out.append((cur, min(a, t1)))
        cur = max(cur, b)
        if cur >= t1:
            break
    if cur < t1:
        out.append((cur, t1))
    return [(a, b) for a, b in out if b > a]


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without ``void`` and its argument list."""
    s = name[5:] if name.startswith("void ") else name
    return s.split("(", 1)[0][:width]


def _device_events(prof) -> List[Interval]:
    """Every device interval of a finished profile, in seconds of the
    profiler's own clock."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        start = e.start_ns() if hasattr(e, "start_ns") else 1e3 * e.start_us()
        dur = (e.duration_ns() if hasattr(e, "duration_ns")
               else 1e3 * e.duration_us())
        out.append((e.name(), start / 1e9, (start + dur) / 1e9))
    return out


class DeviceTrace:
    """``with DeviceTrace() as tr:`` profiles the device over the block;
    afterwards ``tr.intervals`` holds every device interval on the host
    clock, ``tr.drift_s`` the change of the offset across the block
    (None where only one end's marker was recorded).

    Each marker is launched ``MARK_PAD_S`` inside the profile, since the
    profiler may drop device records at the very edges of its trace.
    Where no marker was recorded at all, the offset comes from the last
    device interval, which ends before the synchronize that closes the
    block returns (``aligned_by`` says which way it was found)."""

    def __init__(self):
        self.intervals: List[Interval] = []
        self.drift_s: Optional[float] = None
        self.aligned_by = ""
        self._marks: List[float] = []

    def _mark(self) -> None:
        torch.cuda.synchronize()
        self._marks.append(time.perf_counter())
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
        self._marks.append(time.perf_counter())

    def __enter__(self) -> "DeviceTrace":
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA],
                             acc_events=True)
        self._prof.__enter__()
        time.sleep(MARK_PAD_S)
        self._mark()
        return self

    def __exit__(self, *exc) -> bool:
        self._mark()
        time.sleep(MARK_PAD_S)
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        events = _device_events(self._prof)
        del self._prof
        work = [e for e in events if "spin" not in e[0]]
        spins = sorted(a for n, a, _ in events if "spin" in n)
        offs = []
        if spins and work and spins[0] < work[0][1]:
            offs.append(spins[0] - self._marks[0])
        if spins and work and spins[-1] > max(b for _, _, b in work):
            offs.append(spins[-1] - self._marks[2])
        if not work:
            raise RuntimeError(f"the profile holds no device work "
                               f"({len(events)} device intervals)")
        if offs:
            off = offs[0]
            self.drift_s = offs[1] - offs[0] if len(offs) == 2 else None
            self.aligned_by = f"{len(offs)} marker(s)"
        else:
            off = max(b for _, _, b in work) - self._marks[2]
            self.aligned_by = "the last device interval"
        self.intervals = [(n, a - off, b - off) for n, a, b in work]
        return False


@dataclasses.dataclass
class TraceContext:
    """What a reader of a per-layer metric may read."""

    workload: dict
    config: dict
    traffic: dict
    t0: float                      # window start, host seconds
    t1: float                      # window end
    records: list                  # the driver's per-task / per-request list
    kernels: List[Interval]        # device intervals inside the window
    spans: List[tuple]             # (name, t0, t1, attrs, source)
    counters: Dict[str, object]    # the program's counters after the window
    work: Dict[str, float]         # the check's needed-pair fractions

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_s(self) -> float:
        return union_length((a, b) for _, a, b in self.kernels)

    def kernel_seconds(self, match) -> float:
        """Summed time of the kernels whose name ``match`` accepts."""
        return sum(b - a for n, a, b in self.kernels if match(n))

    def spans_named(self, name: str) -> List[tuple]:
        return [s for s in self.spans if s[0] == name]


def clip(intervals: Sequence[Interval], t0: float,
         t1: float) -> List[Interval]:
    """The parts of ``intervals`` inside ``[t0, t1]``."""
    return [(n, max(a, t0), min(b, t1)) for n, a, b in intervals
            if b > t0 and a < t1]


def program_spans(events: Sequence[dict], origin_s: float) -> List[tuple]:
    """``repro_torch.obs`` trace events as ``(name, t0, t1, attrs,
    "program")`` on the host clock, ``origin_s`` being the clock's value
    at the events' zero."""
    return [(e["name"], origin_s + e["ts_us"] / 1e6,
             origin_s + (e["ts_us"] + e["dur_us"]) / 1e6, e["attrs"],
             "program") for e in events]


def innermost(spans: Sequence[tuple], points: Sequence[float]) -> List[str]:
    """For each of the ascending ``points``, the name of the latest-opened
    span that holds it, or ``host``: one sweep with a heap of the open
    spans by start, so a window of many spans and gaps stays fast."""
    order = sorted(spans, key=lambda s: s[1])
    heap: list = []
    j, out = 0, []
    for t in points:
        while j < len(order) and order[j][1] <= t:
            heapq.heappush(heap, (-order[j][1], j))
            j += 1
        while heap and order[heap[0][1]][2] <= t:
            heapq.heappop(heap)
        out.append(order[heap[0][1]][0] if heap else "host")
    return out


def breakdown(ctx: TraceContext) -> dict:
    """The device operations that took most time, and the idle time of
    the window summed by the span that was open on the host."""
    by_op: Dict[str, float] = {}
    for n, a, b in ctx.kernels:
        k = short_name(n)
        by_op[k] = by_op.get(k, 0.0) + (b - a)
    idle: Dict[str, float] = {}
    holes = gaps(((a, b) for _, a, b in ctx.kernels), ctx.t0, ctx.t1)
    names = innermost(ctx.spans, [0.5 * (a + b) for a, b in holes])
    for (a, b), name in zip(holes, names):
        idle[name] = idle.get(name, 0.0) + (b - a)
    top = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"device_ops": top(by_op), "idle_gaps": top(idle)}


__all__ = ["MARK_CYCLES", "MARK_PAD_S", "TOP", "union_length", "gaps", "short_name",
           "DeviceTrace", "TraceContext", "clip", "program_spans",
           "innermost", "breakdown"]
