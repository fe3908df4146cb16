#!/usr/bin/env python3
"""List every call that waits for the card on a benchmark cell's path, and
the program's ``sync.<site>`` span, if any, that holds it.

    python3 tools/sync_audit.py --workload mix16-32k.task --seconds 0
    python3 tools/sync_audit.py --workload mix16-1m.serve --seconds 30

Run from the repository root on a machine with an NVIDIA GPU.  The cell is
set up as ``kdebench/run.py`` sets it up (its warm tasks or requests run
untraced); then, with the program's tracing on and
``torch.cuda.set_sync_debug_mode("warn")``, it runs the cell's window for
``--seconds`` (0: one task).  PyTorch warns at each synchronizing call,
and each explicit ``torch.cuda.synchronize`` (which the debug mode does
not report) is noted too.  Each wait keeps its thread, its time and the
innermost frames of the program (``src/repro_torch``) and of the harness
(``kdebench``); after the run it is matched to the innermost ``sync.*``
span that its thread had open at that time.  It prints, and writes to
``--out`` as JSON:

  * every site that waited, with its count and its span;
  * each ``sync.*`` span name: spans opened, the waits they declare
    (``syncs``, 1 where absent), the waits seen inside them, and the
    spans whose two counts differ (``mismatched``);
  * the program's waits outside any ``sync.*`` span (``unspanned``),
    and the harness's own (its synchronize at a task's end, before a
    window), which are not the program's.

The exit code is 1 where the program waited outside a ``sync.*`` span or
a span's declared count differs from the waits seen in it, so a count
that a change of the code or of PyTorch made stale fails here.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import threading
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: Ring capacity of the audited run: a window that fills it would lose the
#: spans its first waits fell in.
CAPACITY = 1 << 19
#: What PyTorch's sync debug mode says at a synchronizing call.
WARNING = "synchronizing CUDA operation"


def _rel(path: str) -> str:
    try:
        return str(Path(path).resolve().relative_to(ROOT))
    except ValueError:
        return path


def _frame(frames, part: str):
    """``file:line function`` of the innermost frame whose path holds
    ``part``, or None."""
    for f in reversed(frames):
        if part in f.filename.replace("\\", "/"):
            return f"{_rel(f.filename)}:{f.lineno} {f.name}"
    return None


def watch(run):
    """``run()``'s value, the waits for the card it made, and the span
    events it recorded, with the program's tracing on and PyTorch's sync
    debug mode at "warn"."""
    import torch

    from repro_torch import obs

    if not torch.cuda.is_available():
        raise SystemExit("sync_audit: no CUDA device; the sync debug mode "
                         "reports waits only on the card")
    waits, lock = [], threading.Lock()
    show, synchronize = warnings.showwarning, torch.cuda.synchronize

    def note():
        t_ns = time.perf_counter_ns()
        frames = traceback.extract_stack()[:-2]
        with lock:
            waits.append({
                "t_ns": t_ns,
                "thread": threading.current_thread().name,
                "program": _frame(frames, "/src/repro_torch/"),
                "harness": _frame(frames, "/kdebench/"),
                "top": [f"{_rel(f.filename)}:{f.lineno} {f.name}"
                        for f in frames[-4:]]})

    def warned(message, category, filename, lineno, file=None, line=None):
        if WARNING not in str(message):
            return show(message, category, filename, lineno, file, line)
        note()

    def synchronized(device=None):
        note()
        return synchronize(device)

    obs.clear_trace()
    obs.set_trace_capacity(CAPACITY)
    synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = warned
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.synchronize = synchronized
        obs.configure(trace=True)
        try:
            out = run()
        finally:
            obs.configure(trace=False)
            torch.cuda.synchronize = synchronize
            torch.cuda.set_sync_debug_mode("default")
    events = obs.trace_events()
    if len(events) >= CAPACITY:
        raise SystemExit(f"sync_audit: {len(events)} spans filled the ring; "
                         "audit a shorter window")
    return out, waits, events


def _open_spans(waits, events) -> list:
    """For each wait, the spans its thread had open at its time, outermost
    first.  Spans nest on a thread, so one sweep in time order keeps the
    open ones on a stack."""
    from repro_torch.obs import trace

    out = [[] for _ in waits]
    for thread in {w["thread"] for w in waits}:
        evs = sorted((e for e in events if e["thread"] == thread),
                     key=lambda e: (e["ts_us"], -e["dur_us"]))
        order = sorted((i for i, w in enumerate(waits)
                        if w["thread"] == thread),
                       key=lambda i: waits[i]["t_ns"])
        stack, j = [], 0
        for i in order:
            t = (waits[i]["t_ns"] - trace._ORIGIN_NS) / 1e3
            while j < len(evs) and evs[j]["ts_us"] <= t:
                _close(stack, evs[j]["ts_us"])
                stack.append(evs[j])
                j += 1
            _close(stack, t)
            out[i] = list(stack)
    return out


def _close(stack: list, t: float) -> None:
    while stack and stack[-1]["ts_us"] + stack[-1]["dur_us"] < t:
        stack.pop()


def attribute(waits, events) -> dict:
    """The waits matched to the ``sync.*`` spans that hold them: the sites,
    each span name's declared and seen counts, and the program's waits
    outside any ``sync.*`` span."""
    seen = []
    for w, opened in zip(waits, _open_spans(waits, events)):
        sync = next((e for e in reversed(opened)
                     if e["name"].startswith("sync.")), None)
        seen.append({**w, "span": sync["name"] if sync else None,
                     "span_id": sync["id"] if sync else None,
                     "open": [e["name"] for e in opened]})
    sites = collections.Counter(
        (w["span"], w["program"] or w["harness"] or " < ".join(w["top"]))
        for w in seen)
    by_id = collections.Counter(w["span_id"] for w in seen if w["span_id"])
    spans: dict = {}
    for e in events:
        if not e["name"].startswith("sync."):
            continue
        s = spans.setdefault(e["name"], {"spans": 0, "declared": 0,
                                         "seen": 0, "mismatched": 0})
        declared = e["attrs"].get("syncs", 1)
        s["spans"] += 1
        s["declared"] += declared
        s["seen"] += by_id[e["id"]]
        s["mismatched"] += by_id[e["id"]] != declared
    unspanned = collections.Counter(
        (w["program"], tuple(w["open"])) for w in seen
        if w["span"] is None and w["program"])
    return {
        "waits": len(seen),
        "program_waits": sum(1 for w in seen if w["program"]),
        "sites": [{"span": k[0], "where": k[1], "count": v}
                  for k, v in sorted(sites.items(), key=lambda kv: -kv[1])],
        "sync_spans": spans,
        "mismatched": sum(s["mismatched"] for s in spans.values()),
        "unspanned": [{"where": k[0], "open": list(k[1]), "count": v}
                      for k, v in unspanned.items()],
        "harness_waits": collections.Counter(
            w["harness"] or " < ".join(w["top"]) for w in seen
            if not w["program"]),
    }


def audit(workload: str, seed: int, seconds: float) -> dict:
    """One cell's audit on the card."""
    import torch

    from kdebench import harness, loadgen
    from kdebench.spans import SpanLog

    wl, config, traffic = harness.cell(harness.manifest(), workload)
    drv = harness.kind(ROOT, traffic).Driver(
        config, traffic, seed, torch.device("cuda"), SpanLog(on=True),
        loadgen.sync_device)
    drv.setup()
    window, waits, events = watch(lambda: drv.window(seconds))
    drv.release()
    return {"workload": workload, "seed": seed, "seconds": seconds,
            "device": torch.cuda.get_device_name(0),
            "attempted": window.attempted, **attribute(waits, events)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=4700000001)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    out = audit(args.workload, args.seed, args.seconds)
    print(f"{out['workload']} on {out['device']}: {out['attempted']} "
          f"task(s)/request(s), {out['waits']} waits, "
          f"{out['program_waits']} in the program")
    for s in out["sites"]:
        print(f"  {s['count']:6d}  {s['span'] or '(no sync span)':18s} "
              f"{s['where']}")
    for name, s in sorted(out["sync_spans"].items()):
        print(f"  {name:18s} spans {s['spans']} declared {s['declared']} "
              f"seen {s['seen']} mismatched {s['mismatched']}")
    print(f"  harness waits: {dict(out['harness_waits'])}")
    print(f"  unspanned program waits: {len(out['unspanned'])}")
    for w in out["unspanned"]:
        print(f"    {w}")
    print(f"  spans whose declared count differs: {out['mismatched']}")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1, default=str))
    return 1 if out["unspanned"] or out["mismatched"] else 0


if __name__ == "__main__":
    sys.exit(main())
