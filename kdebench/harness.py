"""One run of one cell: set-up, the measured window, the check, the line.

Everything a cell is made of is found by name from ``BENCHMARK.json``:
the configuration (its ``file``), the traffic (``traffic/<traffic>.json``,
a data file), the code of the traffic's ``kind`` (``kinds/<kind>.py``,
its ``Driver`` and its ``check``; see ``loadgen``), the limits of its
check (``limits/<workload>.json``) and the reader of each per-layer metric
(``metrics/<metric>.py``, a function ``read(ctx)`` returning a number, or
None where it finds nothing to read).  A later cell, mix, kind or metric
is new files and entries only.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from kdebench import check, loadgen
from kdebench import trace as tr
from kdebench.spans import SpanLog

ROOT = Path(__file__).resolve().parents[1]
#: Top-level module names that may not be loaded when the window closes.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: Capacity of the program's span ring buffer in the traced run.
SPAN_CAPACITY = 1 << 19


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(man: dict, workload: str, root: Path = ROOT
         ) -> Tuple[dict, dict, dict]:
    """``(workload entry, configuration, traffic)`` of a cell, by name."""
    found = [w for w in man["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(known: {[w['name'] for w in man['workloads']]})")
    wl = found[0]
    conf = next(c for c in man["configs"] if c["name"] == wl["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "kdebench" / "traffic" /
                          f"{wl['traffic']}.json").read_text())
    return wl, config, traffic


def metrics_of(man: dict, workload: str, kind: str) -> List[dict]:
    """The metrics a cell reports: ``kind`` is ``end_to_end`` or
    ``per_layer``; a metric without a ``workloads`` list belongs to every
    cell (a per-layer one to every cell that reports what it moves)."""
    e2e = [m for m in man["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if workload in m.get("workloads", [workload])
            and m["moves"] in names]


def _load(root: Path, folder: str, name: str):
    """The module ``<folder>/<name>.py`` under ``kdebench/``, loaded by
    path (a name may hold dots and dashes)."""
    path = root / "kdebench" / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder} module {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"kdebench_{folder}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root: Path, metric: str) -> Callable:
    """``read`` of ``metrics/<metric>.py``."""
    return _load(root, "metrics", metric).read


def kind(root: Path, traffic: dict):
    """The module of a traffic file's ``kind``: ``kinds/<kind>.py``, with
    its ``Driver`` and its ``check``."""
    return _load(root, "kinds", traffic["kind"])


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def finite(v: float) -> float:
    """A value the result's JSON can hold: inf and NaN read as 1e300."""
    return v if math.isfinite(v) else 1e300


def _counters(driver) -> Dict[str, object]:
    from repro_torch.kernels import flash_pruned

    out = {name: {"visited": c.tiles_visited, "total": c.tiles_total,
                  "launches": c.launches}
           for name, c in (("score", flash_pruned.score_counts),
                           ("kde", flash_pruned.kde_counts))}
    if hasattr(driver, "frontend"):
        out["frontend"] = driver.frontend.report()
    return out


def _reset_counters() -> None:
    from repro_torch import obs
    from repro_torch.kernels import flash_pruned

    flash_pruned.score_counts.reset()
    flash_pruned.kde_counts.reset()
    obs.registry.reset()


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, root: Path = ROOT, device: str = "cuda",
        config_override: Optional[dict] = None,
        traffic_override: Optional[dict] = None,
        sync: Optional[Callable[[], None]] = None,
        check_kw: Optional[dict] = None) -> Tuple[dict, List[str]]:
    """One run; returns ``(result, check lines)``.  ``t_start`` is the
    process's start on ``time.perf_counter``.  The overrides, ``device``
    and ``sync`` let a test drive the same path on the CPU at a small
    size; the benchmark's runs pass none of them."""
    from repro_torch import obs

    man = manifest(root)
    wl, config, traffic = cell(man, workload, root)
    config = {**config, **(config_override or {})}
    traffic = {**traffic, **(traffic_override or {})}
    dev = torch.device(device)
    spans = SpanLog(on=trace)
    traffic_kind = kind(root, traffic)
    drv = traffic_kind.Driver(config, traffic, seed, dev, spans,
                              sync or loadgen.sync_device)
    drv.setup()

    dtrace = None
    if trace:
        _reset_counters()
        obs.set_trace_capacity(SPAN_CAPACITY)
        obs.configure(trace=True)
        t_anchor = time.perf_counter()
        with obs.span("kdebench.anchor"):
            pass
        dtrace = tr.DeviceTrace()
        with dtrace:
            window = drv.window(seconds)
        obs.configure(trace=False)
        events = obs.trace_events()
        anchor = next(e for e in events if e["name"] == "kdebench.anchor")
        program = tr.program_spans(
            [e for e in events if e is not anchor],
            t_anchor - anchor["ts_us"] / 1e6)
        counters = _counters(drv)
    else:
        window = drv.window(seconds)

    setup_s = window.t0 - t_start          # process start to the window
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    drv.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    numbers, work = traffic_kind.check(drv, window, **(check_kw or {}))
    ref_s = time.perf_counter() - t_ref
    correct, shown = check.judge(numbers,
                                 check.load_limits(root, workload))

    metrics = {}
    result_device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                     "kind": (torch.cuda.get_device_name(0)
                              if dev.type == "cuda" else "cpu"),
                     "count": 1, "memory_peak_bytes": int(peak)}
    extra = {}
    if trace:
        ctx = tr.TraceContext(
            workload=wl, config=config, traffic=traffic, t0=window.t0,
            t1=window.t1, records=window.records,
            kernels=tr.clip(dtrace.intervals, window.t0, window.t1),
            spans=[(*s, "harness") for s in spans.events] + program,
            counters=counters, work=work)
        for m in metrics_of(man, workload, "per_layer"):
            value = reader(root, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result_device.update(busy_s=ctx.busy_s, window_s=ctx.window_s)
        extra["breakdown"] = tr.breakdown(ctx)
    else:
        e2e = dict(window.end_to_end, setup_s=setup_s)
        for m in metrics_of(man, workload, "end_to_end"):
            metrics[m["name"]] = {"value": finite(e2e[m["name"]]),
                                  "unit": m["unit"]}

    result = {"correct": bool(correct), "attempted": window.attempted,
              "failed": window.failed, "metrics": metrics,
              "device": result_device, **extra,
              "checks": {k: {"value": finite(v["value"]), "limit": v["limit"]}
                         for k, v in shown.items()}}
    lines = [f"run {workload}: setup_s {setup_s:.3f}, window_s "
             f"{window.t1 - window.t0:.3f}, attempted {window.attempted}, "
             f"reference_s {ref_s:.3f}",
             "check work: " + ", ".join(f"{k} {v!r}" for k, v in
                                        work.items())]
    lines += loadgen.summary(window)
    if trace:
        lines.append(f"trace: device clock aligned by {dtrace.aligned_by}, "
                     f"drift_s {dtrace.drift_s}")
    lines += [f"check {k}: {finite(v['value'])!r} (limit {v['limit']!r})"
              for k, v in shown.items()]
    return result, lines


__all__ = ["ROOT", "FORBIDDEN", "manifest", "cell", "metrics_of", "reader",
           "kind", "forbidden_modules", "finite", "run"]
