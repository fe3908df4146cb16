"""Process-wide metrics: counters, gauges, log-bucketed histograms.

The counterpart of ``repro.obs.metrics``.  One module-level
``MetricsRegistry`` holds every instrument, created on first use and
addressed by dot-separated name (``serve.requests``,
``kernels.prune.visit_fraction``).  Design constraints, in order:

  1. **Bounded memory.**  Histograms keep fixed log-spaced bucket counts
     plus (count, sum, min, max) — never a sample list — so a long-lived
     server holds as much telemetry state as a fresh one.
  2. **~Free when disabled.**  Every mutation checks ``state.metrics_on``
     first; the disabled path is one attribute read and a branch.
  3. **Exportable.**  ``snapshot()`` returns a JSON-safe dict;
     ``prometheus_text()`` renders the standard text exposition
     (``name{labels} value`` plus ``_bucket/_sum/_count`` for histograms)
     that ``lint_prometheus`` (and ``python -m repro_torch.obs``)
     validates.

Quantiles are geometric interpolation inside the winning bucket, clamped
to the exact [min, max]: exact for 0/1 samples, within one edge ratio
``10^(1/per_decade)`` otherwise.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, List, Optional, Tuple

from repro_torch.obs import state

_NAME_RE_HELP = "metric names: dot-separated [a-zA-Z0-9_] segments"


def _check_name(name: str) -> str:
    if not name or not all(
        seg and all(c.isalnum() or c == "_" for c in seg)
        for seg in name.split(".")
    ):
        raise ValueError(f"bad metric name {name!r} ({_NAME_RE_HELP})")
    return name


def log_bucket_bounds(lo: float, hi: float,
                      per_decade: int = 6) -> Tuple[float, ...]:
    """Fixed log-spaced upper bucket edges covering [lo, hi].

    Edge ``i`` is ``lo · 10^(i/per_decade)``; the last edge is the first
    one ≥ ``hi``.  Values ≤ lo land in the first bucket, values past the
    last edge in the overflow bucket — both bounded, neither lost.
    """
    if not (lo > 0 and hi > lo and per_decade >= 1):
        raise ValueError(f"bad histogram range lo={lo} hi={hi} "
                         f"per_decade={per_decade}")
    n = math.ceil(math.log10(hi / lo) * per_decade)
    return tuple(lo * 10.0 ** (i / per_decade) for i in range(n + 1))


class Counter:
    """Monotonic float counter."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = _check_name(name)
        self.help = help
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if not state.metrics_on:
            return
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._lock:
            self.value += n

    def reset(self) -> None:
        with self._lock:
            self.value = 0.0

    def snapshot(self) -> dict:
        return {"type": self.kind, "value": self.value}


class Gauge:
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = _check_name(name)
        self.help = help
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self.value = 0.0

    def set(self, v: float) -> None:
        if not state.metrics_on:
            return
        with self._lock:
            self.value = float(v)

    def reset(self) -> None:
        with self._lock:
            self.value = 0.0

    def snapshot(self) -> dict:
        return {"type": self.kind, "value": self.value}


class Histogram:
    """Fixed log-spaced-bucket histogram: bounded state, estimated tails.

    ``observe(v, k)`` folds ``k`` identical samples in O(log buckets) —
    the serving engine uses the weight to record one latency per request
    of a coalesced dispatch without looping.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "", *,
                 lo: float = 1e-6, hi: float = 1e3, per_decade: int = 6,
                 labels: Optional[Dict[str, str]] = None):
        self.name = _check_name(name)
        self.help = help
        self.labels = dict(labels or {})
        self.bounds = log_bucket_bounds(lo, hi, per_decade)
        self._lock = threading.Lock()
        self._zero()

    def _zero(self) -> None:
        self.counts = [0] * (len(self.bounds) + 1)  # +1 = overflow bucket
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float, k: int = 1) -> None:
        if not state.metrics_on or k <= 0:
            return
        v = float(v)
        idx = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self.counts[idx] += k
            self.count += k
            self.sum += v * k
            self.min = min(self.min, v)
            self.max = max(self.max, v)

    def reset(self) -> None:
        with self._lock:
            self._zero()

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (0 when empty): geometric interpolation
        inside the winning bucket, clamped to the exact [min, max]."""
        with self._lock:
            if self.count == 0:
                return 0.0
            rank = max(1, math.ceil(q * self.count))
            acc = 0
            for i, c in enumerate(self.counts):
                acc += c
                if acc >= rank:
                    break
            lo = self.bounds[i - 1] if i > 0 else max(self.min, 1e-300)
            hi = self.bounds[i] if i < len(self.bounds) else max(
                self.max, self.bounds[-1])
            est = math.sqrt(max(lo, 1e-300) * max(hi, 1e-300))
            return min(max(est, self.min), self.max)

    @property
    def mean(self) -> float:
        with self._lock:
            return self.sum / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        with self._lock:
            nonzero = [[self.bounds[i] if i < len(self.bounds) else "+Inf",
                        c] for i, c in enumerate(self.counts) if c]
            snap = {"type": self.kind, "count": self.count,
                    "sum": self.sum,
                    "min": self.min if self.count else 0.0,
                    "max": self.max if self.count else 0.0,
                    "buckets": nonzero}
        for q, key in ((0.5, "p50"), (0.99, "p99")):
            snap[key] = self.quantile(q)
        return snap


class MetricsRegistry:
    """Name-addressed instrument store; instruments are created once."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: "Dict[Tuple[str, tuple], object]" = {}

    def _get(self, cls, name: str, help: str, labels, **kw):
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(name, help, labels=labels, **kw)
                self._instruments[key] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{inst.kind}, not {cls.kind}")
            return inst

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", *,
                  lo: float = 1e-6, hi: float = 1e3, per_decade: int = 6,
                  labels: Optional[Dict[str, str]] = None) -> Histogram:
        return self._get(Histogram, name, help, labels,
                         lo=lo, hi=hi, per_decade=per_decade)

    def instruments(self) -> List[object]:
        with self._lock:
            return list(self._instruments.values())

    def reset(self) -> None:
        """Zero every instrument's state; the instrument set survives, so
        a snapshot taken across a reset reports the same metric names."""
        for inst in self.instruments():
            inst.reset()

    def clear(self) -> None:
        """Drop every instrument (tests only — serving code never needs
        to forget an instrument, just ``reset`` its state)."""
        with self._lock:
            self._instruments.clear()

    def snapshot(self) -> Dict[str, dict]:
        """JSON-safe dump of every instrument, sorted by name."""
        out = {}
        for inst in sorted(self.instruments(),
                           key=lambda i: (i.name, sorted(i.labels.items()))):
            key = inst.name
            if inst.labels:
                key += "{" + ",".join(
                    f"{k}={v}" for k, v in sorted(inst.labels.items())
                ) + "}"
            out[key] = inst.snapshot()
        return out

    # -- Prometheus text exposition --------------------------------------

    def prometheus_text(self) -> str:
        """Standard text exposition (one HELP/TYPE block per metric)."""
        by_name: Dict[str, List[object]] = {}
        for inst in self.instruments():
            by_name.setdefault(inst.name, []).append(inst)
        lines = []
        for name in sorted(by_name):
            insts = by_name[name]
            pname = _prom_name(name)
            kind = insts[0].kind
            help_text = next((i.help for i in insts if i.help), name)
            lines.append(f"# HELP {pname} {_prom_escape(help_text)}")
            lines.append(f"# TYPE {pname} {kind}")
            for inst in insts:
                if kind == "histogram":
                    lines.extend(_prom_histogram(pname, inst))
                else:
                    lines.append(f"{pname}{_prom_labels(inst.labels)} "
                                 f"{_prom_value(inst.value)}")
        return "\n".join(lines) + ("\n" if lines else "")


def _prom_name(name: str) -> str:
    return name.replace(".", "_")


def _prom_escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _prom_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    return repr(float(v))


def _prom_labels(labels: Dict[str, str], extra: str = "") -> str:
    parts = [f'{k}="{_prom_escape(str(v))}"'
             for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _prom_histogram(pname: str, h: Histogram) -> List[str]:
    lines, acc = [], 0
    with h._lock:
        counts = list(h.counts)
        total, tsum = h.count, h.sum
    for i, c in enumerate(counts):
        acc += c
        le = _prom_value(h.bounds[i]) if i < len(h.bounds) else "+Inf"
        le_label = 'le="' + le + '"'
        lines.append(
            f"{pname}_bucket{_prom_labels(h.labels, le_label)} {acc}")
    lines.append(f"{pname}_sum{_prom_labels(h.labels)} {_prom_value(tsum)}")
    lines.append(f"{pname}_count{_prom_labels(h.labels)} {total}")
    return lines


# ---------------------------------------------------------------------------
# Exposition lint.
# ---------------------------------------------------------------------------


def _prom_name_ok(s: str) -> bool:
    """A legal Prometheus metric name: ``[a-zA-Z_:][a-zA-Z0-9_:]*``."""
    return (bool(s) and (s[0].isalpha() or s[0] in "_:")
            and all(c.isalnum() or c in "_:" for c in s))


def lint_prometheus(text: str) -> List[str]:
    """Problems found in a Prometheus text exposition (empty = clean).

    Checks the properties a scraper depends on: legal metric names, every
    sample preceded by a TYPE for its family, parseable sample values,
    histogram families exposing ``_bucket``/``_sum``/``_count``, and no
    duplicate TYPE declarations.
    """
    problems: List[str] = []
    typed: Dict[str, str] = {}
    sampled: Dict[str, set] = {}
    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                problems.append(f"line {ln}: bad comment {line!r}")
                continue
            if parts[1] == "TYPE":
                name, kind = parts[2], (parts[3] if len(parts) > 3 else "")
                if not _prom_name_ok(name):
                    problems.append(f"line {ln}: bad metric name {name!r}")
                if kind not in ("counter", "gauge", "histogram", "summary",
                                "untyped"):
                    problems.append(f"line {ln}: bad TYPE {kind!r}")
                if name in typed:
                    problems.append(f"line {ln}: duplicate TYPE for {name}")
                typed[name] = kind
            elif not _prom_name_ok(parts[2]):
                problems.append(f"line {ln}: bad metric name {parts[2]!r}")
            continue
        # sample line: name[{labels}] value
        body = line.strip()
        brace = body.find("{")
        if brace >= 0:
            name = body[:brace]
            close = body.rfind("}")
            if close < brace:
                problems.append(f"line {ln}: unbalanced labels {line!r}")
                continue
            rest = body[close + 1:].split()
        else:
            fields = body.split()
            name, rest = fields[0], fields[1:]
        if not _prom_name_ok(name):
            problems.append(f"line {ln}: bad metric name {name!r}")
            continue
        if not rest:
            problems.append(f"line {ln}: sample without a value")
            continue
        try:
            float(rest[0].replace("+Inf", "inf").replace("-Inf", "-inf"))
        except ValueError:
            problems.append(f"line {ln}: bad sample value {rest[0]!r}")
        family = name
        for suffix in ("_bucket", "_sum", "_count"):
            base = name[: -len(suffix)] if name.endswith(suffix) else None
            if base and typed.get(base) == "histogram":
                family = base
                sampled.setdefault(base, set()).add(suffix)
                break
        if family not in typed:
            problems.append(f"line {ln}: sample {name} has no TYPE")
        else:
            sampled.setdefault(family, set()).add("")
    for name, kind in typed.items():
        if kind == "histogram":
            missing = {"_bucket", "_sum", "_count"} - sampled.get(name, set())
            if missing:
                problems.append(
                    f"histogram {name} missing series: {sorted(missing)}")
    return problems


#: The process-wide registry every instrumented module shares.
registry = MetricsRegistry()

counter = registry.counter
gauge = registry.gauge
histogram = registry.histogram
metrics_snapshot = registry.snapshot
prometheus_text = registry.prometheus_text

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "log_bucket_bounds", "lint_prometheus",
    "registry", "counter", "gauge", "histogram",
    "metrics_snapshot", "prometheus_text",
]
