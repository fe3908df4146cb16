"""Traffic kind ``serve``: one model served, requests in an open loop.

Traffic keys: ``rate`` (requests a second), ``rows_min`` / ``rows_max``
and ``cycle`` (the size and gap tables), ``deadline_s``, ``frontend``
(``FrontendConfig``'s fields), ``warm_rows`` and ``warm_seconds``
(set-up), ``checked`` (requests the check compares, a seeded sample of
the whole window, with the first cycle's largest among them).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from kdebench import check as ck
from kdebench.loadgen import (RESULT_TIMEOUT_S, Window, gap_table,
                              size_table, sync_device)
from kdebench.reference import mixture
from kdebench.reference import sdkde as ref
from kdebench.spans import SpanLog


class Driver:
    """Open-loop arrivals at a served model.

    One model is registered at set-up through ``ServeEngine`` and fronted
    by ``AsyncFrontend``.  A generator thread sends requests on a fixed
    schedule whether or not earlier ones have finished: ``rate`` requests
    a second, the gaps and the sizes each a fixed table of ``cycle``
    entries (Poisson gaps, log-uniform sizes) walked in a new seeded order
    every cycle.  It sends the whole cycles nearest to ``seconds`` of
    arrivals, so every seed offers the same rows over the same time, in
    another order.  The points of every request are drawn on the card
    before the window opens, all fresh.  A request is timed from when it
    was due to when its answer is in the caller's hands (its future
    resolved: the engine synchronizes before it answers), so a late
    generator counts against the latency.  Requests carry ``deadline_s``:
    an answer that comes late is late, not missing."""

    KEY = "model"

    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device, spans: SpanLog,
                 sync: Callable[[], None] = sync_device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.spans, self.sync = device, spans, sync
        self.n = int(config["n_train"])
        self.sampler = mixture.from_config(config["mixture"]).sampler(device)
        t = traffic
        self.sizes = size_table(int(t["rows_min"]), int(t["rows_max"]),
                                int(t["cycle"]))
        self.gaps = gap_table(int(t["cycle"]))

    def model_points(self) -> torch.Tensor:
        return self.sampler.sample(
            self.n, mixture.generator(self.device, self.seed, "model"))

    def setup(self) -> None:
        from repro_torch.serve import (AsyncFrontend, FrontendConfig,
                                       ServeConfig, ServeEngine)

        est = self.config["estimator"]
        self.engine = ServeEngine(ServeConfig(
            method="sdkde", precision=est["precision"],
            fit_precision=est["precision"], prune=est["prune"],
            block_m=est["block_m"], block_n=est["block_n"],
            device=self.device.type))
        self.engine.register(self.KEY, self.model_points())
        self.frontend = AsyncFrontend(
            self.engine, FrontendConfig(**self.traffic.get("frontend", {})))
        gen = mixture.generator(self.device, self.seed, "warm")
        for rows in self.traffic["warm_rows"]:
            self._request(self.sampler.sample(int(rows), gen)).result(
                timeout=RESULT_TIMEOUT_S)
        self._send(self._plan(float(self.traffic["warm_seconds"]), "warm",
                              keep=False))

    def _request(self, y: torch.Tensor):
        from repro_torch.serve import QueryRequest

        return self.frontend.submit(QueryRequest(
            key=self.KEY, points=y,
            deadline_s=float(self.traffic["deadline_s"])))

    def _plan(self, seconds: float, stream: str, keep: bool,
              rate: Optional[float] = None) -> dict:
        """The schedule of ``seconds`` of arrivals: each request's due
        offset and rows, its points drawn on the card in one call (so the
        sender launches no device work), and the seeded sample the check
        keeps."""
        rate = float(self.traffic["rate"] if rate is None else rate)
        rng = np.random.default_rng(mixture.stream_seed(self.seed, stream,
                                                        "order"))
        k = len(self.sizes)
        total = k * max(1, round(seconds * rate / k))   # whole cycles
        checked = set(rng.choice(total, min(total, int(
            self.traffic["checked"])), replace=False).tolist()) \
            if keep else set()
        rows, due, t = [], [], 0.0
        for c in range(total // k):
            sizes, gaps = rng.permutation(k), rng.permutation(k)
            if c == 0 and keep:        # and the first cycle's largest
                checked.add(int(np.flatnonzero(sizes == k - 1)[0]))
            for j in range(k):
                rows.append(self.sizes[sizes[j]])
                due.append(t)
                t += self.gaps[gaps[j]] / rate
        gen = mixture.generator(self.device, self.seed, stream)
        points = self.sampler.sample(sum(rows), gen).split(rows)
        self.sync()
        return {"rows": rows, "due": due, "points": points,
                "checked": checked}

    def _send(self, plan: dict):
        """Offer the planned requests on their schedule; returns every
        request's record and the kept ``(index, points, densities)``,
        once every answer is in."""
        from repro_torch.serve.errors import ServeError

        checked = plan["checked"]
        records: List[dict] = []
        kept: list = []
        lock = threading.Lock()
        pending = []

        def done(rec, y, fut):
            t = time.perf_counter()
            try:
                ans = fut.result()
                ok = (ans.tier == "f32" and not ans.browned
                      and not ans.degraded)
                rec.update(ok=ok, why="" if ok else f"tier {ans.tier}")
                if rec["index"] in checked:   # judged whatever its tier
                    with lock:
                        kept.append((rec["index"], y, ans.value))
            except Exception as e:     # noqa: BLE001 — a typed refusal
                # or an engine error: the request failed, counted by type
                rec.update(ok=False, why=type(e).__name__)
            rec["t1"] = t

        t0 = time.perf_counter()
        for i, (rows, off, y) in enumerate(zip(plan["rows"], plan["due"],
                                               plan["points"])):
            due = t0 + off
            now = time.perf_counter()
            if due > now:
                time.sleep(due - now)
            rec = {"index": i, "rows": rows, "t0": due,
                   "sent": time.perf_counter()}
            records.append(rec)
            try:
                fut = self._request(y)
            except ServeError as e:            # refused at admission
                rec.update(ok=False, why=type(e).__name__,
                           t1=time.perf_counter())
            else:
                fut.add_done_callback(
                    lambda f, r=rec, y=y: done(r, y, f))
                pending.append(fut)
        for fut in pending:
            fut.exception(timeout=RESULT_TIMEOUT_S)
        deadline = time.perf_counter() + RESULT_TIMEOUT_S
        while any("t1" not in r for r in records):   # callbacks finishing
            if time.perf_counter() > deadline:
                raise RuntimeError("a request's answer never came")
            time.sleep(1e-3)
        return records, sorted(kept, key=lambda t: t[0])

    def window(self, seconds: float,
               rate: Optional[float] = None) -> Window:
        plan = self._plan(seconds, "window", keep=True, rate=rate)
        t0 = time.perf_counter()
        records, kept = self._send(plan)
        t1 = max(r["t1"] for r in records)
        failed = sum(not r["ok"] for r in records)
        lat = sorted((r["t1"] - r["t0"]) * 1e3 if r["ok"] else math.inf
                     for r in records)
        p95 = lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
        return Window(t0, t1, attempted=len(records), failed=failed,
                      end_to_end={"request_p95_ms": p95},
                      records=records, kept=kept)

    def release(self) -> None:
        """Stop the front end's threads and drop the program's state."""
        self.frontend.close()
        del self.frontend, self.engine


def check(driver: Driver, window: Window,
          reference: Optional[Callable] = None,
          **kw) -> Tuple[Dict[str, float], Dict[str, float]]:
    """``(numbers, work)`` of a serving window: the registered model's
    bandwidth, score pass and shift once, then every density of the seeded
    sample of requests the generator kept, whatever tier answered them;
    and ``failed_requests``, requests that got no answer or one at another
    tier than float32, held to the exact limit 0.  ``reference``, given the model's points and the
    queries, replaces the program's densities (the precision control)."""
    n = driver.n
    x = driver.model_points()
    h = ref.sdkde_bandwidth(x)
    x_sd, s_pairs = ref.score_shift(x, h, count=True, **kw)
    errs, rows, k_pairs = [], 0, 0
    if window.kept:
        y = torch.cat([k[1] for k in window.kept])
        p = (torch.cat([k[2] for k in window.kept]) if reference is None
             else reference(x, y))
        r, k_pairs = ref.kde(x_sd, y, h, count=True, **kw)
        errs, rows = [ck.rel_errs(p, r)], y.shape[0]
    numbers, more = ck.density_numbers(errs)
    numbers["failed_requests"] = float(window.failed)
    return numbers, {"score_needed": s_pairs / (float(n) * n),
                     "kde_needed": k_pairs / max(1.0, float(rows) * n),
                     "checked": len(window.kept), "checked_rows": rows,
                     "rel_err_mean": more["mean"],
                     "rel_err_p99": more["p99"]}


__all__ = ["Driver", "check"]
