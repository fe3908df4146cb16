"""Traffic kind ``task``: a closed loop of whole SD-KDE tasks, one caller.

A task draws a fresh training sample and fresh queries on the device,
fits ``SDKDE`` on the sample, evaluates the densities at the queries and
ends at ``torch.cuda.synchronize()``.  Tasks start while the window is
open; the one running at its close is finished, and the window ends with
it.  The traced run drives the same body: its spans are host-clock marks
only, and the fit's time comes from two CUDA events on the task's stream,
read once the window has closed.

Traffic keys: ``warm_tasks`` and ``warm_seconds`` (set-up runs at least
that many tasks and that long), ``checked_tasks`` and ``check_pairs``
(the check compares a seeded sample of the window's tasks, as many as
``check_pairs`` pairs of reference work allow: at least one, at most
``checked_tasks``).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from kdebench import check as ck
from kdebench.loadgen import Window, sync_device
from kdebench.reference import mixture
from kdebench.reference import sdkde as ref
from kdebench.spans import SpanLog


class Driver:
    """Closed loop of whole SD-KDE tasks."""

    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device, spans: SpanLog,
                 sync: Callable[[], None] = sync_device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.spans, self.sync = device, spans, sync
        self.n, self.m = int(config["n_train"]), int(config["n_queries"])
        self.sampler = mixture.from_config(config["mixture"]).sampler(device)

    def setup(self) -> None:
        from repro_torch.core.estimator import EstimatorConfig

        est = self.config["estimator"]
        self.est_cfg = EstimatorConfig(
            backend="flash", precision=est["precision"], prune=est["prune"],
            block_m=est["block_m"], block_n=est["block_n"],
            device=self.device.type)
        t_end = time.perf_counter() + float(self.traffic["warm_seconds"])
        i = 0
        while i < int(self.traffic["warm_tasks"]) or time.perf_counter() < t_end:
            self.task(("warm", i))
            i += 1

    def draw(self, stream) -> tuple:
        gen = mixture.generator(self.device, self.seed, "task", *stream)
        return self.sampler.sample(self.n, gen), self.sampler.sample(self.m,
                                                                      gen)

    def _mark(self) -> Optional[torch.cuda.Event]:
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def task(self, stream) -> Tuple[torch.Tensor, tuple]:
        """One task: its densities and the events around its fit."""
        from repro_torch.core.estimator import SDKDE

        with self.spans.span("task.draw"):
            x, y = self.draw(stream)
        with self.spans.span("task.fit"):
            fit0 = self._mark()
            est = SDKDE(config=self.est_cfg).fit(x)
            fit1 = self._mark()
        with self.spans.span("task.evaluate"):
            dens = est.evaluate(y)
        self.sync()
        return dens, (fit0, fit1)

    def release(self) -> None:
        """Nothing to stop: each task's estimator is dropped with it."""

    def window(self, seconds: float) -> Window:
        records, kept, marks = [], [], []
        t0 = time.perf_counter()
        end = t0 + seconds
        i = 0
        while i == 0 or time.perf_counter() < end:
            ts = time.perf_counter()
            with self.spans.span("task", index=i):
                dens, fit = self.task((i,))
            kept.append(dens)
            marks.append(fit)
            records.append({"index": i, "t0": ts, "t1": time.perf_counter()})
            i += 1
        t1 = records[-1]["t1"]
        for rec, (a, b) in zip(records, marks):
            if a is not None:
                rec["fit_ms"] = a.elapsed_time(b)
        return Window(t0, t1, attempted=i, failed=0,
                      end_to_end={"task_s": (t1 - t0) / i},
                      records=records, kept=kept)


def checked_tasks(n_done: int, seed: int, n: int, m: int,
                  traffic: dict) -> List[int]:
    """The tasks the check compares: a seeded sample of the window's."""
    per_task = float(n) * n + float(m) * n
    k = int(max(1, min(int(traffic["checked_tasks"]), n_done,
                       traffic["check_pairs"] // per_task)))
    rng = np.random.default_rng(mixture.stream_seed(seed, "check"))
    return sorted(rng.choice(n_done, k, replace=False).tolist())


def check(driver: Driver, window: Window,
          reference: Optional[Callable] = None,
          **kw) -> Tuple[Dict[str, float], Dict[str, float]]:
    """``(numbers, work)`` of a task window: every density of each checked
    task against the reference, which recomputes the bandwidth, the score
    pass, the shift and the KDE pass.  ``reference`` replaces the
    program's densities by its own of the same inputs (the precision
    control: the reference put in the program's place)."""
    n, m = driver.n, driver.m
    errs, sp, kp = [], 0, 0
    picked = checked_tasks(window.attempted, driver.seed, n, m,
                           driver.traffic)
    for i in picked:
        x, y = driver.draw((i,))
        r, _, s_pairs, k_pairs = ref.sdkde(x, y, count=True, **kw)
        p = window.kept[i] if reference is None else reference(x, y)
        errs.append(ck.rel_errs(p, r))
        sp, kp = sp + s_pairs, kp + k_pairs
    numbers, more = ck.density_numbers(errs)
    k = len(picked)
    return numbers, {"score_needed": sp / (k * float(n) * n),
                     "kde_needed": kp / (k * float(m) * n), "checked": k,
                     "rel_err_mean": more["mean"],
                     "rel_err_p99": more["p99"]}


__all__ = ["Driver", "checked_tasks", "check"]
