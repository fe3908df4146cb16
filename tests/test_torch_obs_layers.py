"""The port's spans inside the estimator, the wrappers, the prepass and the
dispatcher (CPU, small sizes).

Every span goes through ``repro_torch.obs``; each is checked here by name
and by its parent id: a dense and a pruned ``SDKDE`` task, the serving
path behind ``AsyncFrontend``, and the two row counts a pruned launch
carries.  Tracing changes no density, and a task opens few enough spans
that a benchmark window of thousands of tasks fits the traced run's
ring of 2^19 events.
"""

import time

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core.estimator import SDKDE, EstimatorConfig
from repro_torch.kernels import ops, spatial
from repro_torch.serve import (AsyncFrontend, FrontendConfig, QueryRequest,
                               ServeConfig, ServeEngine)

D = 3
#: Spans one task may open: a 32k window holds ~11,000 dense tasks.
BUDGET = {"off": 20, 0.0: 60}
#: The wait-for-the-card sites each task path must cross.
SYNCS = {"off": {"sync.bandwidth", "sync.inv2h2", "sync.shift",
                 "sync.normalize"},
         0.0: {"sync.bandwidth", "sync.inv2h2", "sync.shift",
               "sync.normalize", "sync.labels", "sync.visit_lists",
               "sync.kmeans", "sync.slots", "sync.mask", "sync.epsilon",
               "sync.compact"}}


@pytest.fixture(autouse=True)
def _obs_isolation():
    m0, t0 = obs.state.metrics_on, obs.state.trace_on
    obs.configure(metrics=True, trace=False)
    obs.clear_trace()
    yield
    obs.configure(metrics=m0, trace=t0)
    obs.clear_trace()


@pytest.fixture(scope="module")
def data():
    g = torch.Generator().manual_seed(0)
    return torch.randn(600, D, generator=g), torch.randn(100, D, generator=g)


def _cfg(prune):
    return EstimatorConfig(device="cpu", prune=prune, block_m=32, block_n=64)


def _traced(fn):
    """``fn()``'s value and the span events it recorded."""
    obs.clear_trace()
    obs.configure(trace=True)
    try:
        out = fn()
    finally:
        obs.configure(trace=False)
    return out, obs.trace_events()


def _task(x, y, prune):
    return SDKDE(config=_cfg(prune)).fit(x).evaluate(y)


def _parents(ev):
    by_id = {e["id"]: e for e in ev}

    def chain(e):
        out = []
        while e["parent"] in by_id:
            e = by_id[e["parent"]]
            out.append(e["name"])
        return out

    return {e["id"]: chain(e) for e in ev}


def _parent_names(ev, name):
    chains = _parents(ev)
    return {(chains[e["id"]] or [None])[0] for e in ev if e["name"] == name}


@pytest.mark.parametrize("prune", ["off", 0.0])
def test_task_spans_nest_as_the_layers_do(data, prune):
    x, y = data
    _, ev = _traced(lambda: _task(x, y, prune))
    names = {e["name"] for e in ev}
    want = {"estimator.fit": {None}, "estimator.evaluate": {None},
            "sync.bandwidth": {"estimator.fit"},
            "kernels.shift": {"estimator.fit"},
            "kernels.score_stats": {"kernels.shift"},
            "sync.shift": {"kernels.shift"},
            "kernels.eval": {"estimator.evaluate"},
            "sync.normalize": {"kernels.eval"}}
    if prune == "off":
        want["sync.inv2h2"] = {"kernels.score_stats", "kernels.eval"}
        assert not any(n.startswith(("kernels.p", "spatial.")) for n in names)
    else:
        want.update({
            "kernels.prepass": {"kernels.score_stats", "kernels.eval"},
            "kernels.pruned_score": {"kernels.score_stats"},
            "kernels.pruned_eval": {"kernels.eval"},
            "sync.inv2h2": {"kernels.prepass"},
            "spatial.build_index": {"kernels.prepass"},
            "spatial.assign": {"kernels.prepass"},
            "spatial.layout": {"kernels.prepass"},
            "spatial.tile_metadata": {"kernels.prepass"},
            "spatial.tile_map": {"kernels.prepass"},
            "spatial.visit_lists": {"kernels.prepass"},
            "sync.kmeans": {"spatial.build_index"},
            "sync.labels": {"spatial.layout"},
            "sync.slots": {"spatial.layout"},
            "sync.mask": {"spatial.layout"},
            "sync.epsilon": {"spatial.tile_map"},
            "sync.visit_lists": {"spatial.visit_lists"},
            "sync.compact": {"spatial.visit_lists"}})
        chains = _parents(ev)
        kinds = {e["attrs"]["kind"]: chains[e["id"]][0] for e in ev
                 if e["name"] == "kernels.prepass"}
        assert kinds == {"score": "kernels.score_stats",
                         "columns": "kernels.eval", "kde": "kernels.eval"}
        for e in ev:
            if e["name"] == "kernels.prepass":     # never nested
                assert "kernels.prepass" not in chains[e["id"]]
            if e["name"].startswith("spatial."):   # always inside one
                assert "kernels.prepass" in chains[e["id"]]
        # each prepass closes before its launch opens
        for launch, kind in (("kernels.pruned_score", "score"),
                             ("kernels.pruned_eval", "kde")):
            pre = next(e for e in ev if e["name"] == "kernels.prepass"
                       and e["attrs"]["kind"] == kind)
            run = next(e for e in ev if e["name"] == launch)
            assert pre["ts_us"] + pre["dur_us"] <= run["ts_us"]
    for name, parents in want.items():
        assert _parent_names(ev, name) == parents, name
    assert SYNCS[prune] <= {n for n in names if n.startswith("sync.")}
    assert len(ev) <= BUDGET[prune]


def test_full_pipeline_keeps_its_prep_in_prepass_spans(data):
    x, y = data
    _, ev = _traced(lambda: ops.flash_sdkde(x, y, 0.6, block_m=32,
                                            block_n=64, prune=0.0))
    chains = _parents(ev)
    kinds = sorted((e["attrs"]["kind"], chains[e["id"]][0]) for e in ev
                   if e["name"] == "kernels.prepass")
    assert kinds == [("columns", "kernels.eval"), ("kde", "kernels.eval"),
                     ("score", "kernels.score_stats"),
                     ("score", "kernels.shift")]
    for e in ev:
        if e["name"] == "kernels.prepass":
            assert "kernels.prepass" not in chains[e["id"]]
        if e["name"].startswith("spatial."):
            assert "kernels.prepass" in chains[e["id"]], e["name"]
    for name, parent in (("kernels.score_stats", "kernels.shift"),
                         ("kernels.pruned_score", "kernels.score_stats"),
                         ("kernels.pruned_eval", "kernels.eval"),
                         ("sync.shift", "kernels.shift"),
                         ("sync.normalize", "kernels.eval")):
        assert _parent_names(ev, name) == {parent}, name


@pytest.mark.parametrize("prune", ["off", 0.0])
def test_tracing_changes_no_density(data, prune):
    x, y = data
    off = _task(x, y, prune)
    on, ev = _traced(lambda: _task(x, y, prune))
    assert ev and torch.equal(on, off)
    assert obs.trace_events() == ev


def test_multi_wait_spans_declare_their_waits(data):
    x, y = data
    _, ev = _traced(lambda: _task(x, y, 0.0))
    declared = {(e["name"], e["attrs"].get("syncs", 1)) for e in ev
                if e["name"].startswith("sync.")}
    assert ("sync.kmeans", 1) in declared            # the initial picks
    assert ("sync.kmeans", 16) in declared           # 8 Lloyd bincounts
    assert ("sync.compact", 1) in declared           # a span a wait
    compact = sum(e["name"] == "sync.compact" for e in ev)
    lists = sum(e["name"] == "spatial.visit_lists" for e in ev)
    assert lists and compact == 3 * lists


def _capture(monkeypatch):
    """Record every layout and visit list the pruned wrappers make."""
    seen = {"layout": [], "visits": []}
    layout, visits = spatial.cluster_layout, spatial.visit_lists

    def keep_layout(*a, **kw):
        seen["layout"].append(layout(*a, **kw))
        return seen["layout"][-1]

    def keep_visits(*a, **kw):
        seen["visits"].append(visits(*a, **kw))
        return seen["visits"][-1]

    monkeypatch.setattr(spatial, "cluster_layout", keep_layout)
    monkeypatch.setattr(spatial, "visit_lists", keep_visits)
    return seen


def _host_rows(layout, vl, block_m):
    """``(tile_rows, real_tile_rows)`` counted on the host from the
    layout's slots and the visit counts."""
    counts = vl.counts.numpy().astype(np.int64)
    slots = layout.slots.numpy()
    real = np.bincount(slots // block_m, minlength=counts.size)
    return int(block_m * counts.sum()), int((real * counts).sum())


@pytest.mark.parametrize("block_m, block_n", [(32, 64), (16, 32)])
def test_pruned_launches_count_streamed_and_real_rows(data, monkeypatch,
                                                      block_m, block_n):
    x, y = data
    seen = _capture(monkeypatch)
    h = 0.6
    _, ev = _traced(lambda: ops.flash_sdkde_shift(
        x, h, block_m=block_m, block_n=block_n, prune=0.0))
    score = next(e["attrs"] for e in ev if e["name"] == "kernels.pruned_score")
    assert (score["tile_rows"], score["real_tile_rows"]) == _host_rows(
        seen["layout"][0], seen["visits"][0], block_m)
    seen["layout"].clear()
    seen["visits"].clear()
    _, ev = _traced(lambda: ops.flash_kde(x, y[:70], h, block_m=block_m,
                                          block_n=block_n, prune=0.0))
    run = next(e["attrs"] for e in ev if e["name"] == "kernels.pruned_eval")
    # the columns' layout first, then the queries'
    want = _host_rows(seen["layout"][-1], seen["visits"][-1], block_m)
    assert (run["tile_rows"], run["real_tile_rows"]) == want
    assert 0 < want[1] < want[0]                      # sentinel rows stream


def test_untraced_visit_lists_read_no_real_rows(data, monkeypatch):
    x, y = data
    seen = _capture(monkeypatch)
    dens = ops.flash_kde(x, y, 0.6, block_m=32, block_n=64, prune=0.0)
    assert obs.trace_events() == [] and dens.shape == (y.shape[0],)
    assert seen["visits"] and all(v.real_visit_rows == 0
                                  for v in seen["visits"])
    assert all(v.visits == int(v.counts.sum()) for v in seen["visits"])


def test_frontend_names_its_idle_wait_and_finish(data):
    x, y = data
    eng = ServeEngine(ServeConfig(backend="flash", method="sdkde",
                                  block_m=8, block_n=64, min_batch=16,
                                  max_batch=128, device="cpu"))
    eng.register("t", x.numpy(), h=0.5)
    obs.configure(trace=True)
    fe = AsyncFrontend(eng, FrontendConfig(workers=1, batch_wait_ms=5.0))
    try:
        time.sleep(0.25)                           # an empty queue: idle
        ans = fe.submit(QueryRequest(key="t", points=y[:9],
                                     deadline_s=30.0)).result(timeout=30)
        assert ans.value.shape == (9,)
    finally:
        fe.close()
        obs.configure(trace=False)
    ev = obs.trace_events()
    names = {e["name"] for e in ev}
    assert {"frontend.idle", "frontend.wait", "frontend.finish",
            "frontend.batch", "serve.coalesce", "serve.split",
            "sync.engine"} <= names
    for name, parent in (("frontend.idle", None), ("frontend.wait", None),
                         ("frontend.finish", None),
                         ("serve.coalesce", "frontend.batch"),
                         ("serve.split", "frontend.batch"),
                         ("sync.engine", "serve.request"),
                         ("kernels.eval", "serve.bucket")):
        assert _parent_names(ev, name) == {parent}, name
    worker = {e["thread"] for e in ev if e["name"].startswith("frontend.")}
    assert worker == {"frontend-0"}


class _SlowRange:
    """A profiler range that takes 50 ms to open and to close."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        time.sleep(0.05)
        return self

    def __exit__(self, *exc):
        time.sleep(0.05)
        return False


def test_a_span_is_stamped_before_its_range_opens(monkeypatch):
    """The harness puts the program's spans on its clock by one span
    opened at a known time: a span must be stamped when it is entered,
    whatever its profiler range costs, and hold that cost."""
    monkeypatch.setattr(obs.trace, "_RANGE", _SlowRange)
    obs.configure(trace=True)
    t0 = time.perf_counter_ns()
    with obs.span("t.slow"):
        pass
    t1 = time.perf_counter_ns()
    ev = obs.trace_events()[-1]
    start = obs.trace._ORIGIN_NS + 1e3 * ev["ts_us"]
    assert start - t0 < 0.02e9                    # before the 50 ms enter
    assert 1e3 * ev["dur_us"] >= 0.1e9            # both 50 ms inside
    assert start + 1e3 * ev["dur_us"] <= t1
