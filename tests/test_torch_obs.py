"""The port's observability layer and fault hooks against the JAX package.

``repro_torch.obs`` (metrics, Prometheus exposition and lint, trace
spans, the CLI) and ``repro_torch.fault_injection`` mirror ``repro``'s:
the same instruments render the same exposition text, the lint finds the
same problems, a seeded injector fires on the same draws, and the engine
and stream report through them under ``repro``'s names.  Small sizes
(n 256, d 4), as ``tests/test_obs.py``.
"""

import json
import math

import numpy as np
import pytest
import torch

from repro import fault_injection as jfi
from repro import obs as jobs
from repro_torch import fault_injection as tfi
from repro_torch import obs
from repro_torch.obs import __main__ as obs_cli
from repro_torch.obs.metrics import Histogram, MetricsRegistry, log_bucket_bounds
from repro_torch.serve import QueryRequest, ServeConfig, ServeEngine
from repro_torch.serve.stats import LatencyRecorder

D, H = 4, 0.5


@pytest.fixture(autouse=True)
def _obs_isolation():
    """Every test sees default flags, no injector, and leaves no trace
    events behind."""
    m0, t0 = obs.state.metrics_on, obs.state.trace_on
    obs.configure(metrics=True, trace=False)
    yield
    obs.configure(metrics=m0, trace=t0)
    obs.clear_trace()
    tfi.uninstall()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((256, D)).astype(np.float32),
            rng.standard_normal((32, D)).astype(np.float32),
            rng.standard_normal((64, D)).astype(np.float32))


def _cfg(**kw):
    base = dict(backend="flash", method="sdkde", block_m=8, block_n=64,
                min_batch=16, max_batch=128, device="cpu")
    base.update(kw)
    return ServeConfig(**base)


def _q(eng, key, y, **kw):
    return eng.query(QueryRequest(key=key, points=y, **kw)).value


def test_exports_match_repro():
    assert set(obs.__all__) == set(jobs.__all__)
    assert set(tfi.__all__) == set(jfi.__all__)
    assert tfi.POINT_MODES == jfi.POINT_MODES and tfi.MODES == jfi.MODES


# ---------------------------------------------------------------------------
# Histograms: bucket boundaries, quantiles, bounded state.
# ---------------------------------------------------------------------------


def test_log_bucket_bounds_spacing_and_repro():
    b = log_bucket_bounds(1e-3, 1.0, per_decade=6)
    assert b[0] == pytest.approx(1e-3) and b[-1] >= 1.0
    for lo, hi in zip(b, b[1:]):
        assert hi / lo == pytest.approx(10 ** (1 / 6))
    assert b == jobs.log_bucket_bounds(1e-3, 1.0, per_decade=6)


def test_histogram_boundary_value_lands_in_its_edge_bucket():
    h = Histogram("t.edges", lo=1e-3, hi=1.0, per_decade=6)
    edge = h.bounds[3]
    h.observe(edge)                       # exactly ON an upper edge
    assert h.counts[3] == 1               # bisect_left: le-inclusive
    h.observe(edge * 1.0001)
    assert h.counts[4] == 1
    h.observe(1e-9)                       # below lo -> first bucket
    assert h.counts[0] == 1
    h.observe(1e9, k=5)                   # past hi -> overflow, weighted
    assert h.counts[-1] == 5 and h.count == 8


def test_histogram_quantiles_match_repro():
    h = Histogram("t.q", lo=1e-5, hi=1e3)
    j = jobs.Histogram("t.q", lo=1e-5, hi=1e3)
    assert h.quantile(0.5) == 0.0 and h.quantile(0.99) == 0.0
    h.observe(0.0123)
    j.observe(0.0123)
    for q in (0.01, 0.5, 0.99):           # 1 sample: exact at every q
        assert h.quantile(q) == pytest.approx(0.0123)
    for v in (0.001, 0.002, 0.004, 1.5):
        h.observe(v)
        j.observe(v)
    edge = 10 ** (1 / 6)
    assert 0.002 / edge <= h.quantile(0.5) <= 0.004 * edge
    for q in (0.1, 0.5, 0.9, 0.99):
        assert h.quantile(q) == j.quantile(q)
    assert h.snapshot() == j.snapshot()


def test_histogram_state_is_bounded():
    h = Histogram("t.bounded", lo=1e-5, hi=1e3)
    n_buckets = len(h.counts)
    for i in range(10_000):
        h.observe(1e-4 * (1 + i % 997))
    assert len(h.counts) == n_buckets and h.count == 10_000


def test_counter_and_disabled_fast_path():
    c = obs.counter("t.obs.ctr")
    c.reset()
    c.inc()
    c.inc(2.0)
    assert c.value == 3.0
    with pytest.raises(ValueError):
        c.inc(-1)
    with pytest.raises(TypeError):
        obs.gauge("t.obs.ctr")            # one name, one kind
    with pytest.raises(ValueError):
        obs.counter("bad name")
    obs.configure(metrics=False)
    assert obs.enabled() == {"metrics": False, "trace": False}
    c.inc(100)
    obs.histogram("t.obs.h").observe(1.0)
    obs.gauge("t.obs.g").set(7)
    assert c.value == 3.0
    assert obs.histogram("t.obs.h").count == 0
    assert obs.gauge("t.obs.g").value == 0.0


# ---------------------------------------------------------------------------
# LatencyRecorder: bounded, JSON-safe, exact at small n.
# ---------------------------------------------------------------------------


def test_latency_recorder_empty_single_and_bounded():
    s = LatencyRecorder().summary()
    assert s.count == 0 and s.queries == 0 and s.qps == 0.0
    doc = json.dumps(s.as_dict(), allow_nan=False)
    assert "NaN" not in doc
    r = LatencyRecorder()
    r.record(0.020, n_queries=64)
    s = r.summary()
    assert s.count == 1 and s.queries == 64
    assert s.p50_ms == pytest.approx(20.0) == s.p99_ms
    assert s.qps == pytest.approx(64 / 0.020)
    n_buckets = len(r._hist.counts)
    for _ in range(5000):
        r.record(0.001, n_queries=3, n_requests=4)
    assert len(r._hist.counts) == n_buckets
    assert r.summary().count == 20_001
    r.reset()
    assert r.summary().count == 0 and r.summary().queries == 0


# ---------------------------------------------------------------------------
# Registry: snapshot across reset, Prometheus exposition and lint.
# ---------------------------------------------------------------------------


def test_snapshot_stable_across_reset():
    obs.counter("t.stab.c").inc(5)
    obs.gauge("t.stab.g").set(2.5)
    obs.histogram("t.stab.h", lo=1e-3, hi=1.0).observe(0.1, k=3)
    before = obs.metrics_snapshot()
    obs.registry.reset()
    after = obs.metrics_snapshot()
    assert set(after) == set(before)
    assert after["t.stab.c"]["value"] == 0.0
    assert after["t.stab.g"]["value"] == 0.0
    assert after["t.stab.h"]["count"] == 0
    assert before["t.stab.c"]["value"] == 5.0
    json.dumps(after, allow_nan=False)


def _fill(reg):
    reg.counter("t.prom.requests", "requests").inc()
    reg.histogram("t.prom.lat_s", lo=1e-4, hi=10.0).observe(0.02)
    reg.histogram("t.prom.lat_s", lo=1e-4, hi=10.0,
                  labels={"tier": "bf16"}).observe(3.0, k=2)
    reg.counter("t.prom.labeled", labels={"mode": "a b"}).inc()
    reg.gauge("t.prom.g", "a\nmulti-line help").set(-math.inf)


def test_prometheus_exposition_lints_clean_and_matches_repro():
    mine, theirs = MetricsRegistry(), jobs.MetricsRegistry()
    _fill(mine)
    _fill(theirs)
    text = mine.prometheus_text()
    assert obs.lint_prometheus(text) == []
    assert "t_prom_lat_s_bucket" in text and 'le="+Inf"' in text
    assert text == theirs.prometheus_text()
    assert mine.snapshot() == theirs.snapshot()
    _fill(obs.registry)
    assert obs.lint_prometheus(obs.prometheus_text()) == []


BAD_EXPOSITIONS = {
    "names": "# TYPE ok counter\nok 1.0\n0bad_name 2.0\n",
    "untyped": "untyped_sample 3.0\n",
    "histogram": '# TYPE h histogram\nh_bucket{le="+Inf"} 1\n',
    "value": "# TYPE ok counter\nok not-a-number\n",
    "comment": "# NOPE ok\n# TYPE ok counter\n# TYPE ok counter\nok 1\n",
    "labels": "# TYPE ok counter\nok}{ 1\n",
}


@pytest.mark.parametrize("case", sorted(BAD_EXPOSITIONS))
def test_prometheus_lint_catches_problems_as_repro(case):
    text = BAD_EXPOSITIONS[case]
    problems = obs.lint_prometheus(text)
    assert problems
    assert problems == jobs.lint_prometheus(text)


def test_lint_cli(tmp_path, capsys):
    obs.counter("t.cli.requests", "requests").inc()
    good = tmp_path / "metrics.json"
    good.write_text(json.dumps({"prometheus": obs.prometheus_text()}))
    assert obs_cli.main([str(good)]) == 0
    assert "clean" in capsys.readouterr().out
    bad = tmp_path / "bad.prom"
    bad.write_text(BAD_EXPOSITIONS["names"])
    assert obs_cli.main([str(bad)]) == 1
    empty = tmp_path / "none.json"
    empty.write_text("{}")
    assert obs_cli.main([str(empty)]) == 1
    assert obs_cli.main([]) == 2


# ---------------------------------------------------------------------------
# Spans: nesting under a coalesced dispatch, the null span, the profiler.
# ---------------------------------------------------------------------------


def test_span_nesting_and_ordering_under_query_many(data):
    x, _, y = data
    obs.configure(trace=True)
    obs.clear_trace()
    eng = ServeEngine(_cfg())
    eng.register("t", x, h=H)
    reqs = [QueryRequest(key="t", points=q) for q in (y[:5], y[:17], y[:3])]
    eng.query_many(reqs)
    ev = obs.trace_events()
    req = [e for e in ev if e["name"] == "serve.request"]
    disp = [e for e in ev if e["name"] == "serve.dispatch"]
    buck = [e for e in ev if e["name"] == "serve.bucket"]
    comp = [e for e in ev if e["name"] == "serve.compile"]
    assert len(req) == 1 and req[0]["attrs"]["requests"] == 3
    assert len(disp) == 1 and disp[0]["parent"] == req[0]["id"]
    assert len(buck) == 1 and buck[0]["parent"] == disp[0]["id"]
    assert len(comp) == 1 and comp[0]["parent"] == buck[0]["id"]
    assert buck[0]["attrs"]["rows"] == 25          # coalesced 5+17+3
    assert buck[0]["attrs"]["cache"] == "miss"
    order = [e["name"] for e in ev if e["name"].startswith("serve.")]
    assert order.index("serve.bucket") < order.index("serve.dispatch")
    assert order.index("serve.dispatch") < order.index("serve.request")
    assert req[0]["ts_us"] <= disp[0]["ts_us"] <= buck[0]["ts_us"]
    assert buck[0]["dur_us"] <= req[0]["dur_us"]
    seen = len(obs.trace_events())
    eng.query_many(reqs)                           # reuses the callable
    hit = [e for e in obs.trace_events()[seen:]
           if e["name"] == "serve.bucket"]
    assert hit and hit[0]["attrs"]["cache"] == "hit"
    tree = obs.span_tree(obs.trace_events())
    assert any(c["name"] == "serve.dispatch" for c in tree[req[0]["id"]])
    json.dumps(obs.trace_events(), allow_nan=False)


def test_trace_disabled_is_null_span_and_records_nothing():
    obs.clear_trace()
    with obs.span("t.nothing", a=1) as sp:
        sp.set(b=2)
    with obs.annotate("t.nothing"):
        pass
    assert obs.trace_events() == []
    assert obs.span("x") is obs.span("y") is obs.annotate("z")
    obs.set_trace_capacity(4)
    obs.configure(trace=True)
    for i in range(10):
        with obs.span("t.ring", i=np.int64(i), t=torch.tensor(2.5)):
            pass
    ev = obs.trace_events()
    assert [e["attrs"]["i"] for e in ev] == [6, 7, 8, 9]  # bounded ring
    assert ev[-1]["attrs"]["t"] == 2.5
    obs.set_trace_capacity(obs.trace.DEFAULT_CAPACITY)
    with pytest.raises(ValueError):
        obs.set_trace_capacity(0)


def test_enabled_span_is_a_profiler_range(data):
    """An enabled span opens a ``record_function`` range of its name, so a
    ``torch.profiler`` capture shows the serving chain; off, nothing."""
    from torch.profiler import ProfilerActivity, profile

    x, _, y = data
    eng = ServeEngine(_cfg())
    eng.register("t", x, h=H)
    names = ("serve.request", "serve.dispatch", "serve.bucket",
             "t.annotated")
    for trace in (True, False):
        obs.configure(trace=trace)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _q(eng, "t", y[:9])
            with obs.annotate("t.annotated"):
                torch.ones(3).sum()
        seen = {e.key for e in prof.key_averages()}
        assert all((n in seen) == trace for n in names), (trace, seen)


def test_engine_metrics_surface(data):
    x, _, y = data
    obs.registry.reset()
    eng = ServeEngine(_cfg())
    eng.register("t", x, h=H)
    _q(eng, "t", y[:9])
    _q(eng, "t", y[:9])
    m = eng.metrics()
    assert m["latency"]["count"] == 2 and m["latency_hist"]["count"] == 2
    assert m["bucket_cache"] == {"hits": 1, "misses": 1, "evictions": 0,
                                 "resident": 1}
    reg = m["registry"]
    assert reg["serve.requests"]["value"] == 2
    assert reg["serve.queries"]["value"] == 18
    assert reg["serve.bucket_cache.hits"]["value"] == 1
    assert reg["serve.bucket_cache.misses"]["value"] == 1
    assert reg["serve.pad_ratio"]["count"] == 2
    assert reg["serve.compile_s"]["count"] == 1
    assert m["staleness"] == {}
    json.dumps(m, allow_nan=False)


def test_prune_telemetry(data):
    x, _, y = data
    obs.registry.reset()
    eng = ServeEngine(_cfg(prune=0.0))
    eng.register("t", x, h=H)
    _q(eng, "t", y)
    snap = obs.metrics_snapshot()
    # the fit prunes at "auto" at most (dense at this size): one pruned
    # pass, the query's
    assert snap["kernels.prune.launches{kind=kde}"]["value"] == 1
    assert snap.get("kernels.prune.launches{kind=score}",
                    {"value": 0})["value"] == 0
    assert snap["kernels.prune.visit_fraction"]["count"] == 1
    assert 0.0 < snap["kernels.prune.visit_fraction"]["max"] <= 1.0
    assert snap["kernels.prune.cert_budget"]["count"] == 1
    assert snap["kernels.prune.epsilon"]["value"] == 0.0
    from repro_torch.kernels import ops as tops

    # two blobs: at epsilon 1e-3 the cross tiles are skipped with a
    # certified, nonzero bound
    blob = 0.1 * x
    far = blob + np.array([3.2, 0, 0, 0], np.float32)
    tops.flash_score_stats(torch.from_numpy(np.concatenate([blob, far])), H,
                           block_m=8, block_n=64, prune=1e-3)
    snap = obs.metrics_snapshot()
    assert snap["kernels.prune.launches{kind=score}"]["value"] == 1
    assert snap["kernels.prune.epsilon"]["value"] == pytest.approx(1e-3)
    assert snap["kernels.prune.cert_budget"]["max"] > 0.0


# ---------------------------------------------------------------------------
# Streaming: the staleness histogram and the soak's trace.
# ---------------------------------------------------------------------------


def _stream_cfg(**kw):
    return _cfg(stream=True, staleness_budget=2, **kw)


def test_staleness_histogram_matches_summary(data):
    x, xa, y = data
    obs.registry.reset()
    eng = ServeEngine(_stream_cfg())
    eng.register("s", x[:128], h=H)
    _q(eng, "s", y[:8])
    for i in range(3):
        eng.registry.append("s", xa[i * 8:(i + 1) * 8])
        _q(eng, "s", y[:8])
    summ = eng.staleness_summary()
    hist = obs.histogram("serve.staleness_gen").snapshot()
    assert summ["count"] == hist["count"] == 4
    assert summ["max"] == pytest.approx(hist["max"])
    ratio = 10 ** (1 / 8)
    assert 0.0 <= hist["p50"] <= max(summ["p50"], 1) * ratio
    m = eng.metrics()["registry"]
    assert m["stream.appends"]["value"] == 3
    assert m["stream.append_points"]["value"] == 24
    assert m["stream.publishes"]["value"] >= 2
    assert 0.0 < m["stream.slack_occupancy"]["value"] < 1.0
    assert obs.lint_prometheus(obs.prometheus_text()) == []


def test_streaming_soak_trace_reconstruction(data):
    x, xa, y = data
    obs.configure(trace=True)
    obs.clear_trace()
    obs.registry.reset()
    # prune=0.0 engages the pruned path at any size, so each request's
    # kernel pass appears in the trace
    eng = ServeEngine(_stream_cfg(prune=0.0))
    eng.register("soak", x[:128], h=H)
    rng = np.random.default_rng(0)
    n_requests = 6
    for i in range(n_requests):
        if i % 2 == 0:
            eng.registry.append("soak", xa[(i // 2) * 8:(i // 2) * 8 + 8])
        _q(eng, "soak", y[:int(rng.integers(3, 60))])
    eng.registry.get("soak").stream.ensure(0)
    ev = eng.trace_events()
    tree = obs.span_tree(ev)
    requests = [e for e in ev if e["name"] == "serve.request"]
    assert len(requests) == n_requests
    for req in requests:
        disp = [c for c in tree.get(req["id"], ())
                if c["name"] == "serve.dispatch"]
        assert len(disp) == 1
        a = disp[0]["attrs"]
        assert a["backend"] == "flash" and 0 <= a["staleness"] <= 2
        assert "stream_gen" in a and "layout_epoch" in a
        buck = [c for c in tree.get(disp[0]["id"], ())
                if c["name"] == "serve.bucket"]
        assert len(buck) == 1
        b = buck[0]["attrs"]
        assert b["bucket"] >= b["rows"] == req["attrs"]["rows"]
        assert b["pad_ratio"] == pytest.approx(b["bucket"] / b["rows"],
                                               rel=1e-3)
        # the launch span sits under the wrapper's kernels.eval span
        kern = [k for c in tree.get(buck[0]["id"], ())
                for k in [c] + tree.get(c["id"], [])
                if k["name"] == "kernels.pruned_eval"]
        assert kern and 0.0 < kern[0]["attrs"]["occupancy"] <= 1.0
    names = {e["name"] for e in ev}
    assert {"stream.append", "stream.flush", "stream.rebuild"} <= names
    snap = obs.metrics_snapshot()
    assert snap["serve.staleness_gen"]["count"] == n_requests
    assert snap["kernels.prune.visit_fraction"]["count"] >= n_requests


# ---------------------------------------------------------------------------
# Fault injection: repro's draws, the port's hooks.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("point", sorted(tfi.POINT_MODES))
def test_injector_draws_match_repro(point):
    cfg = dict(seed=7, shard_kill=0.3, slow_shard=0.2, compile_fail=0.4,
               nan_poison=0.5, staleness_blowout=0.25, client_burst=0.3,
               admit_stall=0.2, slow_ms=0.0,
               events=())
    mine = tfi.FaultInjector(tfi.ChaosConfig(**cfg))
    theirs = jfi.FaultInjector(jfi.ChaosConfig(**cfg))

    def trace(inj, mod):
        out = []
        for k in range(40):
            inj.begin_request()
            with inj.scope(k % 3, k % 2):
                try:
                    inj.fire(point)
                    out.append("ok")
                except mod.InjectedFailure as e:
                    out.append(e.kind)
                v = inj.poison(point, np.ones(2))
                out.append(bool(np.isnan(v).any()))
                out.append(inj.burst(point))
        return out, inj.snapshot()

    assert trace(mine, tfi) == trace(theirs, jfi)


def test_engine_and_stream_fire_their_hooks(data):
    x, xa, y = data
    eng = ServeEngine(_stream_cfg())
    eng.register("s", x[:128], h=H)
    with tfi.installed(tfi.FaultInjector(tfi.ChaosConfig(nan_poison=1.0))):
        assert torch.isnan(_q(eng, "s", y[:5])).all()
    with tfi.installed(tfi.FaultInjector(tfi.ChaosConfig(shard_kill=1.0))):
        with pytest.raises(tfi.InjectedFailure, match="shard_kill"):
            _q(eng, "s", y[:5])
    with tfi.installed(tfi.FaultInjector(tfi.ChaosConfig(
            compile_fail=1.0))) as inj:
        with pytest.raises(tfi.InjectedFailure):
            _q(eng, "s", y[:40])                  # a new bucket builds
        with pytest.raises(tfi.InjectedFailure):
            eng.register("other", x[:64], h=H)    # registry.fit
        assert inj.counts["compile_fail"] == 2
    inj = tfi.FaultInjector(tfi.ChaosConfig(staleness_blowout=1.0,
                                            slow_ms=1.0))
    with tfi.installed(inj):
        eng.registry.append("s", xa[:8])
        eng.registry.get("s").stream.flush()     # flushed, slowly
    assert inj.counts["staleness_blowout"] == 1
    assert tfi.active() is None
    assert torch.isfinite(_q(eng, "s", y[:5])).all()
