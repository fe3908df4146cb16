"""The readers of the program's own spans inside a task or a served bucket
(prepass, wrappers, waits for the card, query-tile fill), on synthetic
windows with hand-computed values; each reads nothing where the program
opened no such span, as a checkout that lacks the spans would."""

import pytest

from kdebench import harness
from kdebench import trace as tr
from kdebench.harness import ROOT

CONFIG = {"n_train": 1000, "n_queries": 100, "mixture": {"dim": 4}}
READERS = ("prepass_ms.task", "prepass_ms.serve", "wrapper_host_ms.task",
           "host_syncs.task", "query_tile_fill.serve")


def _read(name, ctx):
    return harness.reader(ROOT, name)(ctx)


def _ctx(spans, records=2):
    return tr.TraceContext(
        workload={}, config=CONFIG, traffic={}, t0=0.0, t1=10.0,
        records=[{}] * records, kernels=[], spans=spans, counters={},
        work={"score_needed": 0.5, "kde_needed": 0.5})


def _p(name, t0, t1, **attrs):
    return (name, t0, t1, attrs, "program")


def _h(name, t0, t1):
    return (name, t0, t1, {}, "harness")


# Two tasks.  Task 0: the fit's shift wrapper (1.0–3.0) holds the score
# wrapper (1.2–2.8), which holds a prepass (1.3–1.9) with a sync inside
# it (1.4–1.5) and a launch span after it; the shift's own sync
# (2.85–2.95) lies in the shift wrapper alone; the evaluate's wrapper
# (3.5–4.5) holds two prepasses (3.6–3.8, 3.9–4.1) and a sync
# (4.3–4.4).  Task 1: one wrapper (6.0–6.5) with a sync (6.1–6.2)
# and one outside every wrapper (5.5–5.6, the bandwidth).
TASKS = [
    _h("task.fit", 0.9, 3.1), _p("estimator.fit", 0.95, 3.05),
    _p("sync.bandwidth", 0.96, 0.98),
    _p("kernels.shift", 1.0, 3.0), _p("kernels.score_stats", 1.2, 2.8),
    _p("kernels.prepass", 1.3, 1.9, kind="score"),
    _p("sync.kmeans", 1.4, 1.5, syncs=16),
    _p("kernels.pruned_score", 1.9, 2.7, tile_rows=1024,
       real_tile_rows=1000),
    _p("sync.shift", 2.85, 2.95),
    _h("task.evaluate", 3.4, 4.6), _p("kernels.eval", 3.5, 4.5),
    _p("kernels.prepass", 3.6, 3.8, kind="columns"),
    _p("kernels.prepass", 3.9, 4.1, kind="kde"),
    _p("sync.compact", 4.0, 4.05, syncs=3),
    _p("kernels.pruned_eval", 4.1, 4.25, tile_rows=512,
       real_tile_rows=128),
    _p("sync.normalize", 4.3, 4.4),
    _p("sync.bandwidth", 5.5, 5.6),
    _p("kernels.eval", 6.0, 6.5), _p("sync.inv2h2", 6.1, 6.2),
]


def test_prepass_ms_task_is_the_prepasses_a_task():
    # (0.6 + 0.2 + 0.2) s over 2 tasks
    assert _read("prepass_ms.task", _ctx(TASKS)) == pytest.approx(500.0)


def test_prepass_ms_serve_is_the_prepasses_a_bucket():
    spans = [_p("kernels.prepass", 0.0, 0.004, kind="kde"),
             _p("kernels.pruned_eval", 0.004, 0.02),
             _p("kernels.prepass", 1.0, 1.002, kind="kde"),
             _p("kernels.pruned_eval", 1.002, 1.01),
             _p("kernels.pruned_eval", 2.0, 2.01)]
    assert _read("prepass_ms.serve", _ctx(spans)) == pytest.approx(2.0)


def test_wrapper_host_ms_is_the_wrappers_self_time():
    # wrappers' union: 1.0–3.0, 3.5–4.5, 6.0–6.5 = 3.5 s; inside it the
    # prepasses (0.6, 0.2, 0.2) and the syncs not already inside a
    # prepass (2.85–2.95, 4.3–4.4, 6.1–6.2) = 1.3 s; the bandwidth's
    # sync lies outside every wrapper and is not subtracted
    assert _read("wrapper_host_ms.task", _ctx(TASKS)) == pytest.approx(
        1e3 * (3.5 - 1.3) / 2)


def test_wrapper_host_ms_counts_nested_and_overlapping_spans_once():
    spans = [_p("kernels.shift", 0.0, 4.0),
             _p("kernels.score_stats", 0.5, 3.0),
             _p("kernels.prepass", 1.0, 2.0), _p("sync.labels", 1.5, 2.5),
             _p("sync.shift", 3.5, 3.6)]
    # union 4.0; covered 1.0–2.5 and 3.5–3.6 = 1.6
    assert _read("wrapper_host_ms.task", _ctx(spans, records=1)) == \
        pytest.approx(2400.0)


def test_host_syncs_sums_each_sites_waits_a_task():
    # 1 + 16 + 1 + 3 + 1 + 1 + 1 waits over 2 tasks
    assert _read("host_syncs.task", _ctx(TASKS)) == pytest.approx(12.0)


def test_query_tile_fill_is_real_rows_over_streamed_rows():
    spans = [_p("kernels.pruned_eval", 0.0, 1.0, tile_rows=1024,
                real_tile_rows=96),
             _p("kernels.pruned_eval", 2.0, 3.0, tile_rows=3072,
                real_tile_rows=160),
             _p("kernels.pruned_score", 4.0, 5.0, tile_rows=100,
                real_tile_rows=100)]
    assert _read("query_tile_fill.serve", _ctx(spans)) == pytest.approx(
        100.0 * 256 / 4096)


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_without_the_programs_spans(name):
    # the spans an older program opens: no prepass, wrapper or sync
    # spans, launch spans without the row counts
    older = [_h("task.fit", 0.0, 2.0), _h("task.evaluate", 2.0, 3.0),
             _p("kernels.pruned_score", 0.5, 1.9, rows=100),
             _p("kernels.pruned_eval", 2.2, 2.9, rows=10),
             _p("serve.bucket", 4.0, 4.1, bucket=512, rows=384)]
    assert _read(name, _ctx(older)) is None
    assert _read(name, _ctx([])) is None
