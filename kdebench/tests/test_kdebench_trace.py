"""The traced run's arithmetic and the per-layer readers, on synthetic
intervals and spans (the device numbers themselves come from the card)."""

import pytest

from kdebench import harness, readers
from kdebench import trace as tr
from kdebench.harness import ROOT

CONFIG = {"n_train": 1000, "n_queries": 100, "mixture": {"dim": 4}}


def _ctx(**kw):
    base = dict(workload={}, config=CONFIG, traffic={}, t0=0.0, t1=10.0,
                records=[{}, {}], kernels=[], spans=[], counters={},
                work={"score_needed": 0.5, "kde_needed": 0.25})
    base.update(kw)
    return tr.TraceContext(**base)


def test_union_gaps_and_clip():
    spans = [(1.0, 3.0), (2.0, 4.0), (6.0, 7.0)]
    assert tr.union_length(spans) == 4.0
    assert tr.gaps(spans, 0.0, 8.0) == [(0.0, 1.0), (4.0, 6.0), (7.0, 8.0)]
    assert tr.clip([("k", -1.0, 2.0), ("k", 9.0, 12.0), ("k", 20, 21)],
                   0.0, 10.0) == [("k", 0.0, 2.0), ("k", 9.0, 10.0)]


def test_innermost_names_the_latest_opened_span():
    spans = [("outer", 0.0, 10.0), ("inner", 2.0, 3.0),
             ("other-thread", 2.5, 6.0)]
    assert tr.innermost(spans, [1.0, 2.2, 2.7, 4.0, 11.0]) == [
        "outer", "inner", "other-thread", "other-thread", "host"]


def test_breakdown_sums_idle_time_by_span():
    ctx = _ctx(kernels=[("void flash::kde_pass_kernel<float>(int)", 1.0,
                         4.0), ("b", 5.0, 6.0)],
               spans=[("task.fit", 0.0, 5.0, {}, "harness")])
    out = tr.breakdown(ctx)
    assert out["device_ops"][0] == ["flash::kde_pass_kernel<float>", 3.0]
    assert out["idle_gaps"] == [["host", 4.0], ["task.fit", 2.0]]
    assert ctx.busy_s == 4.0 and ctx.window_s == 10.0


def test_kernel_classes_follow_the_program_names():
    assert readers.is_score_pass("flash::score_pass_kernel<float, 16>")
    assert readers.is_score_pass("flash::score_combine_kernel")
    assert not readers.is_kde_pass("flash::score_combine_kernel")
    assert readers.is_kde_pass("flash::kde_pass_kernel<float, 16>")
    assert readers.is_kde_pass("flash::combine_kernel")


def test_readers_on_synthetic_windows():
    read = lambda name, ctx: harness.reader(ROOT, name)(ctx)  # noqa: E731
    spans = [("task.fit", 0.0, 2.0, {}, "harness"),
             ("kernels.pruned_score", 0.5, 1.9, {}, "program"),
             ("task.evaluate", 2.0, 3.0, {}, "harness"),
             ("kernels.pruned_eval", 2.25, 2.9, {}, "program"),
             ("serve.bucket", 4.0, 4.1, {"bucket": 512, "rows": 384},
              "program"),
             ("serve.bucket", 5.0, 5.1, {"bucket": 512, "rows": 512},
              "program"),
             ("frontend.batch", 4.0, 4.2, {"rows": 384}, "program"),
             ("frontend.batch", 5.0, 5.2, {"rows": 512}, "program")]
    counters = {"score": {"visited": 30, "total": 40},
                "kde": {"visited": 10, "total": 40},
                "frontend": {"queue_wait_ms": {"p99": 12.5, "count": 3}}}
    ctx = _ctx(spans=spans, counters=counters,
               kernels=[("flash::score_pass_kernel", 0.0, 2.0),
                        ("flash::kde_pass_kernel", 2.0, 2.5)],
               records=[{"rows": 100, "ok": True, "fit_ms": 1500.0},
                        {"rows": 0, "ok": True, "fit_ms": 2500.0}])
    assert read("fit_ms.task", ctx) == pytest.approx(2000.0)
    assert read("prune_host_ms.task", ctx) == pytest.approx(750.0)
    assert read("prune_occupancy.task", ctx) == pytest.approx(50.0)
    assert read("padded_row_share.serve", ctx) == pytest.approx(12.5)
    assert read("batch_rows_mean.serve", ctx) == pytest.approx(448.0)
    assert read("queue_wait_p99_ms.serve", ctx) == 12.5
    assert read("device_idle_share.task", ctx) == pytest.approx(75.0)
    score = read("score_pass_roofline.task", ctx)
    assert 0 < score <= 100
    assert read("kde_pass_roofline.task", ctx) > 0
    assert 0 < read("sdkde_mfu.task", ctx) < score


def test_readers_return_nothing_where_nothing_ran():
    read = lambda name, ctx: harness.reader(ROOT, name)(ctx)  # noqa: E731
    ctx = _ctx(counters={"score": {"visited": 0, "total": 0},
                         "kde": {"visited": 0, "total": 0}})
    for name in ("fit_ms.task", "prune_host_ms.task", "prune_occupancy.task",
                 "score_pass_roofline.task", "kde_pass_roofline.task",
                 "batch_rows_mean.serve", "padded_row_share.serve",
                 "queue_wait_p99_ms.serve"):
        assert read(name, ctx) is None, name
