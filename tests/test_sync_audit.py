"""``tools/sync_audit.py``: each wait for the card is matched to the
innermost ``sync.*`` span its thread had open, and a span's declared
``syncs`` is checked against the waits seen in it.

The matching is checked on the CPU against hand-made windows; the audit
itself needs the card (PyTorch's sync debug mode reports nothing on the
CPU), where one small dense and one pruned task and one served request
must wait only inside ``sync.*`` spans whose counts are right.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch import obs
from repro_torch.obs import trace

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "sync_audit", ROOT / "tools" / "sync_audit.py")
sync_audit = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(sync_audit)


def _ev(i, name, ts, dur, parent=None, thread="main", **attrs):
    return {"name": name, "id": i, "parent": parent, "ts_us": float(ts),
            "dur_us": float(dur), "thread": thread, "attrs": attrs}


def _wait(t_us, thread="main", program="src/repro_torch/x.py:1 f",
          harness=None):
    return {"t_ns": trace._ORIGIN_NS + int(t_us * 1e3),
            "thread": thread, "program": program, "harness": harness,
            "top": ["x"]}


#: A prepass holding a layout (one wait), k-means (two declared, two
#: seen) and a compaction span that saw nothing; a second thread's span.
EVENTS = [
    _ev(1, "kernels.prepass", 0, 100),
    _ev(2, "spatial.layout", 10, 30, parent=1),
    _ev(3, "sync.labels", 12, 5, parent=2),
    _ev(4, "sync.kmeans", 50, 20, parent=1, syncs=2),
    _ev(5, "sync.compact", 80, 5, parent=1),
    _ev(6, "sync.engine", 0, 200, thread="frontend-0"),
]


def test_waits_fall_to_the_innermost_sync_span_of_their_thread():
    waits = [_wait(14), _wait(55), _wait(65), _wait(30),
             _wait(90, thread="frontend-0"),
             _wait(150, program=None, harness="kdebench/loadgen.py:44 s")]
    out = sync_audit.attribute(waits, EVENTS)
    assert out["waits"] == 6 and out["program_waits"] == 5
    assert out["sync_spans"] == {
        "sync.labels": {"spans": 1, "declared": 1, "seen": 1,
                        "mismatched": 0},
        "sync.kmeans": {"spans": 1, "declared": 2, "seen": 2,
                        "mismatched": 0},
        "sync.compact": {"spans": 1, "declared": 1, "seen": 0,
                         "mismatched": 1},
        "sync.engine": {"spans": 1, "declared": 1, "seen": 1,
                        "mismatched": 0}}
    assert out["mismatched"] == 1
    # t=30 is inside the layout but past its sync span
    assert out["unspanned"] == [{"where": "src/repro_torch/x.py:1 f",
                                 "open": ["kernels.prepass",
                                          "spatial.layout"],
                                 "count": 1}]
    assert out["harness_waits"] == {"kdebench/loadgen.py:44 s": 1}


@pytest.mark.parametrize("t_us, thread", [(14, "other"), (120, "main"),
                                          (-5, "main")])
def test_a_wait_outside_any_span_of_its_thread_is_unspanned(t_us, thread):
    out = sync_audit.attribute([_wait(t_us, thread=thread)], EVENTS)
    assert [u["count"] for u in out["unspanned"]] == [1]
    assert all(s["seen"] == 0 for s in out["sync_spans"].values())


def test_a_span_holding_more_waits_than_it_declares_is_mismatched():
    waits = [_wait(t) for t in (13, 14, 15)]
    out = sync_audit.attribute(waits, EVENTS)
    assert out["sync_spans"]["sync.labels"]["seen"] == 3
    assert out["sync_spans"]["sync.labels"]["mismatched"] == 1
    assert not out["unspanned"]


def test_the_sites_count_each_place_that_waited():
    waits = [_wait(55, program="a:1 f"), _wait(60, program="a:1 f"),
             _wait(14, program="b:2 g")]
    sites = sync_audit.attribute(waits, EVENTS)["sites"]
    assert sites == [{"span": "sync.kmeans", "where": "a:1 f", "count": 2},
                     {"span": "sync.labels", "where": "b:2 g", "count": 1}]


def test_watch_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the audit runs there")
    with pytest.raises(SystemExit, match="no CUDA device"):
        sync_audit.watch(lambda: None)


def _card_paths(device="cuda"):
    from repro_torch.core.estimator import SDKDE, EstimatorConfig
    from repro_torch.serve import QueryRequest, ServeConfig, ServeEngine

    g = torch.Generator().manual_seed(0)
    x = torch.randn(4096, 4, generator=g).to(device)   # as the cells do
    y = torch.randn(512, 4, generator=g).to(device)
    eng = ServeEngine(ServeConfig(backend="flash", method="sdkde",
                                  prune=0.0, device=device))
    eng.register("t", x, h=0.5)

    def run():
        for prune in ("off", 0.0):
            cfg = EstimatorConfig(device=device, prune=prune)
            SDKDE(config=cfg).fit(x).evaluate(y)
        eng.query(QueryRequest(key="t", points=y[:100]))
    return run


def test_card_paths_wait_only_inside_sync_spans_with_right_counts():
    if not torch.cuda.is_available():
        pytest.skip("the sync debug mode reports waits only on the card")
    run = _card_paths()
    run()                                        # builds the kernels
    m0, t0 = obs.state.metrics_on, obs.state.trace_on
    try:
        _, waits, events = sync_audit.watch(run)
    finally:
        obs.configure(metrics=m0, trace=t0)
        obs.set_trace_capacity(trace.DEFAULT_CAPACITY)
        obs.clear_trace()
    out = sync_audit.attribute(waits, events)
    assert out["program_waits"] > 0
    assert out["unspanned"] == []
    assert out["mismatched"] == 0, out["sync_spans"]
