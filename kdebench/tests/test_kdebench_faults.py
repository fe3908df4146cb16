"""The whole run with the timed path broken underneath: each fault a cell
can have makes ``correct`` false.  On the CPU at a small size (the
program's plain versions), skipping only the harness's look for a card;
one chip, so no exchange between chips exists to leave out."""

import time

import pytest
import torch

from kdebench import harness
from repro_torch.kernels import ops
from repro_torch.core.estimator import SDKDE
from repro_torch.serve.engine import ServeEngine

SMALL = {
    "mix16-32k.task": ({"n_train": 2048, "n_queries": 256}, {}),
    "mix16-1m.task": ({"n_train": 2048, "n_queries": 512}, {}),
    "mix16-1m.serve": ({"n_train": 2048},
                       {"rows_min": 64, "rows_max": 256, "cycle": 8,
                        "rate": 40.0, "warm_rows": [64, 128, 256],
                        "warm_seconds": 0.1, "checked": 4}),
}


def _run(workload, seed=2**31 + 77):
    config, traffic = SMALL[workload]
    result, lines = harness.run(
        workload, seed, 0.5, False, t_start=time.perf_counter(),
        device="cpu", config_override=config, traffic_override=traffic,
        sync=lambda: None)
    checks = result["checks"]
    assert [line.split(":")[0] for line in lines[-len(checks):]] == [
        f"check {k}" for k in checks]
    assert list(result)[-1] == "checks"
    return result


def _state_unchanged(monkeypatch):
    """The fit returns its input: the shift never moves a point."""
    monkeypatch.setattr(ops, "flash_sdkde_shift",
                        lambda x, h, **kw: x.to(torch.float32))


def _half_left_out(monkeypatch):
    """Densities over half of the training points, normalised over them:
    the mean taken over the rest."""
    kde, prepared = ops.flash_kde, ops.flash_kde_prepared

    def half_kde(x, y, h, **kw):
        return kde(x[: x.shape[0] // 2], y, h, **kw)

    def half_prepared(yp, xt, nrm_x, h, xt_lo=None, **kw):
        half = xt.shape[1] // 2
        kw["columns"] = None
        return 2.0 * prepared(yp, xt[:, :half], nrm_x[:, :half], h,
                              None if xt_lo is None else xt_lo[:, :half],
                              **kw)

    monkeypatch.setattr(ops, "flash_kde", half_kde)
    monkeypatch.setattr(ops, "flash_kde_prepared", half_prepared)


def _answer_altered(monkeypatch):
    """One density of each answer altered where the answer is made."""
    evaluate, split = SDKDE.evaluate, ServeEngine._split_answer

    def bad_evaluate(self, y):
        out = evaluate(self, y).clone()
        out[0] *= 1.5
        return out

    def bad_split(*args, **kw):
        answers = split(*args, **kw)
        for a in answers:
            a.value = a.value.clone()
            a.value[0] *= 1.5
        return answers

    monkeypatch.setattr(SDKDE, "evaluate", bad_evaluate)
    monkeypatch.setattr(ServeEngine, "_split_answer", staticmethod(bad_split))


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_a_sound_run_is_correct(workload):
    result = _run(workload)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out,
                                   _answer_altered],
                         ids=["state_unchanged", "half_left_out",
                              "answer_altered"])
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_a_fault_makes_the_run_incorrect(workload, fault, monkeypatch):
    fault(monkeypatch)
    result = _run(workload)
    assert not result["correct"], result["checks"]
