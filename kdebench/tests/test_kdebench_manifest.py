"""BENCHMARK.json against the contract, the import guard, the harness's
lookup by name, and the refusal to run without a card."""

import ast
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest

from kdebench import harness
from kdebench.harness import ROOT

BENCH = ROOT / "kdebench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def man():
    return harness.manifest()


def _modules(base):
    return sorted(p for p in base.rglob("*.py") if "__pycache__" not in
                  p.parts)


def _top_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    found = [(p.relative_to(ROOT), m) for p in _modules(BENCH)
             for m in _top_imports(p) if m in ("jax", "jaxlib", "repro")]
    assert found == []


def test_the_reference_imports_nothing_of_the_port():
    found = [(p.relative_to(ROOT), m) for p in _modules(BENCH / "reference")
             for m in _top_imports(p) if m != "__future__"
             and m not in ("torch", "numpy", "math", "dataclasses",
                           "contextlib", "typing")]
    assert found == []


def test_the_import_check_compares_whole_names(monkeypatch):
    # repro_torch begins with repro: a prefix test would refuse the port
    import types

    monkeypatch.setitem(sys.modules, "repro_torch", types.ModuleType("x"))
    assert "repro_torch" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    assert "repro" in harness.forbidden_modules()
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "repro")


def test_keys_names_and_units(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["paths"] == ["kdebench"]
    assert man["command"][1].startswith("kdebench/")
    assert 1 <= man["run_seconds"] <= 51
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["reduced"] == []
        assert c["file"].startswith("kdebench/") and (ROOT / c["file"]).is_file()
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in man["end_to_end"] + man["per_layer"]:
        assert NAME.match(m["name"]), m["name"]
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in man[k]]
    assert len(names) == len(set(names))
    assert len(json.dumps(man)) < 64 * 1024


def test_every_cell_reports_what_it_must(man):
    for w in man["workloads"]:
        e2e = {m["name"] for m in harness.metrics_of(man, w["name"],
                                                     "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metrics_of(man, w["name"], "per_layer")
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()


def test_every_per_layer_metric_moves_a_metric_its_cells_report(man):
    layers = {}
    for m in man["per_layer"]:
        assert m["workloads"], m["name"]
        for w in m["workloads"]:
            e2e = {e["name"] for e in harness.metrics_of(man, w,
                                                         "end_to_end")}
            assert m["moves"] in e2e, (m["name"], w)
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert callable(harness.reader(ROOT, m["name"]))
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert "device" in layers


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cells_mixes_and_metrics_are_new_files_only(tmp_path):
    shutil.copytree(BENCH, tmp_path / "kdebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path / "kdebench")
    b = tmp_path / "kdebench"
    conf = json.loads((b / "configs" / "paper-mix16-32k.json").read_text())
    conf.update(name="paper-mix16-8k", n_train=8192, n_queries=1024)
    (b / "configs" / "paper-mix16-8k.json").write_text(json.dumps(conf))
    traffic = json.loads((b / "traffic" / "serve.json").read_text())
    (b / "traffic" / "serve-wide.json").write_text(
        json.dumps(dict(traffic, clients=16)))
    (b / "limits" / "mix16-8k.serve-wide.json").write_text(
        (b / "limits" / "mix16-1m.serve.json").read_text())
    (b / "metrics" / "rows_per_batch.serve.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "paper-mix16-8k", "source": "x",
                           "file": "kdebench/configs/paper-mix16-8k.json",
                           "reduced": ["n_train"], "why": "x"})
    man["workloads"].append({"name": "mix16-8k.serve-wide",
                             "config": "paper-mix16-8k",
                             "traffic": "serve-wide", "chips": 1,
                             "why": "x"})
    for m in man["end_to_end"]:
        if m["name"] == "request_p95_ms":
            m["workloads"].append("mix16-8k.serve-wide")
    man["per_layer"].append({"name": "rows_per_batch.serve", "unit": "rows",
                             "better": "higher", "source": "program_span",
                             "layer": "serving",
                             "moves": "request_p95_ms",
                             "workloads": ["mix16-8k.serve-wide"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    after = _digest(tmp_path / "kdebench")
    assert {k: v for k, v in after.items() if k in before} == before

    wl, config, traffic = harness.cell(man, "mix16-8k.serve-wide", tmp_path)
    assert config["n_train"] == 8192 and traffic["clients"] == 16
    per_layer = [m["name"] for m in harness.metrics_of(
        man, "mix16-8k.serve-wide", "per_layer")]
    assert per_layer == ["rows_per_batch.serve"]
    assert harness.reader(tmp_path, "rows_per_batch.serve")(None) == 42.0


ECHO_KIND = '''"""A kind of traffic written for the test: one step that hands back
the traffic's value; its check compares the two."""

import time

from kdebench.loadgen import Window


class Driver:
    def __init__(self, config, traffic, seed, device, spans, sync):
        self.value = float(traffic["value"]) * config["n_train"]

    def setup(self):
        pass

    def window(self, seconds):
        t0 = time.perf_counter()
        return Window(t0, t0 + seconds, attempted=1, failed=0,
                      end_to_end={"task_s": self.value},
                      records=[{"t0": t0, "t1": t0 + seconds}],
                      kept=[self.value])

    def release(self):
        pass


def check(driver, window, reference=None, **kw):
    return {"echo_err": abs(window.kept[0] - driver.value)}, {"checked": 1}
'''


def test_a_new_kind_of_traffic_is_new_files_only(tmp_path):
    shutil.copytree(BENCH, tmp_path / "kdebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path / "kdebench")
    b = tmp_path / "kdebench"
    (b / "kinds" / "echo.py").write_text(ECHO_KIND)
    (b / "traffic" / "echo-once.json").write_text(
        json.dumps({"kind": "echo", "value": 1e-3}))
    (b / "limits" / "mix16-32k.echo-once.json").write_text(
        json.dumps({"numbers": {"echo_err": {"limit": 0}}}))
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": "mix16-32k.echo-once",
                             "config": "paper-mix16-32k",
                             "traffic": "echo-once", "chips": 1, "why": "x"})
    for m in man["end_to_end"]:
        if m["name"] == "task_s":
            m["workloads"].append("mix16-32k.echo-once")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    after = _digest(tmp_path / "kdebench")
    assert {k: v for k, v in after.items() if k in before} == before

    result, lines = harness.run(
        "mix16-32k.echo-once", 2**31 + 5, 0.25, False,
        t_start=time.perf_counter(), root=tmp_path, device="cpu",
        sync=lambda: None)
    assert result["correct"], result["checks"]
    assert result["metrics"]["task_s"]["value"] == pytest.approx(32.768)
    assert set(result["metrics"]) == {"task_s", "setup_s"}
    assert result["checks"] == {"echo_err": {"value": 0.0, "limit": 0}}
    assert lines[-1].startswith("check echo_err:")


def test_an_unknown_kind_is_refused_by_name(tmp_path):
    with pytest.raises(FileNotFoundError, match="kinds module 'nope'"):
        harness.kind(ROOT, {"kind": "nope"})


def _run(cwd, *extra_env):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **dict(extra_env))
    return subprocess.run(
        [sys.executable, "kdebench/run.py", "--workload", "mix16-32k.task",
         "--seed", "2147483660", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_run_exits_nonzero_without_a_card():
    proc = _run(ROOT)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "CUDA device" in proc.stderr


def test_run_exits_nonzero_with_only_the_benchmark(tmp_path):
    shutil.copytree(BENCH, tmp_path / "kdebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
