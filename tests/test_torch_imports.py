"""Boundaries of the PyTorch port: no JAX inside it, the card by default,
and no silent fallback from a kernel request to the CPU."""

import ast
import pathlib
import re

import pytest
import torch

from repro_torch import device
from repro_torch.core.estimator import SDKDE, EstimatorConfig
from repro_torch.kernels import flash_kde, flash_score, ops
from repro_torch.serve import ServeConfig, ServeEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_repro(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)


def test_port_has_cuda_sources_for_both_kernels():
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    assert {p.stem for p in csrc.glob("*.cu")} >= {"flash_score",
                                                   "flash_kde",
                                                   "flash_pruned",
                                                   "flash_laplace",
                                                   "selective_scan"}


def test_every_loaded_entry_point_is_defined_in_its_source():
    """``_build.load(name, argtypes, entry, prefix=...)`` resolves
    ``<prefix>_<entry>`` and ``<prefix>_error`` (prefix defaults to the
    name) in ``csrc/<name>.cu``: a misnamed C function would only fail on
    the card."""
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    kernels = ROOT / "src" / "repro_torch" / "kernels"
    loads = set()
    for path in kernels.glob("*.py"):
        for m in re.finditer(
                r'_build\.load\(\s*"(\w+)"\s*,\s*\w+'
                r'(?:\s*,\s*"(\w+)")?(?:\s*,\s*prefix="(\w+)")?\)',
                path.read_text()):
            loads.add((m.group(1), m.group(2) or "launch",
                       m.group(3) or m.group(1)))
    assert {name for name, _, _ in loads} == {
        "flash_score", "flash_kde", "flash_pruned", "flash_laplace",
        "selective_scan"}
    assert {p for n, _, p in loads if n == "flash_laplace"} == {
        "flash_laplace", "sq_moment"}
    for name, entry, prefix in loads:
        src = (csrc / f"{name}.cu").read_text()
        for fn in (f"{prefix}_{entry}", f"{prefix}_error"):
            assert re.search(rf'extern "C" [\w\s*]+\b{fn}\(', src), fn


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="cuda"):
        device.resolve()
    x = torch.zeros((8, 2))
    with pytest.raises(RuntimeError, match="cuda"):
        SDKDE(0.5).fit(x)
    with pytest.raises(RuntimeError, match="cuda"):
        SDKDE(0.5, EstimatorConfig(backend="torch")).fit(x)
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(ServeConfig())


def test_defaults_are_the_card_and_the_flash_kernels():
    assert EstimatorConfig().device == "cuda"
    assert EstimatorConfig().backend == "flash"
    assert ServeConfig().device == "cuda"
    assert ServeConfig().backend == "flash"


def test_resolve_turns_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        assert device.resolve("cpu").type == "cpu"
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def _kde_operands(n=256, m=128, d=4):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(n, d, generator=g)
    y = torch.randn(m, d, generator=g)
    y_ops, xt_ops, nrm_y, nrm_x = ops._prep_eval(x, y, 128, 128, "f32")
    return y_ops[0], nrm_y, xt_ops[0], nrm_x, ops._inv2h2(0.5, x.device)


def test_cuda_wrappers_refuse_cpu_tensors():
    args = _kde_operands()
    before = flash_kde.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_kde.flash_kde_cuda(*args)
    assert flash_kde.launches == before
    y, nrm_y, _, _, inv = args
    xs, xt_s, xaug, nrm, _ = ops._score_operands(y, "f32")
    before = flash_score.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_score.flash_score_cuda(xs[0], nrm, xt_s[0], xaug[0], inv)
    assert flash_score.launches == before


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    args = _kde_operands()
    before = flash_kde.launches
    got = flash_kde.flash_kde(*args, block_m=128, block_n=128)
    want = flash_kde.flash_kde_plain(*args, block_n=128)
    assert flash_kde.launches == before
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ROADMAP items whose knobs have landed: A6, the launch tuner ("auto"
# tiles)
LANDED = {"A6"}


@pytest.mark.parametrize("kwargs, roadmap", [
    ({"backend": "ring"}, "A13"),
    ({"block_m": "auto"}, "A6"),
    ({"block_n": "auto"}, "A6"),
])
def test_unported_knobs_raise_naming_the_roadmap(kwargs, roadmap):
    """A knob of an item still to port raises naming it; the knobs of a
    landed item are accepted by both configs."""
    if roadmap in LANDED:
        for cfg in (EstimatorConfig(device="cpu", **kwargs),
                    ServeConfig(device="cpu", **kwargs)):
            assert all(getattr(cfg, k) == v for k, v in kwargs.items())
        return
    with pytest.raises(NotImplementedError, match=roadmap):
        EstimatorConfig(device="cpu", **kwargs)
    with pytest.raises(NotImplementedError, match=roadmap):
        ServeConfig(device="cpu", **kwargs)


@pytest.mark.parametrize("prune", ["bogus", -1.0])
def test_bad_prune_value_raises_in_both_configs(prune):
    with pytest.raises(ValueError, match="prune"):
        EstimatorConfig(device="cpu", prune=prune)
    with pytest.raises(ValueError, match="prune"):
        ServeConfig(device="cpu", prune=prune)


def test_prune_defaults_to_auto_as_in_repro():
    assert EstimatorConfig().prune == "auto"
    assert ServeConfig().prune == "auto"
    for ok in ("auto", "off", 0.0, 1e-7):
        EstimatorConfig(device="cpu", prune=ok)
        ServeConfig(device="cpu", prune=ok)


def test_laplace_method_builds_and_ring_still_raises():
    cfg = ServeConfig(method="laplace")
    assert cfg.method == "laplace" and cfg.device == "cuda"
    assert ServeConfig(method="laplace", backend="torch",
                       device="cpu").row_multiple() == 1
    with pytest.raises(NotImplementedError, match="A13"):
        ServeConfig(method="laplace", backend="ring")
    with pytest.raises(ValueError, match="method"):
        ServeConfig(method="bogus", device="cpu")
