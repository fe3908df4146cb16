"""Boundaries of the PyTorch port: no JAX inside it, the card by default,
and no silent fallback from a kernel request to the CPU."""

import ast
import dataclasses
import importlib
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


# the resilient serving and admission slice (ROADMAP A12)
A12_MODULES = ("repro_torch.distributed", "repro_torch.distributed.fault",
               "repro_torch.distributed.elastic",
               "repro_torch.serve.resilience", "repro_torch.serve.frontend",
               "repro_torch.launch.serve_kde")


@pytest.mark.parametrize("module", A12_MODULES)
def test_a12_modules_are_scanned_and_import(module):
    rel = pathlib.Path("src", *module.split("."))
    path = ROOT / (rel / "__init__.py" if (ROOT / rel).is_dir()
                   else rel.with_suffix(".py"))
    assert path in PORT_FILES
    importlib.import_module(module)


# the ring backend slice (ROADMAP A13)
A13_MODULES = ("repro_torch.distributed.ring",
               "repro_torch.distributed.ring2d",
               "repro_torch.distributed.world",
               "repro_torch.distributed.straggler",
               "repro_torch.distributed.compression",
               "repro_torch.launch.mesh")


@pytest.mark.parametrize("module", A13_MODULES)
def test_a13_modules_are_scanned_and_import(module):
    """Each module of the ring slice is among the files the AST scan
    holds to "no jax, nothing of repro", and imports without a world or
    a card."""
    rel = pathlib.Path("src", *module.split("."))
    path = ROOT / rel.with_suffix(".py")
    assert path in PORT_FILES
    assert not set(_imported_roots(path)) & {"jax", "jaxlib", "repro"}
    importlib.import_module(module)


# the measurement slice (ROADMAP A11's measured cells, A14's analysis/)
MEASUREMENT_MODULES = ("repro_torch.analysis", "repro_torch.analysis.flops",
                       "repro_torch.analysis.roofline",
                       "repro_torch.analysis.profile",
                       "repro_torch.plan.cells")


@pytest.mark.parametrize("module", MEASUREMENT_MODULES)
def test_measurement_modules_are_scanned_and_import(module):
    """Each module of the measurement slice is among the files the AST
    scan holds to "no jax, nothing of repro", imports nothing of
    ``benchmarks`` either, and imports without a card."""
    rel = pathlib.Path("src", *module.split("."))
    path = ROOT / (rel / "__init__.py" if (ROOT / rel).is_dir()
                   else rel.with_suffix(".py"))
    assert path in PORT_FILES
    assert not set(_imported_roots(path)) & {"jax", "jaxlib", "repro",
                                              "benchmarks"}
    importlib.import_module(module)


# the LM families' slices (ROADMAP A15: dense and hybrid serving; MoE,
# VLM and audio)
A15_MODULES = ("repro_torch.models.rope", "repro_torch.models.attention",
               "repro_torch.models.transformer",
               "repro_torch.configs.gemma2_2b",
               "repro_torch.configs.minitron_8b",
               "repro_torch.configs.phi3_mini_3p8b",
               "repro_torch.configs.chatglm3_6b",
               "repro_torch.configs.hymba_1p5b",
               "repro_torch.models.moe", "repro_torch.models.encdec",
               "repro_torch.configs.granite_moe_3b_a800m",
               "repro_torch.configs.kimi_k2_1t_a32b",
               "repro_torch.configs.llava_next_34b",
               "repro_torch.configs.whisper_large_v3")


@pytest.mark.parametrize("module", A15_MODULES)
def test_a15_modules_are_scanned_and_import(module):
    """Each module of the attention families' slice is among the files
    the AST scan holds to "no jax, nothing of repro", and imports
    without a card."""
    path = ROOT / pathlib.Path("src", *module.split(".")).with_suffix(".py")
    assert path in PORT_FILES
    assert not set(_imported_roots(path)) & {"jax", "jaxlib", "repro"}
    importlib.import_module(module)


def test_lm_launcher_defaults_to_the_card(no_card):
    """``launch.serve.generate`` of a model of any family raises without
    a card unless asked for the CPU."""
    from repro_torch.launch import serve

    for arch in ("gemma2_2b", "granite_moe_3b_a800m", "llava_next_34b",
                 "whisper_large_v3"):
        with pytest.raises(RuntimeError, match="cuda"):
            serve.generate(arch, reduced=True, gen=1)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--reduced", "--gen", "1"])


def test_analysis_exports_match_repro_but_the_hlo_parsers():
    """``repro_torch.analysis`` exports ``repro.analysis``'s names less
    the HLO parsers' (``hlo.py``; ``roofline_from_compiled`` reads a
    compiled HLO), which the profiler accounting and
    ``roofline_from_counts`` replace."""
    import repro.analysis as janalysis
    import repro_torch.analysis as tanalysis

    hlo = {"collective_bytes", "hlo_collectives", "roofline_from_compiled"}
    assert set(janalysis.__all__) - hlo <= set(tanalysis.__all__)
    assert {"roofline_from_counts", "format_table", "Hardware",
            "device_breakdown", "flop_count"} <= set(tanalysis.__all__)
    assert all(hasattr(tanalysis, name) for name in tanalysis.__all__)


def test_distributed_exports_match_repro_but_compat():
    """``repro_torch.distributed`` exports ``repro.distributed``'s names
    (``compat``, a JAX-version shim, has no counterpart) and the port's
    ``HostState``."""
    import repro.distributed as jdist
    import repro_torch.distributed as tdist

    jnames = {n for n in dir(jdist) if not n.startswith("_")} - {
        "compat", "annotations"}
    jnames -= {n for n in jnames
               if type(getattr(jdist, n)).__name__ == "module"
               and n != "ring"}
    assert jnames <= set(tdist.__all__), jnames - set(tdist.__all__)
    assert all(hasattr(tdist, name) for name in tdist.__all__)


def test_serve_exports_match_repro_but_the_legacy_aliases():
    """``repro_torch.serve`` exports ``repro.serve``'s names, less the
    two aliases ``repro`` keeps for its deprecated answer types."""
    import repro.serve as jserve
    import repro_torch.serve as tserve

    assert set(tserve.__all__) == set(jserve.__all__) - {
        "FrontendAnswer", "ResilientAnswer"}
    assert all(hasattr(tserve, name) for name in tserve.__all__)


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
    from repro_torch.launch import serve_kde
    from repro_torch.serve import ResilientEngine

    with pytest.raises(RuntimeError, match="cuda"):
        ResilientEngine(ServeConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        serve_kde.main(["--n", "64", "--requests", "1"])


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
# tiles), and A13, the ring backend
LANDED = {"A6", "A13"}


# the training slice (ROADMAP A15, steps 1 and 2): the loss and remat in
# the models, optim/, the train step, checkpoints and the launcher
TRAINING_MODULES = ("repro_torch.optim", "repro_torch.optim.adamw",
                    "repro_torch.optim.adafactor",
                    "repro_torch.optim.clipping",
                    "repro_torch.optim.schedules",
                    "repro_torch.checkpoint",
                    "repro_torch.checkpoint.manager",
                    "repro_torch.models.remat",
                    "repro_torch.launch.steps", "repro_torch.launch.train")


@pytest.mark.parametrize("module", TRAINING_MODULES)
def test_training_modules_are_scanned_and_import(module):
    """Each module of the training slice is among the files the AST scan
    holds to "no jax, nothing of repro", and imports without a card."""
    rel = pathlib.Path("src", *module.split("."))
    path = ROOT / (rel / "__init__.py" if (ROOT / rel).is_dir()
                   else rel.with_suffix(".py"))
    assert path in PORT_FILES
    assert not set(_imported_roots(path)) & {"jax", "jaxlib", "repro"}
    importlib.import_module(module)


def _wrapper_calls():
    """Each of the eight CUDA wrappers (B1-B6, B7's two modes) with valid
    CPU operands: name -> (wrapper, args, kwargs, launch count)."""
    from repro_torch.kernels import flash_laplace, flash_pruned
    from repro_torch.kernels import selective_scan as ss

    kde = _kde_operands()
    y, nrm_y, xt, nrm_x, inv = kde
    xs, xt_s, xaug, nrm, _ = ops._score_operands(y, "f32")
    one = torch.ones(1, dtype=torch.int32)
    tmap = torch.zeros((1, 1), dtype=torch.int32)
    g = torch.Generator().manual_seed(0)
    bsz, s, d, n = 1, 8, 4, 2
    xi, dt, z = (torch.randn(bsz, s, d, generator=g) for _ in range(3))
    b, c = (torch.randn(bsz, s, n, generator=g) for _ in range(2))
    a = -torch.rand(d, n, generator=g) - 0.5
    h0 = torch.zeros(bsz, d, n)
    blocks = {"block_m": 128, "block_n": 128}
    return {
        "flash_score_cuda": (flash_score.flash_score_cuda,
                             (xs[0], nrm, xt_s[0], xaug[0], inv), {},
                             lambda: flash_score.launches),
        "flash_kde_cuda": (flash_kde.flash_kde_cuda, kde, {},
                           lambda: flash_kde.launches),
        "flash_score_pruned_cuda": (
            flash_pruned.flash_score_pruned_cuda,
            (one, tmap, xs[0], nrm, xt_s[0], xaug[0], inv), blocks,
            lambda: dataclasses.astuple(flash_pruned.score_counts)),
        "flash_kde_pruned_cuda": (
            flash_pruned.flash_kde_pruned_cuda,
            (one, tmap, y, nrm_y, xt, nrm_x, inv), blocks,
            lambda: dataclasses.astuple(flash_pruned.kde_counts)),
        "flash_laplace_cuda": (flash_laplace.flash_laplace_cuda, kde, {},
                               lambda: flash_laplace.laplace_launches),
        "sq_moment_cuda": (flash_laplace.sq_moment_cuda, kde, {},
                           lambda: flash_laplace.sq_moment_launches),
        "selective_scan_cuda": (ss.selective_scan_cuda,
                                (xi, dt, b, c, a, h0), {},
                                lambda: ss.launches),
        "mamba_scan_cuda": (ss.mamba_scan_cuda,
                            (xi, dt, b, c, a, h0, torch.zeros(d),
                             torch.ones(d), z), {},
                            lambda: ss.fused_launches),
    }


WRAPPERS = ("flash_score_cuda", "flash_kde_cuda", "flash_score_pruned_cuda",
            "flash_kde_pruned_cuda", "flash_laplace_cuda", "sq_moment_cuda",
            "selective_scan_cuda", "mamba_scan_cuda")


@pytest.mark.parametrize("name", WRAPPERS)
def test_cuda_wrappers_refuse_an_input_that_requires_grad(name):
    """C1: a kernel launch has no backward, so under grad mode a wrapper
    given an input that requires grad raises, naming the differentiable
    route, before any device check (these operands lie on the CPU);
    under no_grad and inference_mode it reaches the device check as
    before, and so it does when nothing requires grad."""
    fn, args, kwargs, count = _wrapper_calls()[name]
    before = count()
    graded = tuple(t.detach().clone().requires_grad_()
                   if torch.is_tensor(t) and t.is_floating_point() else t
                   for t in args)
    route = "ssm_kernel=False" if "scan" in name else name.replace(
        "_cuda", "_plain")
    with pytest.raises(RuntimeError, match="no backward") as err:
        fn(*graded, **kwargs)
    assert route in str(err.value)
    for mode in (torch.no_grad, torch.inference_mode):
        with mode(), pytest.raises(ValueError, match="CUDA"):
            fn(*graded, **kwargs)
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args, **kwargs)
    assert count() == before


def test_wrapper_list_covers_every_cuda_wrapper():
    found = set()
    for path in (ROOT / "src" / "repro_torch" / "kernels").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.FunctionDef) and node.name.endswith(
                    "_cuda") and node.name != "check_cuda":
                found.add(node.name)
    assert found == set(WRAPPERS)


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
    """method="laplace" builds on every backend, the ring's buckets are
    multiples of its size, and the ring still raises where ``repro``'s
    does: with a streaming estimator."""
    cfg = ServeConfig(method="laplace")
    assert cfg.method == "laplace" and cfg.device == "cuda"
    assert ServeConfig(method="laplace", backend="torch",
                       device="cpu").row_multiple() == 1
    ring_cfg = ServeConfig(method="laplace", backend="ring", device="cpu")
    assert ring_cfg.row_multiple(ring_size=4) == 4
    assert all(b % 4 == 0 for b in ring_cfg.bucket_sizes(ring_size=4))
    with pytest.raises(ValueError, match="stream"):
        ServeConfig(method="laplace", backend="ring", stream=True,
                    device="cpu")
    with pytest.raises(ValueError, match="method"):
        ServeConfig(method="bogus", device="cpu")


# the launcher over a world and the sharded checkpoints (ROADMAP A, last
# items 1-2)
MESH_TRAINING_MODULES = ("repro_torch.checkpoint.manager",
                         "repro_torch.launch.train",
                         "repro_torch.launch.steps",
                         "repro_torch.data.synthetic",
                         "repro_torch.models.parallel")


@pytest.mark.parametrize("module", MESH_TRAINING_MODULES)
def test_mesh_training_modules_are_scanned_and_import(module):
    """Each module this slice changed is among the files the AST scan
    holds to "no jax, nothing of repro", imports without a card, and no
    longer points ahead to the slice ("still to port")."""
    path = ROOT / pathlib.Path("src", *module.split(".")).with_suffix(".py")
    assert path in PORT_FILES
    assert not set(_imported_roots(path)) & {"jax", "jaxlib", "repro"}
    assert "still to port" not in path.read_text()
    importlib.import_module(module)


def test_launcher_under_torchrun_asks_for_the_card(no_card, monkeypatch):
    """Under ``torchrun`` the launcher joins an NCCL world on the card
    unless asked for the CPU; without a card it raises before joining."""
    import torch.distributed as dist

    from repro_torch.launch import train

    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError, match="cuda"):
        train.join_world("cuda")
    assert not dist.is_initialized()
