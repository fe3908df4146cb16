"""The port's sharding specs against ``repro``'s, and the mesh registry.

Every spec builder of the dry run (``models.common.param_pspecs``,
``optim``'s ZeRO-1 ``opt_state_pspecs`` / ``adafactor_state_pspecs``,
``data.synthetic.batch_pspecs``, ``launch.steps.cache_pspecs`` and every
input of ``build_cell`` / ``make_kde_step``, ``ring2d.kde_input_specs``)
is held equal to ``repro``'s for all ten architectures, every assigned
shape and both production meshes.  ``repro``'s builders take a
``jax.sharding.AbstractMesh``, so no 256-device JAX process is needed;
its ``cache_pspecs`` at batch 1 reads ``mesh.devices.size``, which an
``AbstractMesh`` does not have, so a small stand-in serves there.  A
JAX PartitionSpec is compared as a tuple: a one-name tuple entry as the
name, trailing ``None`` entries dropped.
"""

import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.data import synthetic as jsynthetic
from repro.distributed import ring2d as jring2d
from repro.launch import steps as jsteps
from repro.models import common as jcommon
from repro.models import parallel as jparallel
from repro.optim import adafactor as jadafactor
from repro.optim import adamw as jadamw
from repro_torch import configs as tconfigs
from repro_torch.data import synthetic as tsynthetic
from repro_torch.distributed import ring2d as tring2d
from repro_torch.launch import steps as tsteps
from repro_torch.models import common as tcommon
from repro_torch.models import parallel
from repro_torch.models.parallel import Abstract, MeshShape
from repro_torch.optim import adafactor as tadafactor
from repro_torch.optim import adamw as tadamw

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = tconfigs.ARCH_IDS


class _Devices:
    def __init__(self, size):
        self.size = size


class _StandIn:
    """What ``repro``'s ``cache_pspecs`` reads of a mesh at batch 1."""

    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))
        self.axis_names = names
        self.devices = _Devices(int(torch.tensor(shape).prod()))


def norm(spec):
    """A spec as a comparable tuple."""
    out = []
    for e in tuple(spec):
        if isinstance(e, tuple):
            e = e[0] if len(e) == 1 else (tuple(e) if e else None)
        out.append(e)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def jtree(tree):
    """repro's abstract tree -> {path: (shape, spec)}."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, (tuple, list)):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            out[path] = (tuple(t.shape), norm(t.sharding.spec))

    walk(tree, ())
    return out


def ttree(tree):
    out = {}

    def walk(t, path):
        if isinstance(t, Abstract):
            out[path] = (tuple(t.shape), norm(t.spec))
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, tuple):
            for i, v in enumerate(t):
                walk(v, path + (i,))

    walk(tree, ())
    return out


@pytest.fixture(params=list(MESHES))
def meshes(request):
    shape, names = MESHES[request.param]
    yield AbstractMesh(shape, names), MeshShape(shape, names)
    jparallel.set_mesh(None)
    parallel.set_mesh(None)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_optimizer_specs_match_repro(arch, meshes):
    jmesh, tmesh = meshes
    jcfg = jconfigs.get_arch(arch).model
    tcfg = tconfigs.get_arch(arch).model
    jspecs = {k: norm(v) for k, v in jcommon.param_pspecs(jcfg).items()}
    assert {k: norm(v) for k, v in tcommon.param_pspecs(tcfg).items()} \
        == jspecs
    jshapes = jcommon.param_shapes(jcfg)
    tshapes = tcommon.param_shape_specs(tcfg)
    assert {k: tuple(v[0]) for k, v in tshapes.items()} == \
        {k: tuple(v[0]) for k, v in jshapes.items()}
    dp_ax = tuple(a for a in tmesh.mesh_dim_names if a != "model")
    axis = dp_ax if len(dp_ax) > 1 else dp_ax[0]
    dp = 32 if len(dp_ax) > 1 else 16
    for jfn, tfn in ((jadamw.opt_state_pspecs, tadamw.opt_state_pspecs),
                     (jadafactor.adafactor_state_pspecs,
                      tadafactor.adafactor_state_pspecs)):
        want = jfn(jshapes, dp, axis=axis)
        got = tfn(tshapes, dp, axis=axis)
        flat_w = {(p, k): norm(v) for p in want if p != "step"
                  for k, v in _leaves(want[p])}
        flat_g = {(p, k): norm(v) for p in got if p != "step"
                  for k, v in _leaves(got[p])}
        assert flat_g == flat_w


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("arch", ARCHS)
def test_every_cell_input_matches_repro(arch, meshes):
    """build_cell's abstract inputs (params, ZeRO-1 state, train / prefill
    batch, decode cache and tokens) for each assigned shape; token ids are
    int64 in the port (int32 in repro), so dtypes are not compared."""
    jmesh, tmesh = meshes
    ja, ta = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    for shape_name, skip in [(s.name, r) for s, r in tconfigs.arch_cells(ta)]:
        if skip:
            continue
        jshape, tshape = jconfigs.SHAPES[shape_name], tconfigs.SHAPES[
            shape_name]
        if jshape.kind == "decode" and jshape.global_batch == 1:
            jm = _StandIn(*MESHES["multi" if len(tmesh.shape) == 3
                                  else "single"])
            want = {k: norm(v) for k, v in jsteps.cache_pspecs(
                ja.model, jm, 1, jshape.seq_len).items()}
            got = {k: norm(v) for k, v in tsteps.cache_pspecs(
                ta.model, tmesh, 1, tshape.seq_len).items()}
            assert got == want
            continue
        _, jabs, jdonate = jsteps.build_cell(ja, jshape, jmesh)
        _, tabs, tdonate = tsteps.build_cell(ta, tshape, tmesh)
        assert tdonate == jdonate
        want, got = jtree(jabs), ttree(tabs)
        if jshape.kind == "decode":
            want.pop((1, "pos"))
        assert got == want, shape_name
        assert parallel.get_mesh() is tmesh


@pytest.mark.parametrize("batch", [1, 128, 24])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_repro(arch, batch, meshes):
    jmesh, tmesh = meshes
    ja, ta = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    jm = _StandIn(tuple(tmesh.shape), tmesh.mesh_dim_names)
    for seq in (32768, 524288, 1000):
        want = {k: norm(v) for k, v in jsteps.cache_pspecs(
            ja.model, jm, batch, seq).items()}
        got = {k: norm(v) for k, v in tsteps.cache_pspecs(
            ta.model, tmesh, batch, seq).items()}
        assert got == want, seq


def test_batch_and_kde_specs_match_repro(meshes):
    jmesh, tmesh = meshes
    for arch in ("gemma2_2b", "llava_next_34b", "whisper_large_v3"):
        jcfg = jconfigs.get_arch(arch).model
        tcfg = tconfigs.get_arch(arch).model
        for axes in (("data",), ("pod", "data")):
            want = {k: norm(v) for k, v in jsynthetic.batch_pspecs(
                jcfg, axes).items()}
            got = {k: norm(v) for k, v in tsynthetic.batch_pspecs(
                tcfg, axes).items()}
            assert got == want
        got = tsynthetic.batch_specs(tcfg, tmesh, 64, 128)
        assert {k: norm(v.spec) for k, v in got.items()} == \
            {k: norm(v) for k, v in jsynthetic.batch_pspecs(jcfg).items()}
    for wl in tconfigs.KDE_WORKLOADS.values():
        want = jring2d.kde_input_specs(wl.n_train, wl.n_test, wl.dim, jmesh)
        got = tring2d.kde_input_specs(wl.n_train, wl.n_test, wl.dim, tmesh)
        assert [(tuple(a.shape), norm(a.spec)) for a in got] == \
            [(tuple(a.shape), norm(a.sharding.spec)) for a in want]
        kabs = tsteps.input_specs(wl, None, tmesh)
        assert [norm(a.spec) for a in kabs] == [norm(a.spec) for a in got]


def test_arch_cells_match_repro():
    for arch in ARCHS:
        want = [(s.name, r) for s, r in jconfigs.arch_cells(
            jconfigs.get_arch(arch))]
        got = [(s.name, r) for s, r in tconfigs.arch_cells(
            tconfigs.get_arch(arch))]
        assert got == want
    cells = [r for a in ARCHS
             for _, r in tconfigs.arch_cells(tconfigs.get_arch(a))]
    assert len(cells) == 40 and sum(r is not None for r in cells) == 7


# ---------------------------------------------------------------------------
# The registry and hint semantics (after tests/test_parallel_hints.py).
# ---------------------------------------------------------------------------


def test_hint_is_identity_without_a_mesh_or_on_a_plain_tensor():
    parallel.set_mesh(None)
    x = torch.ones(4, 8)
    assert parallel.hint(x, "dp", "model") is x
    with parallel.model_mesh(MeshShape((2, 2), ("data", "model"))):
        assert parallel.hint(x, "dp", "model") is x


def test_dp_axes_and_model_mesh_restore_on_exception():
    parallel.set_mesh(None)
    assert parallel.dp_axes() == ()
    with parallel.model_mesh(MeshShape((1, 1), ("data", "model"))):
        assert parallel.dp_axes() == ()
    assert parallel.dp_axes(MeshShape((2, 4, 2),
                                      ("pod", "data", "model"))) == (
        "pod", "data")
    assert parallel.dp_axes(MeshShape((1, 4, 2),
                                      ("pod", "data", "model"))) == ("data",)
    with pytest.raises(RuntimeError):
        with parallel.model_mesh(MeshShape((2, 2), ("data", "model"))):
            raise RuntimeError("boom")
    assert parallel.get_mesh() is None


def test_resolve_replicates_an_indivisible_dim():
    """None in with_sharding_constraint means replicated: an entry whose
    axes do not divide its dim resolves to None, "dp" to the batch axes."""
    mesh = MeshShape((2, 4, 2), ("pod", "data", "model"))
    assert parallel.resolve(mesh, (8, 6, 4, 2), ("dp", "model", None, None)
                            ) == (("pod", "data"), "model", None, None)
    assert parallel.resolve(mesh, (12, 5), ("dp", "model")) == (None, None)
    assert parallel.resolve(MeshShape((1, 2), ("data", "model")), (3, 4),
                            ("dp", "model")) == (None, "model")


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = MeshShape((2, 4, 2), ("pod", "data", "model"))
    assert parallel.placements(mesh, (("pod", "data"), None, "model")) == [
        Shard(0), Shard(0), Shard(2)]
    assert parallel.placements(mesh, ("model", None, "data")) == [
        Replicate(), Shard(2), Shard(0)]
    assert parallel.placements(mesh, ()) == [Replicate()] * 3
    with pytest.raises(ValueError):
        parallel.placements(mesh, (("data", "pod"),))
    with pytest.raises(ValueError):
        parallel.placements(mesh, ("model", "model"))


def test_seq_shard_auto_rule_matches_repros():
    """Sequence-sharded attention only where the heads do not divide the
    model axis, Kimi-K2 by its override."""
    from repro_torch.models.transformer import seq_shard_attn

    mesh = MeshShape((16, 16), ("data", "model"))
    want = {"gemma2_2b": True, "granite_moe_3b_a800m": True,
            "minitron_8b": False, "chatglm3_6b": False,
            "kimi_k2_1t_a32b": True}
    for arch, expect in want.items():
        assert seq_shard_attn(tconfigs.get_arch(arch).model, mesh) == expect
