"""The port's ring backend (``repro_torch.distributed.ring``) and B1's
rectangular form against float64 and against ``repro``.

Inputs are numpy arrays made from seeds and handed to both packages.  On
the CPU every ring block runs the kernels' plain versions.

  * Rectangular B1 (m rows against n other columns), plain version: per
    value within bar·(its absolute mass Σ_j φ_ij·|[x_j | 1]|) of a
    float64 sum over the points the tier-cast operands represent; the
    square call (one norm vector) against ``repro``'s B1 in interpret
    mode at the tier bars of ``tests/test_torch_kernels.py``.
  * A ring of one (no ``torch.distributed`` world, ``repro`` on one CPU
    device): the estimators, ``ServeEngine``, the planner's ring cases,
    the refusals (stream + ring, resilient + ring, RFF on a ring) and
    ``serve_kde --backend ring``.
  * Worlds of 4 gloo ranks spawned on the CPU, at (4,) and pod 2 × data
    2, against ``repro``'s ring computed in a child Python with 8 forced
    host devices (as ``tests/test_distributed_kde.py`` runs it),
    including the padding case n_true 200 of 256.

Tolerance: rtol 2e-4 (``repro``'s own bar in
``tests/test_distributed_kde.py``) with an atol of 1e-6·peak; the f32
model bar max(1e-5, 8·eps·max‖x‖²/(2h²)) where tighter checks are made.
JAX and ``repro`` are imported inside the tests: the spawned ranks import
this module and need neither.
"""

import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import kde as tkde
from repro_torch.core.estimator import KDE, SDKDE, EstimatorConfig, LaplaceKDE
from repro_torch.distributed import ring, world
from repro_torch.kernels import flash_score, ops
from repro_torch.kernels import precision as prec

ROOT = Path(__file__).resolve().parents[1]
RTOL = 2e-4
F32_EPS = float(np.finfo(np.float32).eps)
TIER_BAR = {"f32": 1e-5, "bf16x2": 5e-4, "bf16": 5e-2}
N, M, D, H = 256, 64, 8, 0.6


def assert_close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-6 * np.max(np.abs(want)))


def f32_bar(pts, h) -> float:
    return max(1e-5, 8 * F32_EPS * float(np.max(np.sum(pts * pts, 1)))
               / (2 * h * h))


def ring_data(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, D)).astype(np.float32),
            rng.standard_normal((M, D)).astype(np.float32))


# ---------------------------------------------------------------------------
# B1 over rectangular blocks (plain version).
# ---------------------------------------------------------------------------


def _rect_operands(rows, cols, precision, block_m, block_n):
    """Tier-cast operands of m rows against n columns, padded, and the
    f32 points they represent."""
    rp = ops._pad_to(torch.from_numpy(rows), block_m)
    cp = ops._pad_to(torch.from_numpy(cols), block_n)
    caug = torch.cat([cp, cp.new_ones((cp.shape[0], 1))], 1)
    if precision == "f32":
        r_ops, c_ops, a_ops = (rp, None), (cp, None), (caug, None)
    else:
        r_ops = prec.cast_operand(rp, precision)
        c_ops = prec.cast_operand(cp, precision)
        a_ops = prec.cast_operand(caug, precision)
    rrec, crec = prec.reconstruct(*r_ops), prec.reconstruct(*c_ops)
    args = (r_ops[0], ops._norms(rrec), ops._t(c_ops[0]), a_ops[0],
            ops._inv2h2(0.7, rp.device), r_ops[1],
            None if c_ops[1] is None else ops._t(c_ops[1]), a_ops[1])
    return args, ops._norms(crec).reshape(1, -1), rrec, crec


def _f64_score(rows, cols, h):
    """(S1aug, mass) in float64: Σ_j φ_ij [x_j | 1] and Σ_j φ_ij |[x_j|1]|."""
    r, c = rows.astype(np.float64), cols.astype(np.float64)
    sq = ((r[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    phi = np.exp(-sq / (2 * h * h))
    aug = np.concatenate([c, np.ones((c.shape[0], 1))], 1)
    return phi @ aug, phi @ np.abs(aug)


RECT_SHAPES = [(96, 320, 8), (320, 96, 8), (64, 256, 1), (128, 64, 16),
               (40, 200, 3)]


@pytest.mark.parametrize("m,n,d", RECT_SHAPES)
def test_rect_score_plain_matches_float64(m, n, d):
    """f32 rectangular B1 per value within the f32 model bar times its
    absolute mass of a float64 sum; the real rows' sums do not see the
    sentinel columns."""
    rng = np.random.default_rng(m + n + d)
    rows = rng.standard_normal((m, d)).astype(np.float32)
    cols = (1.1 * rng.standard_normal((n, d))).astype(np.float32)
    args, nrm_x, _, _ = _rect_operands(rows, cols, "f32", 32, 64)
    got = flash_score.flash_score(*args, nrm_x=nrm_x, block_m=32,
                                  block_n=64)
    assert got.shape == (args[0].shape[0], d + 1)
    want, mass = _f64_score(rows, cols, 0.7)
    bar = f32_bar(np.concatenate([rows, cols]), 0.7)
    err = np.abs(got[:m].double().numpy() - want)
    assert (err <= bar * mass).all(), float((err / mass).max())


@pytest.mark.parametrize("precision", ["f32", "bf16x2", "bf16"])
@pytest.mark.parametrize("m,n,d", [(96, 320, 8), (320, 96, 16)])
def test_rect_score_tiers_match_float64_of_the_cast_points(m, n, d,
                                                           precision):
    """Each tier per value within its bar times the absolute mass of a
    float64 sum over the points its cast operands represent (the tier's
    error is then φ's rounding in the second product alone)."""
    rng = np.random.default_rng(7)
    rows = rng.standard_normal((m, d)).astype(np.float32)
    cols = rng.standard_normal((n, d)).astype(np.float32)
    args, nrm_x, rrec, crec = _rect_operands(rows, cols, precision, 32, 64)
    got = flash_score.flash_score(*args, nrm_x=nrm_x, block_m=32,
                                  block_n=64)
    want, mass = _f64_score(rrec[:m].numpy(), crec[:n].numpy(), 0.7)
    bar = max(TIER_BAR[precision],
              f32_bar(np.concatenate([rows, cols]), 0.7))
    err = np.abs(got[:m].double().numpy() - want)
    assert (err <= bar * mass).all(), float((err / mass).max())


@pytest.mark.parametrize("precision", ["f32", "bf16x2", "bf16"])
def test_square_call_matches_pallas(precision):
    """The square pass is the case m = n: passing the row norms again as
    ``nrm_x`` gives the same bits as the square call, and both hold
    against ``repro``'s B1 in interpret mode at the tier bar."""
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    from repro.kernels.flash_score import flash_score_pallas

    rng = np.random.default_rng(3)
    x = rng.standard_normal((300, 16)).astype(np.float32)
    xp = jops._pad_to(jnp.asarray(x), 64)
    x_ops, xt_ops, xaug_ops, nrm, _ = jops._score_operands(xp, precision)
    inv = jops._inv2h2(0.7)
    want = flash_score_pallas(x_ops[0], nrm, xt_ops[0], xaug_ops[0], inv,
                              x_ops[1], xt_ops[1], xaug_ops[1], block_m=32,
                              block_n=64, interpret=True)

    def t(a):
        if a is None:
            return None
        a = np.asarray(a)
        if a.dtype == np.float32:
            return torch.from_numpy(a.copy())
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16)

    args = [t(a) for a in (x_ops[0], nrm, xt_ops[0], xaug_ops[0], inv,
                           x_ops[1], xt_ops[1], xaug_ops[1])]
    square = flash_score.flash_score(*args, block_m=32, block_n=64)
    rect = flash_score.flash_score(*args, nrm_x=args[1].reshape(1, -1),
                                   block_m=32, block_n=64)
    torch.testing.assert_close(rect, square, rtol=0, atol=0)
    bar = TIER_BAR[precision] if precision != "f32" else f32_bar(x, 0.7)
    assert_close(square[:300], np.asarray(want)[:300], bar)


@pytest.mark.parametrize("bad", ["rows", "cols", "nrm_x"])
def test_rect_score_refuses_mismatched_shapes(bad):
    rng = np.random.default_rng(1)
    rows = rng.standard_normal((64, 4)).astype(np.float32)
    cols = rng.standard_normal((128, 4)).astype(np.float32)
    args, nrm_x, _, _ = _rect_operands(rows, cols, "f32", 32, 64)
    bm, bn = 32, 64
    if bad == "rows":
        bm = 48
    elif bad == "cols":
        bn = 96
    else:
        nrm_x = nrm_x[:, :100]
    with pytest.raises(ValueError):
        flash_score.flash_score(*args, nrm_x=nrm_x, block_m=bm, block_n=bn)


def test_score_and_kde_blocks_match_the_plain_math():
    """ops.score_block / kde_block (the ring's per-block pieces) on rows
    and a visiting block of other points, padded inside, against the
    streaming plain math of ``core/kde.py``."""
    x, y = ring_data(11)
    rows = ops.ring_rows(torch.from_numpy(x[:70]))
    cols = torch.from_numpy(x[70:200])
    inv = ops._inv2h2(H, torch.device("cpu"))
    s1aug = ops.score_block(rows, cols, inv)
    s0, s1 = tkde.score_stats(torch.from_numpy(x[:70]), cols, H)
    assert s1aug.shape == (70, D + 1)
    assert_close(s1aug[:, D], s0, 1e-5)
    assert_close(s1aug[:, :D], s1, 1e-5)
    qrows = ops.ring_rows(torch.from_numpy(y))
    sums = ops.kde_block(qrows, cols, inv)
    lap = ops.kde_block(qrows, cols, inv, laplace=True)
    norm = cols.shape[0] * (2 * np.pi) ** (D / 2) * H**D
    assert_close(sums / norm, tkde.kde_eval(cols, torch.from_numpy(y), H),
                 1e-5)
    assert_close(lap / norm,
                 tkde.laplace_kde_eval(cols, torch.from_numpy(y), H), 1e-5)


# ---------------------------------------------------------------------------
# A ring of one, against repro's ring on one CPU device.
# ---------------------------------------------------------------------------


def test_default_mesh_without_a_world_is_a_ring_of_one():
    import torch.distributed as dist

    assert not dist.is_initialized()
    mesh = ring.default_mesh()
    assert isinstance(mesh, ring.SoloMesh)
    assert ring.ring_size(mesh, ("data",)) == 1
    x = torch.arange(12.0).reshape(6, 2)
    shard = ring.shard_points(x, mesh, ("data",))
    assert shard is x or torch.equal(shard, x)
    assert torch.equal(ring.gather_rows(shard, mesh, ("data",)), x)


@pytest.mark.parametrize("cls", ["KDE", "SDKDE", "LaplaceKDE"])
@pytest.mark.parametrize("n", [256, 300])
def test_estimators_ring_match_repro(cls, n):
    """backend="ring" on both sides, one device: the same densities."""
    import jax.numpy as jnp

    from repro.core import estimator as jest

    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, D)).astype(np.float32)
    y = rng.standard_normal((M, D)).astype(np.float32)
    jcls, tcls = getattr(jest, cls), {"KDE": KDE, "SDKDE": SDKDE,
                                      "LaplaceKDE": LaplaceKDE}[cls]
    want = jcls(H, jest.EstimatorConfig(backend="ring")).fit(
        jnp.asarray(x)).evaluate(jnp.asarray(y))
    est = tcls(H, EstimatorConfig(backend="ring", device="cpu",
                                  precision="bf16", prune=0.0))
    got = est.fit(x).evaluate(y)
    assert got.shape == (M,) and got.dtype == torch.float32
    assert_close(got, want)


def test_ring_functions_on_a_ring_of_one_match_repro():
    """ring_score_stats, ring_sdkde_shift (repro's + eps denominator),
    ring_kde with n_true padding and ring_laplace_kde, local shards =
    the whole arrays."""
    import jax.numpy as jnp

    from repro.distributed import ring as jring

    x, y = ring_data(2)
    js0, js1 = jring.ring_score_stats(jnp.asarray(x), H)
    s0, s1 = ring.ring_score_stats(torch.from_numpy(x), H)
    assert_close(s0, js0)
    assert_close(s1, js1)
    assert_close(ring.ring_sdkde_shift(torch.from_numpy(x), 0.8, score_h=H),
                 jring.ring_sdkde_shift(jnp.asarray(x), 0.8, score_h=H))
    mesh = ring.default_mesh()
    xs = ring.shard_points(torch.from_numpy(x[:200]), mesh, ("data",))
    assert_close(ring.ring_kde(xs, torch.from_numpy(y), H, n_true=200),
                 jring.ring_kde(jnp.asarray(x[:200]), jnp.asarray(y), H,
                                n_true=200))
    assert_close(ring.ring_laplace_kde(torch.from_numpy(x),
                                       torch.from_numpy(y), H),
                 jring.ring_laplace_kde(jnp.asarray(x), jnp.asarray(y), H))
    assert_close(ring.ring_sdkde(torch.from_numpy(x), torch.from_numpy(y),
                                 H),
                 jring.ring_sdkde(jnp.asarray(x), jnp.asarray(y), H))


def test_sentinel_rows_shift_to_finite_points():
    """A sentinel row has S0 = 0 against real columns: the ring's + eps
    denominator keeps its shift finite (ops' flash shift has none)."""
    x, _ = ring_data(4)
    xp = torch.cat([torch.from_numpy(x[:30]),
                    torch.full((2, D), ops.PAD_VALUE)])
    out = ring.ring_sdkde_shift(xp, H)
    assert torch.isfinite(out).all()
    assert_close(out[:30], tkde.sdkde_shift(torch.from_numpy(x[:30]), H),
                 1e-5)


def _serve_cfgs(method):
    from repro.serve import ServeConfig as JServeConfig

    from repro_torch.serve import ServeConfig

    kw = dict(backend="ring", method=method, min_batch=16, max_batch=128,
              block=128)
    return JServeConfig(**kw), ServeConfig(device="cpu", **kw)


@pytest.mark.parametrize("method", ["kde", "sdkde", "laplace"])
def test_ring_serve_engine_matches_repro(method):
    """ServeEngine(backend="ring") on both sides, ragged requests and one
    query_many, against repro's ring engine; one bucket callable a size."""
    import jax.numpy as jnp

    from repro.serve import QueryRequest as JRequest
    from repro.serve import ServeEngine as JServeEngine

    from repro_torch.serve import QueryRequest, ServeEngine

    x, y = ring_data(5)
    jcfg, cfg = _serve_cfgs(method)
    jeng, eng = JServeEngine(jcfg), ServeEngine(cfg)
    jeng.register("r", jnp.asarray(x), h=H)
    prep = eng.register("r", x, h=H)
    assert prep.ring_size == 1 and prep.x_sharded.shape == (N, D)
    for m in (1, 7, 33, 64):
        want = jeng.query(JRequest(key="r", points=jnp.asarray(y[:m])))
        got = eng.query(QueryRequest(key="r", points=y[:m]))
        assert_close(got.value, want.value)
    reqs = [QueryRequest(key="r", points=y[a:b])
            for a, b in ((0, 5), (5, 40), (40, 64))]
    many = eng.query_many(reqs)
    assert_close(torch.cat([a.value for a in many]),
                 jeng.query(JRequest(key="r", points=jnp.asarray(y))).value)


def test_ring_buckets_follow_the_ring_size():
    from repro.serve import ServeConfig as JServeConfig

    from repro_torch.serve import ServeConfig

    j = JServeConfig(backend="ring", min_batch=16, max_batch=100)
    t = ServeConfig(backend="ring", min_batch=16, max_batch=100,
                    device="cpu")
    for r in (1, 3, 4, 8):
        assert t.row_multiple(ring_size=r) == j.row_multiple(r)
        assert t.bucket_sizes(ring_size=r) == j.bucket_sizes(r)
        assert t.bucket_for(37, ring_size=r) == j.bucket_for(37, r)


def test_ring_planner_cases_match_repro():
    """tests/test_planner.py's ring cases on both planners: an explicit
    "ring" is honored (f32, dense, no tiles), "auto" never routes to it,
    and resolve_config keeps an explicit ring with prune "off"."""
    from repro.plan import planner as jplanner
    from repro.serve import ServeConfig as JServeConfig

    from repro_torch.plan import planner
    from repro_torch.serve import ServeConfig

    jb, tb = jplanner.BenchModel([]), planner.BenchModel([])
    jr = jplanner.plan_for(8192, 8, backend="ring", bench=jb)
    r = planner.plan_for(8192, 8, backend="ring", bench=tb)
    for p in (jr, r):
        assert p.backend == "ring" and p.prune == "off"
        assert p.precision == "f32" and p.block_m is None
    assert r.validate() == []
    for n in (64, 8192, 1 << 20):
        assert jplanner.plan_for(n, 8, bench=jb).backend != "ring"
        assert planner.plan_for(n, 8, bench=tb).backend != "ring"
    kw = dict(plan="auto", backend="ring", block_m=64, min_batch=16,
              max_batch=128)
    jres, jp = jplanner.resolve_config(JServeConfig(**kw), n=262144, d=16,
                                       bench=jb)
    res, p = planner.resolve_config(ServeConfig(device="cpu", **kw),
                                    n=262144, d=16, bench=tb)
    assert res.backend == jres.backend == p.backend == jp.backend == "ring"
    assert res.block_m == jres.block_m == 64
    assert res.prune == jres.prune == "off"


def test_ring_plan_never_engages_the_rff_tier():
    from repro_torch.plan import planner

    cells = [{"cell": "rff_cascade", "n": 65536, "d": 2,
              "accuracy_target": 1e-2, "rff_hit_frac": 0.99}]
    bench = planner.BenchModel([{"cells": cells}])
    p = planner.plan(planner.PlanRequest(n=65536, d=2, accuracy=1e-2,
                                         backend="ring", rff=True),
                     bench=bench)
    assert p.backend == "ring" and not p.rff


def test_refusals_match_repro():
    """stream + ring and a resilient ring config raise on both sides."""
    from repro.serve import ResilientEngine as JResilient
    from repro.serve import ServeConfig as JServeConfig

    from repro_torch.serve import ResilientEngine, ServeConfig

    with pytest.raises(ValueError, match="ring"):
        JServeConfig(backend="ring", stream=True)
    with pytest.raises(ValueError, match="ring"):
        ServeConfig(backend="ring", stream=True, device="cpu")
    with pytest.raises(ValueError, match="ring"):
        JResilient(JServeConfig(backend="ring"))
    with pytest.raises(ValueError, match="ring"):
        ResilientEngine(ServeConfig(backend="ring", device="cpu"))


@pytest.mark.parametrize("method", ["kde", "sdkde", "laplace"])
def test_rff_tier_refuses_the_ring(method):
    """The ring is not eligible for the RFF tier on either side, and an
    "rff" pin on a ring engine raises."""
    from repro.kernels import flash_rff as jrff

    from repro_torch.kernels import flash_rff
    from repro_torch.serve import (BadRequest, QueryRequest, ServeConfig,
                                   ServeEngine)

    assert flash_rff.supports(method, "ring") is False
    assert jrff.supports(method, "ring") is False
    assert flash_rff.supports(method, "flash") == jrff.supports(method,
                                                                "pallas")
    x, y = ring_data(6)
    eng = ServeEngine(ServeConfig(backend="ring", method=method, rff="on",
                                  min_batch=16, max_batch=64, device="cpu"))
    prep = eng.register("r", x[:128], h=H)
    assert prep.rff is None
    with pytest.raises(BadRequest, match="ring"):
        eng.query(QueryRequest(key="r", points=y[:8], precision="rff"))
    ans = eng.query(QueryRequest(key="r", points=y[:8],
                                 accuracy_target=1e-2))
    assert ans.rff_hits == 0 and ans.path == ("f32",)


def test_serve_kde_ring_runs_and_verifies(capsys):
    from repro_torch.launch import serve_kde

    rc = serve_kde.main(["--device", "cpu", "--backend", "ring", "--n",
                         "512", "--d", "4", "--requests", "6",
                         "--max-batch", "64", "--verify"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "backend=ring" in out and "ring: 1 rank(s)" in out
    assert "verify: serve path matches" in out


def test_serve_kde_ring_refuses_the_resilient_layer():
    from repro_torch.launch import serve_kde

    with pytest.raises(SystemExit):
        serve_kde.main(["--device", "cpu", "--backend", "ring", "--n", "64",
                        "--replicas", "2"])


# ---------------------------------------------------------------------------
# Worlds of 4 gloo ranks against repro's ring on 8 forced host devices.
# ---------------------------------------------------------------------------

_JAX_CHILD = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.distributed import ring

out = sys.argv[1]
rng = np.random.default_rng(0)
x = rng.standard_normal((256, 8)).astype(np.float32)
y = rng.standard_normal((64, 8)).astype(np.float32)
h = 0.6
devs = np.asarray(jax.devices()[:4])
m1 = Mesh(devs, ('data',))
m2 = Mesh(devs.reshape(2, 2), ('pod', 'data'))
res = {}
s0, s1 = ring.ring_score_stats(jnp.asarray(x), h, mesh=m1)
res['score_s0'], res['score_s1'] = s0, s1
res['sdkde_1d'] = ring.ring_sdkde(jnp.asarray(x), jnp.asarray(y), h, mesh=m1)
res['laplace_1d'] = ring.ring_laplace_kde(jnp.asarray(x), jnp.asarray(y), h,
                                          mesh=m1)
res['sdkde_pod'] = ring.ring_sdkde(jnp.asarray(x), jnp.asarray(y), h,
                                   mesh=m2, pod_axis='pod')
res['kde_pod'] = ring.ring_kde(jnp.asarray(x), jnp.asarray(y), h, mesh=m2,
                               pod_axis='pod')
xs = ring.shard_points(jnp.asarray(x[:200]), m1, ('data',))
res['kde_pad'] = ring.ring_kde(xs, jnp.asarray(y), h, n_true=200, mesh=m1)
np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
print('ALL_OK')
"""


def _world_worker(rank, world_size, store, out_dir):
    """One rank of the world of 4: every ring variant, results gathered
    to whole arrays; rank 0 writes them, every rank its rotations."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world.init(rank, world_size, store)
    x, y = (torch.from_numpy(a) for a in ring_data(0))
    res = {}
    m1 = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
    a1 = ("data",)
    xs, ys = ring.shard_points(x, m1, a1), ring.shard_points(y, m1, a1)
    ring.rotations = 0
    s0, s1 = ring.ring_score_stats(xs, H, mesh=m1)
    res["rot_score"] = ring.rotations
    res["score_s0"] = ring.gather_rows(s0, m1, a1)
    res["score_s1"] = ring.gather_rows(s1, m1, a1)
    res["sdkde_1d"] = ring.gather_rows(ring.ring_sdkde(xs, ys, H, mesh=m1),
                                       m1, a1)
    res["laplace_1d"] = ring.gather_rows(
        ring.ring_laplace_kde(xs, ys, H, mesh=m1), m1, a1)
    pad = ring.shard_points(x[:200], m1, a1)
    res["kde_pad"] = ring.gather_rows(
        ring.ring_kde(pad, ys, H, n_true=200, mesh=m1), m1, a1)
    m2 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
    a2 = ("pod", "data")
    xs2, ys2 = ring.shard_points(x, m2, a2), ring.shard_points(y, m2, a2)
    ring.rotations = 0
    res["kde_pod"] = ring.gather_rows(
        ring.ring_kde(xs2, ys2, H, mesh=m2, pod_axis="pod"), m2, a2)
    res["rot_pod"] = ring.rotations
    res["sdkde_pod"] = ring.gather_rows(
        ring.ring_sdkde(xs2, ys2, H, mesh=m2, pod_axis="pod"), m2, a2)
    # the estimator and the engine on the default mesh (the whole world)
    res["est_sdkde"] = SDKDE(H, EstimatorConfig(
        backend="ring", device="cpu")).fit(x).evaluate(y)
    from repro_torch.serve import QueryRequest, ServeConfig, ServeEngine

    eng = ServeEngine(ServeConfig(backend="ring", min_batch=16,
                                  max_batch=64, device="cpu"))
    prep = eng.register("r", x, h=H)
    res["serve_ring_size"] = prep.ring_size
    res["serve_37"] = eng.query(QueryRequest(key="r", points=y[:37])).value
    res = {k: torch.as_tensor(v).numpy() for k, v in res.items()}
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def world_results():
    """(port ranks' results, repro's) for the world-of-4 cases."""
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ,
                   XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
        jpath = os.path.join(tmp, "jax.npz")
        child = subprocess.Popen([sys.executable, "-c", _JAX_CHILD, jpath],
                                 env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
        try:
            world.spawn(_world_worker, 4, tmp, timeout=240)
            out, err = child.communicate(timeout=300)
        finally:
            child.kill()            # no-op once it has exited
            child.wait()
        assert "ALL_OK" in out, out + err
        ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                 for r in range(4)]
        return ranks, dict(np.load(jpath))


@pytest.mark.parametrize("key", ["score_s0", "score_s1", "sdkde_1d",
                                 "laplace_1d", "kde_pad", "kde_pod",
                                 "sdkde_pod"])
def test_world_of_four_rings_match_repro(world_results, key):
    ranks, jax_res = world_results
    want = jax_res[key]
    for res in ranks:       # every rank holds the whole gathered result
        assert_close(res[key][:want.shape[0]], want)


def test_world_of_four_rotation_counts(world_results):
    """A 1-D ring of 4 posts 3 rotations a pass; pod 2 × data 2 posts one
    inner rotation in each of its two inner rings and one pod rotation
    (the last of each would bring a block nobody reads, and is not
    sent)."""
    ranks, _ = world_results
    for res in ranks:
        assert int(res["rot_score"]) == 3
        assert int(res["rot_pod"]) == 3


def test_world_of_four_estimator_and_engine(world_results):
    """SDKDE(backend="ring") and ServeEngine(backend="ring") on the default
    mesh of the world of 4 against repro's ring SD-KDE; every rank gets
    the whole answer."""
    ranks, jax_res = world_results
    for res in ranks:
        assert int(res["serve_ring_size"]) == 4
        assert_close(res["est_sdkde"], jax_res["sdkde_1d"])
        assert_close(res["serve_37"], jax_res["sdkde_1d"][:37])
