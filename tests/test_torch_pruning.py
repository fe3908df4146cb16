"""The port's cluster-pruned path (spatial index, visit lists, B3/B4)
against the JAX package, on the CPU.

Inputs are numpy arrays made from a seed and handed to both packages; the
JAX side runs its pruned kernels in interpret mode, as
``tests/test_pruning.py`` does.  The two packages' k-means draw different
random numbers from one seed, so wherever layouts, tile metadata, maps or
visit lists are compared, JAX's index is carried into the port
(``convert.index_from_state``); where each side clusters for itself only
final sums are compared.

Tolerances, and why:
  * layouts, slots, labels, visit lists: exact (integer and copy work);
  * tile metadata: rtol 1e-6 with an absolute floor of 8 ulps of the
    largest coordinate — centroids are f32 sums taken in another order,
    and a radius inherits its centroid's absolute error;
  * tile maps: ``keep`` exact except pairs whose exponent bound lies
    within 1e-4 (relative) of a decision threshold (``UNDERFLOW_ARG``, or
    ``epsilon`` for epsilon > 0); ``err_bound`` rtol 1e-5, or the
    norm-trick error model 8·eps·max(‖y‖²+‖c‖²)/(2h²) where larger — the
    bound is exp(-arg) and arg carries the f32 cancellation of
    ‖y‖² + ‖c‖² − 2y·c, amplified by 1/(2h²), as the kernels' sq does;
  * kernels and wrappers: the kernel bars of ``test_torch_kernels.py``
    (f32 max(1e-5, 8·eps·max‖x‖²/(2h²)), bf16x2 5e-4, bf16 5e-2, atol
    1e-6·peak), real rows only;
  * certificates: float64 dropped mass ≤ err_bound·(1 + 1e-5), the JAX
    package's own certificate test.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_pruned as jfp
from repro.kernels import ops as jops
from repro.kernels import spatial as jsp
from repro.serve import QueryRequest as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.core import kde as tkde
from repro_torch.core.estimator import SDKDE, EstimatorConfig
from repro_torch.kernels import flash_kde as tfk
from repro_torch.kernels import flash_pruned as tfp
from repro_torch.kernels import flash_score as tfs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import spatial as tsp
from repro_torch.serve import QueryRequest, ServeConfig, ServeEngine

TIERS = ["f32", "bf16x2", "bf16"]
TIER_BAR = {"f32": 1e-5, "bf16x2": 5e-4, "bf16": 5e-2}
F32_EPS = float(np.finfo(np.float32).eps)
# f32 exp(-x) is exactly 0.0 for x > 150·ln2: mass the kernels never
# accumulate is not "dropped" by pruning (as in tests/test_pruning.py)
F32_EXP_UNDERFLOW = 103.97
BM, BN = 32, 64


def _clustered(n, d, k=8, spread=8.0, sigma=0.05, seed=0, offset=0.0,
               centers=0):
    """n points around k centres uniform in [0, spread]^d; the centres
    come from ``centers`` alone, so train and query sets drawn with other
    ``seed``s share them."""
    centers = np.random.default_rng([centers, d, k]).uniform(0.0, spread,
                                                             (k, d))
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, k, n)
    x = centers[lab] + sigma * rng.standard_normal((n, d)) + offset
    return x.astype(np.float32)


def bar(precision, pts, h):
    if precision != "f32":
        return TIER_BAR[precision]
    return max(1e-5, 8 * F32_EPS * float(np.max(np.sum(pts * pts, 1)))
               / (2 * h * h))


def assert_close(got, want, rtol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-6 * np.max(np.abs(want)))


def _t(a):
    """A JAX array (f32, int32 or bf16) as a torch tensor of the same
    bits."""
    if a is None:
        return None
    a = np.asarray(a)
    if a.dtype in (np.float32, np.int32):
        return torch.from_numpy(a.copy())
    return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)


def _index(x, method="kmeans"):
    """JAX's index of x, and the same index carried into the port."""
    jidx = jsp.build_index(jnp.asarray(x), method=method, seed=0)
    tidx = convert.index_from_state(
        np.asarray(jidx.labels),
        None if jidx.centroids is None else np.asarray(jidx.centroids),
        method, device="cpu")
    return jidx, tidx


def _inv(h):
    return 1.0 / (2.0 * h * h)


# ---------------------------------------------------------------------------
# (a) Spatial functions, given JAX's index.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {}, {"total_multiple": 96}, {"bucket_rows": True}, {"slack": 0.25}])
def test_cluster_layout_matches_jax(kw):
    x = _clustered(700, 5, seed=1)
    jidx, tidx = _index(x)
    np.testing.assert_array_equal(
        tsp.cluster_slots(tidx.labels, BN), jsp.cluster_slots(jidx.labels,
                                                              BN))
    jl = jsp.cluster_layout(jnp.asarray(x), jidx.labels, BN, **kw)
    tl = tsp.cluster_layout(torch.from_numpy(x), tidx.labels, BN, **kw)
    np.testing.assert_array_equal(tl.points.numpy(), np.asarray(jl.points))
    np.testing.assert_array_equal(tl.real.numpy(), np.asarray(jl.real))
    np.testing.assert_array_equal(tl.slots.numpy(), np.asarray(jl.slots))
    assert tl.block == jl.block
    np.testing.assert_array_equal(tl.points[tl.slots].numpy(), x)


def test_assign_and_morton_index_match_jax():
    x, y = _clustered(600, 4, seed=2), _clustered(150, 4, seed=3)
    jidx, tidx = _index(x)
    np.testing.assert_array_equal(
        tsp.assign(torch.from_numpy(y), tidx).numpy(),
        np.asarray(jsp.assign(jnp.asarray(y), jidx)))
    jm, _ = _index(x, "morton")
    tm = tsp.build_index(torch.from_numpy(x), method="morton")
    assert tm.centroids is None and tm.method == "morton"
    np.testing.assert_array_equal(tm.labels.numpy(), np.asarray(jm.labels))
    for n in (1, 100, 4096, 262144, 10**7):
        assert tsp.default_n_clusters(n) == jsp.default_n_clusters(n)


def test_kmeans_index_is_seeded_and_labels_every_point():
    x = torch.from_numpy(_clustered(900, 6, seed=4))
    a = tsp.build_index(x, seed=3)
    b = tsp.build_index(x, seed=3)
    torch.testing.assert_close(a.centroids, b.centroids, rtol=0, atol=0)
    assert torch.equal(a.labels, b.labels)
    assert a.labels.dtype == torch.int32 and a.labels.shape == (900,)
    k = tsp.default_n_clusters(900)
    assert a.centroids.shape == (k, 6)
    # every point sits in its nearest centroid's cluster
    d2 = ((x[:, None, :] - a.centroids[None]) ** 2).sum(-1)
    near = d2.gather(1, a.labels.long()[:, None])[:, 0]
    assert bool((near <= d2.min(1).values * (1 + 1e-5) + 1e-6).all())


@pytest.mark.parametrize("precision", TIERS)
def test_tile_metadata_matches_jax(precision):
    x = _clustered(900, 6, seed=5)
    jidx, tidx = _index(x)
    jl = jsp.cluster_layout(jnp.asarray(x), jidx.labels, BN)
    jrec = jops._score_operands(jl.points, precision)[4]
    jm = jsp.tile_metadata(jrec, jl.real, block=BN)
    tl = tsp.cluster_layout(torch.from_numpy(x), tidx.labels, BN)
    trec = tops._score_operands(tl.points, precision)[4]
    np.testing.assert_array_equal(trec.numpy(), np.asarray(jrec))
    tm = tsp.tile_metadata(trec, tl.real, block=BN)
    np.testing.assert_array_equal(tm.counts.numpy(), np.asarray(jm.counts))
    np.testing.assert_array_equal(tm.max_abs.numpy(), np.asarray(jm.max_abs))
    atol = 8 * F32_EPS * float(np.abs(x).max())
    for name in ("centroids", "radii"):
        np.testing.assert_allclose(getattr(tm, name).numpy(),
                                   np.asarray(getattr(jm, name)),
                                   rtol=1e-6, atol=atol, err_msg=name)


def _meta_to_torch(meta):
    return tsp.TileMeta(*[_t(a) for a in meta])


@pytest.mark.parametrize("h", [0.2, 0.6])
@pytest.mark.parametrize("eps", [0.0, 1e-7])
@pytest.mark.parametrize("kind", ["kde", "laplace", "score"])
def test_tile_map_matches_jax(kind, eps, h):
    x, y = _clustered(900, 6, seed=6), _clustered(250, 6, seed=7)
    jidx, _ = _index(x)
    jl = jsp.cluster_layout(jnp.asarray(x), jidx.labels, BN)
    jm = jsp.tile_metadata(jl.points, jl.real, block=BN)
    jq = jsp.cluster_layout(jnp.asarray(y), jsp.assign(jnp.asarray(y), jidx),
                            BM, bucket_rows=True)
    inv = np.float32(_inv(h))
    want = jsp.tile_map(jq.points, jm, jnp.asarray(inv).reshape(1, 1), eps,
                        block_m=BM, kind=kind)
    got = tsp.tile_map(_t(jq.points), _meta_to_torch(jm),
                       torch.tensor([[inv]]), eps, block_m=BM, kind=kind)
    # float64 exponent bound: pairs near a decision threshold may differ
    yq = np.asarray(jq.points, np.float64)
    cen = np.asarray(jm.centroids, np.float64)
    dist = np.sqrt(((yq[:, None] - cen[None]) ** 2).sum(-1))
    dmin = dist.reshape(-1, BM, cen.shape[0]).min(1)
    dmin = np.maximum(dmin - np.asarray(jm.radii, np.float64), 0.0)
    arg = tsp.MARGIN * dmin * dmin * float(inv)
    near = np.abs(arg - tsp.UNDERFLOW_ARG) <= 1e-4 * tsp.UNDERFLOW_ARG
    if eps > 0:
        near |= np.abs(arg + math.log(eps)) <= 1e-4 * arg + 0.1
    keep, jkeep = got.keep.numpy(), np.asarray(want.keep)
    np.testing.assert_array_equal(keep[~near], jkeep[~near])
    pts = np.concatenate([yq[np.asarray(jq.real)], cen])
    rtol = max(1e-5, 8 * F32_EPS * 2 * float((pts * pts).sum(1).max())
               * float(inv))
    np.testing.assert_allclose(got.err_bound.numpy(),
                               np.asarray(want.err_bound), rtol=rtol,
                               atol=1e-30)
    assert 0 < keep.mean() < 1  # the case prunes something and keeps some


@pytest.mark.parametrize("case", ["random", "none_kept", "all_kept",
                                  "empty_row", "no_bucket", "wide"])
def test_visit_lists_bit_for_bit(case):
    rng = np.random.default_rng(8)
    shape = (37, 300) if case == "wide" else (13, 20)
    keep = rng.random(shape) < 0.3
    if case == "none_kept":
        keep[:] = False
    elif case == "all_kept":
        keep[:] = True
    elif case == "empty_row":
        keep[[0, 5]] = False
    want = jsp.visit_lists(jnp.asarray(keep),
                           bucket_visits=case != "no_bucket")
    got = tsp.visit_lists(torch.from_numpy(keep),
                          bucket_visits=case != "no_bucket")
    assert got.counts.dtype == torch.int32 and got.tile_map.dtype == torch.int32
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_array_equal(got.tile_map.numpy(),
                                  np.asarray(want.tile_map))
    assert got.max_visits == want.max_visits
    assert got.occupancy == want.occupancy


@pytest.mark.parametrize("kind", ["kde", "laplace", "score"])
def test_point_mass_bound_matches_jax(kind):
    x, y = _clustered(600, 5, seed=9), _clustered(100, 5, seed=10) + 1.0
    jidx, _ = _index(x)
    jl = jsp.cluster_layout(jnp.asarray(x), jidx.labels, BN)
    jm = jsp.tile_metadata(jl.points, jl.real, block=BN)
    h = 0.5
    want = jsp.point_mass_bound(jnp.asarray(y), jm, _inv(h), kind=kind)
    got = tsp.point_mass_bound(torch.from_numpy(y), _meta_to_torch(jm),
                               _inv(h), kind=kind)
    pts = np.concatenate([y, np.asarray(jm.centroids)])
    rtol = max(1e-5, 8 * F32_EPS * 2 * float((pts * pts).sum(1).max())
               * _inv(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=1e-30)
    for args in ((1e-3, 5, 0.4), (1e-6, 16, 0.7)):
        assert (tsp.epsilon_for_density_error(*args)
                == jsp.epsilon_for_density_error(*args))


# ---------------------------------------------------------------------------
# (b) The pruned kernels' plain versions against the Pallas kernels.
# ---------------------------------------------------------------------------


def _visits(keep, drop_row=0):
    """JAX's visit lists of ``keep`` with row tile ``drop_row`` emptied —
    a zero-count row tile, which must sum to exactly zero."""
    keep = np.asarray(keep).copy()
    keep[drop_row] = False
    vl = jsp.visit_lists(jnp.asarray(keep))
    assert int(np.asarray(vl.counts)[drop_row]) == 0
    assert 0 < vl.occupancy < 1
    return vl


@pytest.mark.parametrize("laplace", [False, True])
@pytest.mark.parametrize("precision", TIERS)
def test_pruned_kde_plain_matches_pallas(precision, laplace):
    x, y = _clustered(700, 6, seed=11), _clustered(200, 6, seed=12)
    h = 0.5
    jidx, _ = _index(x)
    cols = jops.prepare_train_columns(jnp.asarray(x), block_n=BN,
                                      precision=precision, clustered=True,
                                      index=jidx)
    jq = jsp.cluster_layout(jnp.asarray(y), jsp.assign(jnp.asarray(y), jidx),
                            BM, bucket_rows=True)
    y_hi, y_lo, nrm_y, yrec = jops._cast_queries(jq.points, precision)
    inv = jops._inv2h2(h)
    tm = jsp.tile_map(yrec, cols.meta, inv, 0.0, block_m=BM,
                      kind="laplace" if laplace else "kde")
    vl = _visits(tm.keep)
    want = jfp.flash_kde_pallas_pruned(
        vl.counts, vl.tile_map, y_hi, nrm_y, cols.xt, cols.nrm_x, inv, y_lo,
        cols.xt_lo, block_m=BM, block_n=BN, max_visits=vl.max_visits,
        interpret=True, laplace=laplace)
    args = [_t(a) for a in (vl.counts, vl.tile_map, y_hi, nrm_y, cols.xt,
                            cols.nrm_x, inv, y_lo, cols.xt_lo)]
    before = dataclasses.astuple(tfp.kde_counts)
    got = tfp.flash_kde_pruned(*args, block_m=BM, block_n=BN,
                               laplace=laplace)
    plain = tfp.flash_kde_pruned_plain(*args, block_m=BM, block_n=BN,
                                       laplace=laplace)
    # CPU tensors: the plain version, and no kernel launch counted
    assert dataclasses.astuple(tfp.kde_counts) == before
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    assert got.shape == (y_hi.shape[0], 1) and got.dtype == torch.float32
    assert bool((got[:BM] == 0).all())     # the zero-count row tile
    real = np.asarray(jq.real)
    pts = np.concatenate([x, y])
    w = np.asarray(want)[real, 0]
    if laplace:
        # Laplace sums cross zero: bound the deviation by the row scale
        np.testing.assert_allclose(got.numpy()[real, 0] / np.abs(w).max(),
                                   w / np.abs(w).max(), rtol=0,
                                   atol=bar(precision, pts, h))
    else:
        assert_close(got.numpy()[real, 0], w, bar(precision, pts, h))


@pytest.mark.parametrize("precision", TIERS)
def test_pruned_score_plain_matches_pallas(precision):
    x = _clustered(400, 5, seed=13)
    h = 0.5
    jidx, _ = _index(x)
    lay = jsp.cluster_layout(jnp.asarray(x), jidx.labels, BN,
                             total_multiple=math.lcm(BM, BN))
    x_ops, xt_ops, xaug_ops, nrm, xrec = jops._score_operands(lay.points,
                                                              precision)
    inv = jops._inv2h2(h)
    meta = jsp.tile_metadata(xrec, lay.real, block=BN)
    tm = jsp.tile_map(xrec, meta, inv, 0.0, block_m=BM, kind="score")
    vl = _visits(tm.keep, drop_row=1)
    want = jfp.flash_score_pallas_pruned(
        vl.counts, vl.tile_map, x_ops[0], nrm, xt_ops[0], xaug_ops[0], inv,
        x_ops[1], xt_ops[1], xaug_ops[1], block_m=BM, block_n=BN,
        max_visits=vl.max_visits, interpret=True)
    args = [_t(a) for a in (vl.counts, vl.tile_map, x_ops[0], nrm, xt_ops[0],
                            xaug_ops[0], inv, x_ops[1], xt_ops[1],
                            xaug_ops[1])]
    got = tfp.flash_score_pruned(*args, block_m=BM, block_n=BN)
    plain = tfp.flash_score_pruned_plain(*args, block_m=BM, block_n=BN)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    assert got.shape == (lay.points.shape[0], 6)
    assert bool((got[BM:2 * BM] == 0).all())   # the zero-count row tile
    real = np.asarray(lay.real)
    assert_close(got.numpy()[real], np.asarray(want)[real],
                 bar(precision, x, h))


def test_pruned_cuda_wrappers_refuse_cpu_tensors():
    x, y = _clustered(256, 4, seed=14), _clustered(64, 4, seed=15)
    cols = tops.prepare_train_columns(torch.from_numpy(x), block_n=BN,
                                      clustered=True)
    yp = tops._pad_to(torch.from_numpy(y), BM)
    y_hi, _, nrm_y, _ = tops._cast_queries(yp, "f32")
    mt = yp.shape[0] // BM
    counts = torch.ones(mt, dtype=torch.int32)
    tmap = torch.zeros((mt, 1), dtype=torch.int32)
    inv = tops._inv2h2(0.5, yp.device)
    before = (dataclasses.astuple(tfp.score_counts),
              dataclasses.astuple(tfp.kde_counts))
    with pytest.raises(ValueError, match="CUDA"):
        tfp.flash_kde_pruned_cuda(counts, tmap, y_hi, nrm_y, cols.xt,
                                  cols.nrm_x, inv, block_m=BM, block_n=BN)
    xs, xts, xaug, nrm, _ = tops._score_operands(cols.xt.T.contiguous(),
                                                 "f32")
    mt = xs[0].shape[0] // BM
    with pytest.raises(ValueError, match="CUDA"):
        tfp.flash_score_pruned_cuda(
            torch.ones(mt, dtype=torch.int32),
            torch.zeros((mt, 1), dtype=torch.int32), xs[0], nrm, xts[0],
            xaug[0], inv, block_m=BM, block_n=BN)
    assert (dataclasses.astuple(tfp.score_counts),
            dataclasses.astuple(tfp.kde_counts)) == before
    with pytest.raises(ValueError, match="row tiles"):
        tfp.flash_kde_pruned(counts[:-1], tmap[:-1], y_hi, nrm_y, cols.xt,
                             cols.nrm_x, inv, block_m=BM, block_n=BN)


@functools.lru_cache(maxsize=None)
def _clustered_columns():
    x = torch.from_numpy(_clustered(4096, 4, k=16, seed=31))
    return tops.prepare_train_columns(x, block_n=BN, clustered=True)


@pytest.mark.parametrize("m", [1, 3, 17, 128, 1000, 4096])
def test_pruned_split_plan_walks_each_visit_list_once(m):
    """B4's splits as the kernel walks them (``SplitPlan.ranges(count)``):
    every row tile's slots 0 .. counts[i] once each and in order, a count
    of 0 walking nothing and the largest count every column tile, in runs
    whose length comes from n and block_n alone — not from m, the visit
    width or the counts."""
    cols = _clustered_columns()
    n = cols.xt.shape[1]
    y = torch.from_numpy(_clustered(m, 4, k=16, seed=32))
    ql = tsp.cluster_layout(y, tsp.assign(y, cols.index), BM,
                            bucket_rows=True)
    _, _, _, yrec = tops._cast_queries(ql.points, "f32")
    keep = tsp.tile_map(yrec, cols.meta, tops._inv2h2(0.5, y.device), 0.0,
                        block_m=BM, kind="kde").keep
    # and two row tiles more: one that visits nothing, one everything
    keep = torch.cat([keep, torch.zeros_like(keep[:1]),
                      torch.ones_like(keep[:1])])
    vl = tsp.visit_lists(keep)
    counts = vl.counts.tolist()
    assert min(counts) == 0 and max(counts) == vl.max_visits == n // BN
    plan = tfk.plan_splits(n, BN, vl.max_visits)
    assert plan.per_split == tfk.plan_splits(n, BN).per_split
    assert plan.scratch_shape(ql.points.shape[0]) == (
        plan.splits, ql.points.shape[0])
    for i, count in enumerate(counts):
        ranges = plan.ranges(count)
        assert len(ranges) == plan.splits
        assert [v for a, b in ranges for v in range(a, b)] == \
            list(range(count))
        tiles = vl.tile_map[i, :count].tolist()
        assert tiles == sorted(set(tiles))


@pytest.mark.parametrize("n", [4096, 32768])
def test_pruned_score_plan_walks_each_visit_list_once(n):
    """B3's splits as the kernel walks them: every row tile's slots 0 ..
    counts[i] once each and in order, in runs planned from n, block_n, d
    and the visit width alone (the counts do not enter), enough of them
    for the card at n = 32768; a row tile that visits nothing walks
    nothing."""
    d = 4
    x = torch.from_numpy(_clustered(n, d, k=16, seed=33))
    index = tsp.build_index(x, seed=0)
    lay = tsp.cluster_layout(x, index.labels, BN,
                             total_multiple=math.lcm(BM, BN))
    _, _, _, _, xrec = tops._score_operands(lay.points, "f32")
    meta = tsp.tile_metadata(xrec, lay.real, block=BN)
    keep = tsp.tile_map(xrec, meta, tops._inv2h2(0.5, x.device), 0.0,
                        block_m=BM, kind="score").keep
    keep = torch.cat([keep, torch.zeros_like(keep[:1])])
    vl = tsp.visit_lists(keep)
    rows = lay.points.shape[0]
    plan = tfs.plan_score_splits(rows, BN, d, vl.max_visits)
    assert plan == tfs.plan_score_splits(rows, BN, d, vl.max_visits)
    assert plan.slots == vl.max_visits
    counts = vl.counts.tolist()
    assert counts[-1] == 0
    for count in counts:
        ranges = plan.ranges(count)
        assert len(ranges) == plan.splits
        assert [v for a, b in ranges for v in range(a, b)] == \
            list(range(count))
    if n == 32768:
        assert (rows // tfs.SCORE_ROWS) * plan.splits >= 2 * 132


# ---------------------------------------------------------------------------
# (c) The ops wrappers at prune=0.0: against JAX and the port's dense path.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", TIERS)
def test_flash_kde_prune0_matches_jax_and_dense(precision):
    x, y = _clustered(900, 6, seed=16), _clustered(300, 6, seed=17)
    h = 0.35
    kw = dict(precision=precision, block_m=BM, block_n=128)
    want = jops.flash_kde(jnp.asarray(x), jnp.asarray(y), h, interpret=True,
                          prune=0.0, **kw)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    got = tops.flash_kde(xt, yt, h, prune=0.0, **kw)
    dense = tops.flash_kde(xt, yt, h, prune="off", **kw)
    rtol = bar(precision, np.concatenate([x, y]), h)
    assert_close(got, want, rtol)
    assert_close(got, dense, bar("f32", np.concatenate([x, y]), h))
    np.testing.assert_array_equal(got.numpy() == 0, dense.numpy() == 0)
    # a second call reuses the cached clustered columns of the same x
    assert tops._cached_columns(xt, block_n=128, precision=precision,
                                seed=0) is tops._cached_columns(
        xt, block_n=128, precision=precision, seed=0)


@pytest.mark.parametrize("precision", TIERS)
def test_flash_score_stats_prune0_matches_jax_and_dense(precision):
    x = _clustered(512, 5, seed=18)
    h = 0.5
    kw = dict(precision=precision, block_m=BM, block_n=128)
    js0, js1 = jops.flash_score_stats(jnp.asarray(x), h, interpret=True,
                                      prune=0.0, **kw)
    ts0, ts1 = tops.flash_score_stats(torch.from_numpy(x), h, prune=0.0,
                                      **kw)
    ds0, ds1 = tops.flash_score_stats(torch.from_numpy(x), h, prune="off",
                                      **kw)
    rtol = bar(precision, x, h)
    assert_close(ts0, js0, rtol)
    assert_close(ts1, js1, rtol)
    f32 = bar("f32", x, h)
    assert_close(ts0, ds0, f32)
    assert_close(ts1, ds1, f32)


@pytest.mark.parametrize("precision", TIERS)
def test_flash_sdkde_prune0_matches_jax_and_dense(precision):
    x, y = _clustered(512, 5, seed=19), _clustered(150, 5, seed=20)
    h = 0.4
    kw = dict(precision=precision, block_m=BM, block_n=128)
    want = jops.flash_sdkde(jnp.asarray(x), jnp.asarray(y), h,
                            interpret=True, prune=0.0, **kw)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    got = tops.flash_sdkde(xt, yt, h, prune=0.0, **kw)
    dense = tops.flash_sdkde(xt, yt, h, prune="off", **kw)
    pts = np.concatenate([x, y])
    assert_close(got, want, bar(precision, pts, h))
    assert_close(got, dense, bar("f32", pts, h))


def _reference_clustered(n, d, seed, k=8, spread=8.0, sigma=0.05):
    """``tests/test_pruning.py``'s own data (jax.random), as numpy."""
    kc, kl, kn = jax.random.split(jax.random.PRNGKey(seed), 3)
    centres = jax.random.uniform(kc, (k, d), minval=0.0, maxval=spread)
    lab = jax.random.randint(kl, (n,), 0, k)
    return np.array(centres[lab] + sigma * jax.random.normal(kn, (n, d)),
                    np.float32)


def test_bf16x2_pruned_dense_gap_is_within_the_error_model():
    """The reference's exact-mode check (pruned == dense at rtol 1e-6,
    ``test_pruning.py::test_exact_mode_kde_matches_dense[bf16x2]``) fails
    on its own data by ~1e-4 (ROADMAP C).  The port's two paths run one
    Gram routine on the same cast operands, so on that data they meet the
    reference's 1e-6, far inside the norm-trick bar 8·eps·max‖x‖²/(2h²)."""
    x = _reference_clustered(900, 6, seed=20)
    y = _reference_clustered(300, 6, seed=21)
    kw = dict(precision="bf16x2", block_m=BM, block_n=128)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    dense = tops.flash_kde(xt, yt, 0.35, prune="off", **kw).double()
    pruned = tops.flash_kde(xt, yt, 0.35, prune=0.0, **kw).double()
    np.testing.assert_allclose(pruned.numpy(), dense.numpy(), rtol=1e-6,
                               atol=1e-20)
    assert 1e-6 < bar("f32", np.concatenate([x, y]), 0.35)
    np.testing.assert_array_equal(pruned.numpy() == 0, dense.numpy() == 0)


# ---------------------------------------------------------------------------
# (d) epsilon > 0: the certificate dominates the float64 dropped mass.
# ---------------------------------------------------------------------------

GEOMETRIES = {
    "clustered": lambda: (_clustered(900, 6, seed=31),
                          _clustered(250, 6, seed=32)),
    "huge_offset": lambda: (_clustered(900, 6, seed=33, offset=1000.0),
                            _clustered(250, 6, seed=34, offset=1000.0)),
    "duplicates": lambda: (np.tile(_clustered(90, 6, seed=35), (10, 1)),
                           _clustered(250, 6, seed=36)),
    "outlier": lambda: (np.concatenate([_clustered(899, 6, seed=37),
                                        np.full((1, 6), 250.0, np.float32)]),
                        _clustered(250, 6, seed=38)),
    "far_queries": lambda: (_clustered(900, 6, seed=39),
                            _clustered(250, 6, seed=40) + 500.0),
}


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("kind", ["kde", "laplace"])
def test_certificate_dominates_f64_dropped_mass(geometry, kind):
    x, y = GEOMETRIES[geometry]()
    h, eps = 0.4, 1e-7
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    index = tsp.build_index(xt, seed=0)          # the port's own clustering
    xl = tsp.cluster_layout(xt, index.labels, BN)
    meta = tsp.tile_metadata(xl.points, xl.real, block=BN)
    ql = tsp.cluster_layout(yt, tsp.assign(yt, index), BM)
    tm = tsp.tile_map(ql.points, meta, torch.tensor([[_inv(h)]]), eps,
                      block_m=BM, kind=kind)
    xp = xl.points.double().numpy()
    yp = ql.points.double().numpy()
    keep, err = tm.keep.numpy(), tm.err_bound.double().numpy()
    d = xp.shape[1]
    scaled = ((yp[:, None, :] - xp[None, :, :]) ** 2).sum(-1) / (2 * h * h)
    phi = np.where(scaled > F32_EXP_UNDERFLOW, 0.0, np.exp(-scaled))
    contrib = np.abs(phi * (1 + d / 2 - scaled)) if kind == "laplace" else phi
    contrib[:, ~xl.real.numpy()] = 0.0
    mt, t = keep.shape
    for i in range(mt):
        rows = contrib[i * BM:(i + 1) * BM]
        dropped = np.zeros(rows.shape[0])
        for j in range(t):
            if not keep[i, j]:
                dropped += rows[:, j * BN:(j + 1) * BN].sum(axis=1)
        assert dropped.max() <= err[i] * (1 + 1e-5) + 1e-300, (geometry, i)


def test_score_certificate_dominates_f64_dropped_mass():
    x = _clustered(600, 5, seed=41)
    h, eps = 0.4, 1e-7
    xt = torch.from_numpy(x)
    index = tsp.build_index(xt, seed=0)
    lay = tsp.cluster_layout(xt, index.labels, BN,
                             total_multiple=math.lcm(BM, BN))
    meta = tsp.tile_metadata(lay.points, lay.real, block=BN)
    tm = tsp.tile_map(lay.points, meta, torch.tensor([[_inv(h)]]), eps,
                      block_m=BM, kind="score")
    keep, err = tm.keep.numpy(), tm.err_bound.double().numpy()
    x64 = lay.points.double().numpy()
    real = lay.real.numpy()
    scaled = ((x64[:, None] - x64[None]) ** 2).sum(-1) / (2 * h * h)
    phi = np.where(scaled > F32_EXP_UNDERFLOW, 0.0, np.exp(-scaled))
    phi[:, ~real] = 0.0
    w = np.abs(np.concatenate([x64, np.ones((x64.shape[0], 1))], axis=1))
    assert 0 < keep.mean() < 1
    for i in range(keep.shape[0]):
        rows = phi[i * BM:(i + 1) * BM]
        dropped = np.zeros(BM)
        for j in range(keep.shape[1]):
            if not keep[i, j]:
                sl = slice(j * BN, (j + 1) * BN)
                dropped = np.maximum(dropped, (rows[:, sl] @ w[sl]).max(1))
        assert dropped.max() <= err[i] * (1 + 1e-5) + 1e-300, i


def test_prune_1e7_sums_keep_f64_error_within_certificate():
    """End to end through the ops path: every row's float64 error stays
    within its row tile's certificate plus the f32 bar of its sum."""
    x, y = _clustered(1200, 6, seed=42), _clustered(400, 6, seed=43)
    h, eps = 0.35, 1e-7
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    cols = tops.prepare_train_columns(xt, block_n=BN, clustered=True)
    got = tops._pruned_eval_sums(yt, cols, h, eps, precision="f32",
                                 block_m=BM, block_n=BN).double()
    ql = tsp.cluster_layout(yt, tsp.assign(yt, cols.index), BM,
                            bucket_rows=True)
    tm = tsp.tile_map(ql.points, cols.meta, torch.tensor([[_inv(h)]]), eps,
                      block_m=BM, kind="kde")
    row_err = tm.err_bound.double()[ql.slots // BM]
    assert float(row_err.max()) > 0            # something was dropped
    exact = tkde.kde_eval(xt.double(), yt.double(), h) * (
        x.shape[0] * (2 * math.pi) ** 3 * h**6)
    noise = bar("f32", np.concatenate([x, y]), h) * exact + 1e-30
    assert bool(((got - exact).abs() <= row_err * (1 + 1e-5) + noise).all())
    assert eps * x.shape[0] >= float(row_err.max())


# ---------------------------------------------------------------------------
# (e) The prune policy.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prune, cols, block_n", [
    ("off", 10**6, 512), ("auto", 1024, 512), ("auto", 10**6, 512),
    ("auto", 16383, 128), ("auto", 16384, 128), ("auto", 16384, 8192),
    ("auto", 32768, 8192), (1e-8, 64, 512), (0.0, 64, 512), (0, 64, 128),
    (None, 10**6, 128), (False, 10**6, 128)])
def test_resolve_prune_policy_matches_jax(prune, cols, block_n):
    assert tops.resolve_prune(prune, cols, block_n) == jops.resolve_prune(
        prune, cols, block_n)
    assert tops.PRUNE_AUTO_MIN_COLS == jops.PRUNE_AUTO_MIN_COLS
    assert tops.PRUNE_AUTO_MIN_TILES == jops.PRUNE_AUTO_MIN_TILES


@pytest.mark.parametrize("bad", [-1.0, "both"])
def test_resolve_prune_rejects_what_jax_rejects(bad):
    for resolve in (tops.resolve_prune, jops.resolve_prune):
        with pytest.raises(ValueError):
            resolve(bad, 10**6, 512)


# ---------------------------------------------------------------------------
# (f) Serving and the estimator at prune=0.0, and "auto" at its threshold.
# ---------------------------------------------------------------------------


def _serve_cfg(**kw):
    base = dict(backend="flash", method="sdkde", block_m=BM, block_n=128,
                block=128, min_batch=16, max_batch=128, device="cpu")
    base.update(kw)
    return ServeConfig(**base)


def test_serve_prune0_matches_torch_backend_with_one_shared_index():
    x, y = _clustered(512, 5, seed=44), _clustered(200, 5, seed=45)
    h = 0.4
    eng = ServeEngine(_serve_cfg(prune=0.0))
    prep = eng.register("ds", x, h=h)
    ref = ServeEngine(_serve_cfg(backend="torch", prune=0.0))
    ref.register("ds", x, h=h)
    sizes = (1, 33, 200)
    for tier in TIERS:
        for m in sizes:
            got = eng.query(QueryRequest(key="ds", points=y[:m],
                                         precision=tier)).value
            want = ref.query(QueryRequest(key="ds", points=y[:m])).value
            assert got.shape == (m,)
            assert_close(got, want, TIER_BAR[tier]
                         if tier != "f32" else bar("f32", x, h))
    cols = [prep.columns_for(t) for t in TIERS]
    assert all(c.meta is not None for c in cols)
    assert all(c.index is prep.index for c in cols)
    many = eng.query_many([QueryRequest(key="ds", points=y[a:b])
                           for a, b in ((0, 5), (5, 60), (60, 200))])
    want = ref.query(QueryRequest(key="ds", points=y)).value
    assert_close(torch.cat([a.value for a in many]), want,
                 bar("f32", x, h))


def test_sdkde_prune0_matches_torch_backend():
    x, y = _clustered(800, 5, seed=46), _clustered(200, 5, seed=47)
    cfg = dict(device="cpu", block_m=BM, block_n=128)
    got = SDKDE(0.4, EstimatorConfig(prune=0.0, **cfg)).fit(x).evaluate(y)
    want = SDKDE(0.4, EstimatorConfig(backend="torch", **cfg)).fit(
        x).evaluate(y)
    assert_close(got, want, bar("f32", np.concatenate([x, y]), 0.4))


def test_serve_pruned_matches_jax_on_identical_layouts():
    """JAX's pruned serving engine and the port's, on JAX's debiased set
    and JAX's clustering: the same layouts, maps and visit lists."""
    x, y = _clustered(512, 5, seed=48), _clustered(200, 5, seed=49)
    jeng = JServeEngine(JServeConfig(
        backend="pallas", method="sdkde", interpret=True, block_m=BM,
        block_n=128, block=128, min_batch=16, max_batch=128, prune=0.0,
        rff="off"))
    jprep = jeng.register("ds", jnp.asarray(x), h=0.4)
    jcols = jprep.columns_for("f32")
    tidx = convert.index_from_state(np.asarray(jcols.index.labels),
                                    np.asarray(jcols.index.centroids),
                                    device="cpu")
    prep = convert.prepared_from_state(
        "ds", np.asarray(jprep.points), jprep.h, jprep.n_true, jprep.d,
        jprep.norm, block_m=BM, block_n=128,
        config=_serve_cfg(prune=0.0), index=tidx)
    tcols = prep.columns_for("f32")
    np.testing.assert_array_equal(tcols.xt.numpy(), np.asarray(jcols.xt))
    np.testing.assert_array_equal(tcols.meta.counts.numpy(),
                                  np.asarray(jcols.meta.counts))
    eng = ServeEngine(_serve_cfg(prune=0.0))
    eng.registry.adopt(prep)
    for m in (5, 200):
        want = jeng.query(JRequest(key="ds", points=jnp.asarray(y[:m])))
        got = eng.query(QueryRequest(key="ds", points=y[:m]))
        assert_close(got.value, np.asarray(want.value), bar("f32", x, 0.4))


def test_auto_engages_at_16384_columns(monkeypatch):
    """The default ``prune="auto"`` takes B3/B4 at 16384 train points —
    on the CPU through their plain versions — and stays dense below."""
    calls = {"score": 0, "kde": 0}
    score, kde = tfp.flash_score_pruned_plain, tfp.flash_kde_pruned_plain

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tfp, "flash_score_pruned_plain", spy("score", score))
    monkeypatch.setattr(tfp, "flash_kde_pruned_plain", spy("kde", kde))
    rng = np.random.default_rng(50)
    x = rng.standard_normal((16384, 2)).astype(np.float32)
    y = rng.standard_normal((64, 2)).astype(np.float32)
    cfg = EstimatorConfig(device="cpu", block_m=128, block_n=128)
    assert cfg.prune == "auto"
    dens = SDKDE(0.3, cfg).fit(x).evaluate(y)
    assert calls == {"score": 1, "kde": 1}
    SDKDE(0.3, cfg).fit(x[:16383]).evaluate(y)
    assert calls == {"score": 1, "kde": 1}
    off = EstimatorConfig(device="cpu", block_m=128, block_n=128,
                          prune="off")
    dense = SDKDE(0.3, off).fit(x).evaluate(y)
    assert_close(dens, dense, bar("f32", np.concatenate([x, y]), 0.3))


# ---------------------------------------------------------------------------
# (g) index_from_state.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["kmeans", "morton"])
def test_index_from_state_round_trips(method):
    x = _clustered(500, 4, seed=51)
    jidx, tidx = _index(x, method)
    assert tidx.method == method
    assert tidx.labels.dtype == torch.int32
    np.testing.assert_array_equal(tidx.labels.numpy(),
                                  np.asarray(jidx.labels))
    if method == "kmeans":
        assert tidx.centroids.dtype == torch.float32
        np.testing.assert_array_equal(tidx.centroids.numpy(),
                                      np.asarray(jidx.centroids))
        back = jsp.SpatialIndex(jnp.asarray(tidx.labels.numpy()),
                                jnp.asarray(tidx.centroids.numpy()), method)
        np.testing.assert_array_equal(
            np.asarray(jsp.assign(jnp.asarray(x), back)),
            np.asarray(jsp.assign(jnp.asarray(x), jidx)))
    else:
        assert tidx.centroids is None
    cols = tops.prepare_train_columns(torch.from_numpy(x), block_n=BN,
                                      clustered=True, index=tidx)
    assert cols.index is tidx
