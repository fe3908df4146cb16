"""The port's streaming path against the JAX package.

``repro_torch.stream`` (delta pass, config, ``StreamingSDKDE``), the
layout helpers it keeps in place (``spatial.place_points`` /
``merge_tile_meta`` / ``tile_metadata_update``, ``ops.columns_from_layout``
/ ``update_train_columns``), ``SDKDE.append/evict`` and the registry and
engine hooks, held against ``repro`` on the same numpy inputs, at the
sizes of ``tests/test_streaming.py`` (n ≤ 1024, d 4, block_n 64).

Bars, set from the error model before the runs:
  * f32 sums of φ: rtol ``max(1e-5, 8·eps·max‖x‖²/(2h²))`` — the two
    packages round the norm-trick distance differently (ROADMAP C); S1
    cancels, so it is held absolutely at that bar times Σφ·max|x|;
  * densities: the same rtol with an atol of 1e-6·peak (deep-tail
    rounding), the reduced tiers at their tier bars (bf16x2 5e-4, bf16
    5e-2, atol 1e-5 / 5e-3 of the peak, as ``repro``'s own tests);
  * slots, masks, labels, dirty-tile sets, generations: exact; f64 stat
    bookkeeping (round trips): 1e-12.
The JAX side is ``repro``'s streaming estimator on its ``pallas`` layout
(no Pallas kernel runs while it is updated) and ``repro.core.kde``'s
``jnp`` math for refits.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import estimator as jest
from repro.core import kde as jkde
from repro.kernels import ops as jops
from repro.kernels import spatial as jsp
from repro.stream import StreamingSDKDE as JStream
from repro.stream import delta as jdelta
from repro_torch import convert, obs
from repro_torch import fault_injection as tfi
from repro_torch.core.estimator import SDKDE, EstimatorConfig
from repro_torch.kernels import ops as tops
from repro_torch.kernels import spatial as tsp
from repro_torch.serve import QueryRequest, ServeConfig, ServeEngine
from repro_torch.stream import StreamConfig, StreamingSDKDE
from repro_torch.stream import delta as tdelta

D, H = 4, 0.5
EPS32 = float(np.finfo(np.float32).eps)
TIER_BARS = {"f32": (1e-5, 1e-6), "bf16x2": (5e-4, 1e-5),
             "bf16": (5e-2, 5e-3)}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((512, D)).astype(np.float32),
            rng.standard_normal((64, D)).astype(np.float32),
            rng.standard_normal((128, D)).astype(np.float32))


def f32_bar(*pts, h=H) -> float:
    sq = max(float(np.max(np.sum(np.asarray(p, np.float64) ** 2, axis=1)))
             for p in pts)
    return max(1e-5, 8 * EPS32 * sq / (2 * h * h))


def assert_dens(got, want, rtol, atol_frac=1e-6):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_frac * float(np.abs(want).max()))


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfg(**kw):
    base = dict(backend="flash", method="sdkde", block_m=8, block_n=64,
                min_batch=16, max_batch=128, stream=True,
                staleness_budget=0, device="cpu")
    base.update(kw)
    return ServeConfig(**base)


def _q(eng, key, y, **kw):
    return eng.query(QueryRequest(key=key, points=y, **kw)).value.numpy()


def _refit(x_live, y, method="sdkde"):
    fn = {"kde": jkde.kde_eval, "sdkde": jkde.sdkde_eval,
          "laplace": jkde.laplace_kde_eval}[method]
    return np.asarray(fn(jnp.asarray(x_live), jnp.asarray(y), H, block=256))


# ---------------------------------------------------------------------------
# The delta score pass.
# ---------------------------------------------------------------------------


def _stats_close(got, want, pts, what):
    s0, s1 = (np.asarray(v, np.float64) for v in got)
    w0, w1 = want
    bar = f32_bar(pts)
    np.testing.assert_allclose(s0, w0, rtol=bar, err_msg=what)
    mass = w0[:, None] * float(np.abs(pts).max())
    assert np.all(np.abs(s1 - w1) <= bar * mass + 1e-300), what


@pytest.mark.parametrize("op", ["cross", "append", "evict"])
def test_delta_matches_repro(data, op):
    x, xa, _ = data
    both = np.concatenate([x, xa])
    if op == "cross":
        got = tdelta.cross_stats(_t(x), _t(xa), H, block=100)
        want = jdelta.cross_stats(x, xa, H, block=100)
        _stats_close(got, want, both, "cross")
    elif op == "append":
        got = tdelta.append_delta(_t(x), _t(xa), H, block=100)
        want = jdelta.append_delta(x, xa, H, block=100)
        _stats_close(got[:2], want[:2], both, "append live")
        _stats_close(got[2:], want[2:], both, "append new")
    else:
        got = tdelta.evict_delta(_t(x[64:]), _t(x[:64]), H)
        want = jdelta.evict_delta(x[64:], x[:64], H)
        _stats_close(got, want, x, "evict")


def test_apply_shift_matches_repro_bit_for_bit(data):
    """f64 end to end on the same statistics: the same IEEE operations in
    the same order, so the debiased points are equal bit for bit."""
    x, _, _ = data
    s0, s1 = jdelta.initial_stats(x, H)
    got = tdelta.apply_shift(_t(x), _t(s0), _t(s1), H, 0.7 * H).numpy()
    want = jdelta.apply_shift(x, s0, s1, H, 0.7 * H)
    np.testing.assert_array_equal(got, want)


def test_stats_roundtrip_and_within_batch_terms(data):
    x, xa, _ = data
    s0, s1 = tdelta.initial_stats(_t(x), H)
    ds0, ds1, s0n, s1n = tdelta.append_delta(_t(x), _t(xa), H)
    es0, es1 = tdelta.evict_delta(_t(x), _t(xa), H)
    # f64 accumulation: += / -= cancel to f64 rounding, not f32 drift
    np.testing.assert_allclose(s0 + ds0 - es0, s0, rtol=1e-12)
    np.testing.assert_allclose(s1 + ds1 - es1, s1, rtol=1e-12, atol=1e-12)
    w0, w1 = tdelta.initial_stats(_t(np.concatenate([x, xa])), H)
    np.testing.assert_allclose(torch.cat([s0 + ds0, s0n]), w0, rtol=1e-10)
    np.testing.assert_allclose(torch.cat([s1 + ds1, s1n]), w1, rtol=1e-10,
                               atol=1e-12)


# ---------------------------------------------------------------------------
# Subnormal weights: the port flushes them as XLA does.
# ---------------------------------------------------------------------------


def test_subnormal_weights_flush_to_zero():
    a = np.zeros((1, D), np.float32)
    b = np.zeros((1, D), np.float32)
    b[0, 0] = np.sqrt(95.0 * 2 * H * H)          # sq/(2h²) = 95
    inv = float(np.float32(1 / (2 * H * H)))
    raw = torch.exp(torch.tensor(-95.0, dtype=torch.float32))
    assert 0.0 < float(raw) < tdelta.FLT_MIN     # PyTorch keeps it
    assert float(tdelta.phi_cross(_t(a), _t(b), inv)) == 0.0
    assert float(jdelta._phi_cross(a, b, jnp.float32(inv))[0, 0]) == 0.0
    s0, _ = tdelta.cross_stats(_t(a), _t(b), H)
    assert float(s0[0]) == 0.0


def _jax_stream(x, **kw):
    base = dict(method="sdkde", backend="pallas", block_n=64)
    base.update(kw)
    return JStream(x, H, **base)


def _carry(st, device="cpu"):
    """``convert.stream_from_state`` of a flushed JAX stream."""
    idx = st._index
    pol = st.policy
    return convert.stream_from_state(
        st.x, st.ids, st.next_id, st.h, gen=st.gen,
        layout_epoch=st.layout_epoch, s0=st.s0, s1=st.s1, method=st.method,
        score_h=st.sh, backend="flash", block_n=st.block_n,
        precision=st.precision,
        config=StreamConfig(slack=st.config.slack,
                            staleness_budget=st.config.staleness_budget,
                            background=st.config.background),
        index=convert.index_from_state(
            None if idx.labels is None else np.asarray(idx.labels),
            None if idx.centroids is None else np.asarray(idx.centroids),
            idx.method, device=device),
        starts=st._starts, caps=st._caps, slots=st._slots,
        labels=st._labels, real=st._real, xp=st._xp,
        policy={"base_size": pol.base_size, "appends": pol.appends,
                "evicts": pol.evicts, "overflowed": pol.overflowed,
                "base_mean_radius": pol.base_mean_radius},
        device=device)


def _dirty_tiles(st, block_n=64):
    dirty = st._dirty
    if isinstance(dirty, torch.Tensor):
        dirty = dirty.cpu().numpy()
    return set((np.asarray(st._slots)[dirty] // block_n).tolist()) \
        | set(st._dirty_tiles)


def test_subnormal_append_leaves_far_tile_clean_on_both_sides():
    """An append at sq/(2h²) ≈ 95 from a far cluster: its weight is
    subnormal in f32, exactly 0.0 after XLA's flush-to-zero, so repro
    leaves the far cluster's tiles clean; the port must too."""
    rng = np.random.default_rng(3)
    near = (0.02 * rng.standard_normal((200, D))).astype(np.float32)
    far = near.copy()
    far[:, 0] += np.float32(np.sqrt(95.0 * 2 * H * H))
    js = _jax_stream(np.concatenate([near, far]))
    ts = _carry(js)
    far_tiles = set((js._slots[200:] // 64).tolist())
    new = (0.02 * rng.standard_normal((4, D))).astype(np.float32)
    js.append(new)
    ts.append(new)
    jd, td = _dirty_tiles(js), _dirty_tiles(ts)
    assert jd == td
    assert not (td & far_tiles)
    assert ts.ensure(0).affected_tiles == js.ensure(0).affected_tiles


# ---------------------------------------------------------------------------
# Layout helpers on JAX's index.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jlayout(data):
    """JAX's k-means layout of x (block 16, slack 0.5) as numpy arrays."""
    x, xa, _ = data
    index = jsp.build_index(jnp.asarray(x), n_clusters=4, seed=0)
    labels = np.asarray(index.labels)
    lay = jsp.cluster_layout(jnp.asarray(x), labels, 16, slack=0.5)
    starts, caps = jsp.cluster_capacities(labels, 16, slack=0.5)
    return dict(index=index, labels=labels, xp=np.asarray(lay.points),
                real=np.asarray(lay.real), starts=starts, caps=caps,
                lab_new=np.asarray(jsp.assign(jnp.asarray(xa), index)))


def test_place_points_matches_repro(jlayout):
    L = jlayout
    got = tsp.place_points(L["real"], L["lab_new"], L["starts"], L["caps"])
    want = jsp.place_points(L["real"], L["lab_new"], L["starts"], L["caps"])
    np.testing.assert_array_equal(got, want)
    # torch inputs (a device mask and labels) give the same slots
    got_t = tsp.place_points(_t(L["real"]), _t(L["lab_new"]), L["starts"],
                             L["caps"])
    np.testing.assert_array_equal(got_t, want)
    full = np.ones_like(L["real"])
    assert tsp.place_points(full, L["lab_new"][:1], L["starts"],
                            L["caps"]) is None
    assert jsp.place_points(full, L["lab_new"][:1], L["starts"],
                            L["caps"]) is None


def _mutated(L, xa):
    xp, real = L["xp"].copy(), L["real"].copy()
    xp[:16] = xa[:16]
    real[:16] = True
    xp[32:40] = xa[16:24]
    real[32:40] = True
    xp[50] = tops.PAD_VALUE                       # a sentinel mid-tile
    real[50] = False
    return xp, real


def _meta_close(got, want, pts, exact=False):
    for f in tsp.TileMeta._fields:
        g = np.asarray(getattr(got, f))
        w = np.asarray(getattr(want, f))
        if exact or f == "counts":
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            np.testing.assert_allclose(g, w, rtol=f32_bar(pts), atol=1e-6,
                                       err_msg=f)


def test_tile_metadata_update_matches_repro(data, jlayout):
    x, xa, _ = data
    L = jlayout
    meta_t = tsp.tile_metadata(_t(L["xp"]), _t(L["real"]), block=16)
    meta_j = jsp.tile_metadata(jnp.asarray(L["xp"]),
                               jnp.asarray(L["real"]), block=16)
    xp, real = _mutated(L, xa)
    upd_t = tsp.tile_metadata_update(meta_t, _t(xp), _t(real), [0, 2, 3],
                                     block=16)
    upd_j = jsp.tile_metadata_update(meta_j, jnp.asarray(xp),
                                     jnp.asarray(real), [0, 2, 3], block=16)
    _meta_close(upd_t, upd_j, np.concatenate([x, xa]))
    full = tsp.tile_metadata(_t(xp), _t(real), block=16)
    _meta_close(upd_t, full, x, exact=True)       # refreshed == rebuilt
    for f in tsp.TileMeta._fields:                # untouched: carried over
        np.testing.assert_array_equal(getattr(upd_t, f)[1],
                                      getattr(meta_t, f)[1])
    # merge_tile_meta leaves its input as it was (snapshots keep bytes)
    again = tsp.tile_metadata(_t(L["xp"]), _t(L["real"]), block=16)
    _meta_close(meta_t, again, x, exact=True)


@pytest.mark.parametrize("tier", ["f32", "bf16x2", "bf16"])
def test_columns_from_layout_and_update_match_repro(data, jlayout, tier):
    x, xa, _ = data
    L = jlayout
    index_t = convert.index_from_state(L["labels"],
                                       np.asarray(L["index"].centroids),
                                       device="cpu")
    cols_t = tops.columns_from_layout(_t(L["xp"]), _t(L["real"]), index_t,
                                      block_n=16, precision=tier)
    cols_j = jops.columns_from_layout(jnp.asarray(L["xp"]),
                                      jnp.asarray(L["real"]), L["index"],
                                      block_n=16, precision=tier)
    pts = np.concatenate([x, xa])

    def planes_close(ct, cj):
        np.testing.assert_array_equal(ct.xt.float().numpy(),
                                      np.asarray(cj.xt, np.float32))
        if tier == "bf16x2":
            np.testing.assert_array_equal(ct.xt_lo.float().numpy(),
                                          np.asarray(cj.xt_lo, np.float32))
        np.testing.assert_allclose(ct.nrm_x.numpy(), np.asarray(cj.nrm_x),
                                   rtol=1e-6)
        _meta_close(ct.meta, cj.meta, pts)

    planes_close(cols_t, cols_j)
    xp, real = _mutated(L, xa)
    upd_t = tops.update_train_columns(cols_t, _t(xp), _t(real), [0, 2, 3, 0],
                                      precision=tier)   # repeats are fine
    upd_j = jops.update_train_columns(cols_j, jnp.asarray(xp),
                                      jnp.asarray(real), [0, 2, 3, 0],
                                      precision=tier)
    planes_close(upd_t, upd_j)
    fresh = tops.columns_from_layout(_t(xp), _t(real), index_t, block_n=16,
                                     precision=tier)
    for f in ("xt", "xt_lo", "nrm_x"):
        if getattr(fresh, f) is not None:
            assert torch.equal(getattr(upd_t, f), getattr(fresh, f)), f
    _meta_close(upd_t.meta, fresh.meta, x, exact=True)
    # the input columns are unchanged: their tile 0 still holds x's rows
    np.testing.assert_array_equal(
        cols_t.xt.float().numpy(),
        tops.columns_from_layout(_t(L["xp"]), _t(L["real"]), index_t,
                                 block_n=16, precision=tier
                                 ).xt.float().numpy())


def test_prepare_train_columns_routes_through_columns_from_layout(data):
    x, _, _ = data
    cols = tops.prepare_train_columns(_t(x), block_n=64, clustered=True)
    lay = tsp.cluster_layout(_t(x), cols.index.labels, 64)
    again = tops.columns_from_layout(lay.points, lay.real, cols.index,
                                     block_n=64)
    for f in ("xt", "nrm_x"):
        assert torch.equal(getattr(cols, f), getattr(again, f))
    _meta_close(cols.meta, again.meta, x, exact=True)


# ---------------------------------------------------------------------------
# One update sequence through both packages' streams.
# ---------------------------------------------------------------------------


def test_update_sequence_through_convert_matches_repro(data):
    x, xa, y = data
    js = _jax_stream(x)
    ts = _carry(js)
    steps = [("append", xa[:24]), ("evict", None), ("append", xa[24:48]),
             ("slide", xa[48:])]
    for op, arg in steps:
        if op == "append":
            assert np.array_equal(js.append(arg), ts.append(arg))
        elif op == "evict":
            ids = js.ids[5:40:3]
            assert js.evict(ids) == ts.evict(ids)
        else:
            assert np.array_equal(js.slide(arg), ts.slide(arg))
        assert _dirty_tiles(js) == _dirty_tiles(ts), op
        sj, st = js.ensure(0), ts.ensure(0)
        assert (sj.gen, sj.layout_epoch, sj.affected_tiles,
                sj.total_tiles, sj.n_live) == (
            st.gen, st.layout_epoch, st.affected_tiles, st.total_tiles,
            st.n_live), op
        np.testing.assert_array_equal(ts._slots, js._slots)
        np.testing.assert_array_equal(ts._labels, js._labels)
        np.testing.assert_array_equal(st.real.numpy(), np.asarray(sj.real))
        np.testing.assert_array_equal(st.ids, sj.ids)
        pts = np.concatenate([x, xa])
        np.testing.assert_allclose(st.points.numpy(), np.asarray(sj.points),
                                   rtol=0, atol=f32_bar(pts))
        np.testing.assert_allclose(st.xp.numpy(), np.asarray(sj.xp), rtol=0,
                                   atol=f32_bar(pts))
        _meta_close(ts.columns_for("f32", st).meta,
                    js.columns_for("f32", sj).meta, pts)
    # and the served sums agree with JAX's on the same snapshot layout
    live = np.asarray(js.snapshot().points)
    want = _refit(live, y, "kde")
    cols = ts.columns_for("f32")
    got = tops.flash_kde_prepared(
        tops._pad_to(_t(y), 8), cols.xt, cols.nrm_x, H, block_m=8,
        block_n=64)[:len(y)] / ts.snapshot().norm
    assert_dens(got.numpy(), want, f32_bar(live, y))


# ---------------------------------------------------------------------------
# The engine: interleaved updates against a refit.
# ---------------------------------------------------------------------------


def test_interleaved_updates_match_refit_exact_pruning(data):
    x, xa, y = data
    eng = ServeEngine(_cfg(prune=0.0))
    eng.register("ds", x, h=H)
    ids0 = eng.registry.append("ds", xa[:32])
    eng.registry.evict_ids("ds", ids0[:8])
    eng.registry.append("ds", xa[32:])
    eng.registry.evict_ids("ds", np.arange(16))       # oldest originals
    eng.registry.append("ds", xa[:4])                 # duplicates are fine
    got = _q(eng, "ds", y)
    live = np.concatenate([x[16:], xa[8:32], xa[32:], xa[:4]])
    assert_dens(got, _refit(live, y), f32_bar(live, y))
    st = eng.registry.get("ds").stream
    assert st.n_live == live.shape[0]
    snap = st.snapshot()
    assert snap.affected_tiles <= snap.total_tiles


@pytest.mark.parametrize("tier", ["f32", "bf16x2", "bf16"])
def test_streaming_matches_refit_across_precision_tiers(data, tier):
    x, xa, y = data
    eng = ServeEngine(_cfg(precision=tier))
    eng.register("ds", x, h=H)
    ids = eng.registry.append("ds", xa)
    eng.registry.evict_ids("ds", ids[::2])
    live = np.concatenate([x, xa[1::2]])
    rtol, atol = TIER_BARS[tier]
    assert_dens(_q(eng, "ds", y), _refit(live, y),
                max(rtol, f32_bar(live, y)), atol)


@pytest.mark.parametrize("method", ["kde", "laplace"])
def test_streaming_methods_without_stats(data, method):
    x, xa, y = data
    eng = ServeEngine(_cfg(method=method))
    eng.register("ds", x, h=H)
    eng.registry.slide("ds", xa)          # sliding window: append + evict
    live = np.concatenate([x[len(xa):], xa])
    assert_dens(_q(eng, "ds", y), _refit(live, y, method), f32_bar(live, y))


def test_staleness_budget_serves_stale_then_flushes(data):
    x, xa, y = data
    eng = ServeEngine(_cfg(staleness_budget=2))
    eng.register("ds", x, h=H)
    q0 = _q(eng, "ds", y)
    eng.registry.append("ds", xa[:16])                 # gen 1
    ans = eng.query(QueryRequest(key="ds", points=y))  # within budget
    np.testing.assert_array_equal(q0, ans.value.numpy())
    assert ans.staleness == 1
    eng.registry.append("ds", xa[16:32])               # gen 2
    eng.registry.append("ds", xa[32:])                 # gen 3 > budget
    ans = eng.query(QueryRequest(key="ds", points=y))  # must flush
    assert ans.staleness == 0
    live = np.concatenate([x, xa])
    assert_dens(ans.value.numpy(), _refit(live, y), f32_bar(live, y))
    s = eng.staleness_summary()
    assert s["max"] == 1 and s["count"] == 3
    assert eng.metrics()["staleness"] == s


def test_value_generations_reuse_executables_rebuild_invalidates(data):
    x, xa, y = data
    eng = ServeEngine(_cfg())
    eng.register("ds", x, h=H)
    _q(eng, "ds", y[:16])
    misses0 = eng.cache.misses
    eng.registry.append("ds", xa[:8])     # slack absorbs it: same epoch
    _q(eng, "ds", y[:16])
    assert eng.cache.misses == misses0
    st = eng.registry.get("ds").stream
    epoch0 = st.snapshot().layout_epoch
    eng.registry.append("ds", np.repeat(xa, 20, axis=0))   # > append budget
    _q(eng, "ds", y[:16])
    assert st.snapshot().layout_epoch > epoch0
    assert st.last_rebuild_reason in ("append-budget", "slack-overflow")
    assert eng.cache.misses > misses0


def test_slack_overflow_triggers_rebuild_and_stays_correct(data):
    x, xa, y = data
    eng = ServeEngine(_cfg(method="kde", stream_slack=0.05))
    eng.register("ds", x[:128], h=H)
    big = np.concatenate([x[128:], xa])
    eng.registry.append("ds", big)                    # overflows the slack
    got = _q(eng, "ds", y)
    st = eng.registry.get("ds").stream
    assert st.rebuilds == 1
    assert st.last_rebuild_reason == "slack-overflow"
    snap = obs.metrics_snapshot()
    assert snap["stream.rebuilds{reason=slack-overflow}"]["value"] >= 1
    live = np.concatenate([x[:128], big])
    assert_dens(got, _refit(live, y, "kde"), f32_bar(live, y))


def test_radius_drift_rebuilds_one_flush_after_repro(data):
    """Appends far from every cluster inflate the tile radii past twice
    their built mean.  repro reads the new layout's mean radius inside
    the flush and rebuilds there; the port reads it back with the next
    flush's dirty mask, so it rebuilds one flush later.  The value it
    reads is the published layout's mean radius, and the answers after
    the rebuild hold against a refit and against repro's points."""
    x, _, y = data
    rng = np.random.default_rng(7)
    js = _jax_stream(x)
    ts = _carry(js)
    read = []
    note = ts.policy.note_mean_radius
    ts.policy.note_mean_radius = lambda r: read.append(r) or note(r)
    base = js.policy.base_mean_radius
    far = rng.standard_normal((8, D))
    far = (12.0 * far / np.linalg.norm(far, axis=1, keepdims=True)
           ).astype(np.float32)
    small = (0.1 * rng.standard_normal((2, D))).astype(np.float32)

    js.append(far)
    ts.append(far)
    assert _dirty_tiles(js) == _dirty_tiles(ts)
    js.ensure(0)
    snap1 = ts.ensure(0)
    assert (js.rebuilds, js.last_rebuild_reason) == (1, "radius-drift")
    assert (ts.rebuilds, ts.last_rebuild_reason) == (0, None)
    assert read == [pytest.approx(base, rel=1e-6)]   # the carried layout's
    meta = ts.columns_for(ts.precision, snap1).meta
    live = meta.counts.numpy() > 0
    want = float(meta.radii.numpy()[live].astype(np.float64).mean())
    assert want > 2.0 * base

    js.append(small)
    ts.append(small)
    sj, st = js.ensure(0), ts.ensure(0)
    assert js.rebuilds == 1                           # no second rebuild
    assert (ts.rebuilds, ts.last_rebuild_reason) == (1, "radius-drift")
    assert st.layout_epoch == snap1.layout_epoch + 1
    assert len(read) == 2
    assert read[1] == pytest.approx(want, rel=1e-6)
    np.testing.assert_array_equal(st.ids, sj.ids)
    pts = np.concatenate([x, far, small])
    np.testing.assert_allclose(st.points.numpy(), np.asarray(sj.points),
                               rtol=0, atol=f32_bar(pts))
    cols = ts.columns_for("f32", st)
    got = tops.flash_kde_prepared(
        tops._pad_to(_t(y), 8), cols.xt, cols.nrm_x, H, block_m=8,
        block_n=64)[:len(y)] / st.norm
    live_raw = ts.x.numpy()
    assert_dens(got.numpy(), _refit(live_raw, y), f32_bar(live_raw, y))


def _tile_bytes(cols, t, block):
    sl = slice(t * block, (t + 1) * block)
    parts = [cols.xt[:, sl], cols.nrm_x[:, sl]]
    parts += [getattr(cols.meta, f)[t] for f in tsp.TileMeta._fields]
    return [p.clone() for p in parts]


@pytest.mark.parametrize("tier", ["f32", "bf16x2"])
def test_clean_tiles_carry_over_bitwise(data, tier):
    """A far-away append leaves every unaffected tile's operand columns,
    norms and metadata bit for bit as they were."""
    x, _, _ = data
    far = x + np.float32(100.0)           # separate cluster, zero overlap
    st = StreamingSDKDE(np.concatenate([x, far]), H, block_n=64,
                        precision=tier, device="cpu")
    snap0 = st.snapshot()
    cols0 = st.columns_for(tier, snap0)
    before = {t: _tile_bytes(cols0, t, 64) for t in range(snap0.total_tiles)}
    st.append(far[:8] + np.float32(0.1))
    snap1 = st.ensure(0)
    assert snap1.layout_epoch == snap0.layout_epoch   # no rebuild
    assert 0 < snap1.affected_tiles < snap1.total_tiles
    cols1 = st.columns_for(tier, snap1)
    near = set((st._slots[:len(x)] // 64).tolist())
    changed = [t for t in range(snap1.total_tiles)
               if not all(torch.equal(a, b) for a, b in zip(
                   before[t], _tile_bytes(cols1, t, 64)))]
    assert len(changed) <= snap1.affected_tiles
    assert not (set(changed) & near)      # the near cluster is untouched
    # and snapshot 0 still holds its own bytes
    for t in range(snap0.total_tiles):
        assert all(torch.equal(a, b) for a, b in zip(
            before[t], _tile_bytes(cols0, t, 64)))


def test_evicted_slab_keeps_pruned_answers_right(data):
    """Evicting whole clusters leaves all-sentinel tiles (count 0) and
    sentinels mid-tile; B4's plain version and B2's agree with a refit."""
    x, _, y = data
    for prune in (0.0, "off"):
        st_eng = ServeEngine(_cfg(method="kde", prune=prune))
        st_eng.register("ds", x, h=H)
        st = st_eng.registry.get("ds").stream
        lab = st._labels
        out = st.ids[(lab == lab[0]) | (np.arange(len(lab)) % 7 == 0)]
        st_eng.registry.evict_ids("ds", out)
        snap = st.ensure(0)
        cols = st.columns_for("f32", snap)
        assert int((cols.meta.counts == 0).sum()) >= 1
        live = x[~np.isin(np.arange(len(x)), out)]
        assert_dens(_q(st_eng, "ds", y), _refit(live, y, "kde"),
                    f32_bar(live, y))


def test_append_into_trailing_empty_cluster(data, monkeypatch):
    """k-means can leave a trailing centroid with no train point; the
    layout still reserves that cluster's slab, so a later append
    assigned to it lands."""
    x, _, _ = data
    cents = np.zeros((3, D), np.float32)
    cents[0] -= 1.0
    cents[1] += 1.0
    cents[2] = 50.0                       # no train point lands here

    def fake_index(pts, **kw):
        idx = tsp.SpatialIndex(None, _t(cents))
        return tsp.SpatialIndex(tsp.assign(pts, idx), _t(cents))

    monkeypatch.setattr(tsp, "build_index", fake_index)
    st = StreamingSDKDE(x[:64], H, method="kde", block_n=16, device="cpu")
    assert st._caps.shape[0] == 3
    ids = st.append(np.full((3, D), 50.0, np.float32))
    assert (st._slots[-3:] >= 0).all()
    snap = st.ensure(0)
    assert snap.n_live == 67
    assert int(st.columns_for("f32", snap).meta.counts.sum()) == 67
    st.evict(ids)
    assert st.ensure(0).n_live == 64


def test_torch_stream_bounds_layout_shapes(data):
    x, xa, y = data
    st = StreamingSDKDE(x[:200], H, method="kde", backend="torch",
                        device="cpu")
    shape0 = st.snapshot().xp.shape
    st.append(xa[:8])
    assert st.ensure(0).xp.shape == shape0      # same pow2 bucket
    st.append(np.repeat(xa, 2, axis=0))         # past the bucket
    snap = st.ensure(0)
    assert snap.xp.shape[0] >= snap.n_live and snap.xp.shape != shape0
    eng = ServeEngine(_cfg(backend="torch", method="kde"))
    eng.register("ds", x[:200], h=H)
    eng.registry.append("ds", xa)
    live = np.concatenate([x[:200], xa])
    assert_dens(_q(eng, "ds", y), _refit(live, y, "kde"), f32_bar(live, y))


def test_background_flush_serves_stale_then_catches_up(data):
    x, xa, y = data
    st = StreamingSDKDE(x, H, method="kde", backend="torch", device="cpu",
                        config=StreamConfig(background=True))
    gen0 = st.snapshot().gen
    st.append(xa)                          # kicks a worker build
    snap = st.ensure(0)                    # joins the worker
    assert snap.gen == st.gen and snap.gen > gen0
    worker = st._worker
    if worker is not None:
        worker.join(timeout=30)
        assert not worker.is_alive()
    from repro_torch.core import kde as tkde
    got = tkde.kde_eval(snap.points, _t(y), H, block=256).numpy()
    live = np.concatenate([x, xa])
    assert_dens(got, _refit(live, y, "kde"), f32_bar(live, y))
    # the flash layout too: the worker publishes g+1 while g serves (its
    # flush stalled by the chaos hook, so the query surely lands mid-build)
    eng = ServeEngine(_cfg(stream_background=True, staleness_budget=4))
    eng.register("ds", x, h=H)
    st = eng.registry.get("ds").stream
    stall = tfi.FaultInjector(tfi.ChaosConfig(staleness_blowout=1.0,
                                              slow_ms=1500.0))
    with tfi.installed(stall):
        eng.registry.append("ds", xa)
        assert st._worker.is_alive()
        ans = eng.query(QueryRequest(key="ds", points=y))
        assert st._worker.is_alive()
        assert ans.staleness == 1
        assert_dens(ans.value.numpy(), _refit(x, y), f32_bar(x, y))
        st._worker.join(timeout=60)
    assert st.snapshot().gen == st.gen
    assert_dens(_q(eng, "ds", y), _refit(live, y), f32_bar(live, y))


def test_stream_rejects_bad_usage(data):
    x, xa, _ = data
    st = StreamingSDKDE(x[:64], H, method="kde", backend="torch",
                        device="cpu")
    with pytest.raises(KeyError):
        st.evict([999999])
    with pytest.raises(ValueError):
        st.evict(st.ids)                   # cannot evict everything
    with pytest.raises(ValueError):
        st.append(xa[:, :2])               # dimension mismatch
    with pytest.raises(ValueError):
        StreamingSDKDE(x[:64], H, backend="ring", device="cpu")
    for bad in (dict(staleness_budget=-1), dict(stream_slack=-0.5)):
        with pytest.raises(ValueError):
            _cfg(**bad)
    with pytest.raises(ValueError, match="ring"):
        _cfg(backend="ring")               # the ring shards at fit time
    for bad in (dict(staleness_budget=-1), dict(slack=-0.5)):
        with pytest.raises(ValueError):
            StreamConfig(**bad)
    eng = ServeEngine(_cfg(stream=False))
    eng.register("static", x[:64], h=H)
    with pytest.raises(ValueError):
        eng.registry.append("static", xa)


def test_host_reads_per_update(data):
    """An append reads its cluster labels back, a flush its dirty mask,
    an eviction nothing: one device read each."""
    x, xa, _ = data
    st = StreamingSDKDE(x, H, block_n=64, device="cpu")
    r0 = dict(st.host_reads)
    ids = st.append(xa[:16])
    assert st.host_reads["append"] == r0["append"] + 1
    st.evict(ids[:4])
    assert st.host_reads == {**r0, "append": r0["append"] + 1}
    st.ensure(0)
    assert st.host_reads["flush"] == r0["flush"] + 1


def test_prune_flip_across_auto_threshold():
    """Appends carry the live count across ops.resolve_prune's 16384
    columns: one registered key goes from B2 to B4 (plain versions here),
    and both agree with a refit across the flip."""
    rng = np.random.default_rng(1)
    d, h = 2, 0.3
    x = rng.standard_normal((16384 - 128, d)).astype(np.float32)
    xa = rng.standard_normal((256, d)).astype(np.float32)
    y = rng.standard_normal((64, d)).astype(np.float32)
    eng = ServeEngine(_cfg(method="kde", block_m=64, block_n=128,
                           min_batch=64, max_batch=64))
    eng.register("ds", x, h=h)
    launches = obs.counter("kernels.prune.launches",
                           labels={"kind": "kde"})
    n0 = launches.value
    before = _q(eng, "ds", y)
    assert launches.value == n0                       # dense below 16384
    eng.registry.append("ds", xa)
    after = _q(eng, "ds", y)
    assert launches.value == n0 + 1                   # pruned above it
    for got, live in ((before, x), (after, np.concatenate([x, xa]))):
        want = np.asarray(jkde.kde_eval(jnp.asarray(live), jnp.asarray(y),
                                        h, block=4096))
        assert_dens(got, want, f32_bar(live, y, h=h))


# ---------------------------------------------------------------------------
# SDKDE.append / evict.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["torch", "flash"])
def test_sdkde_append_evict_matches_repro(data, backend):
    x, xa, y = data
    est = SDKDE(H, EstimatorConfig(backend=backend, block=128, block_m=8,
                                   block_n=64, prune="off",
                                   device="cpu")).fit(x)
    est.append(xa).evict(np.arange(32))
    jx = jest.SDKDE(H, jest.EstimatorConfig(backend="jnp", block=128)).fit(
        jnp.asarray(x))
    jx.append(xa).evict(np.arange(32))
    live = np.concatenate([x[32:], xa])
    bar = f32_bar(live, y)
    np.testing.assert_allclose(est.x_sd.numpy(), np.asarray(jx.x_sd),
                               rtol=0, atol=bar)
    got = est.evaluate(y).numpy()
    assert_dens(got, np.asarray(jx.evaluate(jnp.asarray(y))), bar)
    assert_dens(got, _refit(live, y), bar)
    with pytest.raises(ValueError):
        est.evict(np.arange(est.x_train.shape[0]))


def test_sdkde_refit_resets_streaming_stats(data):
    x, xa, y = data
    est = SDKDE(H, EstimatorConfig(backend="torch", block=128,
                                   device="cpu")).fit(x)
    est.append(xa)                       # seeds f64 stats for x + xa
    est.fit(x[:256])                     # refit: different dataset
    est.append(xa[:16])
    live = np.concatenate([x[:256], xa[:16]])
    assert_dens(est.evaluate(y).numpy(), _refit(live, y), f32_bar(live, y))


# ---------------------------------------------------------------------------
# Registry / engine update races.
# ---------------------------------------------------------------------------


def test_registry_evict_during_inflight_queries(data):
    """Thread A queries while thread B drops and re-registers the key:
    every answer is a density vector of some registered set or a clean
    UnknownKey — never corruption."""
    from repro_torch.serve import UnknownKey

    x, _, y = data
    eng = ServeEngine(_cfg(method="kde", backend="torch"))
    eng.register("ds", x, h=H)
    want = [_refit(x, y[:16], "kde"), _refit(2.0 + x, y[:16], "kde")]
    errors, results = [], []

    def worker():
        for _ in range(20):
            try:
                results.append(_q(eng, "ds", y[:16]))
            except UnknownKey:
                pass
            except Exception as e:  # noqa: BLE001 - collected for the assert
                errors.append(e)

    t = threading.Thread(target=worker)
    t.start()
    for _ in range(5):
        eng.registry.evict("ds")
        eng.register("ds", 2.0 + x, h=H)
        eng.registry.evict("ds")
        eng.register("ds", x, h=H)
    t.join(timeout=120)
    assert not t.is_alive()
    assert not errors, errors
    assert results
    bar = f32_bar(2.0 + x, y)
    for r in results:
        assert any(np.allclose(r, w, rtol=bar, atol=1e-6 * float(w.max()))
                   for w in want)


def test_point_evict_during_pinned_snapshot_is_consistent(data):
    """A dispatch pinned to snapshot g keeps reading g's bytes while
    evictions publish g+1 (snapshots are immutable)."""
    x, xa, y = data
    eng = ServeEngine(_cfg())
    eng.register("ds", x, h=H)
    st = eng.registry.get("ds").stream
    pinned = st.ensure(0)
    cols_before = st.columns_for("f32", pinned)
    xt0, nrm0, xp0 = (cols_before.xt.clone(), cols_before.nrm_x.clone(),
                      pinned.xp.clone())
    ids = eng.registry.append("ds", xa)
    eng.registry.evict_ids("ds", ids)
    eng.registry.evict_ids("ds", st.ids[:8])
    st.ensure(0)
    cols_after = st.columns_for("f32", pinned)
    assert cols_after is cols_before
    assert torch.equal(cols_after.xt, xt0)
    assert torch.equal(cols_after.nrm_x, nrm0)
    assert torch.equal(pinned.xp, xp0)
    assert pinned.n_live == x.shape[0]
    live = x[8:]
    assert_dens(_q(eng, "ds", y), _refit(live, y), f32_bar(live, y))


def test_stream_refit_bumps_generation_and_invalidates(data):
    x, _, y = data
    eng = ServeEngine(_cfg(method="kde"))
    eng.register("ds", x, h=H)
    stale = _q(eng, "ds", y[:16])
    gen0 = eng.registry.get("ds").generation
    eng.register("ds", 2.0 + x, h=H, refit=True)
    assert eng.registry.get("ds").generation != gen0
    fresh = _q(eng, "ds", y[:16])
    assert_dens(fresh, _refit(2.0 + x, y[:16], "kde"), f32_bar(2.0 + x, y))
    assert not np.allclose(fresh, stale)
