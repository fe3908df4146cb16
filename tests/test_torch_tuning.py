"""The Hopper launch tuner: the H100 cost model (``kernels/tuning.py``),
the tuner (``kernels/autotune.py``) and ``"auto"`` tiles through the
port's layers.

The model has no counterpart to hold against (``repro``'s is the TPU's),
so its properties are checked: monotone in the train count, padding
priced, the kernels' own limits as gates, the bound that ``chip_smoke``
reports, and the occupancy profile against ``repro``'s on the same
feeds.  ``"auto"`` answers are held to the explicit tiles' answers at
rtol 1e-5 (another tile only changes the f32 summation order) and, on
the CPU, no probe is ever built.
"""

import math
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro.kernels import autotune as jautotune
from repro.kernels import tuning as jtuning
from repro_torch import obs
from repro_torch.core.estimator import SDKDE, EstimatorConfig
from repro_torch.kernels import autotune, flash_kde, ops, spatial, tuning
from repro_torch.serve import QueryRequest, ServeConfig, ServeEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (helpers only; its main needs a card)

TIERS = ("f32", "bf16x2", "bf16")


@pytest.fixture(autouse=True)
def fresh_tuner():
    autotune.clear_cache()
    yield
    autotune.clear_cache()


@pytest.fixture
def no_probe(monkeypatch):
    """Fail if anything builds a device probe (the CPU never may)."""
    def boom(*a, **k):
        raise AssertionError("a device probe was built on the CPU")
    monkeypatch.setattr(autotune, "_probe_time_fn", boom)


# ---------------------------------------------------------------------------
# The H100 cost model.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("out_width", [1, 17])
def test_model_is_monotone_in_n(tier, out_width):
    ns = [1024, 4096, 16384, 32768, 131072, 1 << 20]
    for bm, bn in ((128, 128), (64, 512)):
        times = [tuning.pair_pass_cost(
            n if out_width > 1 else 4096, n, 16, block_m=bm, block_n=bn,
            out_width=out_width, precision=tier).step_time for n in ns]
        assert all(a <= b for a, b in zip(times, times[1:])), times


def test_padding_is_priced():
    """Rows pad to block_m (and 64-row blocks), columns to block_n."""
    a = tuning.pair_pass_cost(100, 1000, 16, block_m=128, block_n=128)
    b = tuning.pair_pass_cost(128, 1024, 16, block_m=128, block_n=128)
    assert a.pairs == b.pairs == 128 * 1024
    assert a.hbm_bytes == b.hbm_bytes and a.blocks == b.blocks
    # a block_m that is not a multiple of 64 leaves rows idle: 96 rows
    # run as two 64-row blocks
    c = tuning.pair_pass_cost(96, 1024, 16, block_m=96, block_n=128)
    assert c.pairs == 128 * 1024
    # the score pass pads train rows to lcm(block_m, block_n)
    s = tuning.pair_pass_cost(1000, 1000, 16, block_m=128, block_n=384,
                              out_width=17)
    assert s.pairs == float(1152) * 1152
    # the floor counts only the real pairs
    assert a.floor_s == tuning.pair_bound(
        "kde", "f32", 100 * 1000, 16,
        128 * (16 * 4 + 4) + 1024 * (16 * 4 + 4) + 128 * 4)[0]


def test_pruned_passes_walk_their_visit_slots():
    dense = tuning.pair_pass_cost(4096, 32768, 16, block_m=128,
                                  block_n=128)
    pruned = tuning.pair_pass_cost(4096, 32768, 16, block_m=128,
                                   block_n=128, visits=16)
    assert pruned.pairs == dense.pairs * 16 / 256
    assert pruned.step_time < dense.step_time


@pytest.mark.parametrize("tier", TIERS)
def test_step_time_never_below_the_bound(tier):
    for rows, cols, ow in ((1, 128, 1), (4096, 32768, 1), (32768, 32768, 17),
                           (300, 1000, 5)):
        for bm in (64, 128, 256):
            for bn in (128, 2048):
                c = tuning.pair_pass_cost(rows, cols, 16, block_m=bm,
                                          block_n=bn, out_width=ow,
                                          precision=tier)
                assert c.step_time >= c.floor_s > 0
                assert c.bound in ("hbm", "fp32", "tensor", "sfu", "issue")


@pytest.mark.parametrize("tier", TIERS)
def test_gates_follow_the_kernels_limits(tier):
    assert tuning.infeasible(flash_kde.MAX_D, block_m=flash_kde.MAX_BLOCK_M,
                             block_n=128, precision=tier) is None
    assert "d=65" in tuning.infeasible(65, block_m=128, block_n=128,
                                       precision=tier)
    assert "block_m=257" in tuning.infeasible(16, block_m=257, block_n=128,
                                              precision=tier)
    assert tuning.infeasible(16, block_m=0, block_n=128,
                             precision=tier) is not None
    assert tuning.infeasible(16, block_m=128, block_n=0,
                             precision=tier) is not None
    for d in (1, 4, 8, 16, 24, 32, 48, 64):
        for fn in (tuning.kde_pass_smem, tuning.score_pass_smem):
            nbytes, per_sm = fn(d, tier)
            assert nbytes <= tuning.SMEM_BLOCK and per_sm >= 1
    with pytest.raises(ValueError):
        autotune.autotune_blocks(64, 1024, 65, measure=False)


def test_shared_memory_mirror_matches_the_sources():
    """The blocks an SM the CUDA sources state for their instantiations
    (csrc/flash_kde_pass.cuh, PassSmem: 3 at f32 DMAX 32, 1 at f32 DMAX
    64, 2 at bf16x2 DMAX 64; flash_score_pass.cuh: 3 at f32) and the
    kernels' cap a block (kMaxSmem)."""
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    assert f"kMaxSmem = {tuning.SMEM_BLOCK};" in (
        csrc / "flash_tiles.cuh").read_text()
    assert tuning.kde_pass_smem(32, "f32")[1] == 3
    assert tuning.kde_pass_smem(64, "f32")[1] == 1
    assert tuning.kde_pass_smem(64, "bf16x2")[1] == 2
    assert tuning.kde_pass_smem(16, "f32")[1] == 4
    assert tuning.kde_pass_smem(16, "bf16")[1] == 5
    assert tuning.score_pass_smem(16, "f32")[1] == 3
    assert tuning.score_groups(16, "bf16x2") == 1
    assert tuning.score_groups(32, "bf16x2") == 2
    assert tuning.score_groups(64, "bf16x2") == 3
    assert tuning.score_groups(64, "bf16") == 1


@pytest.mark.parametrize("kind, tier, bound_ms", [
    ("score", "f32", 1.1058), ("score", "bf16x2", 0.2866),
    ("score", "bf16", 0.2568), ("kde", "f32", 0.5769),
    ("kde", "bf16x2", 0.2568), ("laplace", "f32", 0.6090),
    ("sq_moment", "f32", 0.5930)])
def test_one_bound_for_chip_smoke_and_the_tuner(kind, tier, bound_ms):
    """chip_smoke's bound is the tuner's, and it reproduces the kernel
    table's bounds at 32768 x 32768 x 16 (PERF.md §6) to rounding."""
    pairs, moved = 32768 * 32768, 10 << 20
    ms, by = chip_smoke.bound_ms(kind, tier, pairs, 16, moved)
    s, by2 = tuning.pair_bound(kind, tier, pairs, 16, moved)
    assert (ms, by) == (1e3 * s, by2)
    assert ms == pytest.approx(bound_ms, abs=5e-5) and by == "operations"


def test_sdkde_device_cost_and_the_sweep():
    score, kde = tuning.sdkde_device_cost(32768, 16384, 16)
    assert score.kind == "score" and kde.kind == "kde"
    assert score.pairs == 32768.0 ** 2 and kde.pairs == 16384.0 * 32768
    sweep = tuning.sweep_blocks(4096, 32768, 16)
    times = [c.step_time for c in sweep]
    assert times == sorted(times) and len(sweep) == 15
    assert tuning.best_blocks(4096, 32768, 16) == sweep[0]
    assert tuning.sweep_blocks(4096, 32768, 65) == []


def test_selective_scan_bytes_match_repro():
    for args in ((4, 1024, 8192, 16), (1, 7, 33, 3)):
        assert tuning.selective_scan_bytes(*args) == \
            jtuning.selective_scan_bytes(*args)


def test_rff_model_grows_with_features_and_pilot():
    lo = tuning.rff_eval_cost(1024, 4, n_features=2048)
    hi = tuning.rff_eval_cost(1024, 4, n_features=8192)
    assert 0.0 < lo < hi
    assert tuning.rff_eval_cost(1024, 4, n_features=2048,
                                n_pilot=1024) > lo


# ---------------------------------------------------------------------------
# The tuner: shortlist, cache, probe, occupancy profile.
# ---------------------------------------------------------------------------


def test_shortlist_is_sorted_and_launchable():
    cands = autotune.shortlist(4096, 32768, 16)
    assert [c.step_time for c in cands] == sorted(c.step_time for c in cands)
    assert {(c.block_m, c.block_n) for c in cands} == {
        (bm, bn) for bm in autotune.DEFAULT_BLOCK_MS
        for bn in autotune.DEFAULT_BLOCK_NS}
    assert autotune.shortlist(4096, 32768, 80) == []


def test_winner_cache_and_no_probe_on_the_cpu(no_probe):
    hits = obs.counter("autotune.cache_hits")
    h0 = hits.value
    a = autotune.resolve_blocks("auto", "auto", 300, 5000, 8,
                                device=torch.device("cpu"))
    b = autotune.resolve_blocks("auto", "auto", 400, 6000, 8,
                                device=torch.device("cpu"))
    assert a == b and len(autotune.cache_info()) == 1
    assert hits.value == h0 + 1
    assert autotune.resolve_blocks(64, 256, 300, 5000, 8) == (64, 256)
    assert autotune.resolve_blocks("auto", 256, 300, 5000, 8)[1] == 256


def test_measured_probe_needs_a_card():
    with pytest.raises(ValueError, match="CUDA"):
        autotune.resolve_blocks("auto", "auto", 300, 5000, 8, measure=True,
                                device=torch.device("cpu"))


def test_measured_resolve_times_the_top_k_and_logs_them():
    calls = []

    def time_fn(bm, bn):
        calls.append((bm, bn))
        return 1.0 / bn                     # the widest probed tile wins

    probes = obs.counter("autotune.probes")
    p0 = probes.value
    got = autotune.autotune_blocks(4096, 32768, 16, time_fn=time_fn, topk=3)
    # the model's best tile at each of its three best widths, then the
    # default tile
    top, widths = [], set()
    for c in autotune.shortlist(4096, 32768, 16):
        if c.block_n not in widths and len(widths) < 3:
            widths.add(c.block_n)
            top.append(c.blocks)
    want = top + ([autotune.DEFAULT_TILE]
                  if autotune.DEFAULT_TILE not in top else [])
    assert calls == want and len({bn for _, bn in calls}) == len(calls)
    assert got == max(want, key=lambda b: b[1])
    assert probes.value == p0 + len(want)
    log = autotune.probe_log()
    assert [(p["block_m"], p["block_n"]) for p in log] == want
    assert all(p["measured_s"] == 1.0 / p["block_n"] for p in log)
    # cached: no second probe
    assert autotune.autotune_blocks(4096, 32768, 16, time_fn=time_fn) == got
    assert len(calls) == len(want)


def test_row_and_column_multiples_constrain_the_tiles():
    bm, bn = autotune.resolve_blocks("auto", "auto", 384, 1536, 8,
                                     row_multiple=384, col_multiple=1536)
    assert 384 % bm == 0 and 1536 % bn == 0
    bm, bn = autotune.resolve_blocks("auto", "auto", 100, 100, 8,
                                     row_multiple=100, col_multiple=100)
    assert (bm, bn) == (4, 4)


def test_occupancy_profile_matches_repro():
    jautotune.clear_cache()
    feeds = [(4096, 32768, 16, 0.3, 512), (4096, 32768, 16, 0.5, 512),
             (4000, 30000, 16, 0.1, 128), (64, 1000, 4, 0.9, 256)]
    for f in feeds:
        autotune.record_occupancy(*f[:4], block_n=f[4])
        jautotune.record_occupancy(*f[:4], block_n=f[4])
    for q in ((4096, 32768, 16, None), (4096, 32768, 16, 128),
              (4096, 32768, 16, 256), (4096, 32768, 16, 512),
              (4096, 32768, 16, 2048), (64, 1000, 4, 128),
              (10, 10, 2, 128)):
        assert autotune.expected_occupancy(*q) == pytest.approx(
            jautotune.expected_occupancy(*q), rel=1e-12)
    for q in ((4096, 32768, 16, 512), (4096, 32768, 16, 1024)):
        assert autotune.has_occupancy(*q) == jautotune.has_occupancy(*q)
    jautotune.clear_cache()


def test_pruned_resolve_prices_the_learned_occupancy():
    dense = autotune.resolve_blocks("auto", "auto", 4096, 32768, 16,
                                    pruned=True)
    autotune.record_occupancy(4096, 32768, 16, 0.05, block_n=128)
    key_before = set(autotune.cache_info())
    pruned = autotune.resolve_blocks("auto", "auto", 4096, 32768, 16,
                                     pruned=True)
    assert set(autotune.cache_info()) != key_before     # a new regime key
    occ = lambda bn: autotune.expected_occupancy(  # noqa: E731
        4096, 32768, 16, bn)
    assert pruned == autotune.shortlist(4096, 32768, 16,
                                        occupancy_fn=occ)[0].blocks
    assert dense == autotune.shortlist(4096, 32768, 16)[0].blocks


# ---------------------------------------------------------------------------
# "auto" through ops, the estimator and the engine.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pts():
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal((900, 4)).astype(np.float32))
    y = torch.as_tensor(rng.standard_normal((300, 4)).astype(np.float32))
    return x, y


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("prune", ["off", 0.0])
def test_auto_tiles_through_ops(pts, no_probe, prune):
    x, y = pts
    for fn in (ops.flash_kde, ops.flash_laplace_kde):
        _close(fn(x, y, 0.5, block_m="auto", block_n="auto", prune=prune),
               fn(x, y, 0.5, prune=prune))
    _close(ops.laplace_kde_nonfused(x, y, 0.5, block_m="auto",
                                    block_n="auto"),
           ops.laplace_kde_nonfused(x, y, 0.5))
    s0a, s1a = ops.flash_score_stats(x, 0.5, block_m="auto", block_n="auto",
                                     prune=prune)
    s0, s1 = ops.flash_score_stats(x, 0.5, prune=prune)
    _close(s0a, s0)
    np.testing.assert_allclose(s1a.numpy(), s1.numpy(), rtol=1e-5,
                               atol=1e-5 * float(s0.max()))
    _close(ops.flash_sdkde(x, y, 0.5, block_m="auto", block_n="auto",
                           prune=prune),
           ops.flash_sdkde(x, y, 0.5, prune=prune))


def test_auto_tiles_through_the_prepared_path(pts, no_probe):
    x, y = pts
    cols = ops.prepare_train_columns(x, block_n="auto")
    assert cols.block_n in autotune.DEFAULT_BLOCK_NS
    ref = ops.prepare_train_columns(x, block_n=128)
    yp = ops._pad_to(y, 128)
    _close(ops.flash_kde_prepared(yp, cols.xt, cols.nrm_x, 0.5,
                                  block_m="auto", block_n="auto")[:300],
           ops.flash_kde_prepared(yp, ref.xt, ref.nrm_x, 0.5)[:300])
    ccols = ops.prepare_train_columns(x, block_n=256, clustered=True)
    got = ops.flash_kde_prepared(yp, ccols.xt, ccols.nrm_x, 0.5,
                                 block_m="auto", block_n="auto", prune=0.0,
                                 columns=ccols, n_real=300)
    _close(got[:300], ops.flash_kde_prepared(yp, ref.xt, ref.nrm_x,
                                             0.5)[:300])


def test_auto_tiles_through_sdkde(pts, no_probe):
    x, y = pts
    cfg = EstimatorConfig(device="cpu", block_m="auto", block_n="auto",
                          prune="off")
    got = SDKDE(0.5, cfg).fit(x).evaluate(y)
    want = SDKDE(0.5, EstimatorConfig(device="cpu", prune="off")).fit(
        x).evaluate(y)
    _close(got, want)


@pytest.mark.parametrize("prune", ["off", 0.0])
def test_auto_tiles_through_the_engine(pts, no_probe, prune):
    x, y = pts
    base = dict(device="cpu", min_batch=16, max_batch=256, prune=prune)
    eng = ServeEngine(ServeConfig(block_m="auto", block_n="auto", **base))
    prep = eng.register("a", x, h=0.5)
    assert isinstance(prep.block_m, int) and isinstance(prep.block_n, int)
    assert all(b % prep.block_m == 0
               for b in prep.config.bucket_sizes(prep.block_m))
    ref = ServeEngine(ServeConfig(**base))
    ref.register("a", x, h=0.5)
    for m in (1, 37, 300):
        _close(eng.query(QueryRequest(key="a", points=y[:m])).value,
               ref.query(QueryRequest(key="a", points=y[:m])).value)


def test_pruned_wrappers_record_occupancy_and_meta_fine(pts):
    x, y = pts
    autotune.clear_cache()
    ops.flash_kde(x, y, 0.5, block_m=64, block_n=256, prune=0.0)
    n_pad = ops._cached_columns(x, block_n=256, precision="f32",
                                seed=0).xt.shape[1]
    for n_key in (900, n_pad):
        assert autotune.has_occupancy(300, n_key, 4, 256)
        assert autotune.has_occupancy(300, n_key, 4, 128)   # the fine probe
    occ = autotune.expected_occupancy(300, 900, 4, 256)
    assert 0.0 < occ <= 1.0
    ops.flash_score_stats(x, 0.5, block_m=64, block_n=256, prune=0.0)
    assert autotune.has_occupancy(900, 900, 4, 256)
    assert autotune.has_occupancy(900, 900, 4, 128)


def test_meta_fine_is_built_and_merged():
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((1500, 3)).astype(np.float32))
    cols = ops.prepare_train_columns(x, block_n=256, clustered=True)
    assert cols.meta_fine is not None
    assert ops.prepare_train_columns(x, block_n=128,
                                     clustered=True).meta_fine is None
    # rebuild a layout, move a few points of two tiles and refresh them
    index = cols.index
    layout = spatial.cluster_layout(x, index.labels, 256)
    xp = layout.points.clone()
    tiles = np.array([0, 2])
    for t in tiles:
        rows = torch.arange(t * 256, t * 256 + 8)
        xp[rows] = torch.where(layout.real[rows, None], xp[rows] + 0.25,
                               xp[rows])
    base = ops.columns_from_layout(layout.points, layout.real, index,
                                   block_n=256)
    upd = ops.update_train_columns(base, xp, layout.real, tiles)
    fresh = ops.columns_from_layout(xp, layout.real, index, block_n=256)
    for a, b in zip(upd.meta_fine, fresh.meta_fine):
        torch.testing.assert_close(a, b)
    for a, b in zip(upd.meta, fresh.meta):
        torch.testing.assert_close(a, b)


def test_check_blocks_takes_auto_and_refuses_nonsense():
    ops.check_blocks("auto", "auto")
    ops.check_blocks(64, "auto")
    for bad in (0, -1, True, "big", 1.5):
        with pytest.raises(ValueError):
            ops.check_blocks(bad, 128)
    with pytest.raises(ValueError, match="stream needs an int"):
        from repro_torch.stream import StreamingSDKDE
        StreamingSDKDE(np.zeros((8, 2), np.float32), 0.5, block_n="auto",
                       device="cpu")
    assert math.isfinite(tuning.pair_pass_cost(
        1, 1, 1, block_m=1, block_n=1).step_time)
