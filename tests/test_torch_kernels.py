"""Kernels B1 (score) and B2 (KDE) of the port against the JAX package.

On the CPU the port's wrappers run the kernels' plain PyTorch versions;
they are held against ``flash_score_pallas`` / ``flash_kde_pallas``
launched raw in interpret mode on the same padded operands (made by the
JAX wrappers' own helpers from the same numpy inputs), for all three
tiers.  Then the ``ops`` wrappers against ``repro.kernels.ops`` with
``prune="off"`` and explicit blocks.  Only real rows are compared: a
sentinel row against sentinel columns gives ``sq ≈ 0`` by cancellation,
which is harmless only because padded rows are sliced off.

Tolerances (per tier):
  * f32: rtol 1e-5 with atol 1e-6·peak (the serve bar), or the norm-trick
    error model 8·eps·max‖x‖²/(2h²) where that is larger: both sides
    round the Gram differently, and 1/(2h²) amplifies it in ``exp``;
  * bf16x2: 5e-4;  bf16: 5e-2 — the tiers' documented bars.
"""

import ctypes
import inspect
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.flash_kde import flash_kde_pallas
from repro.kernels.flash_score import flash_score_pallas
from repro_torch.kernels import _build, flash_kde, flash_laplace
from repro_torch.kernels import flash_pruned, flash_score, selective_scan
from repro_torch.kernels import ops as tops

TIERS = ["f32", "bf16x2", "bf16"]
TIER_BAR = {"f32": 1e-5, "bf16x2": 5e-4, "bf16": 5e-2}
F32_EPS = float(np.finfo(np.float32).eps)

# (n, m, d) from tests/test_kernels_allclose.py: non-multiples, d=1, d=32
SHAPES = [
    (64, 16, 8),
    (300, 50, 16),
    (513, 129, 16),
    (256, 256, 32),
    (128, 64, 1),
]
BM, BN = 32, 64


def _data(n, m, d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (1.2 * rng.standard_normal((m, d))).astype(np.float32)
    return x, y


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
    """A JAX array (f32 or bf16) as a torch tensor of the same bits."""
    if a is None:
        return None
    a = np.asarray(a)
    if a.dtype == np.float32:
        return torch.from_numpy(a.copy())
    return torch.from_numpy(a.view(np.int16).copy()).view(
        torch.bfloat16)


@pytest.mark.parametrize("precision", TIERS)
@pytest.mark.parametrize("n,m,d", SHAPES)
def test_score_plain_matches_pallas(n, m, d, precision):
    x, _ = _data(n, m, d)
    h = 0.7
    xp = jops._pad_to(jnp.asarray(x), np.lcm(BM, BN))
    x_ops, xt_ops, xaug_ops, nrm, _ = jops._score_operands(xp, precision)
    inv = jops._inv2h2(h)
    want = flash_score_pallas(x_ops[0], nrm, xt_ops[0], xaug_ops[0], inv,
                              x_ops[1], xt_ops[1], xaug_ops[1],
                              block_m=BM, block_n=BN, interpret=True)
    args = [_t(a) for a in (x_ops[0], nrm, xt_ops[0], xaug_ops[0], inv,
                            x_ops[1], xt_ops[1], xaug_ops[1])]
    got = flash_score.flash_score(*args, block_m=BM, block_n=BN)
    plain = flash_score.flash_score_plain(*args, block_n=BN)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    assert got.shape == (xp.shape[0], d + 1) and got.dtype == torch.float32
    assert_close(got[:n], np.asarray(want)[:n], bar(precision, x, h))


def test_f32_score_pass_makes_the_ones_column_itself():
    """At f32 the wrappers pass no xaug: ``_score_operands`` builds none,
    the plain B1 and B3 take None as [xt^T | 1] with the same bits as the
    tensor given, the CUDA wrappers refuse a given xaug (the kernel would
    not read it) and the bf16 tiers still need theirs."""
    x, _ = _data(256, 16, 8)
    xp = tops._pad_to(torch.from_numpy(x), BN)
    x_ops, xt_ops, xaug_ops, nrm, _ = tops._score_operands(xp, "f32")
    assert xaug_ops == (None, None)
    inv = tops._inv2h2(0.7, xp.device)
    aug = flash_score.ones_augmented(xt_ops[0])
    assert torch.equal(aug, torch.cat([xp, torch.ones(xp.shape[0], 1)], 1))
    got = flash_score.flash_score(x_ops[0], nrm, xt_ops[0], None, inv,
                                  block_m=BM, block_n=BN)
    want = flash_score.flash_score_plain(x_ops[0], nrm, xt_ops[0], aug, inv,
                                         block_n=BN)
    assert torch.equal(got, want)
    mt, tn = xp.shape[0] // BM, xp.shape[0] // BN
    counts = torch.full((mt,), tn, dtype=torch.int32)
    tmap = torch.arange(tn, dtype=torch.int32).repeat(mt, 1)
    got = flash_pruned.flash_score_pruned(counts, tmap, x_ops[0], nrm,
                                          xt_ops[0], None, inv, block_m=BM,
                                          block_n=BN)
    want = flash_pruned.flash_score_pruned_plain(
        counts, tmap, x_ops[0], nrm, xt_ops[0], aug, inv, block_m=BM,
        block_n=BN)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="xaug=None"):
        flash_score.flash_score_cuda(x_ops[0], nrm, xt_ops[0], aug, inv,
                                     block_m=BM, block_n=BN)
    with pytest.raises(ValueError, match="xaug=None"):
        flash_pruned.flash_score_pruned_cuda(
            counts, tmap, x_ops[0], nrm, xt_ops[0], aug, inv, block_m=BM,
            block_n=BN)
    b_ops, bt_ops, baug_ops, bnrm, _ = tops._score_operands(xp, "bf16")
    assert baug_ops[0] is not None
    with pytest.raises(ValueError, match="bf16 tiers need xaug"):
        flash_score.flash_score(b_ops[0], bnrm, bt_ops[0], None, inv,
                                block_m=BM, block_n=BN)


@pytest.mark.parametrize("precision", TIERS)
@pytest.mark.parametrize("n,m,d", SHAPES)
def test_kde_plain_matches_pallas(n, m, d, precision):
    x, y = _data(n, m, d, seed=1)
    h = 0.7
    y_ops, xt_ops, nrm_y, nrm_x = jops._prep_eval(
        jnp.asarray(x), jnp.asarray(y), BM, BN, precision)
    inv = jops._inv2h2(h)
    want = flash_kde_pallas(y_ops[0], nrm_y, xt_ops[0], nrm_x, inv,
                            y_ops[1], xt_ops[1], block_m=BM, block_n=BN,
                            interpret=True)
    args = [_t(a) for a in (y_ops[0], nrm_y, xt_ops[0], nrm_x, inv,
                            y_ops[1], xt_ops[1])]
    got = flash_kde.flash_kde(*args, block_m=BM, block_n=BN)
    assert got.shape == (y_ops[0].shape[0], 1)
    assert_close(got[:m], np.asarray(want)[:m],
                 bar(precision, np.concatenate([x, y]), h))


def test_sentinel_columns_add_exactly_zero():
    """Padding the train set further changes no real row beyond f32
    summation order, and a column block made only of sentinels adds
    exactly 0.0 (the kernel's padding contract)."""
    x, y = _data(100, 30, 4, seed=2)
    yt, xt = torch.from_numpy(y), torch.from_numpy(x)
    y_ops, xt_ops, nrm_y, nrm_x = tops._prep_eval(xt, yt, 32, 64, "f32")
    inv = tops._inv2h2(0.6, yt.device)
    base = flash_kde.flash_kde_plain(y_ops[0], nrm_y, xt_ops[0], nrm_x, inv,
                                     block_n=64)
    pad = tops._pad_to(xt, 64)
    far = torch.cat([pad, torch.full((64, 4), tops.PAD_VALUE)])
    _, xt2, _, nrm_x2 = tops._prep_eval(far, yt, 32, 64, "f32")
    more = flash_kde.flash_kde_plain(y_ops[0], nrm_y, xt2[0], nrm_x2, inv,
                                     block_n=64)
    torch.testing.assert_close(more[:30], base[:30], rtol=0, atol=0)


@pytest.mark.parametrize("precision", TIERS)
def test_flash_score_stats_and_shift_match_jax(precision):
    x, _ = _data(300, 50, 16, seed=3)
    h, sh = 0.8, 0.6
    js0, js1 = jops.flash_score_stats(jnp.asarray(x), sh,
                                      precision=precision, block_m=BM,
                                      block_n=BN, interpret=True, prune="off")
    ts0, ts1 = tops.flash_score_stats(torch.from_numpy(x), sh,
                                      precision=precision, block_m=BM,
                                      block_n=BN)
    rtol = bar(precision, x, sh)
    assert_close(ts0, js0, rtol)
    assert_close(ts1, js1, rtol)
    want = jops.flash_sdkde_shift(jnp.asarray(x), h, score_h=sh,
                                  precision=precision, block_m=BM,
                                  block_n=BN, interpret=True, prune="off")
    got = tops.flash_sdkde_shift(torch.from_numpy(x), h, score_h=sh,
                                 precision=precision, block_m=BM, block_n=BN)
    assert_close(got, want, rtol)


@pytest.mark.parametrize("precision", TIERS)
@pytest.mark.parametrize("n,m,d", [(300, 50, 16), (128, 64, 1)])
def test_flash_kde_matches_jax(n, m, d, precision):
    x, y = _data(n, m, d, seed=4)
    h = 0.7
    want = jops.flash_kde(jnp.asarray(x), jnp.asarray(y), h,
                          precision=precision, block_m=BM, block_n=BN,
                          interpret=True, prune="off")
    got = tops.flash_kde(torch.from_numpy(x), torch.from_numpy(y), h,
                         precision=precision, block_m=BM, block_n=BN)
    assert got.shape == (m,)
    assert_close(got, want, bar(precision, np.concatenate([x, y]), h))


@pytest.mark.parametrize("precision", TIERS)
def test_prepared_columns_and_kde_match_jax(precision):
    x, y = _data(200, 96, 8, seed=5)
    h = 0.9
    jcols = jops.prepare_train_columns(jnp.asarray(x), block_n=BN,
                                       precision=precision)
    tcols = tops.prepare_train_columns(torch.from_numpy(x), block_n=BN,
                                       precision=precision)
    np.testing.assert_array_equal(
        tcols.xt.to(torch.float32).numpy(),
        np.asarray(jcols.xt, np.float32))
    if precision == "bf16x2":
        np.testing.assert_array_equal(
            tcols.xt_lo.to(torch.float32).numpy(),
            np.asarray(jcols.xt_lo, np.float32))
    np.testing.assert_array_equal(tcols.nrm_x.numpy(),
                                  np.asarray(jcols.nrm_x))
    yp = np.array(jops._pad_to(jnp.asarray(y), BM))
    want = jops.flash_kde_prepared(jnp.asarray(yp), jcols.xt, jcols.nrm_x, h,
                                   jcols.xt_lo, precision=precision,
                                   block_m=BM, block_n=BN, interpret=True)
    got = tops.flash_kde_prepared(torch.from_numpy(yp), tcols.xt,
                                  tcols.nrm_x, h, tcols.xt_lo,
                                  precision=precision, block_m=BM,
                                  block_n=BN)
    assert_close(got[:96], np.asarray(want)[:96],
                 bar(precision, np.concatenate([x, y]), h))


@pytest.mark.parametrize("precision", TIERS)
@pytest.mark.parametrize("n,m,d", [(300, 50, 16), (256, 128, 4)])
def test_flash_sdkde_matches_jax(n, m, d, precision):
    x, y = _data(n, m, d, seed=6)
    h = 0.8
    want = jops.flash_sdkde(jnp.asarray(x), jnp.asarray(y), h,
                            precision=precision, block_m=BM, block_n=BN,
                            interpret=True, prune="off")
    got = tops.flash_sdkde(torch.from_numpy(x), torch.from_numpy(y), h,
                           precision=precision, block_m=BM, block_n=BN)
    assert_close(got, want, bar(precision, np.concatenate([x, y]), h))


def test_bf16x2_prepared_path_needs_lo_planes():
    x, y = _data(64, 32, 4, seed=7)
    cols = tops.prepare_train_columns(torch.from_numpy(x), block_n=BN)
    with pytest.raises(ValueError, match="lo planes"):
        tops.flash_kde_prepared(torch.from_numpy(y), cols.xt, cols.nrm_x,
                                0.5, precision="bf16x2", block_m=BM,
                                block_n=BN)


def test_wrappers_reject_ragged_operands():
    x, y = _data(100, 30, 4)
    with pytest.raises(ValueError, match="multiple"):
        flash_kde.flash_kde(torch.from_numpy(y), torch.zeros(30, 1),
                            torch.from_numpy(x).T.contiguous(),
                            torch.zeros(1, 100), torch.ones(1, 1),
                            block_m=32, block_n=64)


# ---------------------------------------------------------------------------
# The launch geometry of the KDE pass (B2, B4) and of the score pass (B1,
# B3) is planned in Python, and the kernels are bound through ctypes:
# both are held here on the CPU.
# ---------------------------------------------------------------------------

PLAN_CASES = [(32768, 128), (1_048_576, 128), (4096, 4096), (1000, 8),
              (300, 64), (333, 7), (64, 128)]


@pytest.mark.parametrize("n,block_n", PLAN_CASES)
def test_split_plan_covers_every_column_tile_once_in_order(n, block_n):
    """The splits walk column tiles 0 .. ceil(n / block_n) once each, in
    order, none empty, at most MAX_SPLITS of them, each at least
    SPLIT_COLUMNS columns wide where there are that many."""
    plan = flash_kde.plan_splits(n, block_n)
    tiles = -(-n // block_n)
    ranges = plan.ranges()
    assert len(ranges) == plan.splits <= flash_kde.MAX_SPLITS
    assert [v for a, b in ranges for v in range(a, b)] == list(range(tiles))
    assert all(b > a for a, b in ranges)
    assert plan.per_split * block_n >= flash_kde.SPLIT_COLUMNS
    assert plan.slots == tiles


@pytest.mark.parametrize("n,block_n", PLAN_CASES[:4])
def test_split_plan_is_independent_of_the_rows(n, block_n):
    """Nothing of the plan depends on m: the same per_split and splits for
    every request size from 1 to 4096 rows, so a row's sum is built from
    the same runs of tiles whatever rows share its launch; only the
    scratch grows with m."""
    ms = [1, 2, 3, 17, 63, 64, 65, 127, 128, 129, 1000, 4095, 4096]
    plans = {flash_kde.plan_splits(n, block_n) for _ in ms}
    assert len(plans) == 1
    plan = plans.pop()
    for m in ms:
        assert plan.scratch_shape(m) == (plan.splits, m)


def test_a_request_spreads_over_the_card_at_the_main_shape():
    """One 128-row request (two 64-row blocks) against n = 32768 in tiles
    of 128 launches at least one block for each of the H100's 132 SMs."""
    plan = flash_kde.plan_splits(32768, 128)
    assert plan.per_split == 2 and plan.splits == 128
    assert 2 * plan.splits >= 132


@pytest.mark.parametrize("bad", [(0, 128, None), (128, 0, None),
                                 (128, 128, 0)])
def test_split_plan_rejects_empty_shapes(bad):
    with pytest.raises(ValueError, match="split plan"):
        flash_kde.plan_splits(*bad)


# The score pass (B1, B3) plans its splits from n, block_n, d and the
# visit width: (n, block_n, d, visits).
SCORE_PLAN_CASES = [(32768, 128, 16, None), (1_048_576, 128, 16, None),
                    (1_048_576, 128, 64, None), (128, 128, 8, None),
                    (4096, 128, 16, None), (1000, 8, 16, None),
                    (333, 7, 1, None), (32768, 128, 16, 200),
                    (32768, 128, 16, 1), (4096, 64, 32, 17)]


@pytest.mark.parametrize("n,block_n,d,visits", SCORE_PLAN_CASES)
def test_score_plan_covers_every_slot_once_in_order(n, block_n, d, visits):
    """The score pass's splits walk its column tiles (or visit slots)
    once each, in order, none empty, within the kernel's grid limit
    (65535 splits) and the scratch cap; a visit list cut at any count
    walks slots 0 .. count once each."""
    plan = flash_score.plan_score_splits(n, block_n, d, visits)
    slots = -(-n // block_n) if visits is None else visits
    ranges = plan.ranges()
    assert plan.slots == slots and plan.width == d + 1
    assert len(ranges) == plan.splits <= 65535
    assert [v for a, b in ranges for v in range(a, b)] == list(range(slots))
    assert all(b > a for a, b in ranges)
    for count in sorted({0, 1, slots // 2, slots}):
        assert [v for a, b in plan.ranges(count)
                for v in range(a, b)] == list(range(count))
    shape = plan.scratch_shape(n)
    if plan.splits == 1:
        assert shape is None
    else:
        assert shape == (plan.splits, n, d + 1)
        assert 4 * math.prod(shape) <= flash_score.SCORE_SCRATCH_BYTES


def test_score_plan_depends_only_on_its_inputs():
    """plan_score_splits takes (n, block_n, d, visits, rows) and nothing
    else (the fit has no request batch; rows defaults to n, the square
    pass), and the same inputs give the same plan; d changes only the
    width and, through the scratch cap, the splits.  The row blocks come
    from the rows and the slots from the columns: 8192 rows against
    32768 columns get more splits than 32768 rows against 8192."""
    params = list(inspect.signature(
        flash_score.plan_score_splits).parameters)
    assert params == ["n", "block_n", "d", "visits", "rows"]
    assert flash_score.plan_score_splits(32768, 128, 16) == \
        flash_score.plan_score_splits(32768, 128, 16, rows=32768)
    tall = flash_score.plan_score_splits(8192, 128, 16, rows=32768)
    wide = flash_score.plan_score_splits(32768, 128, 16, rows=8192)
    assert tall.slots == 64 and wide.slots == 256
    assert wide.splits > tall.splits
    assert wide.scratch_shape(8192) == (wide.splits, 8192, 17)
    for case in SCORE_PLAN_CASES:
        plans = {flash_score.plan_score_splits(*case) for _ in range(3)}
        assert len(plans) == 1
    a = flash_score.plan_score_splits(32768, 128, 1)
    b = flash_score.plan_score_splits(32768, 128, 16)
    assert (a.per_split, a.splits) == (b.per_split, b.splits)


@pytest.mark.parametrize("d", [16, 64])
def test_paper_scale_score_pass_runs_one_split(d):
    """At 1M rows the 16384 row blocks fill the card: one split, the
    kernel writes S1aug itself, no scratch and no second pass (the KDE
    pass's plan of up to 128 splits would need ~9 GB at 1M x 17)."""
    n = 1_048_576
    for visits in (None, n // 128, 1):
        plan = flash_score.plan_score_splits(n, 128, d, visits)
        assert plan.splits == 1 and plan.scratch_shape(n) is None
    kde_like = flash_kde.plan_splits(n, 128)
    assert 4 * kde_like.splits * n * (d + 1) > \
        flash_score.SCORE_SCRATCH_BYTES


def test_score_pass_fills_the_card_at_the_main_shape():
    """n = 32768 (512 row blocks of 64) runs at least two waves of the
    H100's 132 SMs, splits included: at least 264 blocks."""
    plan = flash_score.plan_score_splits(32768, 128, 16)
    blocks = (32768 // flash_score.SCORE_ROWS) * plan.splits
    assert plan.splits > 1 and blocks >= 2 * 132
    assert blocks >= flash_score.SCORE_TARGET_BLOCKS


@pytest.mark.parametrize("bad", [(0, 128, 16, None), (128, 0, 16, None),
                                 (128, 128, 0, None), (128, 128, 16, 0)])
def test_score_plan_rejects_empty_shapes(bad):
    with pytest.raises(ValueError, match="split plan"):
        flash_score.plan_score_splits(*bad)


def _c_argtypes(source, fn):
    """ctypes types of a C entry point's parameters, read from its
    source: pointers as c_void_p, ints as c_int, long longs as
    c_longlong."""
    text = (_build.CSRC / source).read_text()
    m = re.search(r'extern "C" int ' + fn + r"\((.*?)\)\s*\{", text, re.S)
    assert m, f"{fn} not found in {source}"
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    assert all(re.fullmatch(r"(const )?(void\*|int\*?|long long) \w+", p)
               for p in params)
    return [ctypes.c_void_p if "*" in p else
            ctypes.c_longlong if p.startswith("long long") else ctypes.c_int
            for p in params]


@pytest.mark.parametrize("argtypes,source,fn", [
    (flash_kde._ARGTYPES, "flash_kde.cu", "flash_kde_launch"),
    (flash_pruned._KDE_ARGTYPES, "flash_pruned.cu",
     "flash_pruned_kde_launch"),
    (flash_pruned._SCORE_ARGTYPES, "flash_pruned.cu",
     "flash_pruned_score_launch"),
    (flash_score._ARGTYPES, "flash_score.cu", "flash_score_launch"),
    (flash_laplace._ARGTYPES, "flash_laplace.cu", "flash_laplace_launch"),
    (flash_laplace._ARGTYPES, "flash_laplace.cu", "sq_moment_launch"),
    (selective_scan._ARGTYPES, "selective_scan.cu",
     "selective_scan_launch"),
    (selective_scan._FUSED_ARGTYPES, "selective_scan.cu",
     "selective_scan_fused_launch"),
    (selective_scan._OCCUPANCY_ARGTYPES, "selective_scan.cu",
     "selective_scan_occupancy"),
])
def test_ctypes_bindings_match_the_c_entry_points(argtypes, source, fn):
    """Each wrapper's argtypes list the C function's parameters in order:
    a pointer passed as an int would be cut to 32 bits."""
    assert list(argtypes) == _c_argtypes(source, fn)
