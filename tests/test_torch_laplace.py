"""The port's Laplace-corrected path (kernels B5/B6, ``LaplaceKDE``,
``method="laplace"`` serving) and oracle-error metrics against the JAX
package, on the CPU.

Inputs are numpy arrays made from a seed and handed to both packages.
The JAX side runs as its own tests run it: Pallas in interpret mode,
explicit blocks; ``prune="off"`` unless a test is about pruning.  Where
each side clusters for itself (prune=0.0) only final sums are compared.

Tolerances, and why:
  * Laplace sums and densities cross zero, so a relative bar on them is
    meaningless there.  Each row j is held to ``|got − want| ≤ bar·A_j``,
    with the absolute mass ``A_j = Σ_i φ_ji·(2 + d/2 + scaled_ji)`` (B5
    and every Laplace density, normalized like the density) or
    ``Σ_i φ_ji·(sq_ji + 2h²)`` (B6), which the plain versions return
    (``kernels/flash_laplace.py`` derives them); ``bar`` is the tier's
    (f32 1e-5, bf16x2 5e-4, bf16 5e-2), and never below the f32
    norm-trick model 8·eps·max‖x‖²/(2h²), which is f32 at every tier;
  * the oracle score against ``jax.grad``: rtol 1e-5 with atol 1e-5 of
    the largest component (both f32; logsumexp rounds differently); the
    closed form against ``torch.autograd`` in float64: 1e-12;
  * oracle errors on the same estimate values: rtol 1e-5 — the port
    evaluates p, q and the integrands in float64, JAX in float32;
  * pruned Laplace at epsilon > 0: float64 error ≤ the row tile's
    certificate·(1 + 1e-5) plus bar·A_j.
"""

import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import estimator as jest
from repro.core import kde as jkde
from repro.core import metrics as jmet
from repro.core import mixtures as jmix
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_laplace import flash_laplace_pallas, sq_moment_pallas
from repro.serve import QueryRequest as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.core import kde as tkde
from repro_torch.core import metrics as tmet
from repro_torch.core import mixtures as tmix
from repro_torch.core.bandwidth import silverman_bandwidth
from repro_torch.core.estimator import EstimatorConfig, LaplaceKDE
from repro_torch.kernels import flash_laplace as tfl
from repro_torch.kernels import flash_pruned as tfp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import spatial as tsp
from repro_torch.serve import QueryRequest, ServeConfig, ServeEngine

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (helpers only; its main needs a card)

TIERS = ["f32", "bf16x2", "bf16"]
TIER_BAR = {"f32": 1e-5, "bf16x2": 5e-4, "bf16": 5e-2}
F32_EPS = float(np.finfo(np.float32).eps)
BM, BN = 32, 64

# (n, m, d): ragged, d = 16, d = 1 (Fig. 4's dimension), ragged d = 1
SHAPES = [(300, 50, 16), (513, 129, 16), (256, 64, 1), (200, 37, 1)]


def bar(precision, pts, h):
    model = 8 * F32_EPS * float(np.max(np.sum(pts * pts, 1))) / (2 * h * h)
    return max(TIER_BAR[precision], model)


def assert_within_mass(got, want, mass, rtol):
    got = np.asarray(got, np.float64).reshape(-1)
    want = np.asarray(want, np.float64).reshape(-1)
    mass = np.asarray(mass, np.float64).reshape(-1)
    assert np.all(np.isfinite(got))
    excess = np.abs(got - want) - rtol * mass
    assert excess.max() <= 0, (float(excess.max()), rtol)


def _t(a):
    """A JAX array (f32 or bf16) as a torch tensor of the same bits."""
    if a is None:
        return None
    a = np.asarray(a)
    if a.dtype == np.float32:
        return torch.from_numpy(a.copy())
    return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)


def _data(n, m, d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (1.2 * rng.standard_normal((m, d))).astype(np.float32)
    return x, y


def _clustered(n, d, k=8, spread=8.0, sigma=0.05, seed=0):
    centers = np.random.default_rng([7, d, k]).uniform(0.0, spread, (k, d))
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, k, n)
    return (centers[lab] + sigma * rng.standard_normal((n, d))).astype(
        np.float32)


def laplace_mass(x, y, h):
    """Normalized absolute mass of each query row's Laplace density, in
    float64: Σ_i φ·(2 + d/2 + scaled) / (n (2π)^{d/2} h^d)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    n, d = x.shape
    s = ((y[:, None, :] - x[None]) ** 2).sum(-1) / (2 * h * h)
    a = (np.exp(-s) * (2 + d / 2 + s)).sum(1)
    return a / (n * (2 * math.pi) ** (d / 2) * h**d)


def laplace_f64(x, y, h):
    """The normalized Laplace-corrected density in float64."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    n, d = x.shape
    s = ((y[:, None, :] - x[None]) ** 2).sum(-1) / (2 * h * h)
    return (np.exp(-s) * (1 + d / 2 - s)).sum(1) / (
        n * (2 * math.pi) ** (d / 2) * h**d)


# ---------------------------------------------------------------------------
# (a) B5 and B6: plain versions against the Pallas kernels in interpret mode.
# ---------------------------------------------------------------------------


def _check_plain_against_pallas(x, y, h, kernel, precision, block_m,
                                block_n):
    """B5 or B6 (``kernel``) at one tier: the port's wrapper on CPU
    tensors (its plain version, no launch counted) against the Pallas
    kernel in interpret mode on the same padded operands, each real row
    within bar·A_j."""
    m = y.shape[0]
    y_ops, xt_ops, nrm_y, nrm_x = jops._prep_eval(
        jnp.asarray(x), jnp.asarray(y), block_m, block_n, precision)
    inv = jops._inv2h2(h)
    jfn = flash_laplace_pallas if kernel == "laplace" else sq_moment_pallas
    want = jfn(y_ops[0], nrm_y, xt_ops[0], nrm_x, inv, y_ops[1], xt_ops[1],
               block_m=block_m, block_n=block_n, interpret=True)
    args = [_t(a) for a in (y_ops[0], nrm_y, xt_ops[0], nrm_x, inv,
                            y_ops[1], xt_ops[1])]
    tfn, plain = {"laplace": (tfl.flash_laplace, tfl.flash_laplace_plain),
                  "sq_moment": (tfl.sq_moment, tfl.sq_moment_plain)}[kernel]
    before = (tfl.laplace_launches, tfl.sq_moment_launches)
    got = tfn(*args, block_m=block_m, block_n=block_n)
    ref, mass = plain(*args, block_n=block_n, mass=True)
    # CPU tensors: the plain version, and no kernel launch counted
    assert (tfl.laplace_launches, tfl.sq_moment_launches) == before
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert got.shape == (y_ops[0].shape[0], 1) and got.dtype == torch.float32
    assert bool((mass[:m] >= got[:m].abs() * (1 - 1e-6)).all())
    pts = np.concatenate([x, y])
    assert_within_mass(got[:m], np.asarray(want)[:m], mass[:m],
                       bar(precision, pts, h))


@pytest.mark.parametrize("precision", TIERS)
@pytest.mark.parametrize("kernel", ["laplace", "sq_moment"])
@pytest.mark.parametrize("n,m,d", SHAPES)
def test_plain_matches_pallas(n, m, d, kernel, precision):
    x, y = _data(n, m, d, seed=n + d)
    h = 0.7 if d > 1 else 0.3
    _check_plain_against_pallas(x, y, h, kernel, precision, BM, BN)


# the blocks the card also checks B5/B6 at: block_m 96 (a half-idle
# 64-row block), block_n 100 (one masked chunk a tile) and 200 (two
# chunks, one masked); the wrapper pads to them
ODD_BLOCKS = [(96, 100), (64, 200)]


@pytest.mark.parametrize("precision", TIERS)
@pytest.mark.parametrize("kernel", ["laplace", "sq_moment"])
@pytest.mark.parametrize("block_m,block_n", ODD_BLOCKS)
def test_plain_matches_pallas_at_odd_blocks(block_m, block_n, kernel,
                                            precision):
    x, y = _data(300, 50, 16, seed=block_n)
    _check_plain_against_pallas(x, y, 0.7, kernel, precision, block_m,
                                block_n)


@pytest.mark.parametrize("precision", TIERS)
@pytest.mark.parametrize("kernel", ["laplace", "sq_moment"])
@pytest.mark.parametrize("d", [24, 64])
def test_plain_matches_pallas_at_wide_d(d, kernel, precision):
    """d = 24 and 64, the kernels' DMAX 32 and 64 builds, h 0.5·√d."""
    x, y = _data(200, 40, d, seed=d)
    _check_plain_against_pallas(x, y, 0.5 * math.sqrt(d), kernel, precision,
                                BM, BN)


@pytest.mark.parametrize("precision", TIERS)
@pytest.mark.parametrize("kernel", ["laplace", "sq_moment"])
def test_plain_matches_pallas_on_fig4_mixture(kernel, precision):
    """Fig. 4's setting at a CPU size: the 1-D trimodal mixture, n 1024
    train points and m 128 queries drawn with numpy, h 0.3."""
    mix = jmix.benchmark_mixture_1d()
    rng = np.random.default_rng(4)

    def draw(k):
        comp = rng.choice(len(mix.weights), size=k, p=mix.weights)
        return (mix.means[comp] + mix.stds[comp, None]
                * rng.standard_normal((k, 1))).astype(np.float32)

    x, y = draw(1024), draw(128)
    _check_plain_against_pallas(x, y, 0.3, kernel, precision, BM, BN)


def test_laplace_sums_match_the_oracles():
    x, y = _data(200, 40, 5, seed=3)
    h = 0.6
    want = np.asarray(jref.ref_laplace_sums(jnp.asarray(x), jnp.asarray(y),
                                            h))
    got = tref.ref_laplace_sums(torch.from_numpy(x), torch.from_numpy(y), h)
    y_ops, xt_ops, nrm_y, nrm_x = tops._prep_eval(
        torch.from_numpy(x), torch.from_numpy(y), BM, BN, "f32")
    plain, mass = tfl.flash_laplace_plain(
        y_ops[0], nrm_y, xt_ops[0], nrm_x, tops._inv2h2(h, "cpu"),
        block_n=BN, mass=True)
    rtol = bar("f32", np.concatenate([x, y]), h)
    assert_within_mass(got, want, mass[:40], rtol)
    assert_within_mass(plain[:40], want, mass[:40], rtol)


def test_cuda_wrappers_refuse_cpu_tensors():
    x, y = _data(128, 64, 4)
    y_ops, xt_ops, nrm_y, nrm_x = tops._prep_eval(
        torch.from_numpy(x), torch.from_numpy(y), 128, 128, "f32")
    args = (y_ops[0], nrm_y, xt_ops[0], nrm_x, tops._inv2h2(0.5, "cpu"))
    before = (tfl.laplace_launches, tfl.sq_moment_launches)
    for fn in (tfl.flash_laplace_cuda, tfl.sq_moment_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)
    assert (tfl.laplace_launches, tfl.sq_moment_launches) == before


@pytest.mark.parametrize("plain", [tfl.flash_laplace_plain,
                                   tfl.sq_moment_plain])
def test_sentinel_columns_add_exactly_zero(plain):
    """A column block of sentinels adds exactly 0.0 (the weights are huge,
    φ underflows to 0): 64 train points padded to 128, summed in blocks
    of 64, give the unpadded sums bit for bit."""
    x, y = _data(64, 32, 4, seed=4)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    sums = []
    for pad_to in (64, 128):
        y_ops, xt_ops, nrm_y, nrm_x = tops._prep_eval(xt, yt, 32, pad_to,
                                                      "f32")
        sums.append(plain(y_ops[0], nrm_y, xt_ops[0], nrm_x,
                          tops._inv2h2(0.5, "cpu"), block_n=64))
    assert tuple(sums[1].shape) == (32, 1)
    torch.testing.assert_close(sums[1], sums[0], rtol=0, atol=0)


@pytest.mark.parametrize("mangled,key", [
    ("_ZN5flash15kde_pass_kernelIfLb0ELi16ELNS_6WeightE1ENS_8AllTilesEEEvPK"
     "T_S5_PKfS5_S5_S7_S7_Pfiiiiiiii", "kde_pass<f32,16,laplace>"),
    ("_ZN5flash15kde_pass_kernelI13__nv_bfloat16Lb1ELi64ELNS_6WeightE2ENS_8"
     "AllTilesEEEvPKT_S6_PKfS6_S6_S8_S8_Pfiiiiiiii",
     "kde_pass<bf16x2,64,sq_moment>"),
    ("_ZN5flash15kde_pass_kernelIfLb0ELi4ELNS_6WeightE1ENS_9VisitListEEEvPK"
     "T_S5_PKfS5_S5_S7_S7_Pfiiiiiiii", "kde_pass<f32,4,laplace,visits>"),
    # the one-thread-per-row body is gone: its name is no flash kernel's
    ("_ZN5flash10kde_kernelIfLb0ELi16ELNS_6WeightE2ENS_8AllTilesEEEvPKT_",
     "_ZN5flash10kde_kernelIfLb0ELi16ELNS_6WeightE2ENS_8AllTilesEEEvPKT_"),
])
def test_chip_smoke_names_the_laplace_instantiations(mangled, key):
    """chip_smoke's phase 2 reads B5's and B6's registers, spills and
    tensor-core counts by these names, and the kernels line picks B5's
    and B6's by their weight."""
    assert chip_smoke.kernel_key(mangled) == key


# ---------------------------------------------------------------------------
# (b) The ops wrappers: dense, prune=0.0 and non-fused against JAX.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", TIERS)
def test_flash_laplace_kde_dense_matches_jax(precision):
    x, y = _data(400, 90, 8, seed=5)
    h = 0.8
    kw = dict(precision=precision, block_m=BM, block_n=128)
    want = jops.flash_laplace_kde(jnp.asarray(x), jnp.asarray(y), h,
                                  interpret=True, prune="off", **kw)
    got = tops.flash_laplace_kde(torch.from_numpy(x), torch.from_numpy(y), h,
                                 prune="off", **kw)
    assert got.shape == (90,)
    assert_within_mass(got, want, laplace_mass(x, y, h),
                       bar(precision, np.concatenate([x, y]), h))


@pytest.mark.parametrize("precision", TIERS)
def test_laplace_kde_nonfused_matches_jax_and_fused(precision):
    x, y = _data(400, 90, 8, seed=6)
    h = 0.8
    kw = dict(precision=precision, block_m=BM, block_n=128)
    want = jops.laplace_kde_nonfused(jnp.asarray(x), jnp.asarray(y), h,
                                     interpret=True, **kw)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    got = tops.laplace_kde_nonfused(xt, yt, h, **kw)
    fused = tops.flash_laplace_kde(xt, yt, h, prune="off", **kw)
    mass = laplace_mass(x, y, h)
    rtol = bar(precision, np.concatenate([x, y]), h)
    assert_within_mass(got, want, mass, rtol)
    assert_within_mass(got, fused, mass, rtol)


@pytest.mark.parametrize("precision", TIERS)
def test_flash_laplace_kde_prune0_matches_jax_and_dense(precision):
    x, y = _clustered(900, 6, seed=16), _clustered(300, 6, seed=17)
    h = 0.35
    kw = dict(precision=precision, block_m=BM, block_n=128)
    want = jops.flash_laplace_kde(jnp.asarray(x), jnp.asarray(y), h,
                                  interpret=True, prune=0.0, **kw)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    counts = tfp.laplace_counts.launches, tfp.kde_counts.launches
    got = tops.flash_laplace_kde(xt, yt, h, prune=0.0, **kw)
    dense = tops.flash_laplace_kde(xt, yt, h, prune="off", **kw)
    assert (tfp.laplace_counts.launches, tfp.kde_counts.launches) == counts
    pts = np.concatenate([x, y])
    mass = laplace_mass(x, y, h)
    assert_within_mass(got, want, mass, bar(precision, pts, h))
    assert_within_mass(got, dense, mass, bar("f32", pts, h))
    np.testing.assert_array_equal(got.numpy() == 0, dense.numpy() == 0)


def test_pruned_laplace_uses_the_laplace_bound_kind(monkeypatch):
    x, y = _clustered(600, 5, seed=21), _clustered(200, 5, seed=22)
    kinds = []
    real = tsp.tile_map

    def spy(*a, **kw):
        kinds.append(kw.get("kind"))
        return real(*a, **kw)

    monkeypatch.setattr(tsp, "tile_map", spy)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    tops.flash_laplace_kde(xt, yt, 0.4, block_m=BM, block_n=128, prune=0.0)
    tops.flash_kde(xt, yt, 0.4, block_m=BM, block_n=128, prune=0.0)
    assert kinds == ["laplace", "kde"]


@pytest.mark.parametrize("h", [0.35, 0.6])
def test_prune_1e7_laplace_keeps_f64_error_within_certificate(h):
    """Pruned Laplace at epsilon > 0, through the ops path: every row's
    float64 error stays within its row tile's Laplace certificate plus
    the f32 bar of its absolute mass."""
    x, y = _clustered(1200, 6, seed=42), _clustered(400, 6, seed=43)
    eps = 1e-7
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    cols = tops.prepare_train_columns(xt, block_n=BN, clustered=True)
    got = tops._pruned_eval_sums(yt, cols, h, eps, precision="f32",
                                 block_m=BM, block_n=BN,
                                 laplace=True).double().numpy()
    ql = tsp.cluster_layout(yt, tsp.assign(yt, cols.index), BM,
                            bucket_rows=True)
    inv = torch.tensor([[1.0 / (2 * h * h)]])
    tm = tsp.tile_map(ql.points, cols.meta, inv, eps, block_m=BM,
                      kind="laplace")
    row_err = tm.err_bound.double()[ql.slots // BM].numpy()
    assert row_err.max() > 0                     # something was dropped
    norm = x.shape[0] * (2 * math.pi) ** 3 * h**6
    exact = laplace_f64(x, y, h) * norm
    mass = laplace_mass(x, y, h) * norm
    excess = np.abs(got - exact) - (row_err * (1 + 1e-5)
                                    + bar("f32", np.concatenate([x, y]), h)
                                    * mass)
    assert excess.max() <= 0, float(excess.max())


# ---------------------------------------------------------------------------
# (c) The plain math and the estimator API.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,m,d", [(300, 50, 16), (256, 64, 1), (700, 33, 3)])
def test_laplace_kde_eval_and_nonfused_match_jax(n, m, d):
    x, y = _data(n, m, d, seed=9)
    h = 0.7 if d > 1 else 0.3
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    mass = laplace_mass(x, y, h)
    rtol = bar("f32", np.concatenate([x, y]), h)
    for jfn, tfn in ((jkde.laplace_kde_eval, tkde.laplace_kde_eval),
                     (jkde.laplace_kde_eval_nonfused,
                      tkde.laplace_kde_eval_nonfused)):
        want = jfn(jnp.asarray(x), jnp.asarray(y), h, block=128)
        got = tfn(xt, yt, h, block=128)
        assert_within_mass(got, want, mass, rtol)
        assert_within_mass(got, laplace_f64(x, y, h), mass, rtol)


def test_sdkde_eval_oracle_matches_jax():
    mixj, mixt = jmix.benchmark_mixture_16d(), tmix.benchmark_mixture_16d()
    x, y = _data(256, 40, 16, seed=10)
    h = 0.9
    want = jkde.sdkde_eval_oracle(jnp.asarray(x), jnp.asarray(y), h,
                                  mixj.score, block=128)
    got = tkde.sdkde_eval_oracle(torch.from_numpy(x), torch.from_numpy(y), h,
                                 mixt.score, block=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6 * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def est_data():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((384, 8)).astype(np.float32),
            rng.standard_normal((300, 8)).astype(np.float32))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("backend", ["flash", "torch"])
def test_laplace_estimator_matches_jax(est_data, backend, fused):
    x, y = est_data
    jcfg = (jest.EstimatorConfig(backend="pallas", interpret=True,
                                 prune="off", block_m=BM, block_n=128)
            if backend == "flash" else
            jest.EstimatorConfig(backend="jnp", block=128))
    jfit = jest.LaplaceKDE(config=jcfg, fused=fused).fit(jnp.asarray(x))
    want = jfit.evaluate(jnp.asarray(y))
    est = LaplaceKDE(config=EstimatorConfig(
        backend=backend, device="cpu", block_m=BM, block_n=128, block=128),
        fused=fused).fit(x)
    assert est.h == pytest.approx(float(jfit.h), rel=1e-6)
    got = est.evaluate(y)
    assert got.shape == (300,) and got.device.type == "cpu"
    mass = laplace_mass(x, y, est.h)
    rtol = bar("f32", np.concatenate([x, y]), est.h)
    assert_within_mass(got, want, mass, rtol)
    assert_within_mass(got, laplace_f64(x, y, est.h), mass, rtol)
    assert float(got.min()) < 0 < float(got.max())   # signed, as designed


def test_laplace_estimator_routes_fused_and_nonfused(monkeypatch):
    """fused=True takes ops.flash_laplace_kde with the config's prune;
    fused=False the non-fused baseline, dense whatever prune says."""
    x, y = _data(300, 40, 4, seed=11)
    calls = []
    for name in ("flash_laplace_kde", "laplace_kde_nonfused"):
        def spy(*a, _real=getattr(tops, name), _name=name, **k):
            calls.append((_name, k.get("prune")))
            return _real(*a, **k)
        monkeypatch.setattr(tops, name, spy)
    cfg = EstimatorConfig(device="cpu", block_m=BM, block_n=128, prune=0.0)
    LaplaceKDE(0.5, cfg).fit(x).evaluate(y)
    LaplaceKDE(0.5, cfg, fused=False).fit(x).evaluate(y)
    assert calls == [("flash_laplace_kde", 0.0),
                     ("laplace_kde_nonfused", None)]


def test_laplace_estimator_ring_still_raises():
    """The ring Laplace estimator (a ring of one here) raises before a
    fit, as every estimator does, and after one agrees with the flash
    path's fused densities (B5's plain version on both sides) at the f32
    bar."""
    est = LaplaceKDE(0.5, EstimatorConfig(backend="ring", device="cpu"))
    y = torch.zeros((4, 3))
    with pytest.raises(RuntimeError, match="fit"):
        est.evaluate(y)
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((200, 3)).astype(np.float32))
    y = torch.as_tensor(rng.standard_normal((50, 3)).astype(np.float32))
    got = est.fit(x).evaluate(y)
    want = LaplaceKDE(0.5, EstimatorConfig(device="cpu", prune="off")
                      ).fit(x).evaluate(y)
    peak = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * peak)


def test_convert_laplace_from_state(est_data):
    x, y = est_data
    jcfg = jest.EstimatorConfig(backend="pallas", interpret=True,
                                prune="off", block_m=BM, block_n=128)
    jfit = jest.LaplaceKDE(config=jcfg, fused=False).fit(jnp.asarray(x))
    est = convert.laplace_from_state(
        np.asarray(jfit.x_train), float(jfit.h), fused=jfit.fused,
        config=EstimatorConfig(device="cpu", block_m=BM, block_n=128))
    assert est.fused is False and est.h == float(jfit.h)
    np.testing.assert_array_equal(est.x_train.numpy(), x)
    assert_within_mass(est.evaluate(y), jfit.evaluate(jnp.asarray(y)),
                       laplace_mass(x, y, est.h),
                       bar("f32", np.concatenate([x, y]), est.h))


# ---------------------------------------------------------------------------
# (d) The oracle score and the oracle-error metrics.
# ---------------------------------------------------------------------------

MIXTURES = {"16d": "benchmark_mixture_16d", "1d": "benchmark_mixture_1d"}


@pytest.mark.parametrize("which", ["16d", "1d", "dim3", "dim8"])
def test_mixture_score_matches_jax_grad(which):
    if which in MIXTURES:
        jm, tm = (getattr(mod, MIXTURES[which])() for mod in (jmix, tmix))
    else:
        d = int(which[3:])
        jm, tm = jmix.mixture_for_dim(d), tmix.mixture_for_dim(d)
    z = (2.0 * np.random.default_rng(5).standard_normal(
        (200, tm.dim))).astype(np.float32)
    want = np.asarray(jm.score(jnp.asarray(z)))
    got = tm.score(torch.from_numpy(z))
    assert got.dtype == torch.float32 and got.shape == z.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    # the closed form is the gradient of log_pdf (float64, autograd)
    z64 = torch.from_numpy(z).double().requires_grad_(True)
    (grad,) = torch.autograd.grad(tm.log_pdf(z64).sum(), z64)
    torch.testing.assert_close(tm.score(z64.detach()), grad, rtol=1e-12,
                               atol=1e-12)


def _np_estimator(kind, x, h):
    """A KDE or Laplace estimate computed in numpy float64 and returned as
    float32, so both packages integrate the same values."""
    def f(z):
        z = np.asarray(z, np.float64)
        n, d = x.shape
        s = ((z[:, None, :] - x[None].astype(np.float64)) ** 2).sum(-1) / (
            2 * h * h)
        w = 1.0 if kind == "kde" else (1 + d / 2 - s)
        return ((np.exp(-s) * w).sum(1) / (
            n * (2 * math.pi) ** (d / 2) * h**d)).astype(np.float32)
    return f


def _rel(a, b, rtol):
    assert a == pytest.approx(b, rel=rtol, abs=1e-12 * max(1.0, abs(b)))


@pytest.mark.parametrize("kind", ["kde", "laplace"])
def test_oracle_errors_grid_matches_jax(kind):
    jm, tm = jmix.benchmark_mixture_1d(), tmix.benchmark_mixture_1d()
    x = np.asarray(jm.sample(jax.random.PRNGKey(1), 512))
    f = _np_estimator(kind, x, 0.3)
    want = jmet.oracle_errors(lambda g: jnp.asarray(f(np.asarray(g))), jm)
    got = tmet.oracle_errors(lambda g: torch.from_numpy(f(g.numpy())), tm,
                             device="cpu")
    _rel(got.mise, want.mise, 1e-5)
    _rel(got.miae, want.miae, 1e-5)
    _rel(got.neg_mass, want.neg_mass, 1e-5)
    assert (got.neg_mass > 0) == (kind == "laplace")


@pytest.mark.parametrize("kind", ["kde", "laplace"])
def test_oracle_errors_importance_matches_jax_on_the_same_samples(kind):
    jm, tm = jmix.benchmark_mixture_16d(), tmix.benchmark_mixture_16d()
    x = np.asarray(jm.sample(jax.random.PRNGKey(2), 500))
    f = _np_estimator(kind, x, 0.9)
    key = jax.random.PRNGKey(3)
    want = jmet.oracle_errors_importance(
        lambda g: jnp.asarray(f(np.asarray(g))), jm, key, n_mc=1024)
    z = np.asarray(jmet.widened_proposal(jm).sample(key, 1024))
    got = tmet.oracle_errors_at(lambda g: torch.from_numpy(f(g.numpy())), tm,
                                torch.from_numpy(z.copy()))
    _rel(got.mise, want.mise, 1e-5)
    _rel(got.miae, want.miae, 1e-5)
    _rel(got.neg_mass, want.neg_mass, 1e-5)


def test_oracle_errors_importance_is_seeded():
    tm = tmix.benchmark_mixture_16d()
    x = np.random.default_rng(4).standard_normal((300, 16)).astype(
        np.float32)
    f = _np_estimator("laplace", x, 0.9)
    fn = lambda g: torch.from_numpy(f(g.numpy()))   # noqa: E731

    def run(seed):
        return tmet.oracle_errors_importance(
            fn, tm, torch.Generator().manual_seed(seed), n_mc=512)

    assert run(0) == run(0) != run(1)
    assert tmet.oracle_errors(fn, tm, device="cpu", n_mc=512) == run(0)
    with pytest.raises(ValueError, match="1-D"):
        tmet.oracle_errors_grid(fn, tm, -1.0, 1.0, device="cpu")


def test_laplace_lowers_mise_on_the_1d_mixture():
    """Fig. 3's ordering at one size, on the port's estimators (CPU):
    Laplace below KDE, fused equal to non-fused."""
    tm = tmix.benchmark_mixture_1d()
    x = tm.sample(4096, torch.Generator().manual_seed(0))
    h = float(silverman_bandwidth(x))
    cfg = EstimatorConfig(device="cpu", block_m=128, block_n=512)
    kde = LaplaceKDE(h, cfg).fit(x)
    errs = {name: tmet.oracle_errors(fn, tm, device="cpu") for name, fn in {
        "kde": lambda g: tkde.kde_eval(x, g, h),
        "laplace": kde.evaluate,
        "laplace_nonfused": LaplaceKDE(h, cfg, fused=False).fit(x).evaluate,
    }.items()}
    assert errs["laplace"].mise < errs["kde"].mise
    _rel(errs["laplace_nonfused"].mise, errs["laplace"].mise, 1e-3)


# ---------------------------------------------------------------------------
# (e) Serving with method="laplace".
# ---------------------------------------------------------------------------

H = 0.6
RAGGED = (1, 7, 16, 33, 128, 200)


def _cfg(backend="flash", **kw):
    base = dict(backend=backend, method="laplace", block_m=8, block_n=128,
                block=128, min_batch=16, max_batch=128, device="cpu")
    base.update(kw)
    return ServeConfig(**base)


def _jcfg(backend="pallas", **kw):
    base = dict(backend=backend, method="laplace", interpret=True, block_m=8,
                block_n=128, block=128, min_batch=16, max_batch=128,
                prune="off", rff="off")
    base.update(kw)
    return JServeConfig(**base)


@pytest.mark.parametrize("backend", ["flash", "torch"])
def test_engine_laplace_matches_jax_engine(est_data, backend):
    x, y = est_data
    jeng = JServeEngine(_jcfg("pallas" if backend == "flash" else "jnp"))
    jeng.register("ds", jnp.asarray(x), h=H)
    eng = ServeEngine(_cfg(backend))
    eng.register("ds", x, h=H)
    rtol = bar("f32", np.concatenate([x, y]), H)
    for m in RAGGED:                 # spans buckets, exact fits, chunking
        want = jeng.query(JRequest(key="ds", points=jnp.asarray(y[:m])))
        ans = eng.query(QueryRequest(key="ds", points=y[:m]))
        assert ans.value.shape == (m,) and ans.tier == "f32"
        assert_within_mass(ans.value, want.value,
                           laplace_mass(x, y[:m], H), rtol)
    parts = (y[:3], y[3:50], y[50:61], y[61:200])
    want = jeng.query_many([JRequest(key="ds", points=jnp.asarray(p))
                            for p in parts])
    got = eng.query_many([QueryRequest(key="ds", points=p) for p in parts])
    assert [a.value.shape[0] for a in got] == [3, 47, 11, 139]
    for g, w, p in zip(got, want, parts):
        assert_within_mass(g.value, w.value, laplace_mass(x, p, H), rtol)


def test_registry_serves_raw_points_at_the_silverman_bandwidth(est_data):
    x, _ = est_data
    eng = ServeEngine(_cfg())
    prep = eng.register("ds", x)
    np.testing.assert_array_equal(prep.points.numpy(), x)
    assert prep.h == pytest.approx(
        float(silverman_bandwidth(torch.from_numpy(x))), rel=1e-7)
    jeng = JServeEngine(_jcfg())
    assert prep.h == pytest.approx(jeng.register("ds", jnp.asarray(x)).h,
                                   rel=1e-6)


def test_engine_laplace_pruned_matches_dense():
    x, y = _clustered(900, 6, seed=23), _clustered(250, 6, seed=24)
    h = 0.4
    dense = ServeEngine(_cfg(prune="off", block_m=BM, max_batch=256))
    pruned = ServeEngine(_cfg(prune=0.0, block_m=BM, max_batch=256))
    for eng in (dense, pruned):
        eng.register("ds", x, h=h)
    assert pruned.registry.get("ds").columns_for("f32").meta is not None
    a = dense.query(QueryRequest(key="ds", points=y)).value
    b = pruned.query(QueryRequest(key="ds", points=y)).value
    assert_within_mass(b, a, laplace_mass(x, y, h),
                       bar("f32", np.concatenate([x, y]), h))


def test_convert_prepared_laplace_estimator(est_data):
    x, y = est_data
    jeng = JServeEngine(_jcfg())
    jprep = jeng.register("ds", jnp.asarray(x), h=H)
    prep = convert.prepared_from_state(
        "ds", np.asarray(jprep.points), jprep.h, jprep.n_true, jprep.d,
        jprep.norm, block_m=jprep.block_m, block_n=jprep.block_n,
        config=_cfg())
    assert prep.config.method == "laplace"
    eng = ServeEngine(_cfg())
    eng.registry.adopt(prep)
    want = jeng.query(JRequest(key="ds", points=jnp.asarray(y)))
    assert_within_mass(eng.query(QueryRequest(key="ds", points=y)).value,
                       want.value, laplace_mass(x, y, H),
                       bar("f32", np.concatenate([x, y]), H))
