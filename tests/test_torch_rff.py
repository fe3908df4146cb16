"""The port's RFF fast tier (``repro_torch.kernels.flash_rff``) against
``repro.kernels.flash_rff``.

The two packages' k-means draw different numbers from one seed, so a
fresh fit differs in its pilot anchors.  The frequencies are drawn with
numpy from the seed on both sides and are identical.  Parity therefore
carries state across: ``convert.rff_from_state`` for evaluation and
updates, and ``convert.index_from_state`` of repro's own index for the
fit's sums.

Tolerances, from the error model:
  * p̂ with carried state: both sides evaluate f32 phases (a d-term dot
    of magnitude T = Σ_k |w_k y_k|, rounding ~d·eps·T), cos/sin, and the
    group means; a row of the estimate moves by at most
    (Σ_j (|rc_j| + |rs_j|)·(d·eps·T_j + 2 eps))/(D/2)/norm plus the
    pilot's f32 rounding, 4·eps·S_pilot/norm.  The tests hold p̂ to twice
    that per row.
  * the fit's feature sums: f32 phases a block on both sides (repro's
    block sums in f32, the port's in float64), so each sum is within the
    same f32 phase model, Σ_i (d·eps·Σ_k |w_k x_k| + 2 eps), of the
    float64 sums, and the two within twice it.
  * updates run in float64 on both sides: 1e-9 relative of the sums'
    magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.mixtures import mixture_for_dim
from repro.kernels import flash_rff as jrff
from repro.kernels import spatial as jspatial
from repro_torch import convert
from repro_torch.kernels import flash_rff

EPS = float(np.finfo(np.float32).eps)


def _sample(n, d, seed=0, queries=64):
    """repro's test data (tests/test_rff_cascade.py): the same points."""
    mix = mixture_for_dim(d)
    key = jax.random.PRNGKey(seed)
    x = np.array(mix.sample(key, n), np.float32)
    y = np.array(mix.sample(jax.random.fold_in(key, 7), queries),
                 np.float32)
    return x, y


def _carry(st):
    return convert.rff_from_state(
        st.w, st.z_cos, st.z_sin, st.centroids, st.pilot_n, st.pilot_s1,
        st.pilot_ss, p_scale=st.p_scale, h=st.h, n=st.n, groups=st.groups,
        seed=st.seed, device="cpu")


def _f64_kde(x, y, h):
    x64 = torch.as_tensor(x, dtype=torch.float64)
    y64 = torch.as_tensor(y, dtype=torch.float64)
    n, d = x64.shape
    s = torch.exp(-torch.cdist(y64, x64) ** 2 / (2 * h * h)).sum(1)
    return (s / (n * (2 * np.pi) ** (d / 2) * h ** d)).numpy()


def _p_model(srv, y):
    """Per-row bound on p̂'s f32 rounding (module docstring)."""
    y64 = np.asarray(y, np.float64)
    wt = srv.wt.double().numpy()
    d = y64.shape[1]
    t_abs = np.abs(y64) @ np.abs(wt)                     # (m, D/2)
    res = np.abs(srv.res_cos.double().numpy()) \
        + np.abs(srv.res_sin.double().numpy())
    feat = ((d * EPS * t_abs + 2 * EPS) * res).mean(axis=1)
    mu = srv.mu.double().numpy()
    d2 = ((y64[:, None, :] - mu[None]) ** 2).sum(-1)
    pilot = (srv.beta.double().numpy()
             * np.exp(-d2 * srv.inv2s2.double().numpy())).sum(1)
    return (feat + 4 * EPS * (pilot + np.abs(y64).sum(1))) / srv.norm


def _sum_model(x, w):
    x64 = np.abs(np.asarray(x, np.float64))
    d = x64.shape[1]
    return d * EPS * (x64 @ np.abs(w).T).sum(0) + 2 * EPS * x64.shape[0]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n,d", [(2048, 2), (2048, 4), (4096, 3)])
def test_band_is_honest_where_repros_fails(n, d, seed):
    """The nine cases of repro's test_band_dominates_realized_error, with
    repro's fitted state carried over: the port's p̂ is repro's, its band
    is at least repro's on every row, and it bounds the realized error
    against float64 sums on every row — (2048, 4, 0) included, where
    repro's band is exceeded (ROADMAP C)."""
    x, y = _sample(n, d, seed=seed, queries=128)
    h = 0.5
    st = jrff.fit(x, h, n_features=2048, n_pilot=64, seed=seed)
    jp, jband = jrff.eval_density(st.serving(), jnp.asarray(y))
    jp, jband = np.asarray(jp, np.float64), np.asarray(jband, np.float64)
    tst = _carry(st)
    p, band = flash_rff.eval_density(tst.serving(), torch.as_tensor(y))
    p, band = p.double().numpy(), band.double().numpy()
    tol = 2 * _p_model(tst.serving(), y)
    assert (np.abs(p - jp) <= tol).all()
    # at least repro's band: the lower end of the interval is never above
    # max(|p̂|, floor); where both sit on the floor they agree to the
    # stderr's f32 rounding (group means of D/(2G) terms)
    assert (band >= jband * (1 - 1e-4)).all()
    want = _f64_kde(x, y, h)
    realized = flash_rff.realized_error(p, want, tst.p_scale)
    assert float((realized - band).max()) <= 0.0, (
        f"band exceeded by {float((realized - band).max()):.3e}")


@pytest.mark.parametrize("precision", ["f32", "bf16x2", "bf16"])
def test_eval_density_matches_repro_with_carried_state(precision):
    x, y = _sample(2048, 3, seed=4)
    st = jrff.fit(x, 0.4, n_features=1024, n_pilot=32, seed=4)
    jp, _ = jrff.eval_density(st.serving(), jnp.asarray(y),
                              precision=precision)
    tst = _carry(st)
    p, band = flash_rff.eval_density(tst.serving(), torch.as_tensor(y),
                                     precision=precision)
    # the reduced tiers cast y and w to bf16 on both sides with the same
    # rounding; their phases then differ by f32 summation order only
    tol = 2 * _p_model(tst.serving(), y)
    np.testing.assert_array_less(
        np.abs(p.double().numpy() - np.asarray(jp, np.float64)), tol + 1e-30)
    assert (band > 0).all() and p.shape == (64,)


def test_serving_tensors_match_repro():
    x, _ = _sample(2048, 2, seed=5)
    st = jrff.fit(x, 0.4, n_features=512, n_pilot=16, seed=5)
    js, ts = st.serving(), _carry(st).serving()
    for name in ("wt", "mu", "beta", "inv2s2"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)),
                                   rtol=2e-7, atol=0)
    # residuals are differences of float64 sums, rounded to f32 once
    for name in ("res_cos", "res_sin"):
        np.testing.assert_allclose(
            getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
            rtol=2e-7, atol=1e-9 * float(np.abs(st.z_cos).max()))
    assert ts.norm == pytest.approx(float(js.norm), rel=1e-7)
    assert ts.p_floor == pytest.approx(float(js.p_floor), rel=1e-7)
    assert ts.groups == js.groups


def test_fit_sums_match_repro_with_a_carried_index():
    x, _ = _sample(3000, 3, seed=6)
    h, seed, feats, pilot = 0.45, 6, 1024, 24
    st = jrff.fit(x, h, n_features=feats, n_pilot=pilot, seed=seed)
    jidx = jspatial.build_index(jnp.asarray(x), n_clusters=pilot, seed=seed)
    idx = convert.index_from_state(np.asarray(jidx.labels),
                                   np.asarray(jidx.centroids),
                                   device="cpu")
    tst = flash_rff.fit(x, h, n_features=feats, n_pilot=pilot, seed=seed,
                        index=idx, device="cpu")
    np.testing.assert_array_equal(tst.w.numpy(), st.w)
    np.testing.assert_allclose(tst.centroids.numpy(), st.centroids,
                               rtol=0, atol=0)
    np.testing.assert_array_equal(tst.pilot_n.numpy(), st.pilot_n)
    np.testing.assert_allclose(tst.pilot_s1.numpy(), st.pilot_s1,
                               rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(tst.pilot_ss.numpy(), st.pilot_ss,
                               rtol=1e-12)
    model = _sum_model(x, st.w)
    assert (np.abs(tst.z_cos.numpy() - st.z_cos) <= 2 * model).all()
    assert (np.abs(tst.z_sin.numpy() - st.z_sin) <= 2 * model).all()
    # the band floor's scale: the same 512 rows (the rng continues after
    # the frequencies on both sides), densities within the p̂ model
    assert tst.p_scale == pytest.approx(st.p_scale, rel=1e-4)
    assert tst.n == st.n and tst.groups == st.groups


def test_update_matches_repro_and_append_then_evict_returns():
    x, _ = _sample(2048, 2, seed=8)
    add, _ = _sample(200, 2, seed=9)
    st = jrff.fit(x, 0.4, n_features=512, n_pilot=16, seed=8)
    tst = _carry(st)
    z0 = (tst.z_cos.clone(), tst.z_sin.clone(), tst.pilot_n.clone(),
          tst.pilot_s1.clone(), tst.pilot_ss.clone())
    jrff.update(st, added=add, removed=x[:100])
    flash_rff.update(tst, added=add, removed=x[:100])
    scale = float(np.abs(st.z_cos).max()) + float(np.abs(st.z_sin).max())
    for got, want in ((tst.z_cos, st.z_cos), (tst.z_sin, st.z_sin)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-9 * scale)
    np.testing.assert_array_equal(tst.pilot_n.numpy(), st.pilot_n)
    np.testing.assert_allclose(tst.pilot_s1.numpy(), st.pilot_s1,
                               atol=1e-9)
    np.testing.assert_allclose(tst.pilot_ss.numpy(), st.pilot_ss,
                               rtol=1e-12)
    assert tst.n == st.n == 2048 + 200 - 100
    # undo it: the accumulators return to the fit's
    flash_rff.update(tst, added=x[:100], removed=add)
    for got, want in zip((tst.z_cos, tst.z_sin, tst.pilot_n, tst.pilot_s1,
                          tst.pilot_ss), z0):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-9 * float(want.abs().max() + 1))
    assert tst.n == 2048 and tst._serving is None


def test_weighted_update_folds_only_the_marked_rows():
    x, _ = _sample(1024, 2, seed=10)
    st = flash_rff.fit(x, 0.4, n_features=256, n_pilot=8, device="cpu")
    other = flash_rff.fit(x, 0.4, n_features=256, n_pilot=8, device="cpu")
    pts = torch.as_tensor(x[:50])
    wts = torch.zeros(50, dtype=torch.float64)
    wts[::5] = 1.0
    flash_rff.update(st, added=pts, added_weights=wts, n_live=1034)
    flash_rff.update(other, added=pts[::5])
    torch.testing.assert_close(st.z_cos, other.z_cos)
    torch.testing.assert_close(st.pilot_n, other.pilot_n)
    assert st.n == other.n == 1034


def test_realized_error_and_helpers_match_repro():
    rng = np.random.default_rng(0)
    p, want = rng.random(50), rng.random(50) * 1e-3
    np.testing.assert_array_equal(
        flash_rff.realized_error(torch.as_tensor(p), want, 0.2),
        jrff.realized_error(p, want, 0.2))
    assert flash_rff.supports("sdkde", "flash")
    assert flash_rff.supports("kde", "torch")
    assert not flash_rff.supports("laplace", "flash")
    lo = flash_rff.modeled_query_cost_us(1024, 4, n_features=2048)
    assert 0 < lo < flash_rff.modeled_query_cost_us(1024, 4,
                                                   n_features=8192)
    with pytest.raises(ValueError, match="multiple"):
        flash_rff.fit(np.zeros((16, 2), np.float32), 0.5, n_features=100,
                      groups=32, device="cpu")
