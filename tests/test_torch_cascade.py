"""The accuracy cascade through the port's engine (``serve/cascade.py``,
``serve/engine.py``, the registry's ``_RFFTier``) against ``repro``'s.

The engines run on the CPU: the port's ``flash`` backend through the
kernels' plain versions, ``repro``'s ``pallas`` backend in interpret
mode.  Inputs are repro's cascade test data (2-d mixture, numpy arrays).

Tolerances:
  * every answered row is held to its own bound against float64 sums:
    the tail-floored realized error of ``flash_rff.realized_error`` at
    most the row's ``rel_err_bounds`` (the band on fast-tier rows, the
    tier's rtol on escalated ones);
  * routing parity with ``repro`` carries repro's RFF state into the
    port's engine (``convert.rff_from_state``).  Each engine's hits are
    the rows whose own band fits the target; the port's band is at least
    repro's (ROADMAP C), so every row the port answers at the fast tier
    repro does too, except rows with a band within 1e-4 relative of the
    target (f32 rounding of the band), which are left out.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.mixtures import mixture_for_dim
from repro.kernels import flash_rff as jrff
from repro.serve import QueryRequest as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch import convert, obs
from repro_torch.kernels import flash_rff
from repro_torch.serve import BadRequest, QueryRequest, ServeConfig, \
    ServeEngine
from repro_torch.serve import cascade

D2, H = 2, 0.4


def _sample(n, d=D2, seed=0, queries=64):
    mix = mixture_for_dim(d)
    key = jax.random.PRNGKey(seed)
    x = np.array(mix.sample(key, n), np.float32)
    y = np.array(mix.sample(jax.random.fold_in(key, 7), queries),
                 np.float32)
    return x, y


def _engine(x, h=H, **kw):
    base = dict(backend="flash", method="kde", rff="on", rff_features=512,
                rff_pilot=32, min_batch=16, max_batch=128, block_m=16,
                device="cpu")
    base.update(kw)
    eng = ServeEngine(ServeConfig(**base))
    eng.register("ds", x, h=h)
    return eng


def _f64_kde(x, y, h=H):
    x64 = torch.as_tensor(np.asarray(x), dtype=torch.float64)
    y64 = torch.as_tensor(np.asarray(y), dtype=torch.float64)
    n, d = x64.shape
    s = torch.exp(-torch.cdist(y64, x64) ** 2 / (2 * h * h)).sum(1)
    return (s / (n * (2 * np.pi) ** (d / 2) * h ** d)).numpy()


def _within_bounds(ans, x, y, p_scale):
    real = flash_rff.realized_error(ans.value, _f64_kde(x, y), p_scale)
    assert ans.rel_err_bounds.shape == (y.shape[0],)
    assert float((real - ans.rel_err_bounds).max()) <= 0.0


def _val(name):
    m = obs.metrics_snapshot().get(name)
    return m["value"] if m else 0


@pytest.fixture(scope="module")
def data():
    return _sample(1024)


@pytest.fixture(scope="module")
def eng(data):
    return _engine(data[0])


def test_loose_target_answers_at_the_fast_tier(eng, data):
    x, y = data
    ans = eng.query(QueryRequest(key="ds", points=y, accuracy_target=10.0))
    assert ans.rff_hits == y.shape[0] and ans.escalated == 0
    assert ans.path == ("rff",) and ans.tier == "rff"
    assert float(ans.rel_err_bounds.max()) <= 10.0
    assert ans.value.device.type == "cpu"
    _within_bounds(ans, x, y, eng.registry.get("ds").rff.state.p_scale)


def test_tight_target_escalates_to_the_exact_tier(eng, data):
    x, y = data
    ans = eng.query(QueryRequest(key="ds", points=y, accuracy_target=1e-9))
    assert ans.rff_hits == 0 and ans.escalated == y.shape[0]
    assert ans.path == ("rff", "f32") and ans.tier == "f32"
    want = eng.query(QueryRequest(key="ds", points=y, precision="f32"))
    torch.testing.assert_close(ans.value, want.value, rtol=1e-6, atol=0)
    assert (ans.rel_err_bounds == cascade.exact_bound("f32", "auto")).all()
    _within_bounds(ans, x, y, eng.registry.get("ds").rff.state.p_scale)


def test_mixed_target_routes_each_row_by_its_band(eng, data):
    x, y = data
    prep = eng.registry.get("ds")
    _, band = flash_rff.eval_density(prep.rff.state.serving(),
                                     torch.as_tensor(y))
    target = float(np.median(band.numpy()))
    ans = eng.query(QueryRequest(key="ds", points=y,
                                 accuracy_target=target))
    fast = band.numpy() <= target
    assert ans.rff_hits == int(fast.sum()) and ans.escalated == int(
        (~fast).sum())
    assert 0 < ans.rff_hits < y.shape[0]
    assert ans.path == ("rff", "f32")
    np.testing.assert_array_equal(ans.rel_err_bounds[fast],
                                  band.double().numpy()[fast])
    _within_bounds(ans, x, y, prep.rff.state.p_scale)


def test_rff_pin_forces_the_fast_tier(eng, data):
    _, y = data
    ans = eng.query(QueryRequest(key="ds", points=y, precision="rff",
                                 accuracy_target=1e-9))
    assert ans.tier == "rff" and ans.escalated == 0
    assert ans.rff_hits == y.shape[0]


def test_exact_pin_skips_the_cascade(eng, data):
    _, y = data
    ans = eng.query(QueryRequest(key="ds", points=y, precision="f32",
                                 accuracy_target=10.0))
    assert ans.tier == "f32" and ans.rff_hits == 0 and ans.path == ("f32",)


def test_rff_off_makes_the_pin_raise(data):
    x, y = data
    off = _engine(x[:512], rff="off")
    with pytest.raises(BadRequest, match="rff"):
        off.query(QueryRequest(key="ds", points=y, precision="rff"))
    # a target alone answers exact when the tier is off
    ans = off.query(QueryRequest(key="ds", points=y, accuracy_target=10.0))
    assert ans.path == ("f32",) and ans.rff_hits == 0
    with pytest.raises(ValueError, match="rff"):
        ServeConfig(precision="rff", rff="off", device="cpu")
    # the Laplace kernel has no fast tier either
    lap = _engine(x[:512], method="laplace", rff="auto")
    with pytest.raises(BadRequest, match="rff"):
        lap.query(QueryRequest(key="ds", points=y, precision="rff"))


def test_query_many_gates_per_member(eng, data):
    x, y = data
    reqs = [QueryRequest(key="ds", points=y[:20], accuracy_target=10.0),
            QueryRequest(key="ds", points=y[20:40], accuracy_target=1e-9),
            QueryRequest(key="ds", points=y[40:])]        # no target: exact
    loose, tight, plain = eng.query_many(reqs)
    assert (loose.rff_hits, loose.escalated, loose.path) == (20, 0, ("rff",))
    assert (tight.rff_hits, tight.escalated) == (0, 20)
    assert (plain.rff_hits, plain.escalated) == (0, 24)
    assert loose.batch_requests == 3
    want = eng.query(QueryRequest(key="ds", points=y[20:40],
                                  precision="f32")).value
    torch.testing.assert_close(tight.value, want, rtol=1e-6, atol=0)
    p_scale = eng.registry.get("ds").rff.state.p_scale
    for a, sl in zip((loose, tight, plain), (slice(0, 20), slice(20, 40),
                                             slice(40, None))):
        _within_bounds(a, x, y[sl], p_scale)


def test_config_target_is_the_default_and_request_beats_it(data):
    x, y = data
    eng = _engine(x, accuracy_target=10.0)
    assert eng.query(QueryRequest(key="ds", points=y)).rff_hits == 64
    ans = eng.query(QueryRequest(key="ds", points=y, accuracy_target=1e-9))
    assert ans.escalated == 64


def test_counters_and_band_histogram(eng, data):
    _, y = data
    hits0, esc0 = _val("serve.cascade_hits"), _val(
        "serve.cascade_escalations")
    n0 = obs.metrics_snapshot().get("serve.cascade_band", {}).get("count", 0)
    eng.query(QueryRequest(key="ds", points=y, accuracy_target=10.0))
    eng.query(QueryRequest(key="ds", points=y, accuracy_target=1e-9))
    assert _val("serve.cascade_hits") == hits0 + y.shape[0]
    assert _val("serve.cascade_escalations") == esc0 + y.shape[0]
    assert obs.metrics_snapshot()["serve.cascade_band"]["count"] > n0
    problems = obs.lint_prometheus(obs.prometheus_text())
    assert problems == []


def test_routing_matches_repro_with_carried_state(data):
    x, y = data
    jeng = JServeEngine(JServeConfig(
        backend="pallas", method="kde", interpret=True, block_m=16,
        block_n=128, prune="off", rff="on", rff_features=512, rff_pilot=32,
        min_batch=16, max_batch=128))
    jeng.register("ds", jnp.asarray(x), h=H)
    st = jeng.registry.get("ds").rff.state
    eng = _engine(x, rff="auto", prune="off", block_n=128)
    prep = eng.registry.get("ds")
    prep.rff.state = convert.rff_from_state(
        st.w, st.z_cos, st.z_sin, st.centroids, st.pilot_n, st.pilot_s1,
        st.pilot_ss, p_scale=st.p_scale, h=st.h, n=st.n, groups=st.groups,
        device="cpu")
    jband = np.asarray(jrff.eval_density(st.serving(), jnp.asarray(y))[1],
                       np.float64)
    _, band = flash_rff.eval_density(prep.rff.state.serving(),
                                     torch.as_tensor(y))
    band = band.double().numpy()
    assert (band >= jband * (1 - 1e-4)).all()
    for target in (float(np.quantile(jband, q)) * 1.01
                   for q in (0.2, 0.5, 0.8)):
        ja = jeng.query(JRequest(key="ds", points=jnp.asarray(y),
                                 accuracy_target=target))
        ta = eng.query(QueryRequest(key="ds", points=y,
                                    accuracy_target=target))
        j_fast, t_fast = jband <= target, band <= target
        assert (ja.rff_hits, ta.rff_hits) == (int(j_fast.sum()),
                                              int(t_fast.sum()))
        near = (np.abs(band - target) <= 1e-4 * target) | (
            np.abs(jband - target) <= 1e-4 * target)
        # the port answers fast only where repro does (its band is wider)
        assert not (t_fast & ~j_fast & ~near).any()
        # rows routed alike agree: fast rows to the p̂ model's scale
        # (test_torch_rff.py), escalated rows at the f32 bar
        jv = np.asarray(ja.value, np.float64)
        tv = ta.value.double().numpy()
        atol = 1e-6 * float(np.abs(jv).max())
        both_fast, both_exact = t_fast & j_fast, ~t_fast & ~j_fast
        np.testing.assert_allclose(tv[both_fast], jv[both_fast], rtol=1e-4,
                                   atol=atol)
        np.testing.assert_allclose(tv[both_exact], jv[both_exact],
                                   rtol=1e-5, atol=atol)


def test_stream_generation_flip_keeps_the_fast_tier_certified():
    x, y = _sample(2048)
    eng = _engine(x, stream=True, rff_features=1024, prune=0.0)
    ans0 = eng.query(QueryRequest(key="ds", points=y, accuracy_target=10.0))
    assert ans0.rff_hits == y.shape[0]
    prep = eng.registry.get("ds")
    tier = prep.rff
    syncs0 = _val("rff.incremental_syncs")
    fresh, _ = _sample(64, seed=99)
    eng.registry.slide("ds", fresh)          # append a batch, evict as many
    ans1 = eng.query(QueryRequest(key="ds", points=y, accuracy_target=10.0))
    assert ans1.rff_hits == y.shape[0]
    assert _val("rff.incremental_syncs") == syncs0 + 1
    assert (tier.fits, tier.syncs) == (1, 1)
    st = prep.stream
    st.ensure(0)
    live = st.snapshot().points
    _within_bounds(ans1, live.numpy(), y, tier.state.p_scale)
    assert not torch.allclose(ans0.value, ans1.value)
    # the synced sums are a fresh fit's over the live set, to the f64
    # deltas' rounding plus the two fits' f32 phases
    refit = flash_rff.fit(live, H, n_features=1024, n_pilot=32,
                          device="cpu")
    eps = float(np.finfo(np.float32).eps)

    def model(pts):
        p = pts.double().abs()
        return 2 * eps * (p @ tier.state.w.abs().T).sum(0) \
            + 2 * eps * p.shape[0]

    bar = model(torch.as_tensor(x)) + model(live)
    assert ((tier.state.z_cos - refit.z_cos).abs() <= bar).all()
    assert ((tier.state.z_sin - refit.z_sin).abs() <= bar).all()
    assert tier.state.n == live.shape[0]


def test_exact_bound_and_engagement_rules():
    assert cascade.exact_bound("f32", "auto") == 1e-5
    assert cascade.exact_bound("bf16x2", 1e-6) == pytest.approx(5e-4 + 1e-6)
    assert cascade.exact_bound("bf16", "off") == 5e-2

    class Cfg:
        rff, method, backend = "auto", "kde", "flash"

    assert cascade.engaged(Cfg, None, "f32", np.ones(2))
    assert not cascade.engaged(Cfg, None, "f32", None)
    assert cascade.engaged(Cfg, None, "rff", None)
    Cfg.rff = "off"
    assert not cascade.engaged(Cfg, None, "f32", np.ones(2))
    assert cascade.engaged(Cfg, None, "rff", None)
