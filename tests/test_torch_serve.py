"""The port's estimator API and serving engine against the JAX package.

Inputs are numpy arrays made from a seed and handed to both packages.
The JAX side runs as its own tests run it: Pallas in interpret mode,
explicit blocks, ``prune="off"``.

Tolerances: the f32 serve bar — rtol 1e-5 with an atol of 1e-6·peak
(deep-tail densities differ by summation order); reduced tiers are held
port against JAX at the same tier, at the tier's bar (bf16x2 5e-4,
bf16 5e-2), since the reference's own bf16 pipeline misses its f32
comparison end to end.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import estimator as jest
from repro.serve import QueryRequest as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.core import kde as tkde
from repro_torch.core.estimator import KDE, SDKDE, EstimatorConfig
from repro_torch.serve import (BadRequest, EstimatorRegistry, QueryRequest,
                               ServeConfig, ServeEngine, ShapeBucketCache,
                               UnknownKey, coalesce, pad_queries, split)

N, D, H = 384, 8, 0.6
TIER_BAR = {"f32": 1e-5, "bf16x2": 5e-4, "bf16": 5e-2}
RAGGED = (1, 7, 16, 33, 128, 200)


def assert_close(got, want, rtol=1e-5):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-6 * np.max(np.abs(want)))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((N, D)).astype(np.float32),
            rng.standard_normal((300, D)).astype(np.float32))


def _cfg(backend="flash", method="sdkde", **kw):
    base = dict(backend=backend, method=method, block_m=8, block_n=128,
                block=128, min_batch=16, max_batch=128, device="cpu")
    base.update(kw)
    return ServeConfig(**base)


def _jcfg(backend="pallas", method="sdkde", **kw):
    base = dict(backend=backend, method=method, interpret=True, block_m=8,
                block_n=128, block=128, min_batch=16, max_batch=128,
                prune="off", rff="off")
    base.update(kw)
    return JServeConfig(**base)


@pytest.fixture(scope="module")
def jax_engines(data):
    x, _ = data
    engines = {}
    for method in ("kde", "sdkde"):
        eng = JServeEngine(_jcfg(method=method))
        eng.register("ds", jnp.asarray(x), h=H)
        engines[method] = eng
    return engines


# ---------------------------------------------------------------------------
# Estimator API.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", ["f32", "bf16x2", "bf16"])
def test_sdkde_flash_fit_evaluate_matches_jax(data, precision):
    x, y = data
    jcfg = jest.EstimatorConfig(backend="pallas", interpret=True,
                                prune="off", block_m=32, block_n=128,
                                precision=precision)
    want = jest.SDKDE(config=jcfg).fit(jnp.asarray(x)).evaluate(
        jnp.asarray(y))
    tcfg = EstimatorConfig(backend="flash", device="cpu", block_m=32,
                           block_n=128, precision=precision)
    est = SDKDE(config=tcfg).fit(x)
    got = est.evaluate(y)
    assert got.shape == (300,) and got.device.type == "cpu"
    assert_close(got, want, TIER_BAR[precision])
    jsd = jest.SDKDE(config=jcfg).fit(jnp.asarray(x)).x_sd
    assert_close(est.x_sd, jsd, TIER_BAR[precision])


@pytest.mark.parametrize("cls", ["KDE", "SDKDE"])
def test_torch_backend_matches_jax_jnp(data, cls):
    x, y = data
    jcls, tcls = {"KDE": (jest.KDE, KDE), "SDKDE": (jest.SDKDE, SDKDE)}[cls]
    want = jcls(config=jest.EstimatorConfig(backend="jnp", block=128)).fit(
        jnp.asarray(x)).evaluate(jnp.asarray(y))
    est = tcls(config=EstimatorConfig(backend="torch", block=128,
                                      device="cpu")).fit(x)
    assert_close(est.evaluate(y), want)
    assert est.h == pytest.approx(float(jcls().fit(jnp.asarray(x)).h),
                                  rel=1e-6)


def test_kde_flash_matches_torch_backend(data):
    x, y = data
    a = KDE(H, EstimatorConfig(device="cpu")).fit(x).evaluate(y)
    b = KDE(H, EstimatorConfig(backend="torch", device="cpu")).fit(
        x).evaluate(y)
    assert_close(a, b)


# ---------------------------------------------------------------------------
# Serving engine against the JAX engine on the same data.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["kde", "sdkde"])
def test_engine_query_matches_jax_engine(data, jax_engines, method):
    x, y = data
    eng = ServeEngine(_cfg(method=method))
    eng.register("ds", x, h=H)
    jeng = jax_engines[method]
    for m in RAGGED:                 # spans buckets, exact fits, chunking
        want = np.asarray(jeng.query(JRequest(key="ds",
                                              points=jnp.asarray(y[:m]))
                                     ).value)
        ans = eng.query(QueryRequest(key="ds", points=y[:m]))
        assert ans.value.shape == (m,) and ans.tier == "f32"
        assert ans.path == ("f32",)
        assert ans.rel_err_bound == pytest.approx(1e-5)
        assert ans.rel_err_bounds.shape == (m,)
        assert_close(ans.value, want)


@pytest.mark.parametrize("method", ["kde", "sdkde"])
def test_engine_query_many_matches_jax_engine(data, jax_engines, method):
    x, y = data
    eng = ServeEngine(_cfg(method=method))
    eng.register("ds", x, h=H)
    parts = (y[:3], y[3:50], y[50:61], y[61:200])
    want = jax_engines[method].query_many(
        [JRequest(key="ds", points=jnp.asarray(p)) for p in parts])
    got = eng.query_many([QueryRequest(key="ds", points=p) for p in parts])
    assert [a.value.shape[0] for a in got] == [3, 47, 11, 139]
    for g, w in zip(got, want):
        assert_close(g.value, w.value)
        assert g.batch_requests == 4
    assert eng.latency.summary().count == 4     # 4 requests, 1 dispatch


@pytest.mark.parametrize("pin", ["bf16x2", "bf16"])
def test_precision_pin_matches_jax_at_the_same_tier(data, jax_engines, pin):
    x, y = data
    eng = ServeEngine(_cfg())
    eng.register("ds", x, h=H)
    want = jax_engines["sdkde"].query(
        JRequest(key="ds", points=jnp.asarray(y[:40]), precision=pin))
    ans = eng.query(QueryRequest(key="ds", points=y[:40], precision=pin))
    assert ans.tier == pin and ans.rel_err_bound == TIER_BAR[pin]
    assert_close(ans.value, want.value, TIER_BAR[pin])


def test_torch_backend_engine_matches_plain_math(data):
    x, y = data
    eng = ServeEngine(_cfg(backend="torch"))
    eng.register("ds", x, h=H)
    want = tkde.sdkde_eval(torch.from_numpy(x), torch.from_numpy(y), H,
                           block=128)
    assert_close(eng.query(QueryRequest(key="ds", points=y)).value, want)


@pytest.mark.parametrize("block_m,lo,hi", [(8, 16, 128), (8, 10, 100),
                                           (128, 128, 4096), (32, 1, 64)])
def test_bucket_ladder_matches_jax(block_m, lo, hi):
    t = ServeConfig(backend="flash", block_m=block_m, min_batch=lo,
                    max_batch=hi, device="cpu")
    j = JServeConfig(backend="pallas", block_m=block_m, min_batch=lo,
                     max_batch=hi)
    assert t.bucket_sizes() == j.bucket_sizes()
    assert t.row_multiple() == j.row_multiple() == block_m
    for m in (1, lo, hi - 1, hi, 3 * hi):
        assert t.bucket_for(m) == j.bucket_for(m)
    jt = JServeConfig(backend="jnp", min_batch=lo, max_batch=hi)
    tt = ServeConfig(backend="torch", min_batch=lo, max_batch=hi,
                     device="cpu")
    assert tt.bucket_sizes() == jt.bucket_sizes()


# ---------------------------------------------------------------------------
# Registry, cache and errors.
# ---------------------------------------------------------------------------


def test_registry_debias_runs_once_per_key(data):
    x, _ = data
    reg = EstimatorRegistry(_cfg())
    p1 = reg.fit("a", x, h=H)
    assert reg.fit("a", x, h=H) is p1 and reg.n_fits == 1
    reg.fit("b", x[:128], h=H)
    assert reg.n_fits == 2
    p3 = reg.fit("a", x, h=H, refit=True)
    assert reg.n_fits == 3 and p3 is not p1
    cols = p3.columns_for("f32")
    assert cols.xt.shape == (D, 384) and cols.nrm_x.shape == (1, 384)


def test_shape_bucket_cache_hits_and_eviction(data):
    x, y = data
    eng = ServeEngine(_cfg(cache_buckets=2))
    eng.register("ds", x, h=H)
    for m in (5, 9, 20):
        eng.query(QueryRequest(key="ds", points=y[:m]))
    assert (eng.cache.hits, eng.cache.misses) == (1, 2)
    eng.query(QueryRequest(key="ds", points=y[:40]))
    assert eng.cache.evictions == 1 and len(eng.cache) == 2
    metrics = eng.metrics()
    assert metrics["bucket_cache"]["misses"] == 3
    assert metrics["latency"]["count"] == 4


def test_refit_and_reregister_never_serve_stale_callables(data):
    x, y = data
    eng = ServeEngine(_cfg())
    eng.register("ds", x, h=H)
    stale = eng.query(QueryRequest(key="ds", points=y[:8])).value
    want = tkde.sdkde_eval(torch.from_numpy(2.0 + x), torch.from_numpy(y[:8]),
                           H, block=128)
    eng.register("ds", 2.0 + x, h=H, refit=True)
    assert_close(eng.query(QueryRequest(key="ds", points=y[:8])).value, want)
    eng.registry.evict("ds")
    eng.register("ds", x, h=H)
    assert_close(eng.query(QueryRequest(key="ds", points=y[:8])).value,
                 stale)


def test_unknown_key_and_bad_requests(data):
    x, y = data
    eng = ServeEngine(_cfg())
    eng.register("ds", x, h=H)
    with pytest.raises(UnknownKey, match="nope"):
        eng.query(QueryRequest(key="nope", points=y[:3]))
    with pytest.raises(KeyError):
        eng.query(QueryRequest(key="nope", points=y[:3]))
    with pytest.raises(BadRequest, match="expected"):
        eng.query(QueryRequest(key="ds", points=y[:3, :5]))
    with pytest.raises(BadRequest):
        eng.query(QueryRequest(key="ds", points=np.zeros((0, D))))
    with pytest.raises(BadRequest, match="share one key"):
        eng.query_many([QueryRequest(key="ds", points=y[:2]),
                        QueryRequest(key="ds", points=y[:2],
                                     precision="bf16")])
    with pytest.raises(ValueError):
        QueryRequest(key="ds", points=y[:2], precision="bogus")
    with pytest.raises(ValueError):
        QueryRequest(key="ds", points=y[:2], accuracy_target=0.0)


def test_prewarm_builds_the_top_bucket(data):
    x, _ = data
    eng = ServeEngine(_cfg())
    eng.register("ds", x, h=H)
    eng.prewarm("ds")
    assert len(eng.cache) == 1 and eng.cache.misses == 1
    assert eng.latency.summary().count == 0


def test_batching_helpers_and_lru():
    y = torch.randn(20, 3)
    assert pad_queries(y[:5], 16).shape == (16, 3)
    with pytest.raises(ValueError):
        pad_queries(y, 16)
    fused, sizes = coalesce([y[:2], y[2:9]])
    assert [p.shape[0] for p in split(fused[:, 0], sizes)] == [2, 7]
    c = ShapeBucketCache(capacity=2)
    built = []
    for k in ("a", "b", "a", "c", "b"):
        c.get_or_build(k, lambda k=k: built.append(k) or (lambda: k))
    assert built == ["a", "b", "c", "b"]
    assert (c.hits, c.misses, c.evictions) == (1, 4, 2)


# ---------------------------------------------------------------------------
# State carried across from the JAX package.
# ---------------------------------------------------------------------------


def test_convert_sdkde_holds_kde_pass_against_jax(data):
    """The port's KDE pass alone, on the debiased set JAX computed."""
    x, y = data
    jcfg = jest.EstimatorConfig(backend="pallas", interpret=True,
                                prune="off", block_m=32, block_n=128)
    jfit = jest.SDKDE(config=jcfg).fit(jnp.asarray(x))
    est = convert.sdkde_from_state(
        np.asarray(jfit.x_train), np.asarray(jfit.x_sd), float(jfit.h),
        config=EstimatorConfig(device="cpu", block_m=32, block_n=128))
    np.testing.assert_array_equal(est.x_sd.numpy(), np.asarray(jfit.x_sd))
    np.testing.assert_array_equal(est.x_train.numpy(), x)
    assert est.h == float(jfit.h)
    assert_close(est.evaluate(y), jfit.evaluate(jnp.asarray(y)))


def test_convert_prepared_estimator_round_trips(data, jax_engines):
    x, y = data
    jprep = jax_engines["sdkde"].registry.get("ds")
    prep = convert.prepared_from_state(
        "ds", np.asarray(jprep.points), jprep.h, jprep.n_true, jprep.d,
        jprep.norm, block_m=jprep.block_m, block_n=jprep.block_n,
        config=_cfg())
    np.testing.assert_array_equal(prep.points.numpy(),
                                  np.asarray(jprep.points))
    assert (prep.h, prep.n_true, prep.d, prep.norm) == (
        jprep.h, jprep.n_true, jprep.d, jprep.norm)
    assert (prep.block_m, prep.block_n) == (jprep.block_m, jprep.block_n)
    np.testing.assert_array_equal(prep.columns_for("f32").nrm_x.numpy(),
                                  np.asarray(jprep.nrm_x))
    eng = ServeEngine(_cfg())
    eng.registry.adopt(prep)
    want = jax_engines["sdkde"].query(JRequest(key="ds",
                                               points=jnp.asarray(y)))
    assert_close(eng.query(QueryRequest(key="ds", points=y)).value,
                 want.value)
    with pytest.raises(ValueError, match="do not match"):
        convert.prepared_from_state("bad", np.asarray(jprep.points), jprep.h,
                                    jprep.n_true + 1, jprep.d, jprep.norm,
                                    config=_cfg())
