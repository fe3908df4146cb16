"""The port's core math against the JAX package on the same numpy inputs.

Bandwidths, the streaming ``core/kde.py`` functions, the ``ref.py``
oracles, the mixture densities and the precision-tier casts.  Inputs are
made with numpy from a seed and handed to both packages.

Tolerances:
  * f32 results: rtol 1e-5 with an atol of 1e-6·peak — the repo's serve
    bar; deep-tail densities differ by summation order.  Where the
    norm-trick self-distance dominates (score statistics), the bar is
    the error model's (``f32_bar``): the two sides' Gram rounding differs
    by a few ulps of 2‖x‖², amplified by 1/(2h²) in the exponent.
  * tier casts: bit for bit — both round to nearest even.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bandwidth as jbw
from repro.core import kde as jkde
from repro.core import mixtures as jmix
from repro.kernels import precision as jprec
from repro.kernels import ref as jref
from repro_torch.core import bandwidth as tbw
from repro_torch.core import kde as tkde
from repro_torch.core import mixtures as tmix
from repro_torch.kernels import precision as tprec
from repro_torch.kernels import ref as tref

F32_EPS = float(np.finfo(np.float32).eps)


def f32_bar(x: np.ndarray, h: float) -> float:
    """rtol of an f32 comparison: 1e-5, or the norm-trick error model
    8·eps·max‖x‖²/(2h²) where that is larger."""
    return max(1e-5, 8 * F32_EPS * float(np.max(np.sum(x * x, 1)))
               / (2 * h * h))


def assert_f32(got, want, rtol=1e-5, atol=None):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if atol is None:
        atol = 1e-6 * np.max(np.abs(want))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _data(n, m, d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (1.2 * rng.standard_normal((m, d))).astype(np.float32)
    return x, y


SHAPES = [(300, 50, 16), (128, 64, 1), (256, 96, 4), (200, 40, 32)]


@pytest.mark.parametrize("n,m,d", SHAPES)
def test_bandwidths_match_jax(n, m, d):
    x, _ = _data(n, m, d)
    xt = torch.from_numpy(x)
    for jf, tf in ((jbw.silverman_bandwidth, tbw.silverman_bandwidth),
                   (jbw.sdkde_bandwidth, tbw.sdkde_bandwidth)):
        np.testing.assert_allclose(float(tf(xt)), float(jf(jnp.asarray(x))),
                                   rtol=1e-6)
    assert tbw.score_bandwidth(0.8) == jbw.score_bandwidth(0.8)
    assert tbw.gaussian_norm_const(d, 0.7) == jbw.gaussian_norm_const(d, 0.7)


@pytest.mark.parametrize("n,m,d", SHAPES)
def test_kde_eval_and_naive_match_jax(n, m, d):
    x, y = _data(n, m, d, seed=1)
    h = 0.7
    want = jkde.kde_eval(jnp.asarray(x), jnp.asarray(y), h, block=64)
    got = tkde.kde_eval(torch.from_numpy(x), torch.from_numpy(y), h,
                        block=64)
    assert_f32(got, want)
    naive = tkde.kde_eval_naive(torch.from_numpy(x), torch.from_numpy(y), h)
    assert_f32(naive, jkde.kde_eval_naive(jnp.asarray(x), jnp.asarray(y), h))


@pytest.mark.parametrize("n,m,d", SHAPES)
def test_score_stats_and_shift_match_jax(n, m, d):
    x, _ = _data(n, m, d, seed=2)
    h = 0.6
    bar = f32_bar(x, h)
    js0, js1 = jkde.score_stats(jnp.asarray(x), jnp.asarray(x), h, block=64)
    ts0, ts1 = tkde.score_stats(torch.from_numpy(x), torch.from_numpy(x), h,
                                block=64)
    assert_f32(ts0, js0, bar)
    assert_f32(ts1, js1, bar)
    # S1 - x·S0 cancels where a row's own term dominates: its rounding,
    # bar·max|x|, divided by h², is the score's absolute error scale
    assert_f32(tkde.empirical_score(torch.from_numpy(x), torch.from_numpy(x),
                                    h, block=64),
               jkde.empirical_score(jnp.asarray(x), jnp.asarray(x), h,
                                    block=64), bar,
               atol=bar * float(np.max(np.abs(x))) / (h * h))
    assert_f32(tkde.sdkde_shift(torch.from_numpy(x), h, score_h=0.5,
                                block=64),
               jkde.sdkde_shift(jnp.asarray(x), h, score_h=0.5, block=64),
               bar)


@pytest.mark.parametrize("n,m,d", SHAPES[:2])
def test_sdkde_eval_matches_jax(n, m, d):
    x, y = _data(n, m, d, seed=3)
    h = 0.8
    want = jkde.sdkde_eval(jnp.asarray(x), jnp.asarray(y), h, block=128)
    got = tkde.sdkde_eval(torch.from_numpy(x), torch.from_numpy(y), h,
                          block=128)
    assert_f32(got, want)


def test_pad_rows_and_sqdist_match_jax():
    x, y = _data(37, 11, 3, seed=4)
    np.testing.assert_array_equal(
        tkde.pad_rows(torch.from_numpy(x), 16).numpy(),
        np.asarray(jkde.pad_rows(jnp.asarray(x), 16)))
    assert tkde.PAD_VALUE == jkde.PAD_VALUE
    assert_f32(tkde.sqdist(torch.from_numpy(x), torch.from_numpy(y)),
               jkde.sqdist(jnp.asarray(x), jnp.asarray(y)), 1e-4)


@pytest.mark.parametrize("n,m,d", SHAPES)
def test_ref_oracles_match_jax(n, m, d):
    x, y = _data(n, m, d, seed=5)
    h = 0.9
    bar = f32_bar(x, h)
    js0, js1 = jref.ref_score_stats(jnp.asarray(x), h)
    ts0, ts1 = tref.ref_score_stats(torch.from_numpy(x), h)
    assert_f32(ts0, js0, bar)
    assert_f32(ts1, js1, bar)
    assert_f32(tref.ref_kde_sums(torch.from_numpy(x), torch.from_numpy(y), h),
               jref.ref_kde_sums(jnp.asarray(x), jnp.asarray(y), h),
               f32_bar(np.concatenate([x, y]), h))
    assert_f32(tref.ref_sdkde_shift(torch.from_numpy(x), h, 0.7),
               jref.ref_sdkde_shift(jnp.asarray(x), h, 0.7), bar)


@pytest.mark.parametrize("mixture", ["16d", "1d", "dim3", "dim8"])
def test_mixture_log_pdf_matches_jax(mixture):
    make = {"16d": lambda m: m.benchmark_mixture_16d(),
            "1d": lambda m: m.benchmark_mixture_1d(),
            "dim3": lambda m: m.mixture_for_dim(3),
            "dim8": lambda m: m.mixture_for_dim(8)}[mixture]
    jm, tm = make(jmix), make(tmix)
    np.testing.assert_array_equal(jm.means, tm.means)
    rng = np.random.default_rng(6)
    pts = (2.0 * rng.standard_normal((200, tm.dim))).astype(np.float32)
    np.testing.assert_allclose(tm.log_pdf(torch.from_numpy(pts)).numpy(),
                               np.asarray(jm.log_pdf(jnp.asarray(pts))),
                               rtol=1e-5, atol=1e-5)
    assert_f32(tm.pdf(torch.from_numpy(pts)), jm.pdf(jnp.asarray(pts)))


def test_mixture_sample_is_seeded_and_on_the_generator_device():
    mix = tmix.benchmark_mixture_16d()
    a = mix.sample(1000, torch.Generator().manual_seed(3))
    b = mix.sample(1000, torch.Generator().manual_seed(3))
    assert a.shape == (1000, 16) and a.dtype == torch.float32
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    # component means show up in the first coordinates' spread
    assert float(a[:, :4].std()) > 1.5 and abs(float(a[:, 8].mean())) < 0.2


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


@pytest.mark.parametrize("precision", ["bf16", "bf16x2"])
def test_tier_casts_match_jax_bit_for_bit(precision):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((64, 9)) * np.logspace(-3, 3, 9)).astype(
        np.float32)
    jhi, jlo = jprec.cast_operand(jnp.asarray(x), precision)
    thi, tlo = tprec.cast_operand(torch.from_numpy(x), precision)
    np.testing.assert_array_equal(_bits(thi), _bits(jhi))
    if precision == "bf16x2":
        np.testing.assert_array_equal(_bits(tlo), _bits(jlo))
        np.testing.assert_array_equal(
            tprec.reconstruct(thi, tlo).numpy(),
            np.asarray(jprec.reconstruct(jhi, jlo)))
    else:
        assert tlo is None and jlo is None


def test_tier_tables_match_jax():
    assert tprec.PRECISIONS == jprec.PRECISIONS
    for p in tprec.PRECISIONS:
        assert tprec.operand_bytes(p) == jprec.operand_bytes(p)
        assert tprec.gram_products(p) == jprec.gram_products(p)
    with pytest.raises(ValueError):
        tprec.validate("fp8")


@pytest.mark.parametrize("precision", ["f32", "bf16", "bf16x2"])
def test_weighted_accum_and_gram_match_jax(precision):
    rng = np.random.default_rng(8)
    phi = rng.uniform(0, 1, (16, 32)).astype(np.float32)
    w = rng.standard_normal((32, 5)).astype(np.float32)
    jw = jprec.cast_operand(jnp.asarray(w), precision)
    tw = tprec.cast_operand(torch.from_numpy(w), precision)
    bar = {"f32": 1e-5, "bf16x2": 5e-4, "bf16": 5e-2}[precision]
    assert_f32(tprec.weighted_accum(torch.from_numpy(phi), *tw),
               jprec.weighted_accum(jnp.asarray(phi), *jw), bar)
    if precision == "bf16x2":
        a = rng.standard_normal((8, 6)).astype(np.float32)
        ja = jprec.split_hi_lo(jnp.asarray(a))
        ta = tprec.split_hi_lo(torch.from_numpy(a))
        assert_f32(tprec.gram_compensated(*ta, tw[0][:6], tw[1][:6]),
                   jprec.gram_compensated(*ja, jw[0][:6], jw[1][:6]))
        assert_f32(tprec.dot_f32(ta[0], tw[0][:6]),
                   jprec.dot_f32(ja[0], jw[0][:6]))
