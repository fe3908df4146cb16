"""The port's density weighting (``repro_torch.data.density``) against
``repro.data.density``.

Inputs are numpy arrays made from a seed and handed to both packages;
the JAX side runs the Pallas kernels in interpret mode with explicit
blocks and ``prune="off"``, as its own tests run them.

Tolerance: w ∝ p^{-alpha} normalized by its mean, so a relative error δ
of the densities moves a weight by at most alpha·δ plus the mean's
alpha·δ.  The densities carry the f32 serve bar, rtol 1e-5 (summation
order), so the weights are held to rtol 2·alpha·1e-5, with an atol of
1e-6 of the largest weight for the sets' sparsest points.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.estimator import EstimatorConfig as JConfig
from repro.data.density import DensityWeighting as JWeighting
from repro.data.density import density_weights as j_density_weights
from repro_torch.core.estimator import EstimatorConfig
from repro_torch.data.density import DensityWeighting, density_weights

N, D, H = 320, 4, 0.7


def _jcfg():
    return JConfig(backend="pallas", interpret=True, block_m=8,
                   block_n=128, prune="off")


def _cfg(**kw):
    base = dict(device="cpu", block_m=8, block_n=128, prune="off")
    base.update(kw)
    return EstimatorConfig(**base)


@pytest.fixture(scope="module")
def emb():
    rng = np.random.default_rng(7)
    return (rng.standard_normal((N, D)) * 0.8).astype(np.float32)


def _close(got, want, alpha):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=2 * alpha * 1e-5,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("alpha", [0.5, 1.0])
def test_density_weights_match_repro(emb, alpha):
    want = j_density_weights(jnp.asarray(emb), alpha=alpha, h=H,
                             config=_jcfg())
    got = density_weights(emb, alpha=alpha, h=H, config=_cfg())
    assert got.shape == (N,) and got.device.type == "cpu"
    _close(got, want, alpha)
    assert abs(float(got.mean()) - 1.0) < 1e-6


def test_density_weighting_stage_matches_repro(emb):
    corpus, batch = emb[:256], emb[256:]
    jstage = JWeighting(alpha=0.5, h=H, config=_jcfg()).fit(
        jnp.asarray(corpus))
    stage = DensityWeighting(alpha=0.5, h=H, config=_cfg()).fit(corpus)
    assert stage._norm == pytest.approx(jstage._norm, rel=1e-5)
    _close(stage(batch), jstage(jnp.asarray(batch)), 0.5)


def test_density_weights_upweight_tails():
    """The reference's behaviour check (tests/test_substrate.py) on the
    port: a sparse far cluster gets more than twice the weight."""
    rng = np.random.default_rng(0)
    dense = rng.standard_normal((400, 4)) * 0.1
    sparse = rng.standard_normal((40, 4)) * 3 + 5
    emb = np.concatenate([dense, sparse]).astype(np.float32)
    w = density_weights(emb, alpha=0.5, config=_cfg(block_n=64))
    assert float(w[400:].mean()) > 2.0 * float(w[:400].mean())
    assert abs(float(w.mean()) - 1.0) < 1e-3


def test_resample_indices_draws_distinct_rows_with_a_generator(emb):
    stage = DensityWeighting(alpha=0.5, h=H, config=_cfg()).fit(emb[:256])
    batch = emb[256:]
    a = stage.resample_indices(batch, torch.Generator().manual_seed(3), 16)
    b = stage.resample_indices(batch, torch.Generator().manual_seed(3), 16)
    assert a.shape == (16,) and torch.equal(a, b)
    assert len(set(a.tolist())) == 16
    assert int(a.min()) >= 0 and int(a.max()) < batch.shape[0]


def test_stage_refuses_to_weight_before_fit(emb):
    with pytest.raises(RuntimeError, match="fit"):
        DensityWeighting(config=_cfg())(emb)
