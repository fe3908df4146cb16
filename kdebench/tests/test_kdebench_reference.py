"""The float64 reference against a direct double sum at small n."""

import math

import numpy as np
import pytest
import torch

from kdebench.reference import mixture
from kdebench.reference import sdkde as ref

MIX = {"dim": 16, "separation": 4.0, "shifted_dims": 4,
       "stds": [1.0, 0.7], "weights": [0.6, 0.4]}


def _draw(n, seed=5, d=None):
    spec = dict(MIX, dim=d or MIX["dim"])
    gen = mixture.generator("cpu", seed, "t")
    return mixture.from_config(spec).sampler("cpu").sample(n, gen)


def _phi(a, b, h):
    a, b = a.double(), b.double()
    sq = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return torch.exp(-sq / (2 * h * h)), sq / (2 * h * h)


def test_bandwidth_is_the_sdkde_rule():
    x = _draw(3000)
    n, d = x.shape
    sigma = np.asarray(x, np.float64).std(axis=0).mean()
    want = (4 / (d + 2)) ** (1 / (d + 4)) * n ** (-1 / (d + 8)) * sigma
    assert ref.sdkde_bandwidth(x) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("block_elems", [64, 1 << 28])
def test_score_shift_matches_direct_double_sum(block_elems):
    x = _draw(300)
    h = ref.sdkde_bandwidth(x)
    phi, arg = _phi(x, x, h)
    s0 = phi.sum(1)
    s1 = phi @ x.double()
    x64 = x.double()
    want = x64 + 0.5 * h * h * (s1 - x64 * s0[:, None]) / (h * h * s0[:, None])
    got, needed = ref.score_shift(x, h, count=True, block_elems=block_elems)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)
    assert needed == int((arg < ref.UNDERFLOW_ARG).sum())


@pytest.mark.parametrize("block_elems", [50, 1 << 28])
def test_kde_matches_direct_double_sum(block_elems):
    x, y = _draw(400), _draw(70, seed=6)
    h = 0.31
    phi, arg = _phi(y, x, h)
    d = x.shape[1]
    want = phi.sum(1) / (400 * (2 * math.pi) ** (d / 2) * h ** d)
    got, needed = ref.kde(x, y, h, count=True, block_elems=block_elems)
    assert torch.allclose(got, want, rtol=1e-11, atol=0)
    assert needed == int((arg < ref.UNDERFLOW_ARG).sum())
    assert 0 < needed < 400 * 70       # some pairs underflow at this h


def test_sdkde_counts_every_pair_at_a_wide_bandwidth():
    x, y = _draw(128, d=2), _draw(32, seed=9, d=2)
    dens, h, score_pairs, kde_pairs = ref.sdkde(x, y, count=True)
    assert score_pairs == 128 * 128 and kde_pairs == 32 * 128
    assert torch.all(dens > 0)


def test_float32_reference_departs_from_float64():
    x, y = _draw(500), _draw(100, seed=3)
    d64 = ref.sdkde(x, y)[0]
    d32 = ref.sdkde(x, y, dtype=torch.float32)[0].double()
    err = ((d32 - d64).abs() / d64).max().item()
    assert 0 < err < 1e-2


def test_sampler_repeats_by_seed_and_stream():
    s = mixture.from_config(MIX).sampler("cpu")
    big = 2**31 + 12345
    a = s.sample(64, mixture.generator("cpu", big, "task", 3))
    b = s.sample(64, mixture.generator("cpu", big, "task", 3))
    c = s.sample(64, mixture.generator("cpu", big, "task", 4))
    d = s.sample(64, mixture.generator("cpu", big + 1, "task", 3))
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)


def test_sampler_draws_the_papers_mixture():
    x = mixture.from_config(MIX).sampler("cpu").sample(
        200_000, mixture.generator("cpu", 1, "m"))
    first = x[:, :4].mean().item()       # 0.6·(−2) + 0.4·2
    assert first == pytest.approx(-0.4, abs=0.02)
    assert x[:, 4:].mean().item() == pytest.approx(0.0, abs=0.01)
    var = x[:, 4:].var().item()          # 0.6·1 + 0.4·0.49
    assert var == pytest.approx(0.796, rel=0.02)


def test_stream_seed_is_63_bits_and_distinct():
    seeds = {mixture.stream_seed(s, "task", i)
             for s in (0, 1, 2**31 + 5, 2**40) for i in range(4)}
    assert len(seeds) == 16
    assert all(0 <= s < 2**63 for s in seeds)
