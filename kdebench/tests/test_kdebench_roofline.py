"""Work counts at the cells' shapes, and bounds that no time can beat."""

import json
import random

import pytest
import torch

from kdebench import roofline
from kdebench.harness import ROOT
from kdebench.reference import sdkde as ref


def _config(name):
    return json.loads((ROOT / "kdebench" / "configs" /
                       f"{name}.json").read_text())


@pytest.mark.parametrize("name,n,m", [("paper-mix16-32k", 32768, 4096),
                                      ("paper-mix16-1m", 2**20, 2**17)])
def test_counts_at_the_cells_shapes(name, n, m):
    c = _config(name)
    assert (c["n_train"], c["n_queries"], c["mixture"]["dim"]) == (n, m, 16)
    s = roofline.score_pass(n, 16)
    k = roofline.kde_pass(m, n, 16)
    assert s.exps == n * n and s.products == n * n * (32 + 34)
    assert s.bytes == 4 * (n * 16 + n * 17)
    assert k.exps == m * n and k.products == m * n * 32
    assert k.bytes == 4 * (m * 16 + n * 16 + m)
    t = roofline.sdkde_task(n, m, 16)
    assert t.exps == s.exps + k.exps
    assert t.products == s.products + k.products
    assert t.bytes == 4 * (n * 16 + m * 16 + m)


def test_exp_rate_is_sfu_plus_fp32_pipes():
    assert roofline.H100.exp_rate == pytest.approx(132 * 1.98e9 * 48)
    # an SD-KDE pair is bound by its exponential, not by its products
    w = roofline.score_pass(4096, 16)
    assert roofline.least_seconds(w) == w.exps / roofline.H100.exp_rate


def test_least_time_takes_the_slowest_kind_at_its_fastest_unit():
    w = roofline.Work(products=3e12, exps=2e11, bytes=5e9)
    p = roofline.H100
    want = max(3e12 / p.tensor_flops, 2e11 / p.exp_rate, 5e9 / p.hbm_bytes)
    assert roofline.least_seconds(w) == want


def test_no_time_at_or_above_the_bound_reads_over_100():
    rnd = random.Random(0)
    for _ in range(500):
        w = roofline.Work(products=10 ** rnd.uniform(0, 16),
                          exps=10 ** rnd.uniform(0, 14),
                          bytes=10 ** rnd.uniform(0, 12))
        least = roofline.least_seconds(w)
        t = least * (1 + 10 ** rnd.uniform(-9, 3))
        assert roofline.share_pct(w, t) <= 100.0
    assert roofline.share_pct(w, least) == pytest.approx(100.0)
    assert roofline.share_pct(w, 0.0) is None


def test_pair_count_equals_the_pairs_of_the_shapes():
    # at a bandwidth where no weight underflows, the reference counts
    # every pair the shapes define, as the roofline does by default
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(96, 16, generator=gen)
    y = torch.randn(40, 16, generator=gen)
    _, needed = ref.kde(x, y, 50.0, count=True)
    assert needed == roofline.kde_pass(40, 96, 16).exps
    sums, needed = ref.pair_sums(x, x, torch.ones(96, 1), 50.0, count=True)
    assert needed == roofline.score_pass(96, 16).exps
    scaled = roofline.score_pass(96, 16, pairs=needed / 2)
    assert scaled.exps == 96 * 96 / 2
