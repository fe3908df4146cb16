"""The f32 score pass's arithmetic: three exact bf16 planes a value
(``precision.split_three``, the mirror of ``split3`` in
``csrc/flash_score_pass.cuh``) and six of their nine products.

The split is exact (h + m + l == v), and the six products the kernel
keeps for the Gram and for φ·[X|1] lie no further from the float64
products than an f32 matrix product does, on the 16-d mixture the
benchmark runs.  Two planes (the bf16x2 tier's split) lie measurably
further, so these tests can fail.
"""

import math

import pytest
import torch

from repro_torch.core import mixtures
from repro_torch.kernels import precision as prec

H = 0.78  # the benchmark's bandwidth on the 16-d mixture


def _mixture(n: int, seed: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return mixtures.benchmark_mixture_16d().sample(n, gen)


def _planes64(x: torch.Tensor):
    return [p.to(torch.float64) for p in prec.split_three(x)]


def _six(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b from the six products of their planes the kernel keeps (hh;
    hm + mh; hl + mm + lh), each exact, summed in float64."""
    ah, am, al = _planes64(a)
    bh, bm, bl = _planes64(b)
    return ((ah @ bl + am @ bm + al @ bh) + (ah @ bm + am @ bh)) + ah @ bh


def _two(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b from bf16x2's two planes a side, four products in float64."""
    ah, al = (p.to(torch.float64) for p in prec.split_hi_lo(a))
    bh, bl = (p.to(torch.float64) for p in prec.split_hi_lo(b))
    return ah @ bh + ah @ bl + al @ bh + al @ bl


def _f32_err(a: torch.Tensor, b: torch.Tensor, exact: torch.Tensor):
    return (prec.dot_f32(a, b).to(torch.float64) - exact).abs()


def test_planes_sum_to_the_mixture_values_exactly():
    x = _mixture(8192, 0)
    h, m, l = _planes64(x)
    assert torch.equal(h + m + l, x.to(torch.float64))
    assert all(p.dtype == torch.bfloat16 for p in prec.split_three(x))


@pytest.mark.parametrize("lo, hi", [(-100, -60), (-60, -1), (-1, 1),
                                    (1, 60), (60, 100)])
def test_planes_sum_exactly_across_exponents(lo, hi):
    """Random f32 significands and signs at binary exponents in [lo, hi)
    (every f32 with |v| >= 2^-110 splits exactly)."""
    gen = torch.Generator().manual_seed(1000 + lo)
    n = 200_000
    frac = torch.randint(0, 1 << 23, (n,), generator=gen, dtype=torch.int64)
    exp = torch.randint(lo, hi, (n,), generator=gen, dtype=torch.int64)
    sign = torch.randint(0, 2, (n,), generator=gen, dtype=torch.int64)
    bits = (sign << 31) | ((exp + 127) << 23) | frac
    v = bits.to(torch.int32).view(torch.float32)
    assert bool(torch.isfinite(v).all())
    h, m, l = _planes64(v)
    assert torch.equal(h + m + l, v.to(torch.float64))
    # each plane carries the next 8 bits: |m| <= 2^-8 |h|, |l| <= 2^-8 |m|
    assert bool((m.abs() <= h.abs() * 2.0 ** -8).all())
    assert bool((l.abs() <= m.abs() * 2.0 ** -8).all())


def test_ones_and_zeros_split_into_the_h_plane():
    h, m, l = prec.split_three(torch.tensor([1.0, 0.0, -1.0]))
    assert h.tolist() == [1.0, 0.0, -1.0]
    assert m.tolist() == l.tolist() == [0.0, 0.0, 0.0]


def test_six_product_gram_is_as_close_as_an_f32_gram():
    """Over 160,000 mixture pairs (400 x 400), the Gram from the six
    plane products is no further from the float64 Gram than an f32 Gram
    is, at its worst and on average; two planes are far further."""
    x = _mixture(800, 2)
    a, b = x[:400], x[400:].T.contiguous()
    exact = a.to(torch.float64) @ b.to(torch.float64)
    f32 = _f32_err(a, b, exact)
    six = (_six(a, b) - exact).abs()
    two = (_two(a, b) - exact).abs()
    assert a.shape[0] * b.shape[1] >= 100_000
    assert float(six.max()) <= float(f32.max())
    assert float(six.mean()) <= float(f32.mean())
    assert float(two.max()) > 10 * float(f32.max())


def test_six_product_second_product_is_as_close_as_f32():
    """phi @ [X | 1] over 400 rows x 512 columns of the mixture (204,800
    pairs), phi the f32 weights of the benchmark's bandwidth: the six
    plane products lie no further from float64 than the f32 product, and
    so does S0 (the ones column); two planes lie far further."""
    x = _mixture(912, 3)
    rows, cols = x[:400], x[400:]
    x64, c64 = rows.to(torch.float64), cols.to(torch.float64)
    sq = torch.cdist(x64, c64) ** 2
    phi = torch.exp(-sq / (2 * H * H)).to(torch.float32)
    aug = torch.cat([cols, cols.new_ones((cols.shape[0], 1))], dim=1)
    exact = phi.to(torch.float64) @ aug.to(torch.float64)
    f32 = _f32_err(phi, aug, exact)
    six = (_six(phi, aug) - exact).abs()
    two = (_two(phi, aug) - exact).abs()
    assert phi.numel() >= 100_000
    assert float(six.max()) <= float(f32.max())
    assert float(six.mean()) <= float(f32.mean())
    assert float(six[:, -1].max()) <= float(f32[:, -1].max())
    assert float(two.max()) > 10 * float(f32.max())


def test_dropped_products_weigh_f32_rounding():
    """The three products the kernel drops (ml, lm, ll) weigh at most
    ~2^-24 of |a||b| a coordinate: f32's own rounding."""
    x = _mixture(256, 4)
    a, b = x[:128], x[128:].T.contiguous()
    ah, am, al = _planes64(a)
    bh, bm, bl = _planes64(b)
    dropped = (am @ bl + al @ bm + al @ bl).abs()
    scale = a.abs().to(torch.float64) @ b.abs().to(torch.float64)
    assert float((dropped / scale).max()) <= 2.0 ** -24
    assert math.isfinite(float(dropped.max()))
