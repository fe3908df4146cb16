"""The f32 score pass on the card against float64: B1 (dense) and B3
(visit lists, exact pruning) at 32,768 points of the paper's 16-d
mixture, and at d = 1, 24 and 64 (the DMAX 4, 32 and 64 builds).

Each value of S1aug = sum_j phi_ij [x_j | 1] is held to chip_smoke's f32
bar times its absolute mass, sum_j phi_ij |[x_j | 1]_k| (S1 cancels
between points on either side of x_i, so the error is absolute; for S0
the mass is S0 itself), the mass and the reference both in float64.
The kernel runs both products as six bf16 products of three exact
planes (csrc/flash_score_pass.cuh); the bar is the one the FP32 body it
replaced was held to.

Skips without a card.  On the card, from the repository root:

    PYTHONPATH=src python3 -m pytest -q --noconftest tests/test_torch_score_card.py
"""

import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

# (d, points, bandwidth): the benchmark's mixture at its bandwidth, and
# normal points at h = 0.5 sqrt(d), as chip_smoke draws its wide checks
CASES = [(16, 32768, 0.78), (1, 8192, 0.5), (24, 8192, 0.5 * math.sqrt(24)),
         (64, 8192, 4.0)]


@pytest.fixture
def card():
    """Skip the test unless a CUDA device is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    return torch.device("cuda")


def _points(d: int, n: int, dev) -> torch.Tensor:
    from repro_torch.core import mixtures

    gen = torch.Generator(device=dev)
    gen.manual_seed(1000 + d)
    if d == 16:
        return mixtures.benchmark_mixture_16d().sample(n, gen)
    return torch.randn(n, d, generator=gen, device=dev)


def _float64_stats(x: torch.Tensor, h: float, block: int = 4096):
    """S1aug of the square pass and its absolute mass, in float64."""
    x64 = x.double()
    n, d = x64.shape
    aug = torch.cat([x64, x64.new_ones((n, 1))], dim=1)
    nrm = (x64 * x64).sum(dim=1)
    s1aug = torch.zeros((n, d + 1), dtype=torch.float64, device=x.device)
    mass = torch.zeros_like(s1aug)
    for j0 in range(0, n, block):
        cols = slice(j0, j0 + block)
        sq = (nrm[:, None] + nrm[None, cols]
              - 2.0 * x64 @ x64[cols].T).clamp_min(0.0)
        phi = torch.exp(-sq / (2.0 * h * h))
        s1aug += phi @ aug[cols]
        mass += phi @ aug[cols].abs()
    return s1aug, mass


@pytest.mark.chip
@pytest.mark.parametrize("prune", ["off", 0.0], ids=["B1", "B3"])
@pytest.mark.parametrize("d, n, h", CASES,
                         ids=[f"d{d}" for d, _, _ in CASES])
def test_f32_score_pass_against_float64(card, d, n, h, prune):
    import chip_smoke
    from repro_torch.kernels import flash_pruned, flash_score, ops

    x = _points(d, n, card)
    flash_score.launches = 0
    flash_pruned.score_counts.reset()
    s0, s1 = ops.flash_score_stats(x, h, precision="f32", block_m=128,
                                   block_n=128, prune=prune)
    torch.cuda.synchronize()
    if prune == "off":
        assert flash_score.launches == 1
        assert flash_pruned.score_counts.launches == 0
    else:
        assert flash_score.launches == 0
        assert flash_pruned.score_counts.launches == 1
    want, mass = _float64_stats(x, h)
    got = torch.cat([s1, s0[:, None]], dim=1).double()
    bar = chip_smoke.tier_bar("f32", x, h)
    ratio = float(((got - want).abs() / mass.clamp_min(1e-300)).max())
    assert bool(torch.isfinite(got).all())
    assert ratio <= bar, (f"d={d} prune={prune}: max |err|/mass {ratio:.3e} "
                          f"over the bar {bar:.1e}")
