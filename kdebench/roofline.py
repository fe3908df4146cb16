"""The work SD-KDE's passes need and the least time one H100 could take.

Work is counted from the inputs alone, never from how the program runs:

* a pair (i, j) is one Gram product (2·d operations), one exponential,
  and, in the score pass, the weighted sums φ_ij · [x_j | 1] (2·(d + 1)
  operations); the KDE pass adds φ_ij alone, which is not a product;
* each input byte is read once and each output byte written once.

Pairs that an exact method may skip: a pair whose float32 weight is
below FLT_MIN contributes exactly zero after flush-to-zero, so an exact
float32 method need not compute it.  The counts below take the number
of pairs as an argument; the harness passes the pairs whose weight is at
least FLT_MIN, which the float64 reference counts on the inputs of the
run (``reference/sdkde.py`` with ``count=True``), and ``m · n`` when no
count is given.

The least time divides each kind of work by the fastest rate at which
any unit of the card could do it, and takes the largest of the three,
since the units run side by side:

* products at the tensor cores' dense peak, 989 TFLOP/s (the bf16 rate;
  no slower format makes a float32-accurate product faster);
* exponentials at the SFU's 16 a clock per SM plus what the FP32 pipes
  could add, 128 lanes a clock per SM at 4 operations an exponential (a
  float32-accurate polynomial needs more), at the 1.98 GHz boost clock:
  132 · 1.98e9 · (16 + 32) = 1.2545e13 a second;
* bytes at the HBM3 bandwidth, 3.35 TB/s.

Peaks: NVIDIA H100 SXM5 data sheet (dense, 700 W), SM count and clock
from the Hopper architecture whitepaper.  A time at or above the bound
gives a share at or below 100% by construction.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

F32_BYTES = 4


@dataclasses.dataclass(frozen=True)
class Peaks:
    """Rates of one card."""

    tensor_flops: float = 989e12
    hbm_bytes: float = 3.35e12
    sms: int = 132
    clock_hz: float = 1.98e9
    sfu_exp_per_clk: int = 16
    fp32_lanes: int = 128
    fp32_ops_per_exp: int = 4

    @property
    def exp_rate(self) -> float:
        """Exponentials a second: SFU and FP32 pipes together."""
        per_clk = self.sfu_exp_per_clk + self.fp32_lanes / self.fp32_ops_per_exp
        return self.sms * self.clock_hz * per_clk


H100 = Peaks()


@dataclasses.dataclass(frozen=True)
class Work:
    """Operations of matrix products, exponentials and bytes moved."""

    products: float = 0.0
    exps: float = 0.0
    bytes: float = 0.0

    def scaled(self, k: float) -> "Work":
        return Work(self.products * k, self.exps * k, self.bytes * k)


def score_pass(n: int, d: int, pairs: Optional[float] = None) -> Work:
    """The score pass over ``n`` points: S0 and S1 for every point, every
    point a column.  Reads x (n·d), writes [S1 | S0] (n·(d+1))."""
    p = float(n) * n if pairs is None else float(pairs)
    return Work(products=p * (2 * d + 2 * (d + 1)), exps=p,
                bytes=F32_BYTES * (n * d + n * (d + 1)))


def kde_pass(m: int, n: int, d: int, pairs: Optional[float] = None) -> Work:
    """The KDE pass of ``m`` queries against ``n`` points.  Reads the
    queries and the points, writes one density a query."""
    p = float(m) * n if pairs is None else float(pairs)
    return Work(products=p * 2 * d, exps=p,
                bytes=F32_BYTES * (m * d + n * d + m))


def sdkde_task(n: int, m: int, d: int, score_pairs: Optional[float] = None,
               kde_pairs: Optional[float] = None) -> Work:
    """A whole task: fit on ``n`` points, densities at ``m`` queries.  Its
    inputs are x and y, its output the densities: the shifted points and
    the statistics between the passes are the method's own."""
    s, k = score_pass(n, d, score_pairs), kde_pass(m, n, d, kde_pairs)
    return Work(products=s.products + k.products, exps=s.exps + k.exps,
                bytes=F32_BYTES * (n * d + m * d + m))


def least_seconds(work: Work, peaks: Peaks = H100) -> float:
    """The least time ``peaks`` allow for ``work``."""
    return max(work.products / peaks.tensor_flops, work.exps / peaks.exp_rate,
               work.bytes / peaks.hbm_bytes)


def share_pct(work: Work, seconds: float, peaks: Peaks = H100
              ) -> Optional[float]:
    """The least time over a measured time, in percent; None when no
    time was measured (a share of nothing is not 0)."""
    if not seconds > 0:
        return None
    return 100.0 * least_seconds(work, peaks) / seconds


__all__ = ["F32_BYTES", "Peaks", "H100", "Work", "score_pass", "kde_pass",
           "sdkde_task", "least_seconds", "share_pct"]
