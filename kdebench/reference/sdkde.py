"""Plain SD-KDE in float64: bandwidth, score statistics, shift, densities.

The benchmark's reference.  It follows the paper's definitions from the
inputs alone and shares nothing with the program under test:

    h      = (4/(d+2))^{1/(d+4)} · n^{-1/(d+8)} · mean_k std(x_k)   (SD-KDE rule)
    φ_ij   = exp(-‖x_i − x_j‖² / (2 h_s²)),          h_s = h (score bandwidth)
    S0_i   = Σ_j φ_ij,  S1_i = Σ_j φ_ij x_j            (the self pair included)
    x^SD_i = x_i + (h²/2) · (S1_i − x_i S0_i) / (h_s² S0_i)
    p(y)   = Σ_i exp(-‖y − x^SD_i‖² / (2h²)) / (n (2π)^{d/2} h^d)

Pair sums run in blocks of rows × columns (the score pass, a set against
itself, only the blocks on and above the diagonal).  Each block is one matrix
product of augmented rows, ``[a, ‖a‖², 1] · [2c/(2h²), −1/(2h²),
−‖c‖²/(2h²)]``, which gives the exponent directly, an in-place ``exp``,
and one product with the weight columns, so a pair costs a few bytes of
memory traffic and the whole n² pass fits in a run.

``dtype`` and ``tf32`` exist for the precision control: the same
reference in float32 with TF32 products stands for a program that
computed below the float32 its configuration states.  ``count=True``
also counts the pairs whose float32 weight is at least FLT_MIN: the pairs
an exact float32 method has to compute (the rest are zero after
flush-to-zero), which the roofline counts as the pass's work.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch

#: exp(-a) < FLT_MIN for a above this: such a pair's float32 weight is 0
#: after flush-to-zero, so no exact float32 method needs it.
UNDERFLOW_ARG = -math.log(torch.finfo(torch.float32).tiny)

#: Elements of one rows × columns block (2 GiB in float64).
BLOCK_ELEMS = 1 << 28


def sdkde_bandwidth(x: torch.Tensor) -> float:
    """The SD-KDE bandwidth rule, in float64."""
    n, d = x.shape
    sigma = x.to(torch.float64).std(dim=0, correction=0).mean()
    factor = (4.0 / (d + 2.0)) ** (1.0 / (d + 4.0))
    return float(factor * n ** (-1.0 / (d + 8.0)) * sigma)


@contextlib.contextmanager
def _tf32(on: bool):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def pair_sums(rows: torch.Tensor, cols: torch.Tensor, weights: torch.Tensor,
              h: float, *, dtype: torch.dtype = torch.float64,
              tf32: bool = False, count: bool = False,
              block_elems: int = BLOCK_ELEMS
              ) -> Tuple[torch.Tensor, Optional[int]]:
    """``Σ_j exp(-‖r_i − c_j‖²/(2h²)) · weights_j`` for every row, shape
    (rows, weights' width), and the count of pairs with an exponent
    below ``UNDERFLOW_ARG`` when ``count`` (else None)."""
    inv = 1.0 / (2.0 * h * h)
    r = rows.to(dtype)
    c = cols.to(dtype)
    w = weights.to(dtype)
    ra = torch.cat([r, (r * r).sum(1, keepdim=True),
                    torch.ones_like(r[:, :1])], dim=1)
    ca = torch.cat([(2.0 * inv) * c,
                    torch.full_like(c[:, :1], -inv),
                    -inv * (c * c).sum(1, keepdim=True)], dim=1)
    m, n = r.shape[0], c.shape[0]
    cb = min(n, max(1, block_elems // max(1, min(m, 8192))))
    rb = min(m, max(1, block_elems // cb))
    out = torch.zeros((m, w.shape[1]), dtype=dtype, device=r.device)
    needed = 0
    with _tf32(tf32):
        for i in range(0, m, rb):
            acc = out[i:i + rb]
            for j in range(0, n, cb):
                neg = ra[i:i + rb] @ ca[j:j + cb].T      # −exponent
                if count:
                    needed += int((neg > -UNDERFLOW_ARG).sum())
                acc += neg.exp_() @ w[j:j + cb]
                del neg
    return out, (needed if count else None)


def self_pair_sums(x: torch.Tensor, weights: torch.Tensor, h: float, *,
                   dtype: torch.dtype = torch.float64, tf32: bool = False,
                   count: bool = False, block_elems: int = BLOCK_ELEMS
                   ) -> Tuple[torch.Tensor, Optional[int]]:
    """:func:`pair_sums` of a point set against itself.  The weights are
    symmetric, so each pair of square blocks is computed once, above the
    diagonal, and adds to the sums of both its row block and its column
    block: half the exponentials of the full square."""
    inv = 1.0 / (2.0 * h * h)
    r = x.to(dtype)
    w = weights.to(dtype)
    nrm = (r * r).sum(1, keepdim=True)
    ra = torch.cat([r, nrm, torch.ones_like(nrm)], dim=1)
    ca = torch.cat([(2.0 * inv) * r, torch.full_like(nrm, -inv),
                    -inv * nrm], dim=1)
    n = r.shape[0]
    b = min(n, max(1, math.isqrt(block_elems)))
    out = torch.zeros((n, w.shape[1]), dtype=dtype, device=r.device)
    needed = 0
    with _tf32(tf32):
        for i in range(0, n, b):
            for j in range(i, n, b):
                neg = ra[i:i + b] @ ca[j:j + b].T        # −exponent
                if count:
                    needed += (1 if i == j else 2) * int(
                        (neg > -UNDERFLOW_ARG).sum())
                phi = neg.exp_()
                out[i:i + b] += phi @ w[j:j + b]
                if j != i:
                    out[j:j + b] += phi.T @ w[i:i + b]
                del neg, phi
    return out, (needed if count else None)


def score_shift(x: torch.Tensor, h: float, score_h: Optional[float] = None,
                **kw) -> Tuple[torch.Tensor, Optional[int]]:
    """Debiased points x^SD (in ``dtype``) and the needed pair count."""
    sh = h if score_h is None else score_h
    dtype = kw.get("dtype", torch.float64)
    xw = torch.cat([x.to(dtype), torch.ones_like(x[:, :1], dtype=dtype)],
                   dim=1)
    sums, needed = self_pair_sums(x, xw, sh, **kw)
    d = x.shape[1]
    s0, s1 = sums[:, d], sums[:, :d]
    x64 = x.to(dtype)
    score = (s1 - x64 * s0[:, None]) / (sh * sh * s0[:, None])
    return x64 + 0.5 * h * h * score, needed


def kde(points: torch.Tensor, y: torch.Tensor, h: float,
        **kw) -> Tuple[torch.Tensor, Optional[int]]:
    """Gaussian KDE densities of ``points`` at ``y`` and the needed pair
    count."""
    n, d = points.shape
    dtype = kw.get("dtype", torch.float64)
    ones = torch.ones((n, 1), dtype=dtype, device=points.device)
    sums, needed = pair_sums(y, points, ones, h, **kw)
    norm = n * (2.0 * math.pi) ** (d / 2.0) * h ** d
    return sums[:, 0] / norm, needed


def sdkde(x: torch.Tensor, y: torch.Tensor, **kw):
    """SD-KDE densities at ``y`` fitted on ``x``, with the bandwidth and
    the needed pair counts of the score pass and the KDE pass."""
    h = sdkde_bandwidth(x)
    x_sd, score_pairs = score_shift(x, h, **kw)
    dens, kde_pairs = kde(x_sd, y, h, **kw)
    return dens, h, score_pairs, kde_pairs


__all__ = ["UNDERFLOW_ARG", "BLOCK_ELEMS", "sdkde_bandwidth", "pair_sums",
           "self_pair_sums", "score_shift", "kde", "sdkde"]
