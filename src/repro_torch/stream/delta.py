"""The delta score pass: incremental (S0, S1) maintenance.

The counterpart of ``repro.stream.delta``, in plain PyTorch on the
stream's device.  SD-KDE's debias shift of point i is a function of the
score statistics

    S0_i = Σ_j φ(x_i, x_j)        S1_i = Σ_j φ(x_i, x_j) · x_j

over the *whole* live set, so appending or evicting points perturbs every
other point's statistics.  But the perturbation is a *sum of the changed
points' contributions*: an append adds ``Σ_{b∈batch} φ(x_i, b)`` to S0_i
(one O(n·b·d) cross GEMM), an eviction subtracts the same terms.

Three numeric choices make the incremental stats track a from-scratch
pass:

  * **φ in f32, as the dense pass computes it** — GEMM-form distances
    with the norm trick, clamped at 0 — so each term matches the refit's
    to f32 rounding;
  * **weights below the smallest normal f32 set to exactly 0.0**, as
    XLA's flush-to-zero leaves them in ``repro``: the stream marks a
    point dirty when ``ΔS0 != 0`` and carries clean tiles over bit for
    bit, which needs a distant point's weight to be exactly 0.0.
    PyTorch keeps subnormals (``exp(-95)`` is 5.5e-42 in f32), so
    without the flush an update at ``sq/(2h²)`` in (87.3, 103.3] would
    dirty points ``repro`` leaves clean;
  * **accumulation in float64** — the running S0/S1 are f64, so a long
    interleaving of ``+=`` / ``-=`` cancels to f64 rounding instead of
    compounding f32 error.

The sums are one f64 product ``φ·[X | 1]`` per block pair.  Everything
here is also the basis of ``core.estimator.SDKDE.append`` — the offline
face of the same math.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

#: The smallest normal f32; φ below it is flushed to exactly 0.0.
FLT_MIN = float(torch.finfo(torch.float32).tiny)


def _inv2h2(sh: float) -> float:
    """1/(2·sh²) rounded to f32, as ``repro`` passes it to its kernel."""
    return float(np.float32(1.0 / (2.0 * float(sh) ** 2)))


def phi_cross(a: torch.Tensor, b: torch.Tensor, inv2h2: float
              ) -> torch.Tensor:
    """f32 kernel weights φ(a_i, b_j), GEMM-form (as the dense pass), with
    subnormal weights flushed to 0.0."""
    an = torch.sum(a * a, dim=-1)[:, None]
    bn = torch.sum(b * b, dim=-1)[None, :]
    sq = torch.clamp(an + bn - 2.0 * (a @ b.T), min=0.0)
    phi = torch.exp(-sq * inv2h2)
    # XLA flushes subnormal f32 results to zero; this reproduces it, and
    # with it the exact 0.0 that ``changed = ds0 != 0`` and the clean-tile
    # carry-over rest on
    return phi.masked_fill_(phi < FLT_MIN, 0.0)


def cross_stats(a: torch.Tensor, b: torch.Tensor, sh: float, *,
                block: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ΔS0, ΔS1): the contributions of point set ``b`` to ``a``'s stats.

    Returns float64 ``(len(a),)`` and ``(len(a), d)`` tensors on ``a``'s
    device, f64-summed from f32 kernel weights.  Blocked on both axes so
    the φ working set stays ≤ block² whatever the sides' sizes; a side
    shorter than ``block`` lets the other take longer chunks (an append
    batch of 256 against 262144 live points is 4 chunks, not 64).
    """
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    (na, d), nb = a.shape, b.shape[0]
    inv2h2 = _inv2h2(sh)
    ca = block if nb >= block else block * block // max(nb, 1)
    cb = block if na >= block else block * block // max(na, 1)
    acc = torch.zeros((na, d + 1), dtype=torch.float64, device=a.device)
    baug = torch.cat([b.double(), b.new_ones((nb, 1), dtype=torch.float64)],
                     dim=1)
    for i in range(0, na, ca):
        ai = a[i:i + ca]
        for j in range(0, nb, cb):
            phi = phi_cross(ai, b[j:j + cb], inv2h2)
            acc[i:i + ca] += phi.double() @ baug[j:j + cb]
    return acc[:, d].contiguous(), acc[:, :d].contiguous()


def initial_stats(x: torch.Tensor, sh: float, *, block: int = 4096
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full (S0, S1) of a point set against itself (the stream's one full
    pass, at fit time — every later update is a delta)."""
    return cross_stats(x, x, sh, block=block)


def append_delta(x_live: torch.Tensor, x_new: torch.Tensor, sh: float, *,
                 block: int = 4096):
    """Stat updates for appending ``x_new`` to a live set ``x_live``.

    Returns ``(ds0_live, ds1_live, s0_new, s1_new)``: the deltas to *add*
    to the existing points' statistics, and the new points' own full
    statistics over the post-append set (existing + batch, including the
    within-batch and self terms φ=1 — the terms a from-scratch pass over
    the grown set would include).
    """
    ds0, ds1 = cross_stats(x_live, x_new, sh, block=block)
    s0a, s1a = cross_stats(x_new, x_live, sh, block=block)
    s0b, s1b = cross_stats(x_new, x_new, sh, block=block)
    return ds0, ds1, s0a + s0b, s1a + s1b


def evict_delta(x_keep: torch.Tensor, x_out: torch.Tensor, sh: float, *,
                block: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stat updates for evicting ``x_out``: the deltas to *subtract* from
    the kept points' statistics (the evicted rows' stats are dropped)."""
    return cross_stats(x_keep, x_out, sh, block=block)


def apply_shift(x: torch.Tensor, s0: torch.Tensor, s1: torch.Tensor,
                h: float, sh: float) -> torch.Tensor:
    """f64 debiased positions x^SD = x + (h²/2)·(S1 − x·S0)/(sh²·S0).

    Same formula as ``kernels.ops._apply_score_shift``; f64 end to end so
    a point whose statistics did not change reproduces its previous
    position bit for bit (the streaming layer's clean-tile invariant).
    """
    x64 = x.to(torch.float64)
    s0c = s0[:, None]
    score = (s1 - x64 * s0c) / (float(sh) ** 2 * s0c)
    return x64 + 0.5 * float(h) ** 2 * score


__all__ = [
    "FLT_MIN", "phi_cross", "cross_stats", "initial_stats", "append_delta",
    "evict_delta", "apply_shift",
]
