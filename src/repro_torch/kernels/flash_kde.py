"""Flash KDE pass (kernel B2): Gaussian kernel sums at query points.

Computes ``p_j = Σ_i exp(-‖y_j - x_i‖²/(2h²))`` for query rows ``y_j``
against the train columns ``xt`` (d, n), with ``sq`` clamped at 0.  Three
functions:

  * ``flash_kde_cuda`` launches the hand-written CUDA kernel
    (``csrc/flash_kde.cu`` over ``csrc/flash_kde_pass.cuh``) on CUDA
    tensors and counts the launch;
  * ``flash_kde_plain`` is the same function in plain PyTorch, streaming
    column blocks of ``block_n`` so n×m is never materialized;
  * ``flash_kde`` takes the plain version for CPU tensors and the kernel
    for CUDA tensors — no fallback between them.

Arguments follow ``repro.kernels.flash_kde.flash_kde_pallas``: padded
operands, norms (m, 1) and (1, n) in f32, ``inv2h2`` a (1, 1) f32 tensor,
the bf16x2 tier given by both lo planes; the result is (m, 1) f32 sums.

The kernel splits the columns: each block sums 64 rows over one split of
``plan_splits(n, block_n).per_split`` column tiles into an (splits, m)
f32 scratch, and a second pass in the same launch adds each row's
splits in order.  The plan depends on n and block_n only, so a row's sum
does not depend on the other rows of its request.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import precision as prec

MAX_D = 64          # the widest d the kernels are built for
# the largest row tile, the padding and visit-list unit of the
# split-column kernels (B1-B6), whose blocks take 64 of its rows each
MAX_BLOCK_M = 256
TIER_CODES = {"f32": 0, "bf16": 1, "bf16x2": 2}
# Column splits of the KDE pass (B2, B4, B5, B6): a split covers at least
# SPLIT_COLUMNS columns, and a row tile has at most MAX_SPLITS splits
# (beyond that the splits grow, which bounds the (splits, m) scratch).
SPLIT_COLUMNS = 256
MAX_SPLITS = 128

# the C signature of the dense KDE passes, B2, B5 and B6 alike
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]

#: Kernel launches made by ``flash_kde_cuda``; set to 0 to start a count.
launches = 0


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """How the KDE pass splits one row tile's column tiles (B2) or visit
    slots (B4): ``splits`` consecutive runs of ``per_split``, the last one
    possibly shorter."""

    per_split: int
    splits: int
    slots: int

    def ranges(self, count: Optional[int] = None) -> List[Tuple[int, int]]:
        """[start, stop) of the slots each split sums, in split order, as
        the kernel walks them: ``count`` (a row tile's visit count, at
        most ``slots``) cuts the runs, and a split that starts past it
        sums nothing (start == stop)."""
        end = self.slots if count is None else count
        out = []
        for s in range(self.splits):
            start = s * self.per_split
            out.append((start, max(start, min(start + self.per_split,
                                              end))))
        return out

    def scratch_shape(self, m: int) -> Tuple[int, int]:
        """The (splits, m) f32 partial sums the wrapper allocates."""
        return (self.splits, m)


def plan_splits(n: int, block_n: int,
                visits: Optional[int] = None) -> SplitPlan:
    """The column splits of the KDE pass for n columns in tiles of
    ``block_n``: ``per_split`` from n and block_n only (never from the
    number of query rows), over the n/block_n column tiles (B2) or over
    ``visits`` visit slots, the visit lists' width (B4)."""
    if n < 1 or block_n < 1 or (visits is not None and visits < 1):
        raise ValueError(f"bad split plan input n={n} block_n={block_n} "
                         f"visits={visits}")
    tiles = -(-n // block_n)
    per_split = max(-(-SPLIT_COLUMNS // block_n), -(-tiles // MAX_SPLITS))
    slots = tiles if visits is None else visits
    return SplitPlan(per_split, -(-slots // per_split), slots)


def _check(y, nrm_y, xt, nrm_x, inv2h2, y_lo, xt_lo, block_m, block_n):
    m, d = y.shape
    if xt.shape[0] != d:
        raise ValueError(f"xt has d={xt.shape[0]}, queries d={d}")
    n = xt.shape[1]
    if (y_lo is None) != (xt_lo is None):
        raise ValueError("bf16x2 needs both lo planes")
    if m % block_m or n % block_n:
        raise ValueError(f"shapes (m={m}, n={n}) must be multiples of "
                         f"(block_m={block_m}, block_n={block_n})")
    if tuple(nrm_y.shape) != (m, 1) or tuple(nrm_x.shape) != (1, n):
        raise ValueError(f"norm shapes {tuple(nrm_y.shape)}, "
                         f"{tuple(nrm_x.shape)} do not match ({m}, 1), "
                         f"(1, {n})")
    if inv2h2.numel() != 1:
        raise ValueError("inv2h2 must hold one value")
    return m, n, d


def refuse_grad(name: str, tensors, route: str) -> None:
    """Raise when autograd would record a launch: grad mode is on and a
    floating input requires grad.  The kernels launch through ``ctypes``
    into ``torch.empty`` outputs and have no backward, so their outputs
    would carry no ``grad_fn`` and the inputs would silently get no
    gradient.  ``route`` names the differentiable version to use
    instead; under ``torch.no_grad()`` or ``inference_mode`` nothing is
    refused."""
    if not torch.is_grad_enabled():
        return
    if any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward and would leave its inputs without a "
            f"gradient: differentiate through {route}, or call it under "
            "torch.no_grad()")


def check_cuda(name, tier, operands, floats, d, block_m, ints=()):
    """Checks shared by every kernel launch: first the refusal of an
    input that requires grad under grad mode (``refuse_grad``, naming
    the plain version), then all tensors contiguous on one CUDA device,
    the GEMM ``operands`` (None for an absent lo plane) of the tier's
    type, the norms and inv2h2 (``floats``) f32, index tensors (``ints``)
    int32, and d and block_m within what the kernels are built for.
    Returns the device."""
    refuse_grad(name, operands + floats,
                f"the plain version {name.removesuffix('_cuda')}_plain")
    dev = operands[0].device
    for t in operands + floats + ints:
        if t is None:
            continue
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} needs every tensor on one CUDA "
                             f"device, got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")
    want = torch.float32 if tier == "f32" else torch.bfloat16
    for t in operands:
        if t is not None and t.dtype != want:
            raise ValueError(f"tier {tier} operands must be {want}, "
                             f"got {t.dtype}")
    if any(t.dtype != torch.float32 for t in floats):
        raise ValueError("norms and inv2h2 must be float32")
    if any(t.dtype != torch.int32 for t in ints):
        raise ValueError("counts and tile_map must be int32")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"{name} is built for 1 <= d <= {MAX_D}, got d={d}")
    if not 1 <= block_m <= MAX_BLOCK_M:
        raise ValueError(f"block_m must be in [1, {MAX_BLOCK_M}], got "
                         f"{block_m}")
    return dev


def flash_kde_plain(
    y: torch.Tensor,
    nrm_y: torch.Tensor,
    xt: torch.Tensor,
    nrm_x: torch.Tensor,
    inv2h2: torch.Tensor,
    y_lo: Optional[torch.Tensor] = None,
    xt_lo: Optional[torch.Tensor] = None,
    *,
    block_n: int = 128,
) -> torch.Tensor:
    """Plain PyTorch B2, one column block of ``block_n`` at a time."""
    m = y.shape[0]
    n = xt.shape[1]
    out = torch.zeros((m, 1), dtype=torch.float32, device=y.device)
    for j0 in range(0, n, block_n):
        cols = slice(j0, j0 + block_n)
        if y_lo is None:
            g = prec.dot_f32(y, xt[:, cols])
        else:
            g = prec.gram_compensated(y, y_lo, xt[:, cols], xt_lo[:, cols])
        sq = torch.clamp(nrm_y + nrm_x[:, cols] - 2.0 * g, min=0.0)
        out += torch.exp(-sq * inv2h2).sum(dim=1, keepdim=True)
    return out


def launch_dense_pass(name, load, y, nrm_y, xt, nrm_x, inv2h2, y_lo, xt_lo,
                      block_m, block_n) -> torch.Tensor:
    """Check, plan and launch one of the dense KDE passes, B2, B5 or B6,
    which share the C signature ``_ARGTYPES``: ``load()`` gives the
    (launch, error) C functions, called after the checks so that refused
    operands never build a kernel.  Allocates the (splits, m) scratch of
    ``plan_splits(n, block_n)`` and the (m, 1) f32 sums on the operands'
    device, launches on its current stream and raises if the launch was
    refused.  The caller counts the launch."""
    m, n, d = _check(y, nrm_y, xt, nrm_x, inv2h2, y_lo, xt_lo,
                     block_m, block_n)
    tier = prec.tier_of(y, y_lo)
    dev = check_cuda(f"{name}_cuda", tier, (y, xt, y_lo, xt_lo),
                     (nrm_y, nrm_x, inv2h2), d, block_m)
    plan = plan_splits(n, block_n)
    launch, error = load()
    part = torch.empty(plan.scratch_shape(m), dtype=torch.float32,
                       device=dev)
    out = torch.empty((m, 1), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            y.data_ptr(), y_lo.data_ptr() if y_lo is not None else None,
            nrm_y.data_ptr(), xt.data_ptr(),
            xt_lo.data_ptr() if xt_lo is not None else None,
            nrm_x.data_ptr(), inv2h2.data_ptr(), part.data_ptr(),
            out.data_ptr(), m, n, d, TIER_CODES[tier], block_m, block_n,
            plan.per_split, plan.splits, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed ({rc}): "
                           f"{error(rc).decode()} [m={m} n={n} d={d} "
                           f"tier={tier} block_m={block_m} "
                           f"block_n={block_n} splits={plan.splits}]")
    return out


def flash_kde_cuda(
    y: torch.Tensor,
    nrm_y: torch.Tensor,
    xt: torch.Tensor,
    nrm_x: torch.Tensor,
    inv2h2: torch.Tensor,
    y_lo: Optional[torch.Tensor] = None,
    xt_lo: Optional[torch.Tensor] = None,
    *,
    block_m: int = 128,
    block_n: int = 128,
) -> torch.Tensor:
    """Launch kernel B2 (both of its passes) on the current stream;
    returns (m, 1) f32 sums."""
    global launches
    out = launch_dense_pass(
        "flash_kde", lambda: _build.load("flash_kde", _ARGTYPES), y, nrm_y,
        xt, nrm_x, inv2h2, y_lo, xt_lo, block_m, block_n)
    launches += 1
    return out


def flash_kde(
    y: torch.Tensor,
    nrm_y: torch.Tensor,
    xt: torch.Tensor,
    nrm_x: torch.Tensor,
    inv2h2: torch.Tensor,
    y_lo: Optional[torch.Tensor] = None,
    xt_lo: Optional[torch.Tensor] = None,
    *,
    block_m: int = 128,
    block_n: int = 128,
) -> torch.Tensor:
    """B2 on the tensors' device: plain PyTorch on the CPU, the kernel on
    the card.  Returns unnormalized sums (m, 1) f32."""
    if y.device.type == "cpu":
        _check(y, nrm_y, xt, nrm_x, inv2h2, y_lo, xt_lo, block_m, block_n)
        return flash_kde_plain(y, nrm_y, xt, nrm_x, inv2h2, y_lo, xt_lo,
                               block_n=block_n)
    return flash_kde_cuda(y, nrm_y, xt, nrm_x, inv2h2, y_lo, xt_lo,
                          block_m=block_m, block_n=block_n)


__all__ = ["MAX_D", "MAX_BLOCK_M", "TIER_CODES", "SPLIT_COLUMNS",
           "MAX_SPLITS", "SplitPlan", "plan_splits", "refuse_grad",
           "check_cuda",
           "launch_dense_pass", "flash_kde", "flash_kde_cuda",
           "flash_kde_plain"]
