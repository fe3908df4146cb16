"""Launch-tile tuning: cost-model shortlist, then optional device timing.

The counterpart of ``repro.kernels.autotune`` for the Hopper kernels.
Every public wrapper may say ``block_m="auto"`` / ``block_n="auto"`` and
gets, per (rows, cols, d, out_width, precision):

  1. a **model shortlist**: every tile the kernels accept, costed on the
     padded problem and the launch geometry by ``kernels/tuning.py``
     (the H100's FP32, tensor, SFU, issue and HBM rates, waves over 132
     SMs, the kernels' own split plans);
  2. optionally, **device timing** (``measure=True``, or
     ``measure=None`` with operands on a CUDA device) of the model's
     best tile at each of its top-k column widths and of the default
     tile: the B1/B2 kernel wrappers with ``prune="off"`` on synthetic
     data, timed with CUDA events after a warm-up launch, so neither the
     first use's ``nvcc`` build nor the first launch is timed — the
     model ranks, the card votes;
  3. a **process-wide winner cache** keyed by shape buckets
     (next-power-of-two rows/cols), so a serving process tunes each
     regime once (``autotune.probes`` counts the timed launches).

The split-column kernels sum 64 rows a block whatever ``block_m`` is, so
``block_m`` is the padding and visit-list unit and the choice that
matters is ``block_n`` (padding, splits, the pruned passes' skip
granularity).  The candidates are the tiles those kernels take, not the
TPU's.  The occupancy profile (``record_occupancy``) lets the pruned
passes price a tile at the skip rate the workload really shows.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch import obs
from repro_torch.kernels import precision as prec
from repro_torch.kernels import tuning

# Candidate tiles: row tiles of whole 64-row blocks up to MAX_BLOCK_M, and
# column tiles of whole 128-column staging chunks.
DEFAULT_BLOCK_MS = (64, 128, 256)
DEFAULT_BLOCK_NS = (128, 256, 512, 1024, 2048)

BlockArg = Union[int, str]  # an int or the literal "auto"


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    """One costed launch candidate (modeled on the padded problem)."""

    block_m: int
    block_n: int
    step_time: float           # modeled seconds for the full padded pass
    bound: str                 # which resource the model says saturates
    precision: str
    smem_bytes: int

    @property
    def blocks(self) -> Tuple[int, int]:
        return self.block_m, self.block_n


def modeled_cost(
    rows: int, cols: int, d: int, *, block_m: int, block_n: int,
    out_width: int = 1, precision: str = "f32",
    gate_all_tiers: bool = False, occupancy: float = 1.0,
) -> Optional[TunedConfig]:
    """The modeled cost of one launch; None if the kernels refuse it.

    ``gate_all_tiers`` checks the kernels' limits at every tier, not
    just ``precision``: the serving registry passes it so a tile tuned
    at one tier stays launchable when a request pins another through
    the same prepared layout.  ``occupancy`` is the expected fraction of
    column tiles a row tile visits under cluster pruning: the pass walks
    ceil(occupancy · tiles) visit slots (1.0 is the dense pass)."""
    prec.validate(precision)
    tiers = prec.PRECISIONS if gate_all_tiers else (precision,)
    if any(tuning.infeasible(d, block_m=block_m, block_n=block_n,
                             precision=t, out_width=out_width)
           for t in tiers):
        return None
    visits = None
    if occupancy < 1.0:
        tiles = -(-cols // block_n)
        visits = max(1, math.ceil(occupancy * tiles))
    c = tuning.pair_pass_cost(rows, cols, d, block_m=block_m,
                              block_n=block_n, out_width=out_width,
                              precision=precision, visits=visits)
    return TunedConfig(block_m, block_n, c.step_time, c.bound, precision,
                       c.smem_bytes)


def shortlist(
    rows: int, cols: int, d: int, *, out_width: int = 1,
    precision: str = "f32",
    block_ms: Sequence[int] = DEFAULT_BLOCK_MS,
    block_ns: Sequence[int] = DEFAULT_BLOCK_NS,
    gate_all_tiers: bool = False,
    occupancy: float = 1.0,
    occupancy_fn: Optional[Callable[[int], float]] = None,
) -> List[TunedConfig]:
    """All launchable candidates, best modeled time first.

    ``occupancy_fn`` maps a candidate ``block_n`` to its expected
    occupancy (see ``expected_occupancy``); when given it overrides the
    flat ``occupancy``."""
    cands = []
    for bm in block_ms:
        for bn in block_ns:
            occ = occupancy_fn(bn) if occupancy_fn is not None else occupancy
            c = modeled_cost(rows, cols, d, block_m=bm, block_n=bn,
                             out_width=out_width, precision=precision,
                             gate_all_tiers=gate_all_tiers, occupancy=occ)
            if c is not None:
                cands.append(c)
    return sorted(cands, key=lambda c: c.step_time)


# ---------------------------------------------------------------------------
# Winner cache, occupancy profile and the tuning entry point.
# ---------------------------------------------------------------------------

_CACHE: Dict[tuple, Tuple[int, int]] = {}
_OCCUPANCY: Dict[tuple, Dict[int, float]] = {}
# the last probed candidates, for reports: (rows, cols, d, out_width,
# precision, block_m, block_n, modeled s, measured s)
_PROBES: "collections.deque[dict]" = collections.deque(maxlen=256)
_LOCK = threading.Lock()

#: Column-tile width the pruned wrappers also probe occupancy at: a fine
#: record lets ``expected_occupancy`` extrapolate to any candidate tile.
FINE_PROBE_BLOCK = 128


def clear_cache() -> None:
    with _LOCK:
        _CACHE.clear()
        _OCCUPANCY.clear()
        _PROBES.clear()


def cache_info() -> Dict[tuple, Tuple[int, int]]:
    with _LOCK:
        return dict(_CACHE)


def probe_log() -> List[dict]:
    """The most recent device-timed candidates (oldest first)."""
    with _LOCK:
        return list(_PROBES)


def _shape_bucket(x: int) -> int:
    """Next power of two ≥ x: the cache key granularity for rows/cols."""
    return 1 << max(int(math.ceil(math.log2(max(x, 1)))), 0)


def record_occupancy(rows: int, cols: int, d: int, occupancy: float,
                     block_n: int, alpha: float = 0.5) -> None:
    """Feed one measured tile-map occupancy back into the tuner: an EMA
    per (shape bucket, block_n), read by the next ``resolve_blocks
    (pruned=True)`` for that regime."""
    key = (_shape_bucket(rows), _shape_bucket(cols), d)
    occupancy = min(max(float(occupancy), 0.0), 1.0)
    obs.counter("autotune.occupancy_updates",
                "occupancy-profile EMA feeds").inc()
    obs.histogram("autotune.occupancy",
                  "measured tile-map occupancies fed to the tuner",
                  lo=1e-3, hi=1.0).observe(occupancy)
    with _LOCK:
        prof = _OCCUPANCY.setdefault(key, {})
        old = prof.get(block_n)
        prof[block_n] = occupancy if old is None else (
            (1.0 - alpha) * old + alpha * occupancy)


def has_occupancy(rows: int, cols: int, d: int, block_n: int) -> bool:
    """Whether a measured occupancy exists for this regime and tile width."""
    key = (_shape_bucket(rows), _shape_bucket(cols), d)
    with _LOCK:
        return block_n in _OCCUPANCY.get(key, {})


def expected_occupancy(rows: int, cols: int, d: int,
                       block_n: Optional[int] = None,
                       default: float = 1.0) -> float:
    """The learned occupancy for a shape regime (``default`` when unseen).

    A column tile wider than a cluster can never be skipped, so the keep
    fraction grows about linearly with tile width until it saturates: an
    unrecorded ``block_n`` extrapolates from the nearest recorded width
    below it, capped at 1."""
    key = (_shape_bucket(rows), _shape_bucket(cols), d)
    with _LOCK:
        prof = dict(_OCCUPANCY.get(key, {}))
    if not prof:
        return default
    if block_n is None:
        return min(prof.values())
    if block_n in prof:
        return prof[block_n]
    below = [b for b in prof if b < block_n]
    ref = max(below) if below else min(prof)
    return min(1.0, prof[ref] * block_n / ref)


#: Timed groups a probed tile gets (the least wins), and kernel launches
#: queued back to back in each, so the wrapper's host work (checks,
#: scratch allocation, ctypes: ~50-100 µs) overlaps the device's.
PROBE_REPS = 3
PROBE_LAUNCHES = 5
#: The tiles the port launches by default: always probed beside the
#: model's picks, so a measured winner is never slower than it.
DEFAULT_TILE = (128, 128)


def _probe_time_fn(rows: int, cols: int, d: int, out_width: int,
                   precision: str, device: torch.device
                   ) -> Callable[[int, int], float]:
    """Device-timing probe: the real kernel wrapper, B1
    (``flash_score.flash_score``) when ``out_width`` > 1 and B2
    (``flash_kde.flash_kde``) otherwise, on synthetic normal data padded
    and cast for the candidate tile outside the timing.  One warm-up
    launch builds and loads the kernel; then the least of ``PROBE_REPS``
    CUDA-event times of ``PROBE_LAUNCHES`` queued launches, in seconds a
    launch.  Dense, as ``repro``'s probe (``prune="off"``): a pruned probe
    would time the wrong pass and feed the workload's occupancy profile."""
    from repro_torch.kernels import flash_kde, flash_score, ops

    if device is None or device.type != "cuda":
        raise ValueError(f"a measured probe needs a CUDA device (got "
                         f"{device}); the CPU tunes by the model alone")
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((cols, d), generator=g, device=device)
    y = torch.randn((rows, d), generator=g, device=device)
    inv = ops._inv2h2(1.0, device)

    def launch_for(bm: int, bn: int) -> Callable[[], torch.Tensor]:
        if out_width > 1:
            xp = ops._pad_to(x, math.lcm(bm, bn))
            xs, xts, xaug, nrm, _ = ops._score_operands(xp, precision)
            return lambda: flash_score.flash_score(
                xs[0], nrm, xts[0], xaug[0], inv, xs[1], xts[1], xaug[1],
                block_m=bm, block_n=bn)
        ys, xts, nrm_y, nrm_x = ops._prep_eval(x, y, bm, bn, precision)
        return lambda: flash_kde.flash_kde(
            ys[0], nrm_y, xts[0], nrm_x, inv, ys[1], xts[1], block_m=bm,
            block_n=bn)

    def time_blocks(bm: int, bn: int) -> float:
        fn = launch_for(bm, bn)
        fn()
        torch.cuda.synchronize(device)
        best = float("inf")
        for _ in range(PROBE_REPS):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(PROBE_LAUNCHES):
                fn()
            e1.record()
            e1.synchronize()
            best = min(best, e0.elapsed_time(e1) / 1e3 / PROBE_LAUNCHES)
        return best

    return time_blocks


def _probe_candidates(cands: List[TunedConfig],
                      topk: int) -> List[TunedConfig]:
    """The candidates the card times: the model's best tile for each of
    its ``topk`` best column widths (``block_m`` only pads, so tiles that
    differ in it alone cost the same to the model), and the default
    tile where it is a candidate."""
    picked, widths = [], set()
    for c in cands:
        if c.block_n not in widths and len(widths) < topk:
            widths.add(c.block_n)
            picked.append(c)
    default = next((c for c in cands if c.blocks == DEFAULT_TILE), None)
    if default is not None and default not in picked:
        picked.append(default)
    return picked


def autotune_blocks(
    rows: int, cols: int, d: int, *, out_width: int = 1,
    precision: str = "f32",
    block_ms: Sequence[int] = DEFAULT_BLOCK_MS,
    block_ns: Sequence[int] = DEFAULT_BLOCK_NS,
    measure: Optional[bool] = None,
    time_fn: Optional[Callable[[int, int], float]] = None,
    topk: int = 3,
    gate_all_tiers: bool = False,
    occupancy: float = 1.0,
    occupancy_fn: Optional[Callable[[int], float]] = None,
    occupancy_key: tuple = (),
    device: "str | torch.device | None" = None,
) -> Tuple[int, int]:
    """The tuned (block_m, block_n) for one pairwise pass.

    ``measure=None`` times the shortlist's best tiles of its ``topk``
    best column widths, and the default tile (``_probe_candidates``),
    when a ``time_fn`` is given or ``device`` is a CUDA device (the
    operands' device: the model alone on the CPU, where no probe is ever
    built); ``False``
    forces the model; ``True`` forces timing (on ``device``, which must
    then be a card).  Winners are cached process-wide by shape bucket."""
    prec.validate(precision)
    dev = None if device is None else torch.device(device)
    key = (_shape_bucket(rows), _shape_bucket(cols), d, out_width, precision,
           tuple(block_ms), tuple(block_ns), gate_all_tiers,
           round(occupancy, 2), occupancy_key)
    with _LOCK:
        if key in _CACHE:
            obs.counter("autotune.cache_hits",
                        "winner-cache hits (no re-tune)").inc()
            return _CACHE[key]

    with obs.span("autotune.resolve", rows=rows, cols=cols, d=d,
                  out_width=out_width, precision=precision) as sp:
        cands = shortlist(rows, cols, d, out_width=out_width,
                          precision=precision, block_ms=block_ms,
                          block_ns=block_ns, gate_all_tiers=gate_all_tiers,
                          occupancy=occupancy, occupancy_fn=occupancy_fn)
        if not cands:
            raise ValueError(
                f"no launchable tile for rows={rows} cols={cols} d={d} "
                f"precision={precision} (kernel limits: d <= 64, "
                f"block_m <= 256)")
        if measure is None:
            measure = time_fn is not None or (
                dev is not None and dev.type == "cuda")
        best = cands[0]
        if measure and len(cands) > 1:
            if time_fn is None:
                time_fn = _probe_time_fn(rows, cols, d, out_width,
                                         precision, dev)

            def timed(c: TunedConfig) -> float:
                t = time_fn(c.block_m, c.block_n)
                obs.counter("autotune.probes",
                            "device-timed candidate launches").inc()
                obs.histogram("autotune.probe_s",
                              "measured candidate launch times (s)",
                              lo=1e-6, hi=1e2).observe(t)
                with _LOCK:
                    _PROBES.append({
                        "rows": rows, "cols": cols, "d": d,
                        "out_width": out_width, "precision": precision,
                        "block_m": c.block_m, "block_n": c.block_n,
                        "modeled_s": c.step_time, "measured_s": t})
                return t

            best = min(_probe_candidates(cands, topk), key=timed)
        obs.counter("autotune.resolves", "fresh tuner decisions",
                    labels={"mode": "measured" if measure else "model"}
                    ).inc()
        sp.set(block_m=best.block_m, block_n=best.block_n,
               bound=best.bound, measured=bool(measure),
               candidates=len(cands))

    with _LOCK:
        _CACHE[key] = best.blocks
    return best.blocks


def resolve_blocks(
    block_m: BlockArg, block_n: BlockArg, rows: int, cols: int, d: int, *,
    out_width: int = 1, precision: str = "f32",
    row_multiple: Optional[int] = None,
    col_multiple: Optional[int] = None,
    measure: Optional[bool] = None,
    gate_all_tiers: bool = False,
    pruned: bool = False,
    device: "str | torch.device | None" = None,
) -> Tuple[int, int]:
    """Turn ``"auto"`` block args into tuned ints (ints pass through).

    ``row_multiple`` / ``col_multiple`` constrain the tile to divide an
    already-padded row/column count (the prepared serving path).
    ``pruned`` prices candidates at the learned occupancy of this shape
    regime (``record_occupancy``) instead of a dense pass.  ``device`` is
    where the operands live (see ``autotune_blocks``'s ``measure``)."""
    m_auto, n_auto = block_m == "auto", block_n == "auto"
    if not m_auto and not n_auto:
        return block_m, block_n

    def _fitting(cands, multiple):
        if multiple is None:
            return tuple(cands)
        fit = tuple(b for b in cands if multiple % b == 0)
        # else the largest power of two dividing the padded count
        return fit or (math.gcd(multiple, 1 << 30),)

    block_ms = _fitting(DEFAULT_BLOCK_MS, row_multiple) if m_auto \
        else (block_m,)
    block_ns = _fitting(DEFAULT_BLOCK_NS, col_multiple) if n_auto \
        else (block_n,)
    occ_fn = None
    occ_key: tuple = ()
    if pruned:
        occ_fn = lambda bn: expected_occupancy(rows, cols, d, bn)  # noqa: E731
        key = (_shape_bucket(rows), _shape_bucket(cols), d)
        with _LOCK:
            prof = _OCCUPANCY.get(key, {})
            occ_key = tuple(sorted((bn, round(o, 3))
                                   for bn, o in prof.items()))
    return autotune_blocks(
        rows, cols, d, out_width=out_width, precision=precision,
        block_ms=block_ms, block_ns=block_ns, measure=measure,
        gate_all_tiers=gate_all_tiers, occupancy_fn=occ_fn,
        occupancy_key=occ_key, device=device)


__all__ = [
    "DEFAULT_BLOCK_MS", "DEFAULT_BLOCK_NS", "TunedConfig",
    "FINE_PROBE_BLOCK", "PROBE_REPS", "PROBE_LAUNCHES", "DEFAULT_TILE",
    "modeled_cost", "shortlist",
    "autotune_blocks", "resolve_blocks", "clear_cache", "cache_info",
    "probe_log", "record_occupancy", "expected_occupancy", "has_occupancy",
]
