"""Serving configuration: backend, estimator method, batching policy.

The counterpart of ``repro.serve.config``, with the knobs this port
implements.  Ragged query traffic is coalesced into a geometric ladder of
padded batch shapes (``bucket_sizes``); on the ``flash`` backend every
bucket is a multiple of the kernels' row tile ``block_m`` (the tile the
fit resolved, when the config says ``"auto"``).  ``plan="auto"`` fills
every knob left at its default from the planner (``repro_torch.plan``);
the ``rff*`` knobs configure the random-feature fast tier behind the
accuracy cascade.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional, Tuple, Union

from repro_torch.core.estimator import check_backend
from repro_torch.kernels import ops
from repro_torch.kernels.precision import validate as _validate_precision

Backend = Literal["flash", "torch"]
Method = Literal["kde", "sdkde", "laplace"]
METHODS = ("kde", "sdkde", "laplace")
# a serving tier is an exact GEMM tier or the RFF fast tier
ServeTier = Literal["f32", "bf16", "bf16x2", "rff"]
BlockArg = Union[int, Literal["auto"]]


def _round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Static serving configuration.

    Batching: a query batch of ``m`` rows is padded up to the smallest
    shape bucket ≥ m.  Buckets double from ``min_batch`` to ``max_batch``
    and are rounded up to the row multiple; larger batches are chunked at
    the top bucket.
    """

    backend: Backend = "flash"
    method: Method = "sdkde"

    # estimator knobs (mirror repro_torch.core.estimator.EstimatorConfig)
    block: int = 1024            # torch-backend streaming column block
    # kernel tiles, ints or "auto" (tuned once per fit for the largest
    # bucket against the train set, kernels/autotune.py)
    block_m: BlockArg = 128      # kernel row tile = bucket row multiple
    block_n: BlockArg = 128      # kernel column tile
    score_h: Optional[float] = None
    # Default serving tier: an exact tier or "rff", the random-feature
    # fast tier (a QueryRequest pin overrides per request); the registry
    # prepares train columns per exact tier on first use.
    precision: str = "f32"
    # Tier of the one-time O(n²·d) debias fit: full precision by default,
    # since a reduced fit bakes its error into every later answer.
    fit_precision: str = "f32"
    # cluster pruning: "auto" = exact pruning once the train set reaches
    # ops.PRUNE_AUTO_MIN_COLS, "off" = dense, float = epsilon >= 0
    prune: "str | float" = "auto"

    # micro-batching policy
    min_batch: int = 128         # smallest shape bucket
    max_batch: int = 4096        # largest shape bucket (larger batches chunk)
    cache_buckets: int = 8       # LRU capacity of per-bucket callables

    # streaming (repro_torch.stream): maintain the registered dataset
    # incrementally under registry.append()/evict_ids()/slide() instead of
    # refitting.  ``staleness_budget`` is how many applied update
    # generations a query may be served across before the engine must
    # publish a fresh snapshot (0 = always fresh); ``stream_slack`` is the
    # per-cluster append headroom of the flash layout;
    # ``stream_background`` builds snapshots on a worker thread so queries
    # keep serving generation g while g+1 prepares.
    stream: bool = False
    staleness_budget: int = 0
    stream_slack: float = 0.5
    stream_background: bool = False

    # execution planning (repro_torch.plan): "auto" resolves every knob
    # still at its default through the planner at fit time (explicitly
    # set knobs win); ``accuracy_target`` is the planner's relative
    # accuracy budget and the cascade's default per-request target
    # (None = f32-grade, and no cascade without a request target)
    plan: Literal["off", "auto"] = "off"
    accuracy_target: Optional[float] = None

    # RFF fast tier + accuracy cascade (kernels/flash_rff.py,
    # serve/cascade.py): "auto" fits the tier on the first cascade-routed
    # request, "on" with the debias pass, "off" disables it (an "rff" pin
    # then raises)
    rff: Literal["off", "auto", "on"] = "auto"
    rff_features: int = 8192     # D: total cos+sin features
    rff_pilot: int = 256         # pilot control-variate mixture size
    rff_groups: int = 32         # frequency groups behind the band
    rff_precision: str = "f32"   # phase-product operand tier

    device: str = "cuda"         # "cuda" (raises without a card) or "cpu"

    def __post_init__(self):
        check_backend(self.backend)
        if self.method not in METHODS:
            raise ValueError(f"unknown method {self.method!r} (choose from "
                             f"{METHODS})")
        ops.check_prune(self.prune)
        ops.check_blocks(self.block_m, self.block_n)
        if self.precision != "rff":
            _validate_precision(self.precision)
        for p in (self.fit_precision, self.rff_precision):
            _validate_precision(p)
        if self.rff not in ("off", "auto", "on"):
            raise ValueError(f"bad rff {self.rff!r} ('off', 'auto', or 'on')")
        if self.precision == "rff" and self.rff == "off":
            raise ValueError("precision='rff' needs the RFF tier enabled "
                             "(rff='auto' or 'on')")
        if self.rff_pilot < 1 or self.rff_groups < 2:
            raise ValueError("need rff_pilot >= 1 and rff_groups >= 2")
        if self.rff_features < 2 * self.rff_groups \
                or self.rff_features % (2 * self.rff_groups):
            raise ValueError(
                f"rff_features must be a positive multiple of "
                f"2·rff_groups, got {self.rff_features} with "
                f"groups={self.rff_groups}")
        if self.plan not in ("off", "auto"):
            raise ValueError(f"bad plan {self.plan!r} ('off' or 'auto')")
        if self.accuracy_target is not None \
                and not (self.accuracy_target > 0):
            raise ValueError(f"accuracy_target must be > 0, got "
                             f"{self.accuracy_target!r}")
        if self.min_batch <= 0 or self.max_batch < self.min_batch:
            raise ValueError(
                f"bad bucket range [{self.min_batch}, {self.max_batch}]")
        if self.cache_buckets < 1:
            raise ValueError("cache_buckets must be >= 1")
        if self.block < 1:
            raise ValueError(f"bad block {self.block!r}")
        if self.staleness_budget < 0:
            raise ValueError("staleness_budget must be >= 0")
        if self.stream_slack < 0:
            raise ValueError("stream_slack must be >= 0")

    @property
    def exact_precision(self) -> str:
        """The exact tier behind the default serving tier: what the
        registry prepares columns at and what cascade escalations run at
        when the default tier is ``"rff"``."""
        return "f32" if self.precision == "rff" else self.precision

    def row_multiple(self, block_m: Optional[int] = None) -> int:
        """Row-count multiple every dispatched batch honors: the kernels'
        row tile on ``flash`` (``block_m``, the fit's resolved tile, when
        the config says ``"auto"``; 128 before a fit resolves it); 1 on
        the shape-agnostic ``torch`` path."""
        if self.backend != "flash":
            return 1
        bm = block_m if block_m is not None else self.block_m
        return bm if isinstance(bm, int) else 128

    def bucket_sizes(self, block_m: Optional[int] = None) -> Tuple[int, ...]:
        """The geometric ladder of padded batch shapes this config serves."""
        mult = self.row_multiple(block_m)
        sizes, b = [], self.min_batch
        while True:
            sizes.append(_round_up(min(b, self.max_batch), mult))
            if b >= self.max_batch:
                break
            b *= 2
        return tuple(dict.fromkeys(sizes))

    def bucket_for(self, m: int, block_m: Optional[int] = None) -> int:
        """Smallest shape bucket that fits an ``m``-row query batch."""
        if m <= 0:
            raise ValueError(f"empty query batch (m={m})")
        sizes = self.bucket_sizes(block_m)
        for b in sizes:
            if m <= b:
                return b
        return sizes[-1]  # chunked by the engine


__all__ = ["Backend", "Method", "METHODS", "ServeTier", "BlockArg",
           "ServeConfig"]
