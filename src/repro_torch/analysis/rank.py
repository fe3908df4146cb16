"""One rank's counts of a DTensor program: the port's counterpart of the
per-device numbers ``repro`` reads from a partitioned HLO module
(``cost_analysis``, ``memory_analysis`` and the collectives it parses).

``torch.utils.flop_counter.FlopCounterMode`` and
``torch.distributed._tools.mem_tracker.MemTracker`` see DTensor
operations at their global shapes (a (4096 × 1024) @ (1024 × 2048)
product split over (16, 16) counts 1.718e10 FLOPs where a rank does
6.71e7).  ``RankCounter`` is a ``TorchDispatchMode`` that lets DTensor
desugar each operation first (it returns ``NotImplemented`` for DTensor
arguments, as ``CommDebugMode`` does) and counts what reaches it: the
rank's operations on its local tensors, the collectives of DTensor's
redistributions and the explicit ones of the mesh paths.  The operations
DTensor runs on global-shape fake tensors to propagate shapes are not
the rank's and are skipped.

Counts, per rank:

* ``flops``: the products (matmul, bmm, convolution, attention) through
  ``flop_counter``'s registry on the local shapes, plus one per output
  element of each pointwise operation and one per input element of each
  reduction (XLA's cost analysis counts those too);
* ``bytes``: each non-view operation's tensor inputs and outputs, once
  each (XLA's "bytes accessed");
* ``peak_bytes``: the most local storage alive at once, the tracked
  arguments included (parameters, optimizer state, batch, cache),
  activations saved for the backward and in-place updates included:
  the eager program's peak, not a compiler's buffer plan;
* ``collectives``: count and wire bytes by kind, an all-gather or a
  reduce-scatter moving (n−1)/n of its full buffer, an all-reduce
  2(n−1)/n of it, an all-to-all (n−1)/n of its input (ring algorithms).
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_COLLECTIVES = ("all_gather_into_tensor", "reduce_scatter_tensor",
                "all_reduce", "all_to_all_single")
#: Row-wise normalizations, one FLOP an output element like a pointwise op
_SOFTMAX = ("_softmax", "_log_softmax", "_softmax_backward_data",
            "_log_softmax_backward_data")
_state = threading.local()


def _in_propagation() -> bool:
    return getattr(_state, "propagating", 0) > 0


def _install_propagation_guard() -> None:
    """Mark the shape propagation of DTensor's sharding propagator (ops
    on global-shape fake tensors), once a process."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = next((n for n in ("_propagate_tensor_meta_non_cached",
                             "_propagate_tensor_meta")
                 if hasattr(ShardingPropagator, n)), None)
    if name is None:
        raise RuntimeError("this torch's ShardingPropagator has no shape "
                           "propagation to tell apart from a rank's work")
    orig = getattr(ShardingPropagator, name)
    if getattr(orig, "_rank_counter_guard", False):
        return

    def guarded(self, *args, **kwargs):
        _state.propagating = getattr(_state, "propagating", 0) + 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            _state.propagating -= 1

    guarded._rank_counter_guard = True
    setattr(ShardingPropagator, name, guarded)


def _group_size(args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in reversed(args):
        if isinstance(a, str):
            return _resolve_process_group(a).size()
    raise ValueError("a collective without a group name")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class RankCounter(TorchDispatchMode):
    """Counts this rank's FLOPs, bytes, live storage and collectives of
    the DTensor program run while it is entered (module docstring)."""

    def __init__(self):
        super().__init__()
        _install_propagation_guard()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: Dict[str, Dict[str, float]] = {}
        self._live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    # -- storage ----------------------------------------------------------

    def _track_tensor(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def track(self, tree: Any) -> None:
        """Count the storage of every tensor in ``tree`` (a DTensor's local
        shard) as live: a step's arguments, alive before it starts."""
        from torch.distributed.tensor import DTensor

        for t in _tensors(tree):
            self._track_tensor(t._local_tensor if isinstance(t, DTensor)
                               else t)

    # -- dispatch ---------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _in_propagation() or not isinstance(func, torch._ops.OpOverload):
            return out
        self._count(func, args, kwargs, out)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track_tensor(t)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        packet = func._overloadpacket
        name = str(packet).split(".")[-1]
        kind = next((c for c in _COLLECTIVES if name.startswith(c)), None)
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if kind is not None:
            n = _group_size(args)
            size = _nbytes(ins[0])
            wire = {"all_gather_into_tensor": (n - 1) * size,
                    "reduce_scatter_tensor": (n - 1) / n * size,
                    "all_reduce": 2 * (n - 1) / n * size,
                    "all_to_all_single": (n - 1) / n * size}[kind]
            c = self.collectives.setdefault(kind, {"count": 0, "bytes": 0.0})
            c["count"] += 1
            c["bytes"] += wire
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        elif torch.Tag.pointwise in func.tags or name in _SOFTMAX:
            self.flops += sum(t.numel() for t in outs)
        elif torch.Tag.reduction in func.tags and ins:
            self.flops += ins[0].numel()
        if not _is_view(func):
            self.bytes += sum(_nbytes(t) for t in ins + outs)

    @property
    def wire_bytes(self) -> float:
        return sum(c["bytes"] for c in self.collectives.values())

    def summary(self) -> Dict[str, Any]:
        return {"flops": self.flops, "bytes": self.bytes,
                "peak_bytes": self.peak_bytes,
                "collective_bytes": self.wire_bytes,
                "collectives": {k: dict(v) for k, v in
                                sorted(self.collectives.items())}}


def _tensors(tree: Any) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


__all__ = ["RankCounter"]
