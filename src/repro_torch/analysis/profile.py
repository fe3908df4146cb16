"""The measured side of the analysis: device time by kernel class from
``torch.profiler``, CUDA-event and CUDA-graph timers, and the aten
products' FLOPs — the port's counterpart of ``repro``'s HLO analyzers
(``analysis/hlo.py``, ``hlo_exec.py``), which read XLA HLO text and have
nothing to read here.

The accounting (:func:`account`) is a pure function over ``(name,
start_us, end_us)`` kernel records: the union of their intervals (the
device's busy time), the idle share against the host clock, time by
class (GEMMs, B7, everything else) and the kernels ranked by time.
:func:`device_breakdown` is the thin capture around it.

This module imports torch and the standard library only, so a script
can load it by path beside another checkout's ``repro_torch``.
"""

from __future__ import annotations

import re
import time
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import torch

#: Substrings of cuBLAS / CUTLASS GEMM kernel names.
GEMM_KERNELS = ("gemm", "nvjet", "xmma", "cutlass", "cublas", "gemv")
#: Elementwise work of the Mamba block's eager glue, counted by name in a
#: profile: with the fused scan no softplus runs, and silu once a layer
#: (the conv's; the gate's runs inside B7).
GLUE_WORDS = ("softplus", "silu")
#: Kernels listed by name in the "other" class.
TOP_OTHER = 12

_DEMANGLED_SCAN = re.compile(
    r"selective_scan_kernel<(float|__nv_bfloat16), (\d+), (true|false)>")
_FUNCTOR = re.compile(r"\w+Functor\w*|\w+_kernel\w*")
_WRAPPERS = ("BinaryFunctor", "AUnaryFunctor", "BUnaryFunctor",
             "gpu_kernel_impl", "gpu_kernel_impl_nocast")

Record = Tuple[str, float, float]       # (kernel name, start µs, end µs)


def short_kernel_name(name: str) -> str:
    """A profiled kernel's name, short: B7's mode and instantiation,
    PyTorch's elementwise kernels as "kernel functor", any other name cut
    to 80 characters."""
    m = _DEMANGLED_SCAN.search(name)
    if m:
        mode = "mamba_scan" if m.group(3) == "true" else "selective_scan"
        return (f"B7 {mode}<{'f32' if m.group(1) == 'float' else 'bf16'},"
                f"{m.group(2)}>")
    outer = re.match(r"(?:void )?(?:\w+::)*(\w+)<", name)
    if outer is None or "at::native" not in name:
        return name[:80]
    inner = [f for f in _FUNCTOR.findall(name, outer.end())
             if f not in _WRAPPERS]
    return f"{outer.group(1)} {inner[0] if inner else '?'}"


def kernel_class(name: str) -> str:
    """"B7", "gemm" or "other" for a device kernel's name."""
    low = name.lower()
    if "selective_scan" in low:
        return "B7"
    return "gemm" if any(k in low for k in GEMM_KERNELS) else "other"


def busy_us(spans: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals: the time at
    least one kernel ran (overlapping kernels count once)."""
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    return busy


def _ranked(table: Dict[str, Tuple[float, int]], k: int) -> List[dict]:
    return [{"ms": t, "count": c, "kernel": n} for t, c, n in
            sorted(((ms, c, n) for n, (ms, c) in table.items()),
                   reverse=True)[:k]]


def account(records: Sequence[Record], wall_ms: float) -> dict:
    """Device time of ``records`` beside a host-clock ``wall_ms``:
    ``device_busy_ms`` (the union of the intervals), ``idle_share`` = 1 −
    busy / wall (None with no device time), ``by_class_ms``, launches
    whose name holds a ``GLUE_WORDS`` word, the ``top`` 6 kernels by
    time and the "other" class's top ``TOP_OTHER``, each with its
    launch count."""
    classes = {"gemm": 0.0, "B7": 0.0, "other": 0.0}
    glue = dict.fromkeys(GLUE_WORDS, 0)
    by_name: Dict[str, Tuple[float, int]] = {}
    other: Dict[str, Tuple[float, int]] = {}
    for name, t0, t1 in records:
        ms = (t1 - t0) / 1e3
        kind = kernel_class(name)
        classes[kind] += ms
        low = name.lower()
        for word in GLUE_WORDS:
            glue[word] += word in low
        short = short_kernel_name(name)
        for table in (by_name, other) if kind == "other" else (by_name,):
            t, count = table.get(short, (0.0, 0))
            table[short] = (t + ms, count + 1)
    busy = busy_us((t0, t1) for _, t0, t1 in records) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall_ms if busy else None,
            "by_class_ms": classes, "glue_launches": glue,
            "top": _ranked(by_name, 6),
            "other_by_kernel": _ranked(other, TOP_OTHER)}


def _need_card() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("device timing needs a CUDA device "
                           "(torch.cuda.is_available() is false)")


def device_breakdown(fn: Callable[[], object]) -> dict:
    """One warm call of ``fn`` under torch.profiler, accounted by
    :func:`account` against the call's host-clock time (synchronized).
    ``device_busy_ms`` is 0 if the profiler recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _need_card()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    records = [(e.name, e.time_range.start, e.time_range.end)
               for e in prof.events() if e.device_type == DeviceType.CUDA]
    return account(records, wall_ms)


def cuda_ms(fn: Callable[[], object], reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after one
    warm-up run (the host work between the events included)."""
    _need_card()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    times.sort()
    return times[len(times) // 2]


def graph_ms(fn: Callable[[], object], calls: int = 10, reps: int = 5) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in one
    CUDA graph, the graph replayed ``reps`` times between two events each;
    the median over the replays, per call.  Unlike ``cuda_ms`` no host
    work (a wrapper's checks and allocations) sits between launches,
    which matters for a kernel shorter than its wrapper's host time."""
    _need_card()
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / calls)
    del graph
    times.sort()
    return times[len(times) // 2]


def flop_count(fn: Callable[..., object], *args, **kwargs) -> int:
    """FLOPs of the aten operations ``fn(*args, **kwargs)`` runs, as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them (matrix
    products and convolutions, 2 a multiply-add): the counterpart of the
    HLO analyzer's dot FLOPs for programs made of aten ops, such as the
    model's GEMMs.  The hand-written kernels (B1-B7, launched through
    ctypes) are invisible to it, and so is elementwise work; their work
    comes from the work models (``analysis.flops``,
    ``kernels.tuning.pair_bound``)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return int(counter.get_total_flops())


__all__ = ["GEMM_KERNELS", "GLUE_WORDS", "TOP_OTHER", "Record",
           "short_kernel_name", "kernel_class", "busy_us", "account",
           "device_breakdown", "cuda_ms", "graph_ms", "flop_count"]
