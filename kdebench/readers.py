"""Arithmetic the per-layer readers (``metrics/<metric>.py``) share.

Kernels are told apart by the program's kernel names: the score pass is
``flash::score_pass_kernel`` (B1 dense, B3 over visit lists) and its
split-combining ``score_combine_kernel``; the KDE pass is
``flash::kde_pass_kernel`` (B2, B4) and its ``combine_kernel``.
Work is counted by ``roofline.py`` from the sizes, with the share of
pairs an exact float32 method needs as the check's reference counted it
on this run's inputs (``ctx.work``).
"""

from __future__ import annotations

from typing import List, Optional

from kdebench import roofline


def is_score_pass(name: str) -> bool:
    return "score_pass_kernel" in name or "score_combine_kernel" in name


def is_kde_pass(name: str) -> bool:
    return "kde_pass_kernel" in name or (
        "combine_kernel" in name and "score_combine_kernel" not in name)


def dims(ctx):
    """``(n, m, d)``: training points, queries a task, dimension."""
    c = ctx.config
    return (int(c["n_train"]), int(c.get("n_queries", 0)),
            int(c["mixture"]["dim"]))


def tasks(ctx) -> int:
    return len(ctx.records)


def score_work(ctx) -> roofline.Work:
    """The score passes of the window's tasks."""
    n, _, d = dims(ctx)
    one = roofline.score_pass(n, d, ctx.work["score_needed"] * n * n)
    return one.scaled(tasks(ctx))


def task_kde_work(ctx) -> roofline.Work:
    """The KDE passes of the window's tasks."""
    n, m, d = dims(ctx)
    one = roofline.kde_pass(m, n, d, ctx.work["kde_needed"] * m * n)
    return one.scaled(tasks(ctx))


def task_work(ctx) -> roofline.Work:
    """The window's whole tasks."""
    n, m, d = dims(ctx)
    one = roofline.sdkde_task(n, m, d, ctx.work["score_needed"] * n * n,
                              ctx.work["kde_needed"] * m * n)
    return one.scaled(tasks(ctx))


def served_rows(ctx) -> int:
    return sum(r["rows"] for r in ctx.records if r["ok"])


def serve_kde_work(ctx) -> roofline.Work:
    """The KDE pass over every answered row of the window."""
    n, _, d = dims(ctx)
    rows = served_rows(ctx)
    return roofline.kde_pass(rows, n, d, ctx.work["kde_needed"] * rows * n)


def kernel_share(ctx, work: roofline.Work, match) -> Optional[float]:
    """``work``'s least time over the summed time of the kernels
    ``match`` accepts, in percent; None without such kernels."""
    return roofline.share_pct(work, ctx.kernel_seconds(match))


def mean(values: List[float]) -> Optional[float]:
    return sum(values) / len(values) if values else None


def span_ms(spans) -> List[float]:
    return [1e3 * (s[2] - s[1]) for s in spans]


def idle_pct(ctx) -> Optional[float]:
    if not ctx.window_s > 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)


__all__ = ["is_score_pass", "is_kde_pass", "dims", "tasks", "score_work",
           "task_kde_work", "task_work", "served_rows", "serve_kde_work",
           "kernel_share", "mean", "span_ms", "idle_pct"]
