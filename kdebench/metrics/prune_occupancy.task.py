"""prune_occupancy.task: column tiles the pruned launches visited over the
tiles dense launches would stream, score and KDE passes together, in
percent, from the program's ``flash_pruned.score_counts`` /
``kde_counts`` over the window.  Nothing to read without pruned
launches."""


def read(ctx):
    visited = sum(ctx.counters[k]["visited"] for k in ("score", "kde"))
    total = sum(ctx.counters[k]["total"] for k in ("score", "kde"))
    return 100.0 * visited / total if total else None
