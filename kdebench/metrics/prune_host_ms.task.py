"""prune_host_ms.task: ms a task spends before its pruned launches, the
prepass: from the start of ``task.fit`` to the program's first
``kernels.pruned_score`` span inside it (bandwidth, k-means index,
layout, bounds and visit lists), plus from the start of ``task.evaluate``
to its first ``kernels.pruned_eval`` span (the columns' index and
layout, the queries' assignment, bounds and visit lists); mean over the
tasks.  Nothing to read where no pass prunes."""

from kdebench import readers


def _lead(outer, inner):
    """Seconds from each outer span's start to the first inner span that
    starts inside it; outer spans holding none are left out."""
    out = []
    for o in outer:
        starts = [s[1] for s in inner if o[1] <= s[1] < o[2]]
        if starts:
            out.append(min(starts) - o[1])
    return out


def read(ctx):
    fit = _lead(ctx.spans_named("task.fit"),
                ctx.spans_named("kernels.pruned_score"))
    ev = _lead(ctx.spans_named("task.evaluate"),
               ctx.spans_named("kernels.pruned_eval"))
    if not fit or len(fit) != len(ev):
        return None
    return 1e3 * (sum(fit) + sum(ev)) / len(fit)
