"""wrapper_host_ms.task: ms a task spends in the kernel wrappers
(``kernels/ops.py``: padding, casts, norms, tile choice, launches, the
shift and the normalisation) outside the prepass and the waits for the
card: the length of the union of the program's ``kernels.shift``,
``kernels.score_stats`` and ``kernels.eval`` spans, less the part of it
that ``kernels.prepass`` and ``sync.*`` spans cover, over the window,
divided by the tasks.  The spans nest on the task's one thread, so
interval containment is their nesting.  Nothing to read where the
program opens no wrapper span."""

from kdebench import readers

WRAPPERS = ("kernels.shift", "kernels.score_stats", "kernels.eval")


def merged(intervals):
    """Disjoint, ascending ``(start, end)`` covering the same union."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(iv) for iv in out]


def overlap(xs, ys):
    """Length of the intersection of two disjoint ascending lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(ctx):
    wrap = merged((s[1], s[2]) for s in ctx.spans if s[0] in WRAPPERS)
    n = readers.tasks(ctx)
    if not wrap or not n:
        return None
    inner = merged((s[1], s[2]) for s in ctx.spans
                   if s[0] == "kernels.prepass" or s[0].startswith("sync."))
    own = sum(b - a for a, b in wrap) - overlap(wrap, inner)
    return 1e3 * own / n
