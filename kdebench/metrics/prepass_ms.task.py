"""prepass_ms.task: ms a task spends in the program's ``kernels.prepass``
spans, the host and device preparation before each pruned launch (the
score pass's k-means index, layout, tile bounds and visit lists; the
columns' index and layout; the queries' assignment, layout, bounds and
visit lists), summed over the window and divided by the tasks.  Nothing
to read where no pass prunes, or where the program opens no such span."""

from kdebench import readers


def read(ctx):
    spans = ctx.spans_named("kernels.prepass")
    n = readers.tasks(ctx)
    return sum(readers.span_ms(spans)) / n if spans and n else None
