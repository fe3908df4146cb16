"""prepass_ms.serve: ms of the program's ``kernels.prepass`` spans a served
bucket (the queries' assignment to the train clusters, their layout, the
tile bounds and the visit lists before a B4 launch): their summed
duration over the window divided by the ``kernels.pruned_eval`` spans.
Nothing to read where no bucket prunes, or where the program opens no
such span."""

from kdebench import readers


def read(ctx):
    spans = ctx.spans_named("kernels.prepass")
    launches = len(ctx.spans_named("kernels.pruned_eval"))
    return sum(readers.span_ms(spans)) / launches \
        if spans and launches else None
