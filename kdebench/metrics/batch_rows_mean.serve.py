"""batch_rows_mean.serve: mean query rows of a coalesced dispatch, the
``rows`` of the program's ``frontend.batch`` spans in the window."""

from kdebench import readers


def read(ctx):
    return readers.mean([s[3]["rows"] for s in
                         ctx.spans_named("frontend.batch")])
