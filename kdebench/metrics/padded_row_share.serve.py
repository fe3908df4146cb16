"""padded_row_share.serve: bucket rows beyond the rows asked for, over
the bucket rows, in percent, from the program's ``serve.bucket`` spans
(``bucket`` and ``rows``) in the window."""


def read(ctx):
    spans = [s[3] for s in ctx.spans if s[0] == "serve.bucket"]
    bucket = sum(a["bucket"] for a in spans)
    return 100.0 * sum(a["bucket"] - a["rows"] for a in spans) / bucket \
        if bucket else None
