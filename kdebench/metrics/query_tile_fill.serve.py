"""query_tile_fill.serve: the share of the row-tile rows that served B4
launches stream which are real queries, not the sentinel rows that pad
each cluster's queries to whole tiles: 100 × Σ ``real_tile_rows`` over
Σ ``tile_rows`` of the program's ``kernels.pruned_eval`` spans (each
row tile counted once for every column tile it visits).  Nothing to read
where the spans do not carry the counts."""


def read(ctx):
    spans = [s[3] for s in ctx.spans_named("kernels.pruned_eval")
             if "tile_rows" in s[3] and "real_tile_rows" in s[3]]
    rows = sum(a["tile_rows"] for a in spans)
    return 100.0 * sum(a["real_tile_rows"] for a in spans) / rows \
        if rows else None
