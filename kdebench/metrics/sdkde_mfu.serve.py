"""sdkde_mfu.serve: the least time of the KDE pass over every answered
row of the window over the window, in percent of the card's peaks."""

from kdebench import readers, roofline


def read(ctx):
    return roofline.share_pct(readers.serve_kde_work(ctx), ctx.window_s)
