"""score_pass_roofline.task: the score passes' least time (roofline.py,
the pairs an exact float32 method needs) over the summed device time of
the score-pass kernels (B1 / B3 and their combine), in percent."""

from kdebench import readers


def read(ctx):
    return readers.kernel_share(ctx, readers.score_work(ctx),
                                readers.is_score_pass)
