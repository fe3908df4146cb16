"""kde_pass_roofline.task: the tasks' KDE passes' least time over the
summed device time of the KDE-pass kernels (B2 / B4 and their combine),
in percent."""

from kdebench import readers


def read(ctx):
    return readers.kernel_share(ctx, readers.task_kde_work(ctx),
                                readers.is_kde_pass)
