"""kde_pass_roofline.serve: the least time of the KDE pass over every
answered row of the window (padding rows are not work) over the summed
device time of the KDE-pass kernels, in percent."""

from kdebench import readers


def read(ctx):
    return readers.kernel_share(ctx, readers.serve_kde_work(ctx),
                                readers.is_kde_pass)
