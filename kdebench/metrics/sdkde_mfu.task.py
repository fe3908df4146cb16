"""sdkde_mfu.task: the least time of the window's whole tasks (score pass,
KDE pass, inputs read once, densities written once; roofline.sdkde_task)
over the window, in percent of the card's peaks."""

from kdebench import readers, roofline


def read(ctx):
    return roofline.share_pct(readers.task_work(ctx), ctx.window_s)
