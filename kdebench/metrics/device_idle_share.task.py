"""device_idle_share.task: the share of the window in which no operation
ran on the card (1 − the union of device intervals over the window), in
percent."""

from kdebench import readers


def read(ctx):
    return readers.idle_pct(ctx)
