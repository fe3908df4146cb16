"""fit_ms.task: mean ms of ``SDKDE.fit`` a task, between two CUDA events
recorded on the task's stream just before the fit is called and just
after it returns (no synchronize added: the device's time from the end
of the draw to the end of the fit's last kernel, host gaps included)."""

from kdebench import readers


def read(ctx):
    return readers.mean([r["fit_ms"] for r in ctx.records if "fit_ms" in r])
