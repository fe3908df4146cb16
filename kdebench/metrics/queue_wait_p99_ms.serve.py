"""queue_wait_p99_ms.serve: the 99th percentile of admit-to-dispatch
time in the admission queue, as ``AsyncFrontend.report()`` gives it
after the window (its histogram zeroed at the window's start)."""


def read(ctx):
    wait = ctx.counters.get("frontend", {}).get("queue_wait_ms", {})
    return wait["p99"] if wait.get("count") else None
