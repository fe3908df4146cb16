"""host_syncs.task: the times a task waits for the card, from the
program's ``sync.<site>`` spans: one around each call on the task's path
that blocks on a device-to-host or host-to-device transfer, carrying
``syncs`` where the call waits more than once (k-means' bincounts, the
visit lists' compaction).  Their sum over the window divided by the
tasks.  Nothing to read where the program opens no such span."""

from kdebench import readers


def read(ctx):
    spans = [s for s in ctx.spans if s[0].startswith("sync.")]
    n = readers.tasks(ctx)
    if not spans or not n:
        return None
    return sum(s[3].get("syncs", 1) for s in spans) / n
