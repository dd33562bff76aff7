"""The device's idle share of the traced slice, in %: 1 - (the union of
the device activity intervals the profiler saw in the slice) / (the host
time of the same units run just before, untraced and synchronised).

The profiler's own cost lands on the host (a graph launch under CUPTI
takes milliseconds), so the traced slice's span is longer than the work
takes untraced; dividing by it would measure the profiler.  The device's
busy time is what the trace alone can give.  None when the trace saw no
device activity."""


def read(ctx):
    tr = ctx["trace"]
    if not tr.device or not ctx.get("plain_s"):
        return None
    return 100.0 * (1.0 - tr.busy_s / ctx["plain_s"])
