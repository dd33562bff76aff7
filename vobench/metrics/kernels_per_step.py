"""Kernels the tracker-step replays ran in the traced slice, per step: the
kernels (not copies or fills) that the graph launches made inside the
benchmark's span around the tracker, over the steps."""

SPANS = ("track_scan", "step")


def read(ctx):
    tr = ctx["trace"]
    n = sum(1 for s in SPANS for e in tr.in_span(s, call="cudaGraphLaunch") if tr.is_kernel(e))
    return n / ctx["steps"] if n else None
