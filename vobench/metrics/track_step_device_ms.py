"""Device time of the tracker-step replays in the traced slice, per step,
in ms: the union of the intervals of the device activity that the graph
launches made inside the benchmark's span around the tracker (the scan of
a batched call, or each step of a session), over the steps."""

from vobench.trace import union_ns

SPANS = ("track_scan", "step")


def read(ctx):
    tr = ctx["trace"]
    ev = [e for s in SPANS for e in tr.in_span(s, call="cudaGraphLaunch")]
    if not ev:
        return None
    return union_ns([(e.start, e.end) for e in ev]) * 1e-6 / ctx["steps"]
