"""Median host latency of the window's poses whose step ran the local BA
(``slam.local_ba_due`` true for the step's frame), in ms: the same
per-pose samples as the latency tail."""

import statistics


def read(ctx):
    w = ctx["window"]
    lat = [t for t, due in zip(w.get("latencies", []), w.get("due", [])) if due]
    return 1e3 * statistics.median(lat) if lat else None
