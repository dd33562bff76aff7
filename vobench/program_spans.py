"""The program's own spans in a traced slice, and the device work launched
inside them.

``tpuvo_torch`` marks its host stages as profiler events named
``tpuvo.<name>`` (``tpuvo_torch/utils/profiling.span``): a bootstrap and
its host draw, a scan, a session's step, each graph replay by graph and
branch, each capture.  They are in ``Trace.host`` beside the benchmark's
``vobench.*`` spans.  Spans of one name follow one another on the
program's one thread, never overlapping.  A program without these spans
reads as none found: the readers then give None.

What a graph launch ran is found by correlation id (``Trace.launches``).
An eager launch is not: the trace keys its device activity by the aten op
that made it (the profiler's linked id), which no runtime call carries.
So eager launches are counted on the host, as the runtime calls that
enqueue device work, and their device activity is taken by time, as what
started on the device while the host was inside the span.
"""

from __future__ import annotations

import bisect

from vobench.trace import union_ns

PREFIX = "tpuvo."
ENQUEUE = ("LaunchKernel", "Memcpy", "Memset")  # in the names of runtime calls that enqueue work


def spans(tr, *names):
    """The program's spans named ``tpuvo.<name>`` for any of ``names``, in
    order of start."""
    want = {PREFIX + n for n in names}
    return sorted((e for e in tr.host if e.name in want), key=lambda e: e.start)


def _inside(within, starts, t) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= within[i].end


def graph_work(tr, within):
    """The device activity that the graph launches (``cudaGraphLaunch``)
    made inside the spans ``within`` (disjoint, in order of start) ran."""
    starts = [s.start for s in within]
    out = []
    for e in tr.device:
        hit = tr.launches.get(e.corr)
        if hit is not None and "cudaGraphLaunch" in hit[1] and _inside(within, starts, hit[0]):
            out.append(e)
    return out


def started_in(tr, within):
    """The device activity that started while the host was inside one of
    the spans ``within``."""
    starts = [s.start for s in within]
    return [e for e in tr.device if _inside(within, starts, e.start)]


def eager_launches(tr, within) -> int:
    """The runtime calls made inside the spans ``within`` that enqueue
    device work besides a graph launch: kernel launches, copies, fills."""
    starts = [s.start for s in within]
    return sum(1 for t, name in tr.launches.values()
               if any(k in name for k in ENQUEUE) and _inside(within, starts, t))


def ms_per(events, n):
    """The union of the events' intervals, in ms per one of n; None where
    there is none."""
    if not n or not events:
        return None
    return union_ns([(e.start, e.end) for e in events]) * 1e-6 / n


def replay_device_ms(tr, graph: str):
    """Device time of the replays of ``graph`` (``<name>[.<branch>]``): the
    union of what their graph launches ran, in ms per replay."""
    within = spans(tr, "replay." + graph)
    return ms_per(graph_work(tr, within), len(within))
