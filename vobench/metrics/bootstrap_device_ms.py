"""Device time of a bootstrap, in ms: the union of the device work of the
program's ``tpuvo.bootstrap`` spans in the traced slice, over the number
of those spans.  Its work is what the span's graph launch ran (the
replay), and what started on the device while the host was in the span
(the frames' and the RANSAC uniforms' copies in); the device is idle when
a bootstrap starts, since the benchmark waits for the work before it.
None where the program records no such span or the trace saw none of its
work."""

from vobench.program_spans import graph_work, ms_per, spans, started_in


def read(ctx):
    tr = ctx["trace"]
    boots = spans(tr, "bootstrap")
    return ms_per(graph_work(tr, boots) + started_in(tr, boots), len(boots))
