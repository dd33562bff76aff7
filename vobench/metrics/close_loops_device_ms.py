"""Device time of the refine's loop closure, in ms per refine: the union
of the device activity that started while the host was inside the
program's ``tpuvo.refine.close_loops`` spans in the traced slice (its
co-visibility, relocalisation and both PGO passes: eager launches, so
taken by time), over the number of those spans.  None where the program
records no such span or the trace saw none of its work."""

from vobench.program_spans import ms_per, spans, started_in


def read(ctx):
    tr = ctx["trace"]
    within = spans(tr, "refine.close_loops")
    return ms_per(started_in(tr, within), len(within))
