"""Device time of a global bundle-adjustment sweep of the refine, in ms per
sweep: the union of the device activity that started while the host was
inside the program's ``tpuvo.refine.sweep.coarse`` and
``tpuvo.refine.sweep.fine`` spans in the traced slice (each span closes
after the host has read the sweep's chi, so the sweep's work starts
inside it), over the number of those spans.  None where the program
records no such span or the trace saw none of its work."""

from vobench.program_spans import ms_per, spans, started_in


def read(ctx):
    tr = ctx["trace"]
    within = spans(tr, "refine.sweep.coarse", "refine.sweep.fine")
    return ms_per(started_in(tr, within), len(within))
