"""Device work a refine enqueues, per refine: the runtime calls that enqueue
device work (kernel launches, copies, fills) made inside the program's
``tpuvo.refine`` spans in the traced slice, counted as
``eager_launches_per_step`` counts them, over the number of those spans.
None where the program records no such span or the trace saw no device
activity."""

from vobench.program_spans import eager_launches, spans


def read(ctx):
    tr = ctx["trace"]
    within = spans(tr, "refine")
    if not within or not tr.device:
        return None
    return eager_launches(tr, within) / len(within)
