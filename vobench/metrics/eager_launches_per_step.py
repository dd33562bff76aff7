"""Device work a session's step launches outside its graph, per step: the
runtime calls that enqueue device work (kernel launches, copies, fills; a
graph launch is not one) made inside the program's ``tpuvo.vo.step`` and
``tpuvo.slam.step`` spans in the traced slice, each its own correlation id
and device activity (the frame's copy into the graph's buffers, the
pose's copy out, a session's state moved in and out of the buffers), over
the number of those spans.  None where the program records no step span
or the trace saw no device activity."""

from vobench.program_spans import eager_launches, spans


def read(ctx):
    tr = ctx["trace"]
    steps = spans(tr, "vo.step", "slam.step")
    if not steps or not tr.device:
        return None
    return eager_launches(tr, steps) / len(steps)
