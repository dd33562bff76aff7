"""The bootstrap's host draw of its RANSAC uniforms, in ms per bootstrap:
the summed duration of the program's ``tpuvo.bootstrap.draw`` spans in the
traced slice over the number of its ``tpuvo.bootstrap`` spans.  None where
the program records no such span."""

from vobench.program_spans import spans


def read(ctx):
    tr = ctx["trace"]
    boots, draws = spans(tr, "bootstrap"), spans(tr, "bootstrap.draw")
    if not boots or not draws:
        return None
    return sum(d.end - d.start for d in draws) * 1e-6 / len(boots)
