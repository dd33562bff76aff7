"""How many LM iterations of the refine build their reduced camera system
from the nonzero (landmark, frame) blocks, per refine: the program's
``tpuvo.ba.schur.sparse`` spans that start inside its ``tpuvo.refine``
spans in the traced slice, over the number of those refine spans (0 where
every reduction is the dense product).  None where the program records no
refine span."""

import bisect

from vobench.program_spans import spans


def read(ctx):
    tr = ctx["trace"]
    refines = spans(tr, "refine")
    if not refines:
        return None
    starts = [s.start for s in refines]

    def inside(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= refines[i].end

    return sum(inside(e.start) for e in spans(tr, "ba.schur.sparse")) / len(refines)
