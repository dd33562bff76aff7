"""Device time of the local BA's fixed-order segment sums, in ms per replay
of the SLAM step's graph with the local BA: the summed device time of the
kernels that the ``tpuvo.replay.slam_step.ba`` replays' graph launches ran
in the traced slice and whose name holds ``segment_reduce_forward``
(``torch.segment_reduce``'s kernel) or ``segsum_kernel`` (the port's kernel
D), over the number of those replays.  Kernel D gathers its entries
through the plan's order itself; ``torch.segment_reduce`` is fed by a
gather (``values[order]``, an indexing kernel) that this leaves out, so
where it runs the reading is the sums without their gather.  None where
there is no such replay or no such kernel."""

from vobench.program_spans import graph_work, spans

KERNELS = ("segment_reduce_forward", "segsum_kernel")


def read(ctx):
    tr = ctx["trace"]
    within = spans(tr, "replay.slam_step.ba")
    hits = [e for e in graph_work(tr, within) if any(k in e.name for k in KERNELS)]
    if not hits:
        return None
    return sum(e.end - e.start for e in hits) * 1e-6 / len(within)
