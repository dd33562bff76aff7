"""Kernel A's share of its roofline in the traced slice, in %: the least
time one H100 needs for the work (``vobench.roofline.picp_work``: the
valid points times the Gauss-Newton rounds each solve ran, as the traced
call's frame logs report them) over the device time the trace gave
``picp_solve_kernel``.  Reads a batched call's logs; None elsewhere."""

from vobench import roofline


def read(ctx):
    logs = ctx.get("logs")
    if logs is None:
        return None
    B, F1 = logs.iterations.shape[:2]
    flops, nbytes = roofline.picp_work(
        float((logs.n_map_matches.double() * logs.iterations.double()).sum()), float(B * F1),
        ctx["cfg"].max_obs)
    return roofline.share_pct(flops, nbytes, ctx["trace"].kernel_s("picp_solve_kernel"))
