"""Host time of one synchronised ``bootstrap_jit`` call on the cell's own
lanes and RANSAC seed, in ms: the mean of three calls made after the
traced slice (the call ``run_batch`` makes first)."""


def read(ctx):
    s = ctx["host"].get("bootstrap_s")
    return None if s is None else 1e3 * s
