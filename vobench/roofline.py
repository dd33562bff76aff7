"""The roofline of a kernel: the least time one H100 could take for the work
these inputs need, over the time the trace saw the kernel take.

Peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet): float32
outside the tensor cores (the kernels use no TF32) and HBM3 bandwidth.
The work counts are those of the project's kernel checks: kernel A (the
fused PICP loop) does ~190 operations per valid point per Gauss-Newton
round (projection and cull ~25, the 2x6 Jacobian ~18, 21 H and 6 g terms
weighted ~135, chi and statistics ~10) and reads each point's index,
pixel, validity and gathered position once; kernel B (the masked top-2
matcher) does 2·D operations per (valid query, valid target) pair and
reads both descriptor sets and masks once.
"""

from __future__ import annotations

PEAK_FLOPS = 67e12    # float32, non-tensor-core, one H100 SXM
PEAK_BYTES = 3.35e12  # HBM3, one H100 SXM
PICP_FLOP_PER_POINT_ROUND = 190


def bound_s(flops: float, nbytes: float) -> tuple:
    """(seconds, "operations" or "bytes"): the least time for the work."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def share_pct(flops: float, nbytes: float, kernel_s: float):
    """The kernel's share of its roofline in %, or None without kernel time."""
    if not kernel_s or kernel_s <= 0:
        return None
    return 100.0 * bound_s(flops, nbytes)[0] / kernel_s


def picp_work(points_x_rounds: float, launches_x_lanes: float, n_obs: int) -> tuple:
    """(flops, bytes) of kernel A: the valid points times the rounds each
    problem ran, summed; and per problem (lane of a launch) its N points'
    gather index (8 bytes), pixel (8), validity (1) and gathered position
    (12), the initial pose (64) and its results (81)."""
    flops = PICP_FLOP_PER_POINT_ROUND * points_x_rounds
    nbytes = launches_x_lanes * (n_obs * (12 + 8 + 1 + 8) + 64 + 81)
    return flops, nbytes


def match_work(pairs: float, launches, desc_dim: int) -> tuple:
    """(flops, bytes) of kernel B: 2·D per valid (query, target) pair, summed
    over the launches; ``launches`` lists (problems, queries, targets) of
    each launch shape, and per problem the query and target descriptors and
    masks are read once and per query the best, index, second and accept
    written."""
    flops = 2.0 * desc_dim * pairs
    nbytes = sum(n * (nq * desc_dim * 4 + nq + nt * desc_dim * 4 + nt + nq * (4 + 8 + 4 + 1))
                 for n, nq, nt in launches)
    return flops, nbytes
