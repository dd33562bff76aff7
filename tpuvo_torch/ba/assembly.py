"""Fixed-order sums of per-entry blocks into their targets: the BA's and the
pose graph's assembly (the JAX twins' ``segment_sum`` / ``.at[].add``).

``index_add_`` on the card sums with atomics, in an order that changes from
run to run: two runs of one solve differ in the last bits, and an LM accept
test near a tie grows that into another step.  Here the targets are sorted
once per topology (``plan``: a stable argsort, so each target's entries
keep their order) and every sum of an LM solve walks them in that order,
from +0.0, one rounded addition at a time: on the card kernel D
(``ops/cuda/segsum``, one launch, which leaves out the all-zero entries
that cannot change such a sum), on the CPU ``torch.segment_reduce`` (one
sequential loop per target and column) — the same bits.  Both are
capture-safe (no host read: the segment bounds come from ``searchsorted``
on the device), and the result is the same on every run, in a graph or
not.  On the CPU the order is ``index_add_``'s own (entry order within a
target, from zero), so the sums are bit-equal to it there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuvo_torch.ops.cuda import segsum


class SumPlan(NamedTuple):
    """A topology's summation order: the entries sorted by target (stable);
    target t's entries are ``order[bounds[t]:bounds[t + 1]]``."""

    order: torch.Tensor   # (n,) int64
    bounds: torch.Tensor  # (n_targets + 1,) int64


def plan(targets, n_targets: int, order=None) -> SumPlan:
    """The plan of (n,) integer ``targets`` in [0, n_targets).  ``order``:
    an argsort already known to sort ``targets`` stably (a finer key of the
    same entries), reused instead of a second sort."""
    targets = targets.reshape(-1).long()
    if order is None:
        order = torch.argsort(targets, stable=True)
    bounds = torch.searchsorted(targets[order], torch.arange(
        n_targets + 1, dtype=torch.int64, device=targets.device))
    return SumPlan(order, bounds)


def segment_sum(values, p: SumPlan):
    """(n_targets, ...) sums of the (n, ...) ``values`` into their targets,
    each in the plan's order (an empty target sums to 0)."""
    return segsum.segment_sum(values, p.order, p.bounds)
