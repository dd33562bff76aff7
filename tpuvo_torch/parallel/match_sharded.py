"""Landmark-sharded descriptor matching (twin of
``tpuvo/parallel/match_sharded.py``).

The map axis is split over the ranks of a mesh axis: rank r scans rows
[r·M/S, (r+1)·M/S) of the map for each query's local (best, idx, second);
ONE ``all_gather`` of the per-row triples (not the distance matrix) then
reduces to the exact global top-2.  Communication is O(N · ranks),
independent of the map size.

The merge: the global best is the min over the shard bests (the first
shard wins ties, which keeps the first-index rule, since the shards
partition the map in order); the runner-up is min(winner's second, every
other shard's best).  A shard with no valid row reports best = second =
+inf (kernel B and the plain top-2 alike; the JAX kernel's ~1.7e38), which
never beats a finite best and is never a finite runner-up.
"""

from __future__ import annotations

import torch

from tpuvo_torch.ops.match import (MatchResult, accept_matches, descriptor_distances,
                                   top2_min)
from tpuvo_torch.parallel.mesh import all_gather_stack, axis_info


def _local_top2(desc1, valid1, desc2_shard, valid2_shard, method):
    """(best, idx, second) of every query against one map shard."""
    if method == "pallas":
        # kernel B on the shard (CUDA tensors), its plain version on the CPU;
        # the kernel's acceptance column is dropped: the merged top-2 decides
        from tpuvo_torch.ops.cuda.match_kernel import match_descriptors_cuda

        r = match_descriptors_cuda(desc1, valid1, desc2_shard, valid2_shard)
        return r.best, r.idx, r.second
    dist = descriptor_distances(desc1, desc2_shard, method)
    return top2_min(dist, valid2_shard)


def sharded_match_descriptors(
    mesh,
    desc1,
    valid1,
    desc2,
    valid2,
    distance_threshold: float = 0.2,
    ratio_threshold: float = 0.8,
    method: str = "direct",
    axis: str = "lm",
) -> MatchResult:
    """Exact equivalent of ``ops.match.match_descriptors`` with the map axis
    sharded over the mesh axis ``axis``.  Every rank passes the same
    desc1/valid1 and the whole desc2/valid2, reads only its own block of
    rows and gets the whole result; M must be divisible by the axis size."""
    group, n_shard, rank = axis_info(mesh, axis)
    M = desc2.shape[0]
    shard_size = M // n_shard
    if shard_size * n_shard != M:
        raise ValueError(f"the map's {M} rows must divide over the {n_shard} ranks of {axis!r}")
    # indices ride the fused f32 all_gather buffer — exact below 2^24
    if M >= 2**24:
        raise ValueError(f"a map of {M} rows: the fused gather carries indices in f32 (< 2^24)")
    lo = rank * shard_size
    best, idx, second = _local_top2(desc1, valid1, desc2[lo:lo + shard_size],
                                    valid2[lo:lo + shard_size], method)
    # ONE fused all_gather of the per-row triples (collectives are
    # latency-bound: one (3, N) message beats three (N,) messages)
    triple = torch.stack([best, (idx + lo).to(torch.float32), second])
    gathered = all_gather_stack(triple, group, n_shard)   # (S, 3, N)
    bests, idxs, seconds = gathered[:, 0], gathered[:, 1].long(), gathered[:, 2]
    win = torch.argmin(bests, dim=0)                      # first shard wins ties
    rows = torch.arange(best.shape[0], device=best.device)
    g_best = bests[win, rows]
    g_idx = idxs[win, rows]
    # runner-up = min over (winner's second, the other shards' bests)
    others = torch.where(torch.arange(n_shard, device=best.device)[:, None] == win[None, :],
                         torch.inf, bests)
    g_second = torch.minimum(seconds[win, rows], others.min(dim=0).values)
    accept = accept_matches(g_best, g_second, valid1, distance_threshold, ratio_threshold)
    return MatchResult(idx=g_idx, valid=accept, best=g_best, second=g_second)
