"""Edge-sharded distributed pose-graph optimization (twin of
``tpuvo/parallel/posegraph_sharded.py``).

The edges are partitioned over the ranks of a mesh axis; each rank
linearizes its own edge block into the full (F, F) block system, and ONE
``all_reduce`` per iteration combines [H | b | n_inliers] — the same
single fused collective as the sharded Schur BA — plus one scalar
``all_reduce`` of the trial chi for the LM acceptance test.  Poses are
replicated (F is the small axis): every rank solves the same damped system
and applies the same update, so nothing is broadcast afterwards.
"""

from __future__ import annotations

import torch

from tpuvo_torch.ba.posegraph import PoseGraph, pgo_solve
from tpuvo_torch.parallel.mesh import all_reduce_sum_, axis_info


def shard_edges(graph: PoseGraph, n_shards: int) -> PoseGraph:
    """Pad the edge set to a multiple of n_shards (weight-0 identity edges
    between pose 0 and itself are inert)."""
    E = graph.edges_ij.shape[0]
    pad = -(-E // n_shards) * n_shards - E
    if pad == 0:
        return graph
    dev = graph.edges_T.device
    eij = torch.cat([graph.edges_ij,
                     torch.zeros((pad, 2), dtype=graph.edges_ij.dtype, device=dev)], 0)
    eT = torch.cat([graph.edges_T, torch.eye(4, dtype=graph.edges_T.dtype, device=dev)
                    .expand(pad, 4, 4)], 0)
    ew = torch.cat([graph.edges_w, torch.zeros(pad, dtype=graph.edges_w.dtype, device=dev)], 0)
    return graph._replace(edges_ij=eij, edges_T=eT, edges_w=ew)


def sharded_pgo_solve(mesh, graph: PoseGraph, iterations: int = 20,
                      kernel_threshold: float = 1.0, damping: float = 1e-6,
                      damping_init: float = 1e-3, axis: str = "edge"):
    """Distributed adaptive-LM PGO: ``ba/posegraph.pgo_solve`` on this rank's
    edge block, with one fused all_reduce per iteration (plus one scalar
    all_reduce for the trust-region test) as its ``reduce`` hook.  Every
    rank passes the whole graph and reads its own edge block; every rank
    returns the same (optimized PoseGraph, PGOStats), with no host sync."""
    group, n, rank = axis_info(mesh, axis)
    graph = shard_edges(graph, n)
    Es = graph.edges_ij.shape[0] // n
    sl = slice(rank * Es, (rank + 1) * Es)
    local = graph._replace(edges_ij=graph.edges_ij[sl], edges_T=graph.edges_T[sl],
                           edges_w=graph.edges_w[sl])
    out, stats = pgo_solve(local, iterations, kernel_threshold, damping, damping_init,
                           reduce=lambda buf: all_reduce_sum_(buf, group))
    return graph._replace(poses=out.poses), stats
