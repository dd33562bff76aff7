"""Loop-closure detection + relocalization + pose-graph drift repair (twin
of ``tpuvo/ba/loop.py``).

On an open trajectory the constraint graph is a chain and monocular drift
is gauge-like: neither windowed nor global BA can repair it.  Loop edges
make it observable:
  1. co-visibility: (F, F) counts of co-observed map landmarks, from an
     (F, L) membership matrix and one matmul M·Mᵀ (tiled over landmark-id
     blocks for large maps);
  2. loop candidates: the top-K pairs (i, j) with j - i >= min_gap and
     >= min_shared co-observed landmarks;
  3. relocalize the LATE frame of each pair against the map positions of
     the shared landmarks (triangulated at the early visit) with RANSAC
     DLT PnP + PICP polish (``ops/pnp.py``), batched over the pairs;
  4. loop edges Z_ij = T_i^-1 · T_j^pnp plus odometry edges into
     ``pgo_solve``: an L2 pass, then a robust pass.

Each stage runs under a span (``utils/profiling.span``): ``tpuvo.loop.covis``
(1-2), ``tpuvo.loop.reloc`` (3), ``tpuvo.loop.pgo.l2`` and
``tpuvo.loop.pgo.robust`` (4).
"""

from __future__ import annotations

import torch

from tpuvo_torch.ba.posegraph import PoseGraph, odometry_edges, pgo_solve
from tpuvo_torch.ops import lie
from tpuvo_torch.ops.pnp import pnp_ransac, ransac_uniforms, topk_stable
from tpuvo_torch.utils.profiling import span


def _membership(cols, valid, n: int):
    """(F, n) float 0/1 membership: M[f, c] = 1 iff a valid observation of
    frame f has id c.  The JAX twin scatters with ``.max(mode="drop")``,
    which torch lacks: ids outside [0, n) and invalid observations go to a
    dump column n that is cut off.  Only 1.0 is ever written, so duplicate
    ids need no reduction."""
    F = cols.shape[0]
    hit = valid & (cols >= 0) & (cols < n)
    rows = torch.arange(F, device=cols.device)[:, None].expand_as(cols)
    M = torch.zeros((F, n + 1), dtype=torch.float32, device=cols.device)
    M.index_put_((rows, torch.where(hit, cols, n)), hit.to(torch.float32))
    return M[:, :n]


def covisibility_counts(obs_lm, obs_valid, L: int, tile: int | None = None):
    """(F, F) matrix of co-observed-landmark counts.

    obs_lm: (F, N) map ids; obs_valid: (F, N) bool.  Dense below 16k
    landmarks; tiled (``tile``, or 8192 above 16k) sums M_t·M_tᵀ over
    landmark-id blocks so the (F, L) matrix never materializes.  Exact: the
    blocks partition the id space."""
    lm = obs_lm.long()
    if tile is None and L > 16384:
        tile = 8192
    if tile is None or tile >= L:
        M = _membership(lm, obs_valid, L)
        return M @ M.T
    C = torch.zeros((lm.shape[0],) * 2, dtype=torch.float32, device=lm.device)
    for lo in range(0, L, tile):
        Mt = _membership(lm - lo, obs_valid & (lm >= lo) & (lm < lo + tile), tile)
        C = C + Mt @ Mt.T
    return C


def detect_loops(C, min_gap: int, min_shared: int, max_edges: int):
    """Top-``max_edges`` loop-candidate pairs from a co-visibility matrix.

    Returns (pairs (E, 2) int64 with i < j, shared (E,), valid (E,)).
    The counts are integers, so ties at the cut-off are common:
    ``jax.lax.top_k`` puts the lower flat index first, and a stable sort
    (``topk_stable``) does the same."""
    F = C.shape[0]
    ii = torch.arange(F, device=C.device)
    sep = ii[None, :] - ii[:, None]                    # j - i
    mask = (sep >= min_gap) & (C >= min_shared)
    score = torch.where(mask, C, -1.0).reshape(-1)
    idx = topk_stable(score, max_edges)
    top = score[idx]
    pairs = torch.stack([idx // F, idx % F], -1)
    return pairs, torch.clamp(top, min=0.0), top > 0


def _relocalize_pairs(K, poses, map_xyz, map_valid, uv, obs_lm, obs_valid, pairs, pvalid,
                      width, height, min_shared, uniforms):
    """Loop edges (Z (E, 4, 4), w (E,)): robust PnP of each pair's late
    frame on the landmarks it shares with the early one, its RANSAC drawn
    from ``uniforms`` (E, H, N).  An edge is kept when >= min_shared
    correspondences survive as inliers."""
    i, j = pairs[:, 0], pairs[:, 1]
    lm = obs_lm.long()
    lm_i = torch.where(obs_valid[i], lm[i], -1)                      # (E, N)
    lm_j = lm[j]
    # map_valid gate: raw matches would otherwise feed garbage-position
    # map slots into the relocalization
    shared = obs_valid[j] & map_valid[lm_j] & torch.any(
        lm_j[:, :, None] == lm_i[:, None, :], -1)
    T_wic, ok, n_inl = pnp_ransac(None, K, map_xyz[lm_j], uv[j], shared,
                                  width, height, uniforms=uniforms)
    Z = lie.inv_se3(poses[i]) @ lie.inv_se3(T_wic)
    w = (pvalid & ok & (n_inl >= min_shared)).to(torch.float32)
    eye = torch.eye(4, dtype=Z.dtype, device=Z.device)
    return torch.where((w > 0)[:, None, None], Z, eye), w


def close_loops(K, poses, map_xyz, map_valid, uv, obs_lm, obs_valid,
                width: int, height: int, min_gap: int = 30, min_shared: int = 12,
                max_edges: int = 32, pgo_iterations: int = 60,
                loop_weight: float = 1.0, odo_weight: float = 25.0,
                generator=None, uniforms=None, record=None):
    """Detect loops, relocalize, and pose-graph-optimize.

    poses: (F, 4, 4) camera-in-world tracked trajectory; obs_lm/obs_valid:
    per-frame matches against the FROZEN map.  The RANSAC draws come from
    ``uniforms`` (max_edges, 64, N) when given, else from ``generator``
    (seed 0 when None; the JAX twin folds the pair into a PRNG key).
    Returns (poses_pgo, n_loop_edges, chi) — poses unchanged when no loop
    qualifies.

    record: None, or a dict that receives each stage's outputs by name, as
    tensors on the run's device (the stages' own outputs, not copies):
    ``covis`` (F, F) counts, ``pairs`` (E, 2) and ``pairs_valid`` (E,),
    ``uniforms`` (E, H, N), the loop edges ``Z`` (E, 4, 4) and ``w`` (E,),
    the poses after the L2 pass (``pgo_l2``) and after the robust pass
    (``pgo_robust``), each pass's iterations (``pgo_l2_solve``,
    ``pgo_robust_solve``: ``pgo_solve``'s record, whose iterates are copies
    of its graph's buffers on the card), the robust chi (``pgo_chi``) and
    the poses returned (``poses_pgo``).  A later implementation of these
    stages must still hand out these names with these meanings: the
    benchmark's check holds each stage to a plain reference from them.
    With None nothing is kept and nothing copied."""
    F = poses.shape[0]
    L = map_xyz.shape[0]
    with span("loop.covis"):
        C = covisibility_counts(obs_lm, obs_valid & map_valid[obs_lm.long()], L)
        pairs, _, pvalid = detect_loops(C, min_gap, min_shared, max_edges)
    with span("loop.reloc"):
        if uniforms is None:
            generator = generator or torch.Generator().manual_seed(0)
            uniforms = ransac_uniforms(generator, (max_edges, 64, obs_lm.shape[1]),
                                       poses.device)
        Z, w = _relocalize_pairs(K, poses, map_xyz, map_valid, uv, obs_lm, obs_valid,
                                 pairs, pvalid, width, height, min_shared, uniforms)

    # information weighting: consecutive-frame relative poses are far more
    # accurate (~mm) than a PnP relocalization over >= min_shared points
    # (~dm); without the ratio the L2 pass bends a good trajectory toward
    # noisy loop edges
    e_ij, e_T, e_w = odometry_edges(poses, weight=odo_weight)
    graph = PoseGraph(
        poses=poses, edges_ij=torch.cat([e_ij, pairs], 0), edges_T=torch.cat([e_T, Z], 0),
        edges_w=torch.cat([e_w, loop_weight * w], 0),
        fixed=torch.arange(F, device=poses.device) < 1)
    # L2 pass: drifted loop residuals are enormous, and a robust kernel
    # would suppress exactly the edges that carry the information
    solves = ({}, {}) if record is not None else (None, None)
    with span("loop.pgo.l2"):
        graph_l2, _ = pgo_solve(graph, iterations=pgo_iterations, kernel_threshold=1.0e8,
                                record=solves[0])
    # robust pass: with the drift redistributed, surviving large residuals
    # are bad relocalizations — saturate them out
    with span("loop.pgo.robust"):
        graph_rob, stats = pgo_solve(graph_l2, iterations=max(pgo_iterations // 3, 10),
                                     kernel_threshold=1.0, record=solves[1])
    n_loops = torch.sum(w > 0)
    ok = torch.isfinite(graph_rob.poses).all() & (n_loops > 0)
    out = torch.where(ok, graph_rob.poses, poses)
    if record is not None:
        record.update(covis=C, pairs=pairs, pairs_valid=pvalid, uniforms=uniforms, Z=Z, w=w,
                      pgo_l2=graph_l2.poses, pgo_robust=graph_rob.poses, pgo_chi=stats.chi,
                      poses_pgo=out, pgo_l2_solve=solves[0], pgo_robust_solve=solves[1])
    return out, n_loops, stats.chi
