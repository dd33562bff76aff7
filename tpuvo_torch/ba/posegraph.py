"""Pose-graph optimization: Gauss-Newton on SE(3) over relative-pose edges
(twin of ``tpuvo/ba/posegraph.py``).

  * state: F camera-in-world poses T_i (4x4)
  * edge (i, j) with measured relative pose Z_ij and weight w:
        r_ij = log_se3(Z_ij^-1 · T_i^-1 · T_j)   in R^6
  * GN over left perturbations T_k <- exp(xi_k)·T_k; the 6x6 edge
    Jacobians are exact: ``torch.func.jacfwd`` of the residual, under
    ``torch.func.vmap`` over the edges (the JAX twin's ``jax.jacfwd``)
  * gauge: ``fixed`` poses (pose 0 at least); robust kernel: the
    saturating sqrt(thr/chi) weight of PICP, per edge on chi = rᵀr

H is assembled into (F, F) 6x6 blocks by fixed-order segmented sums
(``ba/assembly``: the edges' targets sorted once per solve, so two runs give
the same bits on the card) and solved with one damped Cholesky of the
(6F, 6F) system.  The LM loop carries every
value through ``torch.where``, so a solve makes no host round-trip; on the
card each LM iteration is one replay of a captured graph of it
(``utils/graphs``), which launches the eager iteration's kernels in order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuvo_torch.ba import assembly
from tpuvo_torch.engine.state import tuple_from_numpy, tuple_to_numpy
from tpuvo_torch.ops import lie
from tpuvo_torch.ops.linalg_small import cholesky_solve_nan
from tpuvo_torch.utils import graphs


class PoseGraph(NamedTuple):
    """Fixed-shape pose-graph problem.

    poses:    (F, 4, 4) camera-in-world estimates
    edges_ij: (E, 2) node indices (i, j)
    edges_T:  (E, 4, 4) measured relative poses Z_ij = T_i^-1 T_j
    edges_w:  (E,) float32 weights (0 disables an edge — padding)
    fixed:    (F,) bool — poses held fixed
    """

    poses: torch.Tensor
    edges_ij: torch.Tensor
    edges_T: torch.Tensor
    edges_w: torch.Tensor
    fixed: torch.Tensor


class PGOStats(NamedTuple):
    chi: torch.Tensor         # robust total chi (sum w·min(rᵀr, thr))
    num_inliers: torch.Tensor
    iterations: torch.Tensor


_GRAPH_DTYPES = {"poses": torch.float32, "edges_ij": torch.int64,
                 "edges_T": torch.float32, "edges_w": torch.float32, "fixed": torch.bool}


def graph_from_numpy(fields, device="cuda") -> PoseGraph:
    """PoseGraph on ``device`` (the card by default) from numpy arrays keyed
    by field name (a mapping, or an object with those attributes — e.g. the
    JAX package's PoseGraph)."""
    return tuple_from_numpy(PoseGraph, _GRAPH_DTYPES, fields, device)


def graph_to_numpy(graph: PoseGraph) -> dict:
    return tuple_to_numpy(graph)


def edge_residual(T_i, T_j, Z_ij):
    """r = log_se3(Z^-1 · T_i^-1 · T_j), batched — zero iff satisfied."""
    return lie.se3_log(lie.inv_se3(Z_ij) @ lie.inv_se3(T_i) @ T_j)


def _perturbed_residual(xi, T_i, T_j, Z_ij):
    # evaluated with a leading axis of 1: torch.func.jacfwd gives a float64
    # tangent to a 0-d tensor plus a Python float (theta2 + 1e-32 in the
    # se3 chart), which then fails in the next float32 op
    xi, T_i, T_j, Z_ij = xi[None], T_i[None], T_j[None], Z_ij[None]
    return edge_residual(lie.se3_exp(xi[:, :6]) @ T_i, lie.se3_exp(xi[:, 6:]) @ T_j, Z_ij)[0]


def _edge_lin(T_i, T_j, Z_ij):
    """Residuals (E, 6) + exact Jacobians (E, 6, 6) wrt left perturbations
    of T_i and T_j.  Finite on a satisfied edge: so3_log's atan2 form has a
    finite derivative at theta = 0."""
    r = edge_residual(T_i, T_j, Z_ij)
    xi0 = torch.zeros(T_i.shape[:-2] + (12,), dtype=T_i.dtype, device=T_i.device)
    J = torch.func.vmap(torch.func.jacfwd(_perturbed_residual))(xi0, T_i, T_j, Z_ij)
    return r, J[..., :6], J[..., 6:]


def assembly_plans(graph: PoseGraph):
    """The summation order of ``linearize_pgo``'s sums for this graph's
    edges: (H's blocks (i,i), (j,j), (i,j), (j,i) of every edge, in that
    order, by target block; b's (i, j) by target pose).  Planned once per
    solve."""
    F = graph.poses.shape[0]
    ii = graph.edges_ij[:, 0].long()
    jj = graph.edges_ij[:, 1].long()
    return (assembly.plan(torch.cat([ii * F + ii, jj * F + jj, ii * F + jj, jj * F + ii]), F * F),
            assembly.plan(torch.cat([ii, jj]), F))


def linearize_pgo(graph: PoseGraph, kernel_threshold: float, plans):
    """All-edge linearization -> (H (F, F, 6, 6), b (F, 6), robust chi,
    inlier count).  ``plans``: ``assembly_plans(graph)``, made once by the
    solve."""
    F = graph.poses.shape[0]
    ii = graph.edges_ij[:, 0].long()
    jj = graph.edges_ij[:, 1].long()
    r, Ji, Jj = _edge_lin(graph.poses[ii], graph.poses[jj], graph.edges_T)

    chi = torch.sum(r * r, -1)
    active = graph.edges_w > 0
    lam = torch.where(chi <= kernel_threshold, 1.0,
                      torch.sqrt(kernel_threshold / torch.clamp(chi, min=1e-20)))
    w = graph.edges_w * lam * active

    Hii = torch.einsum("eki,ekj,e->eij", Ji, Ji, w)
    Hjj = torch.einsum("eki,ekj,e->eij", Jj, Jj, w)
    Hij = torch.einsum("eki,ekj,e->eij", Ji, Jj, w)
    bi = torch.einsum("eki,ek,e->ei", Ji, r, w)
    bj = torch.einsum("eki,ek,e->ei", Jj, r, w)

    # not index_add_, whose atomics sum in no fixed order on the card
    by_block, by_pose = plans
    H = assembly.segment_sum(torch.cat([Hii, Hjj, Hij, Hij.mT]), by_block).reshape(F, F, 6, 6)
    b = assembly.segment_sum(torch.cat([bi, bj]), by_pose)

    chi_rob = torch.sum(torch.where(active, torch.clamp(chi, max=kernel_threshold), 0.0))
    n_inl = torch.sum(active & (chi <= kernel_threshold)).to(torch.int32)
    return H, b, chi_rob, n_inl


def _solve_system(H, b, fixed, damping):
    """Damped gauge-fixed solve of the (6F, 6F) block system; NaN (never an
    exception) when the system is not positive definite."""
    F = H.shape[0]
    S = H.permute(0, 2, 1, 3).reshape(F * 6, F * 6)
    free = torch.repeat_interleave(~fixed, 6).to(S.dtype)
    S = S * free[:, None] * free[None, :]
    S = S + torch.diag(damping * free + (1.0 - free))
    return cholesky_solve_nan(S, -b.reshape(F * 6) * free).reshape(F, 6)


def pgo_eval_chi(poses, graph: PoseGraph, kernel_threshold: float):
    """Truncated robust objective at given poses (the LM accept test)."""
    ii = graph.edges_ij[:, 0].long()
    jj = graph.edges_ij[:, 1].long()
    r = edge_residual(poses[ii], poses[jj], graph.edges_T)
    chi = torch.sum(r * r, -1)
    return torch.sum(torch.where(graph.edges_w > 0,
                                 graph.edges_w * torch.clamp(chi, max=kernel_threshold), 0.0))


def _reduce_system(H, b, n_inl, reduce):
    """[H | b | n_inliers] as one (6F, 6F+2) buffer through ``reduce``
    (ints < 2^24 are exact in f32); returns the reduced (H, b, n_inliers)."""
    F, dt = H.shape[0], H.dtype
    col = torch.cat([n_inl.to(dt).reshape(1), torch.zeros(F * 6 - 1, dtype=dt, device=H.device)])
    buf = reduce(torch.cat([H.permute(0, 2, 1, 3).reshape(F * 6, F * 6), b.reshape(F * 6, 1),
                            col[:, None]], 1))
    return (buf[:, :F * 6].reshape(F, 6, F, 6).permute(0, 2, 1, 3), buf[:, F * 6].reshape(F, 6),
            buf[0, F * 6 + 1].to(torch.int32))


def _chi(poses, graph: PoseGraph, kernel_threshold: float, reduce):
    chi = pgo_eval_chi(poses, graph, kernel_threshold)
    return chi if reduce is None else reduce(chi.reshape(1))[0]


def _lm_iteration(graph: PoseGraph, plans, lam, chi_prev, kernel_threshold: float,
                  damping: float, reduce=None):
    """One LM iteration from ``graph.poses``, damping ``lam`` and the
    truncated chi ``chi_prev`` there: the trial step, kept or rolled back
    by the accept test.  Returns (poses, lam, chi, inlier count)."""
    poses = graph.poses
    H, b, _, n_inl = linearize_pgo(graph, kernel_threshold, plans)
    if reduce is not None:
        H, b, n_inl = _reduce_system(H, b, n_inl, reduce)
    dx = _solve_system(H, b, graph.fixed, lam)
    new_poses = lie.se3_exp(dx) @ poses
    new_poses = torch.where(graph.fixed[:, None, None], poses, new_poses)
    chi_new = _chi(new_poses, graph, kernel_threshold, reduce)
    accept = (torch.isfinite(chi_new) & torch.isfinite(new_poses).all()
              & (chi_new <= chi_prev))
    return (torch.where(accept, new_poses, poses),
            torch.where(accept, torch.clamp(lam * 0.5, min=damping),
                        torch.clamp(lam * 4.0, max=1e8)),
            torch.where(accept, chi_new, chi_prev), n_inl)


def _eager_iterations(graph: PoseGraph, plans, state, iterations: int, kernel_threshold: float,
                      damping: float, reduce=None, its=None):
    """``iterations`` LM iterations op by op from ``state`` (poses, lam,
    chi, inlier count); ``its`` receives the state before each."""
    for _ in range(iterations):
        poses, lam, chi, _ = state
        if its is not None:
            its.append(dict(poses=poses, lam=lam, chi=chi))
        state = _lm_iteration(graph._replace(poses=poses), plans, lam, chi, kernel_threshold,
                              damping, reduce)
    return state


def _step_body(kernel_threshold: float, damping: float):
    """The captured LM iteration: the carried poses, lam, chi and inlier
    count read from the Program's buffers and written back."""
    def body(b):
        g = b["graph"]
        for dst, src in zip((g.poses, b["lam"], b["chi"], b["n_inl"]),
                            _lm_iteration(g, b["plans"], b["lam"], b["chi"], kernel_threshold,
                                          damping)):
            dst.copy_(src)

    return body


def _replayed_iterations(graph: PoseGraph, plans, state, iterations: int,
                         kernel_threshold: float, damping: float, its=None):
    """``_eager_iterations`` as replays of one captured LM iteration: a
    ``utils/graphs`` Program per graph signature, threshold and damping
    floor (host floats the graph bakes in).  The solve's graph, plans and
    state are copied into its buffers, which the next solve of the key
    overwrites, so ``its`` receives copies."""
    def make():
        b = dict(graph=PoseGraph(*(t.clone() for t in graph)),
                 plans=tuple(type(p)(*(t.clone() for t in p)) for p in plans),
                 **{k: t.clone() for k, t in zip(("lam", "chi", "n_inl"), state[1:])})
        return graphs.Program("pgo_step", b, (b["graph"].poses, b["lam"], b["chi"], b["n_inl"]))

    prog = graphs.cached(("pgo_step", graphs.signature(graph), kernel_threshold, damping), make)
    b = prog.buffers
    carried = (b["graph"].poses, b["lam"], b["chi"], b["n_inl"])
    for dst, src in zip((*b["graph"], *(t for p in b["plans"] for t in p), *carried[1:]),
                        (*graph, *(t for p in plans for t in p), *state[1:])):
        dst.copy_(src)
    body = _step_body(kernel_threshold, damping)
    for k in range(iterations):
        if its is not None:
            if k:
                state = tuple(t.clone() for t in carried)
            its.append(dict(poses=state[0], lam=state[1], chi=state[2]))
        prog.replay(None, body)
    return tuple(t.clone() for t in carried)


def pgo_solve(graph: PoseGraph, iterations: int = 20, kernel_threshold: float = 1.0,
              damping: float = 1e-6, damping_init: float = 1e-3, reduce=None, record=None):
    """Adaptive-LM pose-graph solve: one trial step per iteration; a
    rejected or non-finite step rolls back with lambda x4, an accepted one
    relaxes x0.5 toward ``damping``.  ``accept`` is a tensor and every
    carried value goes through ``torch.where`` (no host sync).  Returns
    (optimized PoseGraph, PGOStats).

    On the card (``graphs.on_card``) an LM iteration is one replay of its
    captured graph (``_replayed_iterations``), which runs the kernels of
    the eager iteration in their order: the same bits.  The plans, the
    first chi and the copies in and out stay eager, once a solve.

    ``reduce``: a sum over the ranks that share the poses (the sharded
    solver's all_reduce), given an edge block as ``graph``: each iteration
    sums [H | b | n_inliers] in one fused buffer and the trial chi in one
    scalar, so every rank takes the same step and the same accept test.
    Such a solve runs its iterations eagerly, on the card too.

    record: None, or a dict whose ``iterations`` receives the state before
    each LM iteration and after the last (``poses``, ``lam``, ``chi`` the
    truncated objective), as tensors on the solve's device, so that a plain
    reference can take each iteration from the solver's own state: the
    first holds the solve's input poses, the last what it returns; no two
    entries share storage (on the card, copies of the graph's buffers)."""
    dev = graph.poses.device
    chi_prev = _chi(graph.poses, graph, kernel_threshold, reduce)
    lam = torch.full((), damping_init, dtype=torch.float32, device=dev)
    n_inl = torch.zeros((), dtype=torch.int32, device=dev)
    plans = assembly_plans(graph)  # the edges are the solve's: sorted once
    its = record.setdefault("iterations", []) if record is not None else None
    state = (graph.poses, lam, chi_prev, n_inl)
    if reduce is None and graphs.on_card(graph.poses) and iterations > 0:
        state = _replayed_iterations(graph, plans, state, iterations, float(kernel_threshold),
                                     float(damping), its)
    else:
        state = _eager_iterations(graph, plans, state, iterations, kernel_threshold, damping,
                                  reduce, its)
    poses, lam, chi_prev, n_inl = state
    if its is not None:
        its.append(dict(poses=poses, lam=lam, chi=chi_prev))
    return graph._replace(poses=poses), PGOStats(
        chi_prev, n_inl, torch.full((), iterations, dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# Graph construction from a VO run
# ---------------------------------------------------------------------------
def odometry_edges(poses, weight: float = 1.0):
    """Sequential (i, i+1) edges of a camera-in-world trajectory (F, 4, 4).
    Returns (edges_ij, edges_T, edges_w)."""
    F = poses.shape[0]
    ii = torch.arange(F - 1, device=poses.device)
    edges_T = lie.inv_se3(poses[:-1]) @ poses[1:]
    return (torch.stack([ii, ii + 1], -1), edges_T,
            torch.full((F - 1,), weight, dtype=torch.float32, device=poses.device))


def window_edges(poses_refined, window: int, step: int, weight: float = 1.0, skip: int = 2):
    """Relative-pose constraints (lo, lo+k), k in [skip, window), for each
    window [lo, lo+window) of a windowed-BA trajectory: window-local
    relative poses are accurate even where the window's anchor drifted."""
    F = poses_refined.shape[0]
    pairs = [(lo, lo + k) for lo in range(0, F - window + 1, step)
             for k in range(skip, window)]
    eij = torch.as_tensor(pairs, dtype=torch.int64, device=poses_refined.device)
    eT = lie.inv_se3(poses_refined[eij[:, 0]]) @ poses_refined[eij[:, 1]]
    return eij, eT, torch.full((len(pairs),), weight, dtype=torch.float32,
                               device=poses_refined.device)


def build_graph(poses, extra_edges=None, odo_weight: float = 1.0) -> PoseGraph:
    """Odometry backbone + optional extra (e.g. loop-closure) edge sets, a
    list of (edges_ij, edges_T, edges_w) triples; pose 0 fixed."""
    poses = torch.as_tensor(poses, dtype=torch.float32)
    sets = [odometry_edges(poses, odo_weight)] + list(extra_edges or [])
    F = poses.shape[0]
    return PoseGraph(poses, torch.cat([s[0].long() for s in sets], 0),
                     torch.cat([s[1] for s in sets], 0), torch.cat([s[2] for s in sets], 0),
                     torch.arange(F, device=poses.device) == 0)
