"""Sliding-window bundle adjustment with Schur-complement landmark reduction
(twin of ``tpuvo/ba/window.py``).

Formulation — classic visual BA:
  * state: W camera poses (world-in-camera T_f) + L landmarks X_l
  * per observation (f, l): residual e = pi(K · T_f · X_l) - uv with the
    saturating robust weight of PICP (sqrt(thr/chi) above the threshold)
  * pose Jacobian A (2x6) as in PICP; landmark Jacobian B = Jp · K · R_f
  * Hll is block-diagonal (3x3 per landmark), so the reduced camera system
        S = Hpp - Hpl Hll^-1 Hlp      (dense (6W, 6W))
    is solved for the poses, and the landmarks follow by back-substitution.
  * gauge: ``fixed`` poses are pinned (rows/cols zeroed, diagonal 1).

Every per-observation quantity is one batched pass over (W, N); the
per-landmark blocks are assembled by fixed-order segmented sums
(``ba/assembly``, the JAX twin's ``segment_sum``; the order is planned once
per solve, so two runs give the same bits on the card) and S is one large
matrix product over the landmark axis.
The Levenberg-Marquardt loop carries every value through ``torch.where``
on a tensor ``accept``, so a solve makes no host round-trip on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpuvo_torch.ba import assembly
from tpuvo_torch.config import BAConfig, EngineConfig
from tpuvo_torch.engine.state import tuple_from_numpy, tuple_to_numpy
from tpuvo_torch.ops import lie
from tpuvo_torch.ops.camera import project_points_with_cam
from tpuvo_torch.ops.linalg_small import cholesky_solve_nan, inv3


class BAProblem(NamedTuple):
    """Fixed-shape BA problem.

    poses:       (W, 4, 4) world-in-camera transforms
    points:      (L, 3) landmark positions
    obs_uv:      (W, N, 2) pixel measurements
    obs_lm:      (W, N) landmark index per observation (any integer dtype)
    obs_valid:   (W, N) bool
    point_valid: (L,) bool
    fixed:       (W,) bool — poses held fixed (gauge)
    """

    poses: torch.Tensor
    points: torch.Tensor
    obs_uv: torch.Tensor
    obs_lm: torch.Tensor
    obs_valid: torch.Tensor
    point_valid: torch.Tensor
    fixed: torch.Tensor


class BAStats(NamedTuple):
    chi: torch.Tensor          # robust total chi
    num_inliers: torch.Tensor
    num_obs: torch.Tensor


_PROBLEM_DTYPES = {
    "poses": torch.float32, "points": torch.float32, "obs_uv": torch.float32,
    "obs_lm": torch.int64, "obs_valid": torch.bool, "point_valid": torch.bool,
    "fixed": torch.bool,
}


def problem_from_numpy(fields, device="cuda") -> BAProblem:
    """BAProblem on ``device`` (the card by default) from numpy arrays keyed
    by field name (a mapping, or an object with those attributes — e.g. the
    JAX package's BAProblem)."""
    return tuple_from_numpy(BAProblem, _PROBLEM_DTYPES, fields, device)


def problem_to_numpy(problem: BAProblem) -> dict:
    """Field name -> numpy array (host copy)."""
    return tuple_to_numpy(problem)


def _per_obs_blocks(K, T, X, uv, valid, width, height, kernel_threshold,
                    keep_outliers: bool = False, cull_bounds: bool = True):
    """Linearize observations, batched over leading dims: T (..., 4, 4),
    X (..., N, 3).  Returns per-obs A (..., N, 2, 6), B (..., N, 2, 3),
    e (..., N, 2), robust weight w (0 for culled/invalid), chi, ok, inlier."""
    uv_hat, proj_ok, p_cam, phom = project_points_with_cam(K, T, X, width, height)
    e = uv_hat - uv
    z = phom[..., 2]
    iz = 1.0 / torch.where(torch.abs(z) > 1e-12, z, torch.ones_like(z))
    a0 = phom[..., 0] * iz
    a1 = phom[..., 1] * iz
    C0 = iz[..., None] * (K[0] - a0[..., None] * K[2])  # (..., N, 3)
    C1 = iz[..., None] * (K[1] - a1[..., None] * K[2])
    w_ax = -p_cam
    A = torch.stack(
        [torch.cat([C0, torch.linalg.cross(C0, w_ax, dim=-1)], -1),
         torch.cat([C1, torch.linalg.cross(C1, w_ax, dim=-1)], -1)], -2)
    JpK = torch.stack([C0, C1], -2)                                  # (..., N, 2, 3)
    B = torch.einsum("...nik,...kl->...nil", JpK, T[..., :3, :3])   # point Jacobian

    ok = valid & (proj_ok if cull_bounds else (p_cam[..., 2] > 0.0))
    # zero masked rows before any reduction (inf·0 = NaN hazard, see picp)
    e = torch.where(ok[..., None], e, 0.0)
    A = torch.where(ok[..., None, None], A, 0.0)
    B = torch.where(ok[..., None, None], B, 0.0)
    chi = torch.sum(e * e, -1)
    inlier = chi <= kernel_threshold
    lam = torch.where(inlier, 1.0,
                      torch.sqrt(kernel_threshold / torch.clamp(chi, min=1e-20)))
    contrib = ok if keep_outliers else (ok & inlier)
    w = lam * contrib.to(X.dtype)
    return A, B, e, w, chi, ok, inlier


def _gather_obs(problem: BAProblem):
    """(landmark ids (W, N) int64 clamped into [0, L), X (W, N, 3), valid).

    Clamped like a JAX gather: an invalid observation may carry the map
    capacity as its id (a dropped candidate's slot); its weight is 0, so
    the clamped id only receives zero blocks."""
    L = problem.points.shape[0]
    lm = torch.clamp(problem.obs_lm.long(), 0, L - 1)
    return lm, problem.points[lm], problem.obs_valid & problem.point_valid[lm]


def assembly_plans(problem: BAProblem):
    """The summation order of ``linearize_ba``'s landmark sums for this
    problem's topology (its observations' landmark ids): (by landmark, by
    landmark and frame).  Planned once per solve."""
    W, N = problem.obs_lm.shape
    L = problem.points.shape[0]
    lm = _gather_obs(problem)[0].reshape(-1)
    by_lm = assembly.plan(lm, L)
    fidx = torch.arange(W, device=lm.device)[:, None].expand(W, N).reshape(-1)
    # the stable sort by landmark keeps each landmark's observations in
    # (frame, slot) order, so it sorts landmark * W + frame as well
    return by_lm, assembly.plan(lm * W + fidx, L * W, order=by_lm.order)


def linearize_ba(problem: BAProblem, K, width, height, cfg: BAConfig, plans):
    """Assemble all Schur ingredients in batched passes.

    Returns (Hpp (W,6,6), bp (W,6), Hll (L,3,3), bl (L,3),
    Wfl (L,W,6,3) coupling blocks, stats).  ``cfg.assembly`` "segsum" and
    "onehot" name two TPU assemblies of the same sums; both are the one
    fixed-order segmented sum here (JAX's own tests hold the two equal).
    ``plans``: ``assembly_plans(problem)``, made once by the solve."""
    W = problem.obs_lm.shape[0]
    L = problem.points.shape[0]
    _, X, valid = _gather_obs(problem)
    A, B, e, w, chi, ok, inlier = _per_obs_blocks(
        K, problem.poses, X, problem.obs_uv, valid, width, height,
        cfg.huber_threshold, cfg.keep_outliers, cfg.cull_bounds)
    Hpp = torch.einsum("fnki,fnkj,fn->fij", A, A, w)
    bp = torch.einsum("fnki,fnk,fn->fi", A, e, w)
    HB = torch.einsum("fnki,fnkj,fn->fnij", B, B, w)   # (W, N, 3, 3)
    blB = torch.einsum("fnki,fnk,fn->fni", B, e, w)    # (W, N, 3)
    Wb = torch.einsum("fnki,fnkj,fn->fnij", A, B, w)   # (W, N, 6, 3)

    # not index_add_, whose atomics sum in no fixed order on the card: two
    # runs of one problem would differ in the last bits, and an LM accept
    # test near a tie can grow that into a different step
    by_lm, by_lm_frame = plans
    Hll = assembly.segment_sum(HB.reshape(-1, 3, 3), by_lm)
    bl = assembly.segment_sum(blB.reshape(-1, 3), by_lm)
    Wfl = assembly.segment_sum(Wb.reshape(-1, 6, 3), by_lm_frame).reshape(L, W, 6, 3)

    stats = BAStats(
        chi=torch.sum(chi * (w > 0) * torch.clamp(w, max=1.0)),
        num_inliers=torch.sum(ok & inlier).to(torch.int32),
        num_obs=torch.sum(ok).to(torch.int32),
    )
    return Hpp, bp, Hll, bl, Wfl, stats


def invert_hll(Hll, damping):
    """Damped inverse of the landmark blocks (batched 3x3 adjugate).

    Symmetrize + scale-relative damping + a trace-relative fp32
    conditioning floor; non-finite inverses are zeroed (the landmark is
    skipped this step)."""
    I3 = torch.eye(3, dtype=Hll.dtype, device=Hll.device)
    Hll_s = 0.5 * (Hll + Hll.mT)
    tr = Hll_s[:, 0, 0] + Hll_s[:, 1, 1] + Hll_s[:, 2, 2]
    lam_l = damping * (tr / 3.0 + 1.0) + 1e-5 * tr
    Hll_inv = inv3(Hll_s + lam_l[:, None, None] * I3)
    finite = torch.isfinite(Hll_inv).flatten(1).all(1)
    return torch.where(finite[:, None, None], Hll_inv, 0.0)


def schur_parts(Hpp, bp, Hll, bl, Wfl, damping):
    """The reduced camera system before gauge fixing: (S (6W, 6W),
    b (6W,), Hll_inv) — sums over the landmark axis."""
    W = Hpp.shape[0]
    Hll_inv = invert_hll(Hll, damping)
    WHinv = torch.einsum("lfij,ljk->lfik", Wfl, Hll_inv)           # (L, W, 6, 3)
    # the (6W, 6W) product over (l, k): one plain matrix product, as in JAX
    S = -torch.einsum("lfik,lgjk->figj", WHinv, Wfl)                # (W, 6, W, 6)
    eyeW = torch.eye(W, dtype=Hpp.dtype, device=Hpp.device)
    S = S + torch.einsum("fij,fg->figj", Hpp, eyeW)
    bp_red = bp - torch.einsum("lfik,lk->fi", WHinv, bl)
    return S.reshape(W * 6, W * 6), bp_red.reshape(W * 6), Hll_inv


def finalize_reduced(S, b_red, fixed, damping):
    """Gauge-fix (zero fixed rows/cols, pin their diagonal to 1) and damp
    scale-relatively: S_ii·(1+lambda) + lambda on the free poses."""
    free = torch.repeat_interleave(~fixed, 6).to(S.dtype)
    S = S * free[:, None] * free[None, :]
    d = torch.diagonal(S)
    S = S + torch.diag(damping * (d + 1.0) * free + (1.0 - free))
    return S, b_red * free


def backsubstitute(Hll_inv, bl, Wfl, dx_p):
    """Landmark updates given the pose step: dx_l = -Hll^-1 (bl + W^T dx_p)."""
    rhs = bl + torch.einsum("lfij,fi->lj", Wfl, dx_p)
    return -torch.einsum("lij,lj->li", Hll_inv, rhs)


def schur_reduce(Hpp, bp, Hll, bl, Wfl, fixed, damping):
    """Single-device reduced camera system (parts + finalize)."""
    S, b_red, Hll_inv = schur_parts(Hpp, bp, Hll, bl, Wfl, damping)
    S, b_red = finalize_reduced(S, b_red, fixed, damping)
    return S, b_red, Hll_inv, None


def eval_robust_chi(problem: BAProblem, K, width, height, cfg: BAConfig):
    """Truncated robust objective sum(min(chi_i, thr)) over valid obs; a
    valid observation that projects out of bounds (or behind the camera
    when ``cull_bounds`` is off) counts the full threshold."""
    thr = cfg.huber_threshold
    _, X, valid = _gather_obs(problem)
    uv_hat, ok, p_cam, _ = project_points_with_cam(K, problem.poses, X, width, height)
    if not cfg.cull_bounds:
        ok = p_cam[..., 2] > 0.0
    e = torch.where((valid & ok)[..., None], uv_hat - problem.obs_uv, 0.0)
    chi = torch.sum(e * e, -1)
    per = torch.where(ok, torch.clamp(chi, max=thr), thr)
    return torch.sum(torch.where(valid, per, 0.0))


def _reduce_fused(S, b_red, stats: BAStats, reduce):
    """[S | b | chi, inliers, obs] as one (6W, 6W+2) buffer through
    ``reduce`` (ints < 2^24 are exact in f32); returns the reduced parts."""
    n = S.shape[0]
    extra = torch.cat([torch.stack([stats.chi, stats.num_inliers.to(S.dtype),
                                    stats.num_obs.to(S.dtype)]),
                       torch.zeros(n - 3, dtype=S.dtype, device=S.device)])
    buf = reduce(torch.cat([S, b_red[:, None], extra[:, None]], 1))
    return buf[:, :n], buf[:, n], BAStats(chi=buf[0, n + 1],
                                          num_inliers=buf[1, n + 1].to(torch.int32),
                                          num_obs=buf[2, n + 1].to(torch.int32))


def ba_step(problem: BAProblem, K, width, height, cfg: BAConfig, damping=None, reduce=None, *,
            plans):
    """One Levenberg-damped GN iteration; ``damping`` (a float or a 0-d
    tensor) overrides cfg.damping; ``plans``: ``assembly_plans(problem)``
    (the solve's topology, planned once by the caller).

    ``reduce``: a sum over the ranks that share the poses (the sharded
    solver's all_reduce), given a landmark shard as ``problem``: the reduced
    camera system and the statistics are summed in one fused buffer before
    the solve, so every rank takes the same pose step."""
    damping = cfg.damping if damping is None else damping
    Hpp, bp, Hll, bl, Wfl, stats = linearize_ba(problem, K, width, height, cfg, plans)
    S, b_red, Hll_inv = schur_parts(Hpp, bp, Hll, bl, Wfl, damping)
    if reduce is not None:
        S, b_red, stats = _reduce_fused(S, b_red, stats, reduce)
    S, b_red = finalize_reduced(S, b_red, problem.fixed, damping)
    # a non-PD S gives a NaN step, which the LM loop rejects (see
    # cholesky_solve_nan)
    dx_p = cholesky_solve_nan(S, -b_red).reshape(-1, 6)
    dx_l = backsubstitute(Hll_inv, bl, Wfl, dx_p)

    new_poses = lie.se3_exp(dx_p) @ problem.poses
    new_poses = torch.where(problem.fixed[:, None, None], problem.poses, new_poses)
    touched = Hll[:, 0, 0] + Hll[:, 1, 1] + Hll[:, 2, 2] > 0
    upd = problem.point_valid & touched
    new_points = torch.where(upd[:, None], problem.points + dx_l, problem.points)
    return problem._replace(poses=new_poses, points=new_points), stats


def _compact_active(obs_lm, obs_valid, L: int, La: int):
    """Active-first landmark renumbering: the observed ids packed in
    ascending order into [0, La-1); invalid observations and the overflow
    past the cap go to the inert last slot La-1.

    Returns (new_obs_lm (W, N) int64, active_old (La,) original ids, L for
    an unused slot).  The JAX twin's ``sort`` is ``argsort(stable=True)``;
    its "mask" variant computes the same renumbering and runs this code."""
    flat = obs_lm.reshape(-1).long()
    key = torch.where(obs_valid.reshape(-1), flat, L)  # invalid -> sentinel group
    order = torch.argsort(key, stable=True)
    sv = key[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=sv.device), sv[1:] != sv[:-1]])
    nid_sorted = torch.cumsum(first.to(torch.int64), 0) - 1
    nid_sorted = torch.where(sv == L, La - 1, torch.clamp(nid_sorted, max=La - 1))
    new_flat = torch.empty_like(flat).index_copy_(0, order, nid_sorted)
    # window.py's scatter into active_old drops out-of-range slots
    # (mode="drop"); torch has no such mode, but every nid is already
    # clamped into [0, La), and the slots below La-1 are written only with
    # their one landmark id, so the order of duplicate writes is moot
    active_old = torch.full((La,), L, dtype=torch.int64, device=sv.device).index_copy_(
        0, nid_sorted, sv)
    # the last slot is the inert sentinel: overflow landmarks collide into
    # it when La caps below the unique count, so pin it to L and they are
    # DROPPED (point_valid false) instead of aggregated into one corrupted
    # pseudo-landmark
    last = torch.arange(La, device=sv.device) == La - 1
    active_old = torch.where(last, L, active_old)
    return new_flat.reshape(obs_lm.shape), active_old


def ba_solve(problem: BAProblem, K, width, height, cfg: BAConfig, compact: bool = True,
             record=None):
    """Run cfg.iterations BA steps.

    compact=True renumbers the observed landmarks into a prefix of La =
    min(L, W·N+1, compact_cap) slots once per solve, so every O(L) term
    runs at O(La).  With ``cfg.lm_adaptive`` each iteration is one trial
    step against the truncated robust objective: a rejected or non-finite
    step rolls back with lambda x4, an accepted one relaxes lambda x0.5
    toward cfg.damping.  ``accept`` is a tensor and every carried value
    goes through ``torch.where`` — no ``if accept``, so no host sync.

    record: None, or a dict that receives the solve as it ran, as tensors
    (references, no copies): the problem in the solve's own numbering
    (``obs_lm``, ``point_valid``, ``fixed``; ``slots``, each solve point's
    map slot, or None when not compacted) and ``iterations``: the state
    before each LM iteration and after the last (``poses`` world-in-camera,
    ``points``, ``lam``, ``chi`` the truncated objective), so that a plain
    reference can take each iteration from the solver's own state.  The
    adaptive LM only."""
    Wf, N = problem.obs_lm.shape
    L = problem.points.shape[0]
    # at full width the global sweep has W·N = 200·128 > L = 8192: no
    # compaction, and Wfl / WHinv are (L, W, 6, 3) fp32, ~118 MB each
    La = min(L, Wf * N + 1)
    if cfg.compact_cap:
        La = min(La, cfg.compact_cap)
    use_compact = compact and La < L

    if use_compact:
        new_lm, active_old = _compact_active(problem.obs_lm, problem.obs_valid, L, La)
        slot_used = active_old < L
        gather_idx = torch.clamp(active_old, 0, L - 1)
        prob = problem._replace(
            points=problem.points[gather_idx],
            point_valid=problem.point_valid[gather_idx] & slot_used,
            obs_lm=new_lm,
        )
    else:
        prob = problem

    dev = problem.points.device
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    plans = assembly_plans(prob)  # the topology is the solve's: sorted once
    if cfg.lm_adaptive:
        chi_prev = eval_robust_chi(prob, K, width, height, cfg)
        stats = BAStats(chi_prev, zero_i, zero_i)
        lam = torch.full((), cfg.damping_init, dtype=torch.float32, device=dev)
        its = None
        if record is not None:
            its = []
            record.update(obs_lm=prob.obs_lm, point_valid=prob.point_valid, fixed=prob.fixed,
                          slots=active_old if use_compact else None, iterations=its)
        for _ in range(cfg.iterations):
            if its is not None:
                its.append(dict(poses=prob.poses, points=prob.points, lam=lam, chi=chi_prev))
            prob_new, stats_new = ba_step(prob, K, width, height, cfg, lam, plans=plans)
            chi_new = eval_robust_chi(prob_new, K, width, height, cfg)
            finite = (torch.isfinite(chi_new) & torch.isfinite(prob_new.poses).all()
                      & torch.isfinite(prob_new.points).all())
            accept = finite & (chi_new <= chi_prev)
            prob = prob._replace(
                poses=torch.where(accept, prob_new.poses, prob.poses),
                points=torch.where(accept, prob_new.points, prob.points))
            stats = BAStats(*(torch.where(accept, a, b) for a, b in zip(stats_new, stats)))
            lam = torch.where(accept, torch.clamp(lam * 0.5, min=cfg.damping),
                              torch.clamp(lam * 4.0, max=1e8))
            chi_prev = torch.where(accept, chi_new, chi_prev)
        if its is not None:
            its.append(dict(poses=prob.poses, points=prob.points, lam=lam, chi=chi_prev))
    else:
        stats = BAStats(torch.zeros((), dtype=torch.float32, device=dev), zero_i, zero_i)
        for _ in range(cfg.iterations):
            prob, stats = ba_step(prob, K, width, height, cfg, plans=plans)

    if use_compact:
        # scatter back; window.py drops the unused slots (index L) with
        # mode="drop" — here they land in a dump row L that is cut off
        scatter_idx = torch.where(slot_used, active_old, L)
        ext = torch.cat([problem.points, problem.points[:1]], 0)
        new_points = ext.index_copy_(0, scatter_idx, prob.points)[:L]
        prob = problem._replace(poses=prob.poses, points=new_points)
    return prob, stats


def build_problem_from_vo(state, seq, frame_indices, cfg: EngineConfig) -> BAProblem:
    """Adapter: a VO map + a window of frames -> a BAProblem on the map's
    device.  Correspondences come from re-matching each window frame's
    descriptors against the (frozen) map; the poses are zeros (the caller
    overwrites them with tracked poses)."""
    from tpuvo_torch.ops.match import match_descriptors

    dev = state.map_xyz.device
    W = len(frame_indices)
    obs_lm, obs_valid = [], []
    for fi in frame_indices:
        res = match_descriptors(
            torch.as_tensor(np.asarray(seq.desc[fi]), dtype=torch.float32, device=dev),
            torch.as_tensor(np.asarray(seq.valid[fi]), dtype=torch.bool, device=dev),
            state.map_desc, state.map_valid,
            cfg.matcher.distance_threshold, cfg.matcher.ratio_threshold)
        obs_lm.append(res.idx)
        obs_valid.append(res.valid)
    fixed = torch.arange(W, device=dev) == 0
    return BAProblem(
        poses=torch.zeros((W, 4, 4), dtype=torch.float32, device=dev),
        points=state.map_xyz,
        obs_uv=torch.as_tensor(np.asarray(seq.uv)[list(frame_indices)], dtype=torch.float32,
                               device=dev),
        obs_lm=torch.stack(obs_lm),
        obs_valid=torch.stack(obs_valid),
        point_valid=state.map_valid,
        fixed=fixed,
    )
