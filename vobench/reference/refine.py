"""Plain reference of the loop-closure refine (``slam --refine loop``): the
frozen topology, loop detection, RANSAC PnP relocalisation, the two-pass
pose-graph optimisation and the graduated global bundle adjustment, each
stage a function of its own inputs, so that the check can start every
stage from the program's recorded input.  Plain PyTorch float32; it
imports nothing of the program.  The matcher, the products (``mm`` /
``ein``, where the control's emulated TF32 rounds), the PICP solve and the
SE(3) pieces of the BA come from ``vo.py`` and ``slam.py``.

The semantics followed, as the configuration (``refine``,
``fixed_by_program``) and the program's documentation state them:
  * topology: every frame's keypoints matched against the tracked (frozen)
    map with ``vo.match`` (top-2, the ratio test);
  * co-visibility: (F, F) counts of co-observed valid landmarks, the
    product of the 0/1 membership matrix with its transpose;
  * loop pairs: the ``max_edges`` largest counts with j - i >= ``min_gap``
    and at least ``min_shared``, by a stable sort (the lower flat index
    first on a tie); a pair counts when its count is positive;
  * relocalisation of each pair's late frame on the landmarks it shares
    with the early one: 64 hypotheses a pair, each the 8 valid rows with
    the largest Gumbel keys -log(-log u) of the recorded uniforms, a
    calibrated DLT (Hartley-normalised points, the least eigenvector of
    AᵀA, the sign by majority positive depth, the closest rotation by SVD,
    the scale the mean singular value); the first hypothesis with the most
    inliers (reprojection under 8 px), a DLT refit on its inliers, then 10
    rounds of PICP at 9 x 64 px² (the tracker's ``vo.picp``); a loop edge
    Z_ij = T_i^-1 T_j^pnp is kept when the PnP holds >= 6 votes and at
    least ``min_shared`` inliers after the polish;
  * edges: odometry (i, i+1) at ``odo_weight``, the loop edges at
    ``loop_weight`` times their 0/1 weight; pose 0 fixed;
  * PGO: residual log(Z^-1 T_i^-1 T_j) in the (v, w) chart of SE(3),
    exact 6x6 Jacobians of left perturbations (forward-mode autodiff of
    this file's chart functions), the saturating weight sqrt(thr/chi) per
    edge, Levenberg-Marquardt with an additive damping (1e-3 first, x0.5
    on a kept step down to 1e-6, x4 on a rejected one up to 1e8), a step
    kept when finite and not raising the truncated chi; an L2 pass
    (``pgo_iterations`` at 1e8), then a robust pass (a third of them, at
    least 10, at 1.0); its poses are taken when finite and a loop edge
    was kept;
  * the global sweeps: BA over every pose (world-in-camera; 0 and 1
    fixed) and every map slot on the frozen topology, no image-bounds cull
    (only cheirality), ``slam.py``'s Schur LM step (its landmark damping,
    its scaled pose damping; damping 1.0 first, floor 1e-6), 15
    iterations; sweep 0 coarse (threshold max(thr, 1e8), outliers kept
    with the weight sqrt(thr/chi)), then fine at the configured threshold
    (outliers carry no weight); a sweep's chi is that of the last kept
    step's linearisation point: sum chi · min(w, 1) over the weighted
    observations (the starting truncated cost when no step was kept); a
    sweep that is not finite is skipped (its poses, and its points that
    are not finite, keep their values);
  * the stopping rule: after ``n_sweeps`` (and at least 2) sweeps, stop
    when a fine chi is not below (1 - ``rel_improvement_stop``) times the
    previous fine chi; at most max(``max_sweeps``, ``n_sweeps``).

Departures from the program, none of which changes what is computed:
  * sums by ``index_add_`` and ``einsum`` in any order (the program's are
    fixed-order segment sums);
  * the sweep over all L map slots, never compacted (the program compacts
    only when F·N + 1 < L; at the cell's size it does not either);
  * the small solves through ``torch.linalg`` (``eigh``, ``svd``,
    ``det``, ``inv_ex``, ``cholesky_ex``) where the program has its own;
    where the batched ``eigh`` gives up on a matrix, each matrix is solved
    alone on the host and one that fails gets NaN, as the program does;
  * the topology in blocks of frames (the program: one launch of kernel B).
"""

from __future__ import annotations

import math

import torch

from vobench.reference import slam, vo
from vobench.reference.vo import ein, mm


# ---------------------------------------------------------------- topology --
def topology(map_desc, map_valid, desc, valid, dist_thr: float, ratio_thr: float,
             block: int = 16):
    """(obs_lm (F, N) int64, obs_valid (F, N)) of frames (F, N, D) against
    the map (C, D), ``block`` frames at a time."""
    F, N, D = desc.shape
    idx, ok = [], []
    for lo in range(0, F, block):
        m = vo.match(desc[lo:lo + block].reshape(1, -1, D), valid[lo:lo + block].reshape(1, -1),
                     map_desc[None], map_valid[None], dist_thr, ratio_thr)
        idx.append(m.idx[0])
        ok.append(m.valid[0])
    return torch.cat(idx).view(F, N), torch.cat(ok).view(F, N)


def covisibility(obs_lm, obs_valid, map_valid):
    """(F, F) counts of valid map landmarks co-observed by two frames."""
    F = obs_lm.shape[0]
    L = map_valid.shape[0]
    lm = obs_lm.long()
    inside = (lm >= 0) & (lm < L)
    hit = obs_valid & inside & map_valid[lm.clamp(0, L - 1)]
    M = torch.zeros(F, L, device=obs_lm.device)
    rows = torch.arange(F, device=obs_lm.device)[:, None].expand_as(lm)
    M[rows[hit], lm[hit]] = 1.0
    return mm(M, M.T)


def loop_pairs(C, min_gap: int, min_shared: int, max_edges: int):
    """(pairs (E, 2) int64 with i < j, valid (E,)): the largest counts
    with j - i >= min_gap and >= min_shared, lower flat index first."""
    F = C.shape[0]
    ii = torch.arange(F, device=C.device)
    keep = (ii[None, :] - ii[:, None] >= min_gap) & (C >= min_shared)
    score = torch.where(keep, C, -1.0).reshape(-1)
    top = torch.argsort(-score, stable=True)[:max_edges]
    return torch.stack([top // F, top % F], -1), score[top] > 0


def uniforms(shape, device, seed: int = 0):
    """The relocalisation's documented draw: uniforms in [1e-9, 1) from a
    CPU generator seeded ``seed``, float32."""
    u = torch.rand(tuple(shape), generator=torch.Generator().manual_seed(seed))
    return torch.clamp(u * (1.0 - 1e-9) + 1e-9, min=1e-9).to(device)


# --------------------------------------------------------------------- PnP --
def _eye4(shape, like):
    return torch.eye(4, dtype=like.dtype, device=like.device).expand(tuple(shape) + (4, 4))


def dlt(K, X, uv, valid):
    """Calibrated DLT pose (world-in-camera (..., 4, 4), ok) from the valid
    rows of X (..., N, 3) seen at uv (..., N, 2)."""
    w = valid.to(X.dtype)
    n = valid.sum(-1)
    X = torch.where(valid[..., None], X, 0.0)
    uv = torch.where(valid[..., None], uv, 0.0)
    xn = (uv[..., 0] - K[0, 2]) / K[0, 0]
    yn = (uv[..., 1] - K[1, 2]) / K[1, 1]
    den = n.to(X.dtype).clamp(min=1.0)
    mean = (X * w[..., None]).sum(-2) / den[..., None]
    Xc = X - mean[..., None, :]
    s = math.sqrt(3.0) / torch.sqrt(((Xc * Xc).sum(-1) * w).sum(-1) / den).clamp(min=1e-12)
    one = torch.ones_like(xn)[..., None]
    Xh = torch.cat([Xc * s[..., None, None], one], -1)
    z4 = torch.zeros_like(Xh)
    A = torch.cat([torch.cat([Xh, z4, -xn[..., None] * Xh], -1) * w[..., None],
                   torch.cat([z4, Xh, -yn[..., None] * Xh], -1) * w[..., None]], -2)
    M = mm(A.mT, A)
    # a far landmark overflows the sums in float32: AᵀA NaN, which eigh
    # refuses; solve I instead and drop the hypothesis (the program does)
    solvable = torch.isfinite(M).flatten(-2).all(-1)
    _, V = vo.eigh(torch.where(solvable[..., None, None], M,
                               torch.eye(12, dtype=M.dtype, device=M.device)))
    Pn = V[..., :, 0].reshape(V.shape[:-2] + (3, 4))
    eye3 = torch.eye(3, dtype=X.dtype, device=X.device)
    Tn = vo.make_T(s[..., None, None] * eye3, -s[..., None] * mean)
    P = mm(Pn, Tn)[..., :3, :]
    depth = ein("...nj,...j->...n", torch.cat([X, one], -1), P[..., 2, :])
    flip = ((depth > 0) * w).sum(-1) < 0.5 * n
    P = torch.where(flip[..., None, None], -P, P)
    finite = solvable & torch.isfinite(P).flatten(-2).all(-1)  # svd raises on NaN: [I | 0]
    P = torch.where(finite[..., None, None], P, torch.eye(3, 4, dtype=P.dtype, device=P.device))
    U, S, Vt = torch.linalg.svd(P[..., :, :3])
    d = torch.linalg.det(U @ Vt)
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1))
    R = U @ D @ Vt
    t = P[..., :, 3] / (S.sum(-1) / 3.0).clamp(min=1e-12)[..., None]
    T = vo.make_T(R, t)
    ok = finite & (n >= 6) & torch.isfinite(T).flatten(-2).all(-1)
    return torch.where(ok[..., None, None], T, _eye4(T.shape[:-2], T)), ok


def reproj2(K, T, X, uv):
    """Squared reprojection error of X under world-in-camera T (inf behind)."""
    pc = mm(X, T[..., :3, :3].mT) + T[..., None, :3, 3]
    ph = mm(pc, K.mT)
    z = torch.where(ph[..., 2].abs() > 1e-12, ph[..., 2], torch.ones_like(ph[..., 2]))
    e2 = ((ph[..., :2] / z[..., None] - uv) ** 2).sum(-1)
    return torch.where(pc[..., 2] > 0, e2, math.inf)


def pnp_ransac(K, X, uv, valid, u, cam: vo.Cam, sample_size: int = 8, inlier_px: float = 8.0,
               polish_rounds: int = 10):
    """Robust PnP of B problems (X (B, N, 3), uv (B, N, 2), valid (B, N))
    from uniforms u (B, H, N).  Returns (T (B, 4, 4) world-in-camera, ok,
    inliers)."""
    B, N = X.shape[:2]
    H = u.shape[1]
    thr2 = inlier_px * inlier_px
    g = -torch.log(-torch.log(u)) + torch.where(valid, 0.0, -math.inf)[:, None, :]
    pick = torch.argsort(-g, dim=-1, stable=True)[..., :sample_size]
    sel = torch.zeros_like(g, dtype=torch.bool).scatter_(-1, pick, True) & valid[:, None, :]
    Xh, uvh = X[:, None].expand(B, H, N, 3), uv[:, None].expand(B, H, N, 2)
    Ts, ok_h = dlt(K, Xh, uvh, sel)
    votes = (valid[:, None, :] & (reproj2(K, Ts, Xh, uvh) < thr2) & ok_h[..., None]).sum(-1)
    best = votes.argmax(-1)  # the first of the most
    T_best = Ts[torch.arange(B, device=X.device), best]
    inl = valid & (reproj2(K, T_best, X, uv) < thr2)
    T_fit, ok_fit = dlt(K, X, uv, inl)
    T_fit = torch.where(ok_fit[:, None, None], T_fit, T_best)
    p = dict(kernel_threshold=9.0 * thr2, damping=1.0, max_iterations=polish_rounds,
             convergence_threshold=1e-6, min_num_inliers=0)
    T_pol = vo.picp(K, T_fit, X, uv, inl, cam, p)[0]
    T = torch.where(torch.isfinite(T_pol).flatten(-2).all(-1)[:, None, None], T_pol, T_fit)
    n_inl = (valid & (reproj2(K, T, X, uv) < thr2)).sum(-1)
    ok = (votes.gather(1, best[:, None])[:, 0] >= 6) & torch.isfinite(T).flatten(-2).all(-1)
    return torch.where(ok[:, None, None], T, _eye4((B,), T)), ok, n_inl


def loop_edges(K, poses, map_xyz, map_valid, uv, obs_lm, obs_valid, pairs, pvalid, u,
               cam: vo.Cam, fx: dict):
    """Loop edges (Z (E, 4, 4), w (E,) 0/1) of the pairs: the late frame's
    PnP on the valid landmarks it shares with the early one.  fx: the
    configuration's ``fixed_by_program``."""
    i, j = pairs[:, 0], pairs[:, 1]
    lm = obs_lm.long()
    lm_i = torch.where(obs_valid[i], lm[i], -1)
    lm_j = lm[j]
    shared = obs_valid[j] & map_valid[lm_j] & (lm_j[:, :, None] == lm_i[:, None, :]).any(-1)
    T_wic, ok, n_inl = pnp_ransac(K, map_xyz[lm_j], uv[j], shared, u, cam,
                                  fx["pnp_sample_size"], fx["pnp_inlier_px"],
                                  fx["pnp_polish_iterations"])
    Z = mm(vo.inv_se3(poses[i]), vo.inv_se3(T_wic))
    w = (pvalid & ok & (n_inl >= fx["min_shared"])).to(torch.float32)
    return torch.where((w > 0)[:, None, None], Z, _eye4(w.shape, Z)), w


# --------------------------------------------------------------------- PGO --
def _T(R, t):
    """(R, t) -> 4x4, without writing into a tensor (autodiff-friendly)."""
    row = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    row = row + torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    return torch.cat([torch.cat([R, t[..., None]], -1), row], -2)


def _so3_exp(w):
    th2 = (w * w).sum(-1)
    th = torch.sqrt(th2 + 1e-32)
    W = slam.skew(w)
    big = th2 > 1e-12
    a = torch.where(big, torch.sin(th) / th, 1.0 - th2 / 6.0)
    b = torch.where(big, (1.0 - torch.cos(th)) / th2, 0.5 - th2 / 24.0)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * W + b[..., None, None] * (W @ W)


def se3_exp(xi):
    """SE(3) exponential of (v, w), written without in-place writes."""
    v, w = xi[..., :3], xi[..., 3:]
    th2 = (w * w).sum(-1)
    th = torch.sqrt(th2 + 1e-32)
    W = slam.skew(w)
    big = th2 > 1e-12
    b = torch.where(big, (1.0 - torch.cos(th)) / th2, 0.5 - th2 / 24.0)
    c = torch.where(big, (th - torch.sin(th)) / (th2 * th), torch.full_like(th, 1.0 / 6.0))
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    V = eye + b[..., None, None] * W + c[..., None, None] * (W @ W)
    return _T(_so3_exp(w), (V @ v[..., None])[..., 0])


def _so3_log(R):
    """Axis-angle of R by atan2 (a finite derivative at the identity)."""
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    s2 = (v * v).sum(-1)
    sin = 0.5 * torch.sqrt(s2 + 1e-24)
    cos = torch.clamp((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) * 0.5, -1.0, 1.0)
    th = torch.atan2(sin, cos)
    return v * torch.where(s2 > 1e-12, th / (2.0 * sin), 0.5 + th * th / 12.0)[..., None]


def se3_log(T):
    """(v, w) with se3_exp(v, w) = T: w = log R, v = V(w)^-1 t."""
    w = _so3_log(T[..., :3, :3])
    th2 = (w * w).sum(-1)
    h = 0.5 * torch.sqrt(th2 + 1e-32)
    W = slam.skew(w)
    coef = torch.where(th2 > 1e-12,
                       (1.0 - h * torch.cos(h) / torch.clamp(torch.sin(h), min=1e-20)) / th2,
                       1.0 / 12.0 + th2 / 720.0)
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    Vinv = eye - 0.5 * W + coef[..., None, None] * (W @ W)
    return torch.cat([(Vinv @ T[..., :3, 3:])[..., 0], w], -1)


def _inv(T):
    R = T[..., :3, :3].mT
    return _T(R, -(R @ T[..., :3, 3:])[..., 0])


def edge_residual(Ti, Tj, Z):
    return se3_log(_inv(Z) @ _inv(Ti) @ Tj)


def _edge_one(xi, Ti, Tj, Z):
    # one edge with a leading axis of 1, so that forward-mode autodiff
    # sees tensors throughout
    xi, Ti, Tj, Z = xi[None], Ti[None], Tj[None], Z[None]
    return edge_residual(se3_exp(xi[:, :6]) @ Ti, se3_exp(xi[:, 6:]) @ Tj, Z)[0]


def edge_jacobians(Ti, Tj, Z):
    """Residuals (E, 6) and their Jacobians (E, 6, 6) by left perturbations
    of T_i and of T_j."""
    xi = torch.zeros(Ti.shape[:-2] + (12,), dtype=Ti.dtype, device=Ti.device)
    J = torch.func.vmap(torch.func.jacfwd(_edge_one))(xi, Ti, Tj, Z)
    return edge_residual(Ti, Tj, Z), J[..., :6], J[..., 6:]


def graph_edges(poses, pairs, Z, w, odo_weight: float, loop_weight: float):
    """(edges_ij, edges_T, edges_w): odometry (i, i+1), then the loop edges."""
    F = poses.shape[0]
    ii = torch.arange(F - 1, device=poses.device)
    odo = mm(vo.inv_se3(poses[:-1]), poses[1:])
    return (torch.cat([torch.stack([ii, ii + 1], -1), pairs.long()]), torch.cat([odo, Z]),
            torch.cat([torch.full((F - 1,), odo_weight, device=poses.device), loop_weight * w]))


def pgo_chi(poses, eij, eT, ew, thr: float):
    r = edge_residual(poses[eij[:, 0]], poses[eij[:, 1]], eT)
    chi = (r * r).sum(-1)
    return torch.where(ew > 0, ew * chi.clamp(max=thr), 0.0).sum()


def pgo_iteration(poses, lam, chi_prev, eij, eT, ew, fixed, thr: float,
                  damping: float = 1e-6):
    """One Levenberg-Marquardt iteration of the pose graph from (poses,
    lam, its truncated chi).  Returns (poses, lam, chi, accepted)."""
    F = poses.shape[0]
    dev = poses.device
    i, j = eij[:, 0], eij[:, 1]
    free = (~fixed).repeat_interleave(6).to(poses.dtype)
    r, Ji, Jj = edge_jacobians(poses[i], poses[j], eT)
    chi = (r * r).sum(-1)
    we = ew * torch.where(chi <= thr, 1.0, torch.sqrt(thr / chi.clamp(min=1e-20))) * (ew > 0)
    Hij = ein("eki,ekj,e->eij", Ji, Jj, we)
    H = torch.zeros(F * F, 6, 6, device=dev)
    for tgt, blk in ((i * F + i, ein("eki,ekj,e->eij", Ji, Ji, we)),
                     (j * F + j, ein("eki,ekj,e->eij", Jj, Jj, we)),
                     (i * F + j, Hij), (j * F + i, Hij.mT)):
        H.index_add_(0, tgt, blk)
    b = torch.zeros(F, 6, device=dev)
    b.index_add_(0, i, ein("eki,ek,e->ei", Ji, r, we))
    b.index_add_(0, j, ein("eki,ek,e->ei", Jj, r, we))
    S = H.view(F, F, 6, 6).permute(0, 2, 1, 3).reshape(6 * F, 6 * F)
    S = S * free[:, None] * free[None, :] + torch.diag(lam * free + (1.0 - free))
    Lc, info = torch.linalg.cholesky_ex(S)
    dx = torch.cholesky_solve(-(b.reshape(-1) * free)[:, None], Lc)[:, 0]
    dx = torch.where(info == 0, dx, torch.full_like(dx, math.nan)).view(F, 6)
    new = torch.where(fixed[:, None, None], poses, mm(se3_exp(dx), poses))
    chi_new = pgo_chi(new, eij, eT, ew, thr)
    accept = torch.isfinite(chi_new) & torch.isfinite(new).all() & (chi_new <= chi_prev)
    return (torch.where(accept, new, poses),
            torch.where(accept, (lam * 0.5).clamp(min=damping), (lam * 4.0).clamp(max=1e8)),
            torch.where(accept, chi_new, chi_prev), accept)


def pgo(poses, eij, eT, ew, fixed, iterations: int, thr: float, damping: float = 1e-6,
        damping_init: float = 1e-3, record=None):
    """The pose-graph solve: ``iterations`` LM iterations from damping_init.
    Returns (poses, robust chi); ``record`` as the program's."""
    chi = pgo_chi(poses, eij, eT, ew, thr)
    lam = torch.tensor(damping_init, device=poses.device)
    its = record.setdefault("iterations", []) if record is not None else None
    for _ in range(iterations):
        if its is not None:
            its.append(dict(poses=poses, lam=lam, chi=chi))
        poses, lam, chi, _ = pgo_iteration(poses, lam, chi, eij, eT, ew, fixed, thr, damping)
    if its is not None:
        its.append(dict(poses=poses, lam=lam, chi=chi))
    return poses, chi


# ------------------------------------------------------------ global sweep --
def ba_cost(K, wic, X, point_valid, obs_uv, obs_lm, obs_valid, thr: float):
    """The truncated objective: sum min(e·e, thr) over valid observations,
    thr for one behind its camera."""
    lm = obs_lm.long().clamp(0, X.shape[0] - 1)
    return slam._cost(K, wic, X[lm], obs_uv, obs_valid & point_valid[lm], thr)


def ba_iteration(wic, X, lam, cost, point_valid, obs_uv, obs_lm, obs_valid, fixed, K,
                 thr: float, keep_outliers: bool, damping: float = 1e-6):
    """One Levenberg-Marquardt iteration of the BA from world-in-camera
    poses wic (F, 4, 4), points X (L, 3), lam and the truncated cost there.
    Returns (wic, X, lam, cost, accepted, (chi, inliers) of the
    linearisation point)."""
    F, N = obs_lm.shape
    L = X.shape[0]
    dev = X.device
    lm = obs_lm.long().clamp(0, L - 1)
    valid = obs_valid & point_valid[lm]
    free6 = (~fixed).repeat_interleave(6).to(X.dtype)
    idx = lm.reshape(-1)
    fidx = torch.arange(F, device=dev)[:, None].expand(F, N).reshape(-1)
    A, B, e, w, _ = slam._linearize(K, wic, X[lm], obs_uv, valid, thr)
    chi = (e * e).sum(-1)
    ok = valid & ((mm(X[lm], wic[:, :3, :3].mT) + wic[:, None, :3, 3])[..., 2] > 0)
    if keep_outliers:
        w = ok * torch.where(chi <= thr, 1.0, torch.sqrt(thr / chi.clamp(min=1e-20)))
    stat = ((chi * (w > 0) * w.clamp(max=1.0)).sum(), (ok & (chi <= thr)).sum())
    Hpp = ein("fnki,fnkj,fn->fij", A, A, w)
    bp = ein("fnki,fnk,fn->fi", A, e, w)
    Hll = torch.zeros(L, 3, 3, device=dev).index_add_(
        0, idx, ein("fnki,fnkj,fn->fnij", B, B, w).reshape(-1, 3, 3))
    bl = torch.zeros(L, 3, device=dev).index_add_(
        0, idx, ein("fnki,fnk,fn->fni", B, e, w).reshape(-1, 3))
    Wfl = torch.zeros(L * F, 6, 3, device=dev).index_add_(
        0, idx * F + fidx, ein("fnki,fnkj,fn->fnij", A, B, w).reshape(-1, 6, 3)
    ).view(L, F, 6, 3)
    Hs = 0.5 * (Hll + Hll.mT)
    tr = Hs.diagonal(dim1=-2, dim2=-1).sum(-1)
    Hinv = torch.linalg.inv_ex(Hs + (lam * (tr / 3.0 + 1.0) + 1e-5 * tr)[:, None, None]
                               * torch.eye(3, device=dev))[0]
    Hinv = torch.where(torch.isfinite(Hinv).flatten(1).all(1)[:, None, None], Hinv, 0.0)
    WH = ein("lfij,ljk->lfik", Wfl, Hinv)
    S = -ein("lfik,lgjk->figj", WH, Wfl) + ein("fij,fg->figj", Hpp, torch.eye(F, device=dev))
    b = (bp - ein("lfik,lk->fi", WH, bl)).reshape(-1) * free6
    S = S.reshape(6 * F, 6 * F) * free6[:, None] * free6[None, :]
    S = S + torch.diag(lam * (S.diagonal() + 1.0) * free6 + (1.0 - free6))
    Lc, info = torch.linalg.cholesky_ex(S)
    dx = torch.cholesky_solve(-b[:, None], Lc)[:, 0]
    dx = torch.where(info == 0, dx, torch.full_like(dx, math.nan)).view(F, 6)
    dl = -ein("lij,lj->li", Hinv, bl + ein("lfij,fi->lj", Wfl, dx))
    wic_new = torch.where(fixed[:, None, None], wic, mm(slam.se3_exp(dx), wic))
    touched = Hll.diagonal(dim1=-2, dim2=-1).sum(-1) > 0
    X_new = torch.where((point_valid & touched)[:, None], X + dl, X)
    cost_new = slam._cost(K, wic_new, X_new[lm], obs_uv, valid, thr)
    accept = (torch.isfinite(cost_new) & torch.isfinite(wic_new).all()
              & torch.isfinite(X_new).all() & (cost_new <= cost))
    return (torch.where(accept, wic_new, wic), torch.where(accept, X_new, X),
            torch.where(accept, (lam * 0.5).clamp(min=damping), (lam * 4.0).clamp(max=1e8)),
            torch.where(accept, cost_new, cost), accept, stat)


def sweep(poses, points, point_valid, obs_uv, obs_lm, obs_valid, K, thr: float,
          keep_outliers: bool, iterations: int = 15, damping: float = 1e-6,
          damping_init: float = 1.0, record=None):
    """One global BA sweep from camera-in-world poses (F, 4, 4) and the
    map's points (L, 3), poses 0 and 1 fixed.  Returns (poses, points, chi,
    inliers, skipped); ``record`` as the program's ``ba_solve``'s (never
    compacted)."""
    F = obs_lm.shape[0]
    dev = points.device
    fixed = torch.arange(F, device=dev) < 2
    wic, X = vo.inv_se3(poses), points
    cost = ba_cost(K, wic, X, point_valid, obs_uv, obs_lm, obs_valid, thr)
    chi_out, inl_out = cost, torch.zeros((), dtype=torch.long, device=dev)
    lam = torch.tensor(damping_init, device=dev)
    its = None
    if record is not None:
        its = []
        record.update(obs_lm=obs_lm, point_valid=point_valid, fixed=fixed, slots=None,
                      iterations=its)
    for _ in range(iterations):
        if its is not None:
            its.append(dict(poses=wic, points=X, lam=lam, chi=cost))
        wic, X, lam, cost, accept, (chi_s, inl_s) = ba_iteration(
            wic, X, lam, cost, point_valid, obs_uv, obs_lm, obs_valid, fixed, K, thr,
            keep_outliers, damping)
        chi_out = torch.where(accept, chi_s, chi_out)
        inl_out = torch.where(accept, inl_s, inl_out)
    if its is not None:
        its.append(dict(poses=wic, points=X, lam=lam, chi=cost))
    ok = torch.isfinite(wic).all()
    poses_out = torch.where((ok & ~fixed)[:, None, None], vo.inv_se3(wic), poses)
    points_out = torch.where((ok & torch.isfinite(X).all(1))[:, None], X, points)
    return poses_out, points_out, chi_out, inl_out, ~ok


def sweep_count(chis, n_sweeps: int, max_sweeps: int, rel: float) -> int:
    """How many sweeps the stopping rule runs given each sweep's chi in
    turn: the count at which it stops, or len(chis) + 1 when it has not
    stopped by the last of them."""
    prev = None
    for i, chi in enumerate(chis):
        n = i + 1
        if n >= max(max_sweeps, n_sweeps):
            return n
        if n >= n_sweeps and n > 1 and prev is not None and chi >= prev * (1.0 - rel):
            return n
        if i > 0:
            prev = chi
    return len(chis) + 1


# ------------------------------------------------------------ whole refine --
def refine(map_xyz, map_desc, map_valid, frames: dict, poses, cam: vo.Cam, match: dict,
           prm: dict) -> tuple:
    """The whole refine closed loop on its own outputs (the control), its
    stages recorded in the layout of the program's ``record``.  prm: the
    configuration's ``refine`` block with ``fixed_by_program`` merged in.
    Returns (poses, points, record)."""
    K = cam.K
    F, N = frames["valid"].shape
    fx = prm["fixed_by_program"]
    obs_lm, obs_valid = topology(map_desc, map_valid, frames["desc"], frames["valid"],
                                 match["distance_threshold"], match["ratio_threshold"])
    C = covisibility(obs_lm, obs_valid, map_valid)
    pairs, pvalid = loop_pairs(C, fx["min_gap"], fx["min_shared"], fx["max_edges"])
    u = uniforms((fx["max_edges"], fx["ransac_hypotheses"], N), poses.device,
                 fx["ransac_seed"])
    Z, w = loop_edges(K, poses, map_xyz, map_valid, frames["uv"], obs_lm, obs_valid, pairs,
                      pvalid, u, cam, fx)
    eij, eT, ew = graph_edges(poses, pairs, Z, w, fx["odo_weight"], fx["loop_weight"])
    fixed = torch.arange(F, device=poses.device) < 1
    solves = {}, {}
    l2, _ = pgo(poses, eij, eT, ew, fixed, fx["pgo_iterations"], 1.0e8, record=solves[0])
    rob, chi = pgo(l2, eij, eT, ew, fixed, max(fx["pgo_iterations"] // 3, 10), 1.0,
                   record=solves[1])
    ok = torch.isfinite(rob).all() & ((w > 0).sum() > 0)
    p = torch.where(ok, rob, poses)
    rec = dict(poses_in=poses, obs_lm=obs_lm, obs_valid=obs_valid,
               loops=dict(covis=C, pairs=pairs, pairs_valid=pvalid, uniforms=u, Z=Z, w=w,
                          pgo_l2=l2, pgo_robust=rob, pgo_chi=chi, poses_pgo=p,
                          pgo_l2_solve=solves[0], pgo_robust_solve=solves[1]), sweeps=[])
    ba = prm["ba"]
    x, chis = map_xyz, []
    n_max = max(fx["max_sweeps"], prm["n_sweeps"])
    while len(chis) < n_max:
        coarse = not chis
        solve = {}
        p2, x2, chi_s, inl, skipped = sweep(
            p, x, map_valid, frames["uv"], obs_lm, obs_valid, K,
            max(ba["huber_threshold"], 1.0e8) if coarse else ba["huber_threshold"], coarse,
            ba["iterations"], record=solve)
        rec["sweeps"].append(dict(kind="coarse" if coarse else "fine", poses_before=p,
                                  points_before=x, poses_after=p2, points_after=x2, chi=chi_s,
                                  inliers=inl, skipped=skipped, solve=solve))
        p, x = p2, x2
        chis.append(float(chi_s))
        if sweep_count(chis, prm["n_sweeps"], fx["max_sweeps"],
                       fx["rel_improvement_stop"]) == len(chis):
            break
    return p, x, rec
