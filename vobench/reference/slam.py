"""Plain reference of one SLAM step: the tracking step of ``vo.step``, the
frame's observations written to its ring-buffer row, and, when due, the
local bundle adjustment of the window of keyframes ending at the frame.
Plain PyTorch float32; it imports nothing of the program.

The local BA, as the configuration states it:
  * the window: W frames spaced S apart ending at frame k, the first two
    fixed (gauge and scale); its observations are the frames' ring rows
    (map slot, pixel, valid);
  * its landmarks: the observed slots in ascending order, at most
    ``compact_cap - 1`` of them (the rest are left out of the solve);
  * residuals e = pi(K T_f X_l) - uv; an observation counts when it is
    valid, its landmark is valid and in front of the camera, and e·e is at
    most the Huber threshold (outliers carry no weight);
  * Levenberg-Marquardt on the Schur complement: each landmark's 3x3 block
    damped by lambda (tr/3 + 1) + 1e-5 tr and inverted, the reduced camera
    system's free diagonal scaled by (1 + lambda) plus lambda, fixed poses
    pinned; the pose step is SE(3)'s exponential (v, w) applied on the
    left, the landmark step back-substituted; a step is kept when finite
    and it does not raise the truncated cost sum(min(e·e, thr)) (an
    observation behind the camera costs thr), lambda halved (not below
    the BA damping) on a kept step and multiplied by 4 (at most 1e8) on a
    rejected one;
  * the solve's poses (not the fixed ones) and landmarks are written back
    when all are finite.
"""

from __future__ import annotations

import torch

from vobench.reference import vo
from vobench.reference.vo import ein, mm


def skew(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def se3_exp(xi):
    """SE(3) exponential of twists (..., 6) = (v, w)."""
    v, w = xi[..., :3], xi[..., 3:]
    th2 = (w * w).sum(-1)
    th = torch.sqrt(th2 + 1e-32)
    W = skew(w)
    W2 = W @ W
    big = th2 > 1e-12
    a = torch.where(big, torch.sin(th) / th, 1.0 - th2 / 6.0)
    b = torch.where(big, (1.0 - torch.cos(th)) / th2, 0.5 - th2 / 24.0)
    c = torch.where(big, (th - torch.sin(th)) / (th2 * th), torch.full_like(th, 1.0 / 6.0))
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    return vo.make_T(R, (V @ v[..., None])[..., 0])


def _linearize(K, wic, X, uv, valid, thr):
    """Per observation (W, N): pose Jacobian (2x6), point Jacobian (2x3),
    residual, weight (1 for a counted inlier), truncated cost."""
    pc = mm(X, wic[:, :3, :3].mT) + wic[:, None, :3, 3]
    ph = mm(pc, K.mT)
    z = ph[..., 2]
    iz = 1.0 / torch.where(z.abs() > 1e-12, z, torch.ones_like(z))
    uv_hat = ph[..., :2] * iz[..., None]
    Jp = torch.stack([torch.stack([iz, torch.zeros_like(iz), -ph[..., 0] * iz * iz], -1),
                      torch.stack([torch.zeros_like(iz), iz, -ph[..., 1] * iz * iz], -1)], -2)
    JK = mm(Jp, K)                                        # (W, N, 2, 3)
    A = torch.cat([JK, mm(JK, skew(-pc))], -1)            # (W, N, 2, 6)
    B = mm(JK, wic[:, None, :3, :3])                      # (W, N, 2, 3)
    front = pc[..., 2] > 0
    ok = valid & front
    e = torch.where(ok[..., None], uv_hat - uv, 0.0)
    chi = (e * e).sum(-1)
    w = (ok & (chi <= thr)).to(chi.dtype)
    A = torch.where(ok[..., None, None], A, 0.0)
    B = torch.where(ok[..., None, None], B, 0.0)
    cost = torch.where(valid, torch.where(front, chi.clamp(max=thr), thr), 0.0).sum()
    return A, B, e, w, cost


def _cost(K, wic, X, uv, valid, thr):
    return _linearize(K, wic, X, uv, valid, thr)[4]


def ba_solve(wic, points, point_valid, obs_uv, obs_lm, obs_valid, fixed, K, p: dict):
    """The local BA over the window (W world-in-camera poses) and the map's
    points (C, 3).  Returns (wic', points')."""
    Wn, N = obs_lm.shape
    C = points.shape[0]
    dev = points.device
    La = min(C, Wn * N + 1, p["compact_cap"])
    # the observed slots in ascending order, at most La - 1 of them
    lm = obs_lm.long()
    ids = torch.unique(lm[obs_valid])
    active = ids[:La - 1]
    n_act = active.numel()
    remap = torch.full((C + 1,), La - 1, dtype=torch.long, device=dev)
    remap[active] = torch.arange(n_act, device=dev)
    new_lm = torch.where(obs_valid, remap[lm.clamp(0, C)], La - 1)
    X = torch.zeros(La, 3, device=dev)
    X[:n_act] = points[active]
    pv = torch.zeros(La, dtype=torch.bool, device=dev)
    pv[:n_act] = point_valid[active]
    valid = obs_valid & pv[new_lm]
    thr = p["huber_threshold"]
    free6 = (~fixed).repeat_interleave(6).to(points.dtype)
    lam = torch.tensor(p["damping_init"], device=dev)
    cost = _cost(K, wic, X[new_lm], obs_uv, valid, thr)
    eye3 = torch.eye(3, device=dev)
    for _ in range(p["iterations"]):
        A, B, e, w, _ = _linearize(K, wic, X[new_lm], obs_uv, valid, thr)
        Hpp = ein("fnki,fnkj,fn->fij", A, A, w)
        bp = ein("fnki,fnk,fn->fi", A, e, w)
        idx = new_lm.reshape(-1)
        Hll = torch.zeros(La, 3, 3, device=dev).index_add_(
            0, idx, ein("fnki,fnkj,fn->fnij", B, B, w).reshape(-1, 3, 3))
        bl = torch.zeros(La, 3, device=dev).index_add_(
            0, idx, ein("fnki,fnk,fn->fni", B, e, w).reshape(-1, 3))
        fidx = torch.arange(Wn, device=dev)[:, None].expand(Wn, N).reshape(-1)
        Wfl = torch.zeros(La * Wn, 6, 3, device=dev).index_add_(
            0, idx * Wn + fidx, ein("fnki,fnkj,fn->fnij", A, B, w).reshape(-1, 6, 3)
        ).view(La, Wn, 6, 3)
        Hs = 0.5 * (Hll + Hll.mT)
        tr = Hs.diagonal(dim1=-2, dim2=-1).sum(-1)
        lam_l = lam * (tr / 3.0 + 1.0) + 1e-5 * tr
        Hinv = torch.linalg.inv_ex(Hs + lam_l[:, None, None] * eye3)[0]
        Hinv = torch.where(torch.isfinite(Hinv).flatten(1).all(1)[:, None, None], Hinv, 0.0)
        WH = ein("lfij,ljk->lfik", Wfl, Hinv)
        S = -ein("lfik,lgjk->figj", WH, Wfl)
        S = S + ein("fij,fg->figj", Hpp, torch.eye(Wn, device=dev))
        b = (bp - ein("lfik,lk->fi", WH, bl)).reshape(-1)
        S = S.reshape(6 * Wn, 6 * Wn) * free6[:, None] * free6[None, :]
        S = S + torch.diag(lam * (S.diagonal() + 1.0) * free6 + (1.0 - free6))
        b = b * free6
        Lc, info = torch.linalg.cholesky_ex(S)
        dx = torch.cholesky_solve(-b[:, None], Lc)[:, 0]
        dx = torch.where(info == 0, dx, torch.full_like(dx, float("nan"))).view(Wn, 6)
        dl = -ein("lij,lj->li", Hinv, bl + ein("lfij,fi->lj", Wfl, dx))
        wic_new = torch.where(fixed[:, None, None], wic, se3_exp(dx) @ wic)
        touched = Hll.diagonal(dim1=-2, dim2=-1).sum(-1) > 0
        X_new = torch.where((pv & touched)[:, None], X + dl, X)
        cost_new = _cost(K, wic_new, X_new[new_lm], obs_uv, valid, thr)
        fin = (torch.isfinite(cost_new) & torch.isfinite(wic_new).all()
               & torch.isfinite(X_new).all())
        accept = fin & (cost_new <= cost)
        wic = torch.where(accept, wic_new, wic)
        X = torch.where(accept, X_new, X)
        cost = torch.where(accept, cost_new, cost)
        lam = torch.where(accept, (lam * 0.5).clamp(min=p["damping"]), (lam * 4.0).clamp(max=1e8))
    out = points.clone()
    out[active] = X[:n_act]
    return wic, out


def step(c: dict, k: int, curr: dict, nxt: dict, cam: vo.Cam, cfg: dict, ba: dict) -> dict:
    """The reference's SLAM step at frame k from carry ``c`` (one sequence,
    no lane axis): the VO state's pose, map_xyz, map_desc, map_id_meas,
    map_valid, map_last_seen, map_count, and poses_all (F, 4, 4), buf_lm
    (R, Nb), buf_valid, buf_uv (R, Nb, 2).  Returns the new carry (``c`` is
    not changed), the step's NewPoints and its extras (``vo.step``)."""
    K = cam.K
    C = c["map_valid"].shape[0]
    mp = vo.Map(c["map_xyz"][None], c["map_desc"][None], c["map_valid"][None],
                c["map_valid"].sum()[None])
    pose, new, ex = vo.step(c["pose"][None], mp, {k_: v[None] for k_, v in curr.items()},
                            {k_: v[None] for k_, v in nxt.items()}, cam, cfg, extras=True)
    out = {k_: v.clone() for k_, v in c.items()}
    ok = new.ok[0]
    slot = (mp.count[0] + torch.cumsum(ok.long(), 0) - 1)
    s = slot[ok]
    out["map_xyz"][s] = new.xyz[0][ok]
    out["map_desc"][s] = ex["desc"][0][ok]
    out["map_id_meas"][s] = new.id_meas[0][ok].to(out["map_id_meas"].dtype)
    out["map_valid"][s] = True
    out["map_last_seen"][s] = k
    out["map_count"] = out["map_valid"].sum().to(out["map_count"].dtype)
    out["poses_all"][k] = pose[0]
    R = ba["window"] * ba["stride"]
    r = k % R
    new_slots = torch.where(ok, slot, C)
    out["buf_lm"][r] = torch.cat([ex["map_idx"][0], new_slots]).to(out["buf_lm"].dtype)
    out["buf_valid"][r] = torch.cat([ex["map_valid"][0], ok])
    out["buf_uv"][r] = torch.cat([nxt["uv"], torch.where(ex["cand"][0][:, None],
                                                         ex["uv2"][0], 0.0)])
    if k >= ba["window"] * ba["stride"] and k % ba["every"] == 0:
        Wn, S = ba["window"], ba["stride"]
        idxs = k - S * (Wn - 1 - torch.arange(Wn, device=K.device))
        ring = idxs % R
        win = out["poses_all"][idxs]
        wic, pts = ba_solve(vo.inv_se3(win), out["map_xyz"], out["map_valid"],
                            out["buf_uv"][ring], out["buf_lm"][ring], out["buf_valid"][ring],
                            torch.arange(Wn, device=K.device) < 2, K, ba)
        fin = torch.isfinite(wic).all() & torch.isfinite(pts).all()
        fixed = torch.arange(Wn, device=K.device) < 2
        out["poses_all"][idxs] = torch.where((fin & ~fixed)[:, None, None], vo.inv_se3(wic), win)
        out["map_xyz"] = torch.where(fin, pts, out["map_xyz"])
    out["pose"] = out["poses_all"][k].clone()
    return out, new, ex
