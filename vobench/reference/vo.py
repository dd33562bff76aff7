"""Plain reference of the monocular tracker: the two-view bootstrap and one
tracking step, written from the algorithm's description in plain PyTorch
float32 (``torch.linalg`` for the small eigen-, singular-value and linear
solves).  It imports nothing of the program.

Every function takes a leading axis L of independent problems (a lane, a
sequence, or a (lane, frame) pair of a teacher-forced check).  The
products are ``torch.matmul`` / ``einsum``, so the same code run with TF32
allowed on the card is the lower-precision control.

The products go through ``mm`` / ``ein``, where the control's emulated TF32
can round their inputs (``set_lower``); the reference itself runs them as
they are, with TF32 off.

The semantics followed, each as the program's configuration states it:
  * match: squared-L2 best and second best over the valid targets, the
    first index on a tie; accept when best < distance threshold and
    best / second < ratio threshold (an infinite second passes);
  * bootstrap: 8-point RANSAC over Gumbel-top-k minimal sets drawn from
    the run's uniforms, Sampson inliers under (1 px / fx)^2, the first
    hypothesis with the most inliers, a weighted refit kept when it loses
    no inlier, cheirality voting over the four (R, t) with depths in
    (0, 50), every match triangulated (DLT, 2 Gauss-Newton polishes) and
    appended in order;
  * step: 2D-3D match against the map, projective ICP (Gauss-Newton on
    SE(3), Euler update, saturating kernel, relative-chi stop) from the
    previous pose, 2D-2D match of the current frame against the next,
    the unmapped matches compacted in order to the per-frame cap,
    triangulated from both poses, gated (reprojection, parallax, finite)
    and appended in order up to the map's capacity.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


# The products' inputs pass through LOWER: None in the reference; the
# control's emulation of TF32 on a machine without it (``set_lower``).
LOWER = None


def set_lower(mode):
    """None, or "tf32": round every product's inputs to TF32's 10 mantissa
    bits (to nearest), as the tensor cores do when TF32 is allowed."""
    global LOWER
    LOWER = None if mode is None else _tf32


def _tf32(x):
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def eigh(A, chunk: int = 16384):
    """``torch.linalg.eigh`` of a batch of small symmetric matrices, in
    chunks of the flattened batch (cuSOLVER's batched solver refuses very
    large batches)."""
    flat = A.reshape((-1,) + A.shape[-2:])
    parts = [torch.linalg.eigh(flat[i:i + chunk]) for i in range(0, flat.shape[0], chunk)]
    w = torch.cat([p[0] for p in parts]).reshape(A.shape[:-1])
    v = torch.cat([p[1] for p in parts]).reshape(A.shape)
    return w, v


def mm(a, b):
    if LOWER is not None:
        a, b = LOWER(a), LOWER(b)
    return a @ b


def ein(eq, *ops):
    if LOWER is not None:
        ops = [LOWER(o) for o in ops]
    return torch.einsum(eq, *ops)


class Cam(NamedTuple):
    K: torch.Tensor  # (3, 3)
    width: int
    height: int


def inv_se3(T):
    R = T[..., :3, :3].mT
    t = -(R @ T[..., :3, 3:])[..., 0]
    return make_T(R, t)


def make_T(R, t):
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def euler_T(v):
    """6-vector -> SE(3): R = Rx(v3) Ry(v4) Rz(v5), t = v[:3]."""
    a, b, c = v[..., 3], v[..., 4], v[..., 5]
    o, z = torch.ones_like(a), torch.zeros_like(a)
    rx = torch.stack([o, z, z, z, a.cos(), -a.sin(), z, a.sin(), a.cos()], -1)
    ry = torch.stack([b.cos(), z, b.sin(), z, o, z, -b.sin(), z, b.cos()], -1)
    rz = torch.stack([c.cos(), -c.sin(), z, c.sin(), c.cos(), z, z, z, o], -1)
    sh = v.shape[:-1] + (3, 3)
    return make_T(rx.view(sh) @ ry.view(sh) @ rz.view(sh), v[..., :3])


# ------------------------------------------------------------------ match --
class Match(NamedTuple):
    idx: torch.Tensor    # (L, N) int64
    valid: torch.Tensor  # (L, N) bool


def match(desc1, valid1, desc2, valid2, dist_thr: float, ratio_thr: float) -> Match:
    d = ((desc1 * desc1).sum(-1)[..., :, None] + (desc2 * desc2).sum(-1)[..., None, :]
         - 2.0 * mm(desc1, desc2.mT))
    d = torch.where(valid2[..., None, :], d, math.inf)
    best, idx = d.min(-1)  # the first index of the minimum
    d2 = d.scatter(-1, idx[..., None], math.inf)
    second = d2.min(-1).values
    ok = valid1 & (best < dist_thr) & (best / second < ratio_thr)
    return Match(idx, ok)


def take(x, idx):
    """x[l, idx[l, n]] for x (L, M, ...) and idx (L, N)."""
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2))
                        .expand(idx.shape + x.shape[2:]))


# ---------------------------------------------------------- triangulation --
def project(K, wic, X):
    """(uv (L, N, 2), in front and inside the image, depth) of world points
    X (L, N, 3) under world-in-camera wic (L, 4, 4)."""
    pc = mm(X, wic[:, :3, :3].mT) + wic[:, None, :3, 3]
    ph = mm(pc, K.mT)
    z = ph[..., 2]
    uv = ph[..., :2] / torch.where(z.abs() > 1e-12, z, torch.ones_like(z))[..., None]
    return uv, pc


def in_image(uv, pc, cam: Cam):
    return ((pc[..., 2] > 0) & (uv[..., 0] >= 0) & (uv[..., 0] <= cam.width - 1)
            & (uv[..., 1] >= 0) & (uv[..., 1] <= cam.height - 1))


def triangulate(P1, P2, uv1, uv2, polish: int):
    """Inhomogeneous DLT of (L, N, 2) correspondences under (L, 3, 4)
    projections, each row scaled to unit norm, then ``polish``
    Gauss-Newton steps on the two-view reprojection error (a step is kept
    for a point only when finite and not worse).  Returns (X (L, N, 3),
    finite: the normal matrix's determinant is not ~0)."""
    def rows(P, uv):
        return torch.stack([uv[..., 0:1] * P[:, None, 2] - P[:, None, 0],
                            uv[..., 1:2] * P[:, None, 2] - P[:, None, 1]], -2)

    A = torch.cat([rows(P1, uv1), rows(P2, uv2)], -2)  # (L, N, 4, 4)
    A = A / A.norm(dim=-1, keepdim=True).clamp(min=1e-20)
    A3, a4 = A[..., :3], A[..., 3]
    N = mm(A3.mT, A3)
    det = torch.linalg.det(N)
    X = torch.linalg.solve_ex(N, -mm(A3.mT, a4[..., None]))[0][..., 0]
    Ps = torch.stack([P1, P2], 1)        # (L, 2, 3, 4)
    uvs = torch.stack([uv1, uv2], 2)     # (L, N, 2, 2)

    def resid(X):
        h = ein("lvij,lnj->lnvi", Ps[..., :3], X) + Ps[:, None, :, :, 3]
        z = h[..., 2]
        z = torch.where(z.abs() > 1e-12, z, torch.full_like(z, 1e-12))
        return h[..., :2] / z[..., None] - uvs, h, z

    eye = torch.eye(3, dtype=X.dtype, device=X.device)
    for _ in range(polish):
        r, h, z = resid(X)
        u = h[..., :2] / z[..., None]
        J = (Ps[:, None, :, :2, :3] - u[..., None] * Ps[:, None, :, 2:3, :3]) / z[..., None, None]
        J = J.flatten(-3, -2)            # (L, N, 4, 3)
        r = r.flatten(-2)                # (L, N, 4)
        H = mm(J.mT, J) + 1e-6 * eye
        g = mm(J.mT, r[..., None])[..., 0]
        Xn = X + torch.linalg.solve_ex(H, -g[..., None])[0][..., 0]
        rn = resid(Xn)[0].flatten(-2)
        keep = torch.isfinite(Xn).all(-1) & ((rn * rn).sum(-1) <= (r * r).sum(-1))
        X = torch.where(keep[..., None], Xn, X)
    return X, det.abs() > 1e-12


# ---------------------------------------------------------------- the map --
class Map(NamedTuple):
    xyz: torch.Tensor      # (L, C, 3)
    desc: torch.Tensor     # (L, C, D)
    valid: torch.Tensor    # (L, C) bool
    count: torch.Tensor    # (L,) int64


class NewPoints(NamedTuple):
    """What a bootstrap or step appends, in append order: per problem
    (L, Kc) rows with ``ok`` marking those that landed in the map, and the
    geometry of each one's two viewing rays (``rays``): their angle
    (radians) and the lesser depth (m) where they meet."""

    xyz: torch.Tensor
    id_meas: torch.Tensor
    id_real: torch.Tensor
    ok: torch.Tensor
    ray: torch.Tensor
    depth: torch.Tensor


def rays(K, wic1, wic2, uv1, uv2):
    """(angle, depth) of the viewing rays of pixels uv1 (view 1) and uv2
    (view 2), (L, N): the angle between the two world-frame rays, and the
    lesser of the two depths along them at their closest approach.  A small
    angle (a far point, or one near the direction of travel) or a small
    depth (the rays meet at a camera: no baseline) leaves the two-view
    triangulation ill-posed, whatever the arithmetic."""
    Kinv = torch.linalg.inv(K)

    def ray(wic, uv):
        d = (torch.cat([uv, torch.ones_like(uv[..., :1])], -1) @ Kinv.mT) @ wic[:, :3, :3]
        return d / d.norm(dim=-1, keepdim=True)

    d1, d2 = ray(wic1, uv1), ray(wic2, uv2)
    c1, c2 = inv_se3(wic1)[:, None, :3, 3], inv_se3(wic2)[:, None, :3, 3]
    b = (d1 * d2).sum(-1)
    w0 = c1 - c2
    d, e = (d1 * w0).sum(-1), (d2 * w0).sum(-1)
    den = (1.0 - b * b).clamp(min=1e-12)
    lam1, lam2 = (b * e - d) / den, (e - b * d) / den
    angle = torch.atan2(torch.linalg.cross(d1, d2).norm(dim=-1), b)
    return angle, torch.minimum(lam1, lam2)


def append(count, capacity: int, keep):
    """(ok, slot) of the kept candidates (L, K) appended in order from
    ``count`` (L,) into a map of ``capacity`` slots."""
    pos = count[:, None] + torch.cumsum(keep.long(), -1) - 1
    ok = keep & (pos < capacity)
    return ok, pos


# -------------------------------------------------------------- bootstrap --
def _essential_from_rows(A):
    """Smallest eigenvector of AᵀA as E (3x3), projected to singular values
    (1, 1, 0)."""
    _, vec = eigh(mm(A.mT, A))
    E = vec[..., :, 0].reshape(vec.shape[:-2] + (3, 3))
    U, _, Vh = torch.linalg.svd(E)
    return (U * torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)) @ Vh


def _epipolar_rows(x1, x2):
    a1, b1, a2, b2 = x1[..., 0], x1[..., 1], x2[..., 0], x2[..., 1]
    return torch.stack([a2 * a1, a2 * b1, a2, b2 * a1, b2 * b1, b2, a1, b1,
                        torch.ones_like(a1)], -1)


def _sampson(E, x1, x2):
    """Sampson error of every point (L, N) under E (L, [H,] 3, 3)."""
    ones = torch.ones_like(x1[..., :1])
    x1h, x2h = torch.cat([x1, ones], -1), torch.cat([x2, ones], -1)
    if E.dim() == 4:
        x1h, x2h = x1h[:, None], x2h[:, None]
    Ex1 = mm(x1h, E.mT)
    Etx2 = mm(x2h, E)
    num = (x2h * Ex1).sum(-1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / den.clamp(min=1e-12)


def _first_argmax(x):
    """Index of the first maximum along the last axis."""
    m = x.max(-1, keepdim=True).values
    ar = torch.arange(x.shape[-1], device=x.device)
    return torch.where(x == m, ar, x.shape[-1]).min(-1).values


def _pick(x, i):
    return torch.gather(x, 1, i.view((-1, 1) + (1,) * (x.dim() - 2))
                        .expand((x.shape[0], 1) + x.shape[2:]))[:, 0]


def ransac_pose(x1, x2, valid, uniforms, sample_size: int, thr: float):
    """Essential-matrix RANSAC and pose recovery in normalized coordinates.
    Returns (R, t) with X_cam2 = R X_cam1 + t."""
    u = uniforms.clamp(min=torch.finfo(uniforms.dtype).tiny)
    scores = torch.where(valid[:, None, :], -torch.log(-torch.log(u)), -math.inf)
    samples = scores.topk(sample_size, -1).indices            # (L, H, S)
    rows = _epipolar_rows(x1, x2)                              # (L, N, 9)
    Ah = torch.gather(rows[:, None].expand(-1, samples.shape[1], -1, -1), 2,
                      samples[..., None].expand(-1, -1, -1, 9))  # (L, H, S, 9)
    _, vec = eigh(mm(Ah.mT, Ah))
    Es = vec[..., :, 0].reshape(vec.shape[:-2] + (3, 3))       # (L, H, 3, 3)
    inl = (_sampson(Es, x1, x2) < thr) & valid[:, None]
    counts = inl.sum(-1)
    best = _first_argmax(counts)
    inl_best = _pick(inl, best)
    E_ref = _essential_from_rows(rows * inl_best[..., None].to(rows.dtype))
    inl_ref = (_sampson(E_ref, x1, x2) < thr) & valid
    better = inl_ref.sum(-1) >= _pick(counts, best)
    E = torch.where(better[:, None, None], E_ref, _pick(Es, best))
    inliers = torch.where(better[:, None], inl_ref, inl_best)

    U, _, Vh = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))[:, None, None]
    Vh = Vh * torch.sign(torch.linalg.det(Vh))[:, None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype, device=E.device)
    R1, R2, t = U @ W @ Vh, U @ W.mT @ Vh, U[..., :, 2]
    Rs = torch.stack([R1, R1, R2, R2], 1)                      # (L, 4, 3, 3)
    ts = torch.stack([t, -t, t, -t], 1)
    L, N = x1.shape[:2]
    eye34 = torch.eye(3, 4, dtype=x1.dtype, device=x1.device).expand(L * 4, 3, 4)
    P2 = torch.cat([Rs, ts[..., None]], -1).flatten(0, 1)
    rep = lambda a: a[:, None].expand((L, 4) + a.shape[1:]).flatten(0, 1)
    X, _ = triangulate(eye34, P2, rep(x1), rep(x2), polish=0)
    z1 = X[..., 2]
    z2 = (X @ Rs.flatten(0, 1)[:, 2, :, None])[..., 0] + ts.flatten(0, 1)[:, None, 2]
    good = (z1 > 0) & (z2 > 0) & (z1 < 50.0) & (z2 < 50.0) & rep(inliers)
    c = _first_argmax(good.sum(-1).view(L, 4))
    return _pick(Rs, c), _pick(ts, c)


def bootstrap_pose(f0, f1, uniforms, cam: Cam, cfg: dict):
    """The two-view pose of L problems.  f0, f1: dicts of (L, N, ...)
    frames; uniforms (L, H, N) the run's RANSAC draw.  Returns (T_boot
    (L, 4, 4) camera-1-in-world, the frames' Match)."""
    m = match(f0["desc"], f0["valid"], f1["desc"], f1["valid"],
              cfg["distance_threshold"], cfg["ratio_threshold"])
    uv2 = take(f1["uv"], m.idx)
    K = cam.K
    norm = lambda uv: torch.stack([(uv[..., 0] - K[0, 2]) / K[0, 0],
                                   (uv[..., 1] - K[1, 2]) / K[1, 1]], -1)
    R, t = ransac_pose(norm(f0["uv"]), norm(uv2), m.valid, uniforms, cfg["sample_size"],
                       (cfg["inlier_threshold_px"] / float(K[0, 0])) ** 2)
    return inv_se3(make_T(R, t)), m


def bootstrap_points(f0, f1, m: Match, T_boot, cam: Cam, cfg: dict, capacity: int):
    """The initial map from the bootstrap's pose: every match triangulated
    from frames 0 (the world frame) and 1 and appended in order."""
    K = cam.K
    L = T_boot.shape[0]
    eye = torch.eye(4, dtype=K.dtype, device=K.device).expand(L, 4, 4)
    X, _ = triangulate(K @ eye[:, :3], K @ inv_se3(T_boot)[:, :3], f0["uv"],
                       take(f1["uv"], m.idx), cfg["triangulation_refine_iters"])
    ok, _ = append(torch.zeros(L, dtype=torch.long, device=K.device), capacity, m.valid)
    ray, depth = rays(K, eye, inv_se3(T_boot), f0["uv"], take(f1["uv"], m.idx))
    return NewPoints(X, f0["id_meas"], f0["id_real"], ok, ray, depth)


# ------------------------------------------------------------------- PICP --
def picp(K, T0, X, uv, valid, cam: Cam, p: dict):
    """Gauss-Newton PICP of L problems from world-in-camera T0 (L, 4, 4):
    points X (L, N, 3) observed at uv (L, N, 2) where ``valid``.  Returns
    (T, inliers, rounds)."""
    L = T0.shape[0]
    dev = T0.device
    T = T0
    prev = torch.full((L,), 1e30, device=dev)
    done = torch.zeros(L, dtype=torch.bool, device=dev)
    rounds = torch.zeros(L, dtype=torch.long, device=dev)
    n_in = torch.zeros(L, dtype=torch.long, device=dev)
    eye6 = torch.eye(6, device=dev)
    for _ in range(p["max_iterations"]):
        if bool(done.all()):
            break
        uv_hat, pc = project(K, T, X)
        ok = valid & in_image(uv_hat, pc, cam)
        ph = mm(pc, K.mT)
        iz = 1.0 / torch.where(ph[..., 2].abs() > 1e-12, ph[..., 2], torch.ones_like(ph[..., 2]))
        Jp = torch.stack([torch.stack([iz, torch.zeros_like(iz), -ph[..., 0] * iz * iz], -1),
                          torch.stack([torch.zeros_like(iz), iz, -ph[..., 1] * iz * iz], -1)], -2)
        JK = mm(Jp, K)                                    # (L, N, 2, 3)
        skew = torch.zeros(pc.shape + (3,), device=dev)   # [I | skew(-p_cam)]
        x, y, z = -pc[..., 0], -pc[..., 1], -pc[..., 2]
        skew[..., 0, 1], skew[..., 0, 2] = -z, y
        skew[..., 1, 0], skew[..., 1, 2] = z, -x
        skew[..., 2, 0], skew[..., 2, 1] = -y, x
        J = torch.cat([JK, mm(JK, skew)], -1)             # (L, N, 2, 6)
        e = torch.where(ok[..., None], uv_hat - uv, 0.0)
        J = torch.where(ok[..., None, None], J, 0.0)
        chi = (e * e).sum(-1)
        inl = ok & (chi <= p["kernel_threshold"])
        w = inl.to(chi.dtype)
        A = torch.cat([J, e[..., None]], -1)              # (L, N, 2, 7)
        Hx = ein("lnki,lnkj,ln->lij", A, A, w)
        H, b = Hx[:, :6, :6] + p["damping"] * eye6, Hx[:, :6, 6]
        cnt = inl.sum(-1)
        chi_in = (chi * w).sum(-1)
        step_ok = cnt >= p["min_num_inliers"]
        dx = torch.linalg.solve_ex(H, -b[..., None])[0][..., 0]
        T2 = torch.where(step_ok[:, None, None], euler_T(dx) @ T, T)
        rel = torch.where(prev > 1e-10, (prev - chi_in).abs() / prev, 0.0)
        conv = step_ok & (rel < p["convergence_threshold"])
        act = ~done
        T = torch.where(act[:, None, None], T2, T)
        prev = torch.where(act, chi_in, prev)
        rounds = rounds + act.long()
        n_in = torch.where(act, cnt, n_in)
        done = done | ~step_ok | conv
    return T, n_in, rounds


# ------------------------------------------------------------------- step --
def step(pose, mp: Map, curr, nxt, cam: Cam, cfg: dict, extras: bool = False):
    """One teacher-forced tracking step of L problems: camera-in-world
    ``pose`` (L, 4, 4) of the current frame, the map as the step finds it,
    the current and next frames (dicts of (L, N, ...)).  Returns (pose of
    the next frame (L, 4, 4), NewPoints in append order, rounds), and with
    ``extras`` a dict of the frame's map matches (``map_idx``,
    ``map_valid``), its candidates in append order (``cand``), their pixels
    in the next frame (``uv2``) and their descriptors (``desc``)."""
    K = cam.K
    mt = cfg["matcher"]
    m_map = match(nxt["desc"], nxt["valid"], mp.desc, mp.valid,
                  mt["distance_threshold"], mt["ratio_threshold"])
    T_init = inv_se3(pose)
    T, _, rounds = picp(K, T_init, take(mp.xyz, m_map.idx), nxt["uv"], m_map.valid, cam,
                        cfg["picp"])
    new_pose = inv_se3(T)
    healthy = ((m_map.valid.sum(-1) >= cfg["picp"]["min_matches_reuse_pose"])
               & torch.isfinite(new_pose).flatten(-2).all(-1))
    new_pose = torch.where(healthy[:, None, None], new_pose, pose)
    wic_new = torch.where(healthy[:, None, None], T, T_init)

    m_img = match(curr["desc"], curr["valid"], nxt["desc"], nxt["valid"],
                  mt["distance_threshold"], mt["ratio_threshold"])
    is_new = m_img.valid & ~torch.gather(m_map.valid, 1, m_img.idx)
    Kc = cfg["max_new_landmarks_per_frame"]
    # the first Kc candidates in keypoint order
    order = torch.argsort((~is_new).to(torch.int8), dim=-1, stable=True)[:, :Kc]
    cand = torch.gather(is_new, 1, order)
    uv1 = take(curr["uv"], order)
    uv2 = take(nxt["uv"], torch.gather(m_img.idx, 1, order))
    X, finite = triangulate(K @ T_init[:, :3], K @ wic_new[:, :3], uv1, uv2,
                            cfg["triangulation_refine_iters"])
    keep = cand
    if cfg["gate"]:
        thr2 = cfg["landmark_max_reproj_px"] ** 2
        u1, pc1 = project(K, T_init, X)
        u2, pc2 = project(K, wic_new, X)
        ok1, ok2 = in_image(u1, pc1, cam), in_image(u2, pc2, cam)
        r1 = X - pose[:, None, :3, 3]
        r2 = X - new_pose[:, None, :3, 3]
        cosang = (r1 * r2).sum(-1) / (r1.norm(dim=-1) * r2.norm(dim=-1)).clamp(min=1e-20)
        keep = (keep & ok1 & ok2 & (((u1 - uv1) ** 2).sum(-1) < thr2)
                & (((u2 - uv2) ** 2).sum(-1) < thr2) & finite
                & (cosang < math.cos(cfg["landmark_min_parallax_rad"])))
    ok, _ = append(mp.count, mp.valid.shape[1], keep)
    new = NewPoints(X, take(curr["id_meas"][..., None], order)[..., 0],
                    take(curr["id_real"][..., None], order)[..., 0], ok,
                    *rays(K, T_init, wic_new, uv1, uv2))
    if extras:
        return new_pose, new, dict(map_idx=m_map.idx, map_valid=m_map.valid, cand=cand,
                                   uv2=uv2, desc=take(curr["desc"], order))
    return new_pose, new, rounds
