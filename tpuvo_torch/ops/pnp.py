"""DLT PnP: camera pose from 2D-3D correspondences, no initialization
needed (twin of ``tpuvo/ops/pnp.py``).

Loop-closure relocalization (``ba/loop.py``) has no initial pose inside
PICP's basin: the drifted estimate can be tens of meters off.  The
calibrated Direct Linear Transform solves the projection equations
globally (one 12x12 ``eigh``), and a short PICP polish reaches GN accuracy
(``solve_cuda``: one kernel-A launch for the whole batch on the card).

Every function is batched over leading axes (the JAX twin vmaps over loop
pairs and RANSAC hypotheses); invalid correspondences weight their rows to
zero.  Sign conventions: the ``eigh`` eigenvector's sign is arbitrary and
is fixed by majority positive depth; R = U·diag(1, 1, det(U·Vᵀ))·Vᵀ does
not depend on the signs ``svd`` picks for its singular vectors.
"""

from __future__ import annotations

import math

import torch

from tpuvo_torch.config import PICPConfig
from tpuvo_torch.engine.state import check_device
from tpuvo_torch.ops import lie
from tpuvo_torch.ops.camera import project_points_with_cam
from tpuvo_torch.ops.cuda.picp_kernel import solve_cuda


def topk_stable(x, k: int):
    """Indices of the k largest entries along the last axis, the lower index
    first on a tie — the order ``jax.lax.top_k`` gives and ``torch.topk``
    does not promise: a stable ascending sort of -x."""
    return torch.argsort(-x, dim=-1, stable=True)[..., :k]


def _eye4(shape, like):
    return torch.eye(4, dtype=like.dtype, device=like.device).expand(shape + (4, 4))


def pnp_dlt(K, X, uv, valid):
    """Pose from >= 6 valid 2D-3D correspondences via calibrated DLT.

    K: (3, 3); X: (..., N, 3) world points; uv: (..., N, 2) pixels;
    valid: (..., N) bool.  Returns (T (..., 4, 4) world-in-camera, ok)."""
    n_valid = torch.sum(valid, -1)
    w = valid.to(X.dtype)
    # invalid rows carry weight 0 everywhere below; zeroing them too keeps
    # garbage positions from reaching eigh as inf·0 = NaN (torch's eigh
    # raises on NaN where JAX's returns NaN)
    X = torch.where(valid[..., None], X, 0.0)
    uv = torch.where(valid[..., None], uv, 0.0)

    xn = (uv[..., 0] - K[0, 2]) / K[0, 0]
    yn = (uv[..., 1] - K[1, 2]) / K[1, 1]

    # Hartley-normalize the 3D points (masked statistics)
    denom = torch.clamp(n_valid.to(X.dtype), min=1.0)
    mean = torch.sum(X * w[..., None], -2) / denom[..., None]
    Xc = X - mean[..., None, :]
    rms = torch.sqrt(torch.sum(torch.sum(Xc * Xc, -1) * w, -1) / denom)
    s3 = math.sqrt(3.0) / torch.clamp(rms, min=1e-12)
    Xn = Xc * s3[..., None, None]

    ones = torch.ones_like(xn)[..., None]
    Xh = torch.cat([Xn, ones], -1)                                   # (..., N, 4)
    z4 = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, z4, -xn[..., None] * Xh], -1)               # (..., N, 12)
    r2 = torch.cat([z4, Xh, -yn[..., None] * Xh], -1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], -2)       # (..., 2N, 12)

    _, evecs = torch.linalg.eigh(A.mT @ A)
    Pn = evecs[..., :, 0].reshape(evecs.shape[:-2] + (3, 4))        # least eigvec

    # un-normalize: X_h = T_norm @ [X; 1], T_norm = [[s I, -s mean], [0, 1]]
    eye3 = torch.eye(3, dtype=X.dtype, device=X.device)
    Tn = lie.rt_to_T(s3[..., None, None] * eye3, -s3[..., None] * mean)
    P = Pn @ Tn                                                     # (..., 3, 4)

    # global sign: P's third row on a homogeneous point is depth up to a
    # positive scale, so most valid points must land in front
    zP = torch.einsum("...nj,...j->...n", torch.cat([X, ones], -1), P[..., 2, :])
    flip = torch.sum((zP > 0) * w, -1) < 0.5 * n_valid
    P = torch.where(flip[..., None, None], -P, P)

    # closest rotation by SVD, then scale and t; with the sign fixed,
    # det(U Vᵀ) = +1 except on degenerate input
    U, S, Vt = torch.linalg.svd(P[..., :, :3])
    d = torch.linalg.det(U @ Vt)
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1))
    R = U @ D @ Vt
    scale = torch.sum(S, -1) / 3.0
    t = P[..., :, 3] / torch.clamp(scale, min=1e-12)[..., None]

    T = lie.rt_to_T(R, t)
    ok = (n_valid >= 6) & torch.isfinite(T).flatten(-2).all(-1)
    T = torch.where(ok[..., None, None], T, _eye4(T.shape[:-2], T))
    return T, ok


def _reproj_err2(K, T, X, uv):
    """Squared reprojection error per point (behind the camera -> +inf)."""
    uv_hat, _, p_cam, _ = project_points_with_cam(K, T, X, 10**9, 10**9)
    e2 = torch.sum((uv_hat - uv) ** 2, -1)
    return torch.where(p_cam[..., 2] > 0, e2, math.inf)


def ransac_uniforms(generator, shape, device="cuda"):
    """Uniforms in [1e-9, 1) for the hypothesis draws, drawn on the CPU
    (as ``vo.make_generator`` draws) and moved to ``device`` (the card
    unless the caller asks for the CPU)."""
    check_device(device)
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return torch.clamp(u * (1.0 - 1e-9) + 1e-9, min=1e-9).to(device)


def pnp_ransac(generator, K, X, uv, valid, width: int, height: int,
               iterations: int = 64, sample_size: int = 8,
               inlier_px: float = 8.0, polish_iterations: int = 10, uniforms=None):
    """Robust PnP: minimal-DLT hypotheses + inlier voting + consensus refit
    + robust PICP polish, batched over a leading axis B.

    X: (B, N, 3), uv: (B, N, 2), valid: (B, N).  Each hypothesis samples
    ``sample_size`` valid rows by a Gumbel top-k of ``uniforms`` (B,
    iterations, N) in (0, 1) — drawn from ``generator`` when None (the JAX
    twin draws them per hypothesis key).  Returns (T (B, 4, 4)
    world-in-camera, ok (B,), n_inliers (B,))."""
    B, N = X.shape[:2]
    thr2 = inlier_px * inlier_px
    if uniforms is None:
        uniforms = ransac_uniforms(generator, (B, iterations, N), X.device)
    g = -torch.log(-torch.log(uniforms))
    logp = torch.where(valid, 0.0, -math.inf)[:, None, :]
    idx = topk_stable(g + logp, sample_size)                        # (B, H, s)
    sel = torch.zeros(g.shape, dtype=torch.bool, device=X.device).scatter_(-1, idx, True)
    sel = sel & valid[:, None, :]
    H = uniforms.shape[1]
    Xh = X[:, None].expand(B, H, N, 3)
    uvh = uv[:, None].expand(B, H, N, 2)
    Ts, ok_h = pnp_dlt(K, Xh, uvh, sel)
    e2 = _reproj_err2(K, Ts, Xh, uvh)
    scores = torch.sum(valid[:, None, :] & (e2 < thr2) & ok_h[..., None], -1)
    best = torch.argmax(scores, -1)                                  # first on a tie
    T_best = torch.take_along_dim(Ts, best[:, None, None, None], 1)[:, 0]
    score_best = torch.take_along_dim(scores, best[:, None], 1)[:, 0]

    # consensus refit + robust polish on the winning inlier set
    inl = valid & (_reproj_err2(K, T_best, X, uv) < thr2)
    T_fit, ok_fit = pnp_dlt(K, X, uv, inl)
    T_fit = torch.where(ok_fit[:, None, None], T_fit, T_best)
    cfg = PICPConfig(max_iterations=polish_iterations, convergence_threshold=1e-6)
    # the B problems in one kernel-A launch on the card (K read there)
    res = solve_cuda(K, T_fit, X, uv, None, inl, width, height, cfg,
                     kernel_threshold=9.0 * thr2)
    fin = torch.isfinite(res.T).flatten(-2).all(-1)
    T = torch.where(fin[:, None, None], res.T, T_fit)
    n_inl = torch.sum(valid & (_reproj_err2(K, T, X, uv) < thr2), -1)
    ok = (score_best >= 6) & torch.isfinite(T).flatten(-2).all(-1)
    T = torch.where(ok[:, None, None], T, _eye4((B,), T))
    return T, ok, n_inl


def pnp_solve(K, X, uv, valid, width: int, height: int, polish_iterations: int = 10,
              kernel_threshold: float = 1.0e6):
    """DLT initialization + PICP Gauss-Newton polish (a permissive robust
    threshold, no bounds cull).  Batched over leading axes of X; returns
    (T world-in-camera, ok)."""
    T0, ok = pnp_dlt(K, X, uv, valid)
    cfg = PICPConfig(max_iterations=polish_iterations, convergence_threshold=1e-6)
    res = solve_cuda(K, T0, X, uv, None, valid, width, height, cfg,
                     kernel_threshold=kernel_threshold)
    fin = torch.isfinite(res.T).flatten(-2).all(-1)
    return torch.where(fin[..., None, None], res.T, T0), ok
