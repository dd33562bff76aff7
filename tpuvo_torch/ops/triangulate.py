"""Batched DLT triangulation with a per-point Gauss-Newton polish (twin of
``tpuvo/ops/triangulate.py``).

P = K · [T^-1]_(3x4) for both camera-in-world poses, a DLT per
correspondence, then GN on the true reprojection error — fp32 loses digits
on low-parallax points in the squared DLT system, and two polish steps
recover them.  No cheirality filtering (the reference keeps every DLT
output); a finite mask is returned for callers that gate.  Every function
takes optional leading lane axes: poses (..., 4, 4), correspondences
(..., N, 2).
"""

from __future__ import annotations

import torch

from tpuvo_torch.ops import lie
from tpuvo_torch.ops.linalg_small import solve3, solve_dlt3


def projection_matrix(K, camera_in_world_T):
    """P = K · [T^-1]_(3x4)."""
    return K @ lie.inv_se3(camera_in_world_T)[..., :3, :4]


def _dlt_rows(P1, P2, uv1, uv2):
    def rows(P, uv):
        a = uv[..., 0:1] * P[..., None, 2, :] - P[..., None, 0, :]
        b = uv[..., 1:2] * P[..., None, 2, :] - P[..., None, 1, :]
        return a, b

    # the two views' lane axes may differ (a projection shared by every lane)
    a1, b1, a2, b2 = torch.broadcast_tensors(*rows(P1, uv1), *rows(P2, uv2))
    A = torch.stack([a1, b1, a2, b2], dim=-2)  # (..., N, 4, 4)
    return A / torch.clamp(torch.linalg.norm(A, dim=-1, keepdim=True), min=1e-20)


def triangulate_dlt(P1, P2, uv1, uv2, method: str = "inhomogeneous"):
    """DLT for (..., N, 2) correspondences under (..., 3, 4) projections.

    Returns (points (..., N, 3), w (..., N) degeneracy indicator: ~0 marks a
    near-infinity point).  ``inhomogeneous`` fixes w = 1 and solves the 4x3
    least-squares system in closed form; ``homogeneous`` takes the smallest
    eigenvector of the row-normalized A^T A.
    """
    A = _dlt_rows(P1, P2, uv1, uv2)
    if method == "inhomogeneous":
        return solve_dlt3(A)
    AtA = torch.einsum("...nij,...nik->...njk", A, A)
    _, vecs = torch.linalg.eigh(AtA)  # ascending eigenvalues
    X = vecs[..., 0]
    w = X[..., 3]
    safe_w = torch.where(torch.abs(w) > 1e-12, w, torch.full_like(w, 1e-12))
    return X[..., :3] / safe_w[..., None], w


def refine_points(P1, P2, uv1, uv2, pts, iterations: int = 2, damping: float = 1e-6):
    """Per-point GN polish of the two-view reprojection error; divergent
    updates (non-finite or residual increase) are rejected per point."""

    def proj(P, X):
        h = X @ P[..., :3].mT + P[..., None, :, 3]
        z = h[..., 2]
        safe_z = torch.where(torch.abs(z) > 1e-12, z, torch.full_like(z, 1e-12))
        return h[..., :2] / safe_z[..., None], safe_z, h

    def residual(X):
        u1, z1, h1 = proj(P1, X)
        u2, z2, h2 = proj(P2, X)
        return torch.cat([u1 - uv1, u2 - uv2], dim=-1), (z1, h1, z2, h2)

    def J_of(P, z, h):
        iz = 1.0 / z
        u = h[..., 0] * iz
        v = h[..., 1] * iz
        Ju = (P[..., None, 0, :3] - u[..., None] * P[..., None, 2, :3]) * iz[..., None]
        Jv = (P[..., None, 1, :3] - v[..., None] * P[..., None, 2, :3]) * iz[..., None]
        return torch.stack([Ju, Jv], dim=-2)

    eye = torch.eye(3, dtype=pts.dtype, device=pts.device)
    for _ in range(iterations):
        r, (z1, h1, z2, h2) = residual(pts)
        J = torch.cat([J_of(P1, z1, h1), J_of(P2, z2, h2)], dim=-2)  # (..., N, 4, 3)
        H = torch.einsum("...nki,...nkj->...nij", J, J) + damping * eye
        g = torch.einsum("...nki,...nk->...ni", J, r)
        X_new = pts + solve3(H, -g)
        r_new, _ = residual(X_new)
        better = (torch.all(torch.isfinite(X_new), dim=-1)
                  & (torch.sum(r_new * r_new, -1) <= torch.sum(r * r, -1)))
        pts = torch.where(better[..., None], X_new, pts)
    return pts


def triangulate_two_view(K, T1, T2, uv1, uv2, refine_iterations: int = 2,
                         method: str = "inhomogeneous", wic1=None, wic2=None):
    """Triangulate correspondences seen from camera-in-world poses T1, T2.

    wic1/wic2: optional world-in-camera transforms; when given, the pose
    inversions are skipped (the tracker already holds both directions).
    Returns (points (..., N, 3) in the world frame, finite_mask (..., N)).
    """
    P1 = K @ wic1[..., :3, :4] if wic1 is not None else projection_matrix(K, T1)
    P2 = K @ wic2[..., :3, :4] if wic2 is not None else projection_matrix(K, T2)
    pts, w = triangulate_dlt(P1, P2, uv1, uv2, method)
    if refine_iterations:
        pts = refine_points(P1, P2, uv1, uv2, pts, refine_iterations)
    return pts, torch.abs(w) > 1e-12


def triangulate_normalized(R, t, x1, x2):
    """DLT in normalized coordinates with P1 = [I|0], P2 = [R|t] (R
    (..., 3, 3), t (..., 3)).  Returns (points in the cam-1 frame (..., N,
    3), depth1 (..., N), depth2 (..., N))."""
    P1 = torch.cat([torch.eye(3, dtype=x1.dtype, device=x1.device),
                    torch.zeros((3, 1), dtype=x1.dtype, device=x1.device)], 1)
    P2 = torch.cat([R, t[..., None]], -1)
    pts, _ = triangulate_dlt(P1, P2, x1, x2)
    # depth in view 2: R's last row against every point (a matrix-vector
    # product without lanes, one a lane with them)
    z2 = pts @ R[2] if R.dim() == 2 else (pts @ R[..., 2, :, None])[..., 0]
    return pts, pts[..., 2], z2 + t[..., 2, None]
