"""Masked pinhole projection (twin of ``tpuvo/ops/camera.py``).

A point is valid when it is in front of the camera (z > 0) and projects
inside [0, width-1] x [0, height-1]; invalid entries keep their computed uv
and callers consult the mask.
"""

from __future__ import annotations

import torch

from tpuvo_torch.ops.linalg_small import matmul_small


def project_points_with_cam(K, world_in_camera_T, pts, width: int, height: int):
    """Project (N, 3) world points through a 4x4 world-in-camera transform.

    Returns (uv (N, 2), valid (N,) bool, p_cam (N, 3), phom (N, 3)) — the
    camera-frame and K-homogeneous points are what the PICP Jacobian needs.
    The products are ``matmul_small``'s: on the card a lane of a batch
    projects as the same pose alone.
    """
    R = world_in_camera_T[..., :3, :3]
    t = world_in_camera_T[..., :3, 3]
    p_cam = matmul_small(pts, R.transpose(-1, -2)) + t[..., None, :]
    phom = matmul_small(p_cam, K.T)
    z = phom[..., 2]
    iz = 1.0 / torch.where(torch.abs(z) > 1e-12, z, torch.ones_like(z))
    uv = phom[..., :2] * iz[..., None]
    in_front = p_cam[..., 2] > 0.0
    in_bounds = (
        (uv[..., 0] >= 0.0) & (uv[..., 0] <= width - 1)
        & (uv[..., 1] >= 0.0) & (uv[..., 1] <= height - 1)
    )
    return uv, in_front & in_bounds, p_cam, phom


def project_points(K, world_in_camera_T, pts, width: int, height: int):
    """Returns (uv (N, 2), valid (N,) bool); see project_points_with_cam."""
    uv, ok, _, _ = project_points_with_cam(K, world_in_camera_T, pts, width, height)
    return uv, ok
