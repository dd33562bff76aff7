"""Synthetic-world generator: a known random world and planar camera path
rendered into padded ``FrameObservations``.

Twin of ``tpuvo/data/synthetic.py``: the same numpy RNG calls in the same
order, so a seed gives bit-identical worlds, trajectories and sequences in
both packages.
"""

from __future__ import annotations

import numpy as np

from tpuvo_torch.config import DESC_DIM, EngineConfig
from tpuvo_torch.data.loader import FrameObservations, WorldPoints


def make_world(
    seed: int,
    n_landmarks: int = 1000,
    xy_extent: float = 10.0,
    z_range=(0.0, 2.0),
    desc_dim: int = DESC_DIM,
) -> WorldPoints:
    """Random landmark cloud with unique random descriptors."""
    rng = np.random.default_rng(seed)
    xyz = np.concatenate(
        [
            rng.uniform(-xy_extent, xy_extent, (n_landmarks, 2)),
            rng.uniform(z_range[0], z_range[1], (n_landmarks, 1)),
        ],
        axis=1,
    ).astype(np.float32)
    desc = rng.uniform(-1.0, 1.0, (n_landmarks, desc_dim)).astype(np.float32)
    ids = np.arange(n_landmarks, dtype=np.int32)
    return WorldPoints(xyz, desc, ids)


def make_planar_trajectory(
    n_frames: int, step: float = 0.2, turn: float = 0.02, seed: int = 0
) -> np.ndarray:
    """Forward-dominant planar path (~0.2 m/frame). Returns (F, 3) (x, y, theta)."""
    rng = np.random.default_rng(seed)
    poses = np.zeros((n_frames, 3), np.float32)
    for i in range(1, n_frames):
        x, y, th = poses[i - 1]
        th = th + turn + 0.01 * rng.standard_normal()
        poses[i] = [x + step * np.cos(th), y + step * np.sin(th), th]
    return poses


def make_kitti_like_trajectory(
    n_frames: int, step: float = 1.0, seed: int = 0
) -> np.ndarray:
    """KITTI-odometry-flavoured planar path: long straights (~1 m/frame)
    with occasional 90-degree-ish turns.  Returns (F, 3) (x, y, theta)."""
    rng = np.random.default_rng(seed)
    poses = np.zeros((n_frames, 3), np.float32)
    turn_until = -1
    turn_rate = 0.0
    for i in range(1, n_frames):
        x, y, th = poses[i - 1]
        if i > turn_until and rng.random() < 0.02:
            turn_until = i + rng.integers(15, 30)
            turn_rate = rng.choice([-1.0, 1.0]) * (np.pi / 2) / (turn_until - i)
        rate = turn_rate if i <= turn_until else 0.0
        th = th + rate + 0.002 * rng.standard_normal()
        poses[i] = [x + step * np.cos(th), y + step * np.sin(th), th]
    return poses


def make_loop_trajectory(
    n_frames: int, step: float = 1.0, seed: int = 0, turn_frames: int = 12
) -> np.ndarray:
    """Closed square circuit (four straights, four smooth 90-degree turns)
    that returns near the start. Returns (F, 3) (x, y, theta)."""
    rng = np.random.default_rng(seed)
    straight = max((n_frames - 4 * turn_frames) // 4, 1)
    poses = np.zeros((n_frames, 3), np.float32)
    phase = []
    for _ in range(4):
        phase += [0.0] * straight
        phase += [(np.pi / 2) / turn_frames] * turn_frames
    while len(phase) < n_frames:
        phase.append(0.0)
    for i in range(1, n_frames):
        x, y, th = poses[i - 1]
        th = th + phase[i - 1] + 0.002 * rng.standard_normal()
        poses[i] = [x + step * np.cos(th), y + step * np.sin(th), th]
    return poses


def camera_pose_from_gt(gt_xyt: np.ndarray, cfg: EngineConfig) -> np.ndarray:
    """Camera-in-world 4x4 from a planar robot pose (robot pose . mount)."""
    x, y, th = float(gt_xyt[0]), float(gt_xyt[1]), float(gt_xyt[2])
    c, s = np.cos(th), np.sin(th)
    T_wr = np.eye(4, dtype=np.float32)
    T_wr[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    T_wr[:3, 3] = [x, y, 0.0]
    return T_wr @ cfg.mount_T()


def render_sequence(
    world: WorldPoints,
    gt_poses: np.ndarray,
    cfg: EngineConfig | None = None,
    pixel_noise: float = 0.0,
    descriptor_noise: float = 0.0,
    seed: int = 0,
    max_obs: int | None = None,
) -> FrameObservations:
    """Project the world through the camera along the path -> padded frames.

    Landmarks in front of the camera and inside the image become
    observations; when more than max_obs are visible, the lowest
    ``saliency * max(z, 1)^2`` are kept (a persistent per-landmark priority
    times image-uniform density).  id_real = landmark id, id_meas = index
    within the frame.
    """
    cfg = cfg or EngineConfig()
    max_obs = max_obs or cfg.max_obs
    rng = np.random.default_rng(seed)
    K = cfg.K()
    F = len(gt_poses)
    saliency = rng.uniform(size=len(world.xyz)).astype(np.float32)

    uv_a = np.zeros((F, max_obs, 2), np.float32)
    desc_a = np.zeros((F, max_obs, world.desc.shape[1]), np.float32)
    id_meas = np.full((F, max_obs), -1, np.int32)
    id_real = np.full((F, max_obs), -1, np.int32)
    valid = np.zeros((F, max_obs), bool)
    n_obs = np.zeros(F, np.int32)

    for i in range(F):
        T_wc = camera_pose_from_gt(gt_poses[i], cfg)
        T_cw = np.linalg.inv(T_wc)
        p_cam = world.xyz @ T_cw[:3, :3].T + T_cw[:3, 3]
        z = p_cam[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            phom = p_cam @ K.T
            uv = phom[:, :2] / phom[:, 2:3]
        ok = (z > 0) & np.isfinite(uv).all(1)
        ok &= (uv[:, 0] >= 0) & (uv[:, 0] <= cfg.width - 1)
        ok &= (uv[:, 1] >= 0) & (uv[:, 1] <= cfg.height - 1)
        sel = np.nonzero(ok)[0]
        if len(sel) > max_obs:
            score = saliency[sel] * np.maximum(z[sel], 1.0) ** 2
            sel = sel[np.argsort(score)[:max_obs]]
        n = len(sel)
        obs_uv = uv[sel]
        if pixel_noise > 0:
            obs_uv = obs_uv + pixel_noise * rng.standard_normal(obs_uv.shape)
        obs_desc = world.desc[sel]
        if descriptor_noise > 0:
            obs_desc = obs_desc + descriptor_noise * rng.standard_normal(obs_desc.shape)
        uv_a[i, :n] = obs_uv
        desc_a[i, :n] = obs_desc
        id_real[i, :n] = world.ids[sel]
        id_meas[i, :n] = np.arange(n)
        valid[i, :n] = True
        n_obs[i] = n

    odom = gt_poses.copy()
    return FrameObservations(
        uv_a, desc_a.astype(np.float32), id_meas, id_real, valid, n_obs,
        gt_poses.astype(np.float32), odom.astype(np.float32),
    )
