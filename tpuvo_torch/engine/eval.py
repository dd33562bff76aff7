"""Trajectory evaluation and the reference-format artifacts (twin of
``tpuvo/engine/eval.py``, same formulas, byte-identical files).

  * remap camera-frame poses to world axes: pose <- cameraToImage · pose
  * Sim(3) Umeyama alignment of estimated vs ground-truth translations;
    scale = |linear.col(0)|
  * per-frame errors: translation |scale·t_est - t_gt|; rotation in the
    reference's unwrapped form (+pi/2 offset) and the wrapped form
  * ATE after full Sim(3) alignment, and the mount-compensated robot-frame
    ATE (camera centres -> robot poses before alignment)

Host-side numpy, with the alignment and angle helpers run as fp32 torch on
the CPU, as the JAX twin runs them in fp32.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from tpuvo_torch.config import EngineConfig
from tpuvo_torch.engine.state import to_host
from tpuvo_torch.ops import lie


class EvalResult(NamedTuple):
    poses_world: np.ndarray     # (F, 4, 4) axis-remapped estimated poses
    gt_T: np.ndarray            # (F, 4, 4) augmented GT poses
    scale: float                # recovered Sim(3) scale
    align_T: np.ndarray         # (4, 4) full Umeyama similarity
    angles: np.ndarray          # (F,) estimated heading (+pi/2 offset applied)
    angles_gt: np.ndarray       # (F,)
    trans_err: np.ndarray       # (F,) |scale*t_est - t_gt| (reference metric)
    rot_err_parity: np.ndarray  # (F,) unwrapped |angle - angle_gt|
    rot_err_fixed: np.ndarray   # (F,) wrapped to (-pi, pi]
    ate_rmse: float             # RMSE after full Sim(3) alignment
    trans_err_robot: np.ndarray # (F,) mount-compensated robot-frame errors
    ate_robot: float            # robot-frame ATE


def _umeyama(src, dst) -> np.ndarray:
    return lie.umeyama(torch.as_tensor(np.asarray(src, np.float32)),
                       torch.as_tensor(np.asarray(dst, np.float32))).numpy()


def evaluate(poses, gt_xyt, cfg: EngineConfig | None = None) -> EvalResult:
    """poses: (F, 4, 4) camera-in-world (camera-0 frame), numpy or tensor;
    gt_xyt: (F, 3) planar ground truth."""
    cfg = cfg or EngineConfig()
    poses = to_host(poses)
    poses_world = np.einsum("ij,fjk->fik", cfg.cam_to_image(), poses)
    gt_T = lie.augment_pose(torch.as_tensor(np.asarray(gt_xyt, np.float32))).numpy()

    est_t = poses_world[:, :3, 3]
    gt_t = gt_T[:, :3, 3]
    align_T = _umeyama(est_t, gt_t)
    scale = float(np.linalg.norm(align_T[:3, 0]))

    angles = np.arctan2(poses_world[:, 1, 0], poses_world[:, 0, 0]) + np.pi / 2.0
    angles_gt = np.arctan2(gt_T[:, 1, 0], gt_T[:, 0, 0])
    trans_err = np.linalg.norm(est_t * scale - gt_t, axis=1)
    rot_err_parity = np.abs(angles - angles_gt)
    rot_err_fixed = np.abs(lie.wrap_angle(torch.as_tensor(angles - angles_gt)).numpy())

    aligned = est_t @ align_T[:3, :3].T + align_T[:3, 3]
    ate_rmse = float(np.sqrt(np.mean(np.sum((aligned - gt_t) ** 2, axis=1))))

    # robot-frame metric: metric scale from camera centres vs GT camera
    # centres (gt · mount), rescale, right-multiply mount^-1, then align
    mount = cfg.mount_T().astype(np.float64)
    gt_cam_t = np.einsum("fij,jk->fik", gt_T.astype(np.float64), mount)[:, :3, 3]
    P = poses.astype(np.float64)
    A1 = _umeyama(P[:, :3, 3], gt_cam_t)
    Pm = P.copy()
    Pm[:, :3, 3] *= float(np.linalg.norm(A1[:3, 0]))
    rob_t = np.einsum("fij,jk->fik", Pm, np.linalg.inv(mount))[:, :3, 3]
    A2 = _umeyama(rob_t, gt_t)
    rob_aligned = rob_t @ A2[:3, :3].T + A2[:3, 3]
    trans_err_robot = np.linalg.norm(rob_aligned - gt_t, axis=1)
    ate_robot = float(np.sqrt(np.mean(trans_err_robot ** 2)))

    return EvalResult(
        poses_world, gt_T, scale, align_T, angles, angles_gt,
        trans_err, rot_err_parity, rot_err_fixed, ate_rmse,
        trans_err_robot, ate_robot,
    )


def world_points_output(state, cfg: EngineConfig, scale: float):
    """The estimated_world_points.txt dump: for each id in [0, 1000), the
    FIRST map entry with that id_real, axis remapped and scaled.  ``state``:
    a VOState on any device.  Returns (ids (M,), points (M, 3)) sorted by
    id."""
    cam_to_image = cfg.cam_to_image()
    ids, xyz, valid = (to_host(x) for x in (state.map_id_real, state.map_xyz, state.map_valid))
    out_ids, out_pts = [], []
    for wid in range(1000):
        hits = np.nonzero(valid & (ids == wid))[0]
        if len(hits):
            p = xyz[hits[0]]
            q = cam_to_image[:3, :3] @ p * scale + cam_to_image[:3, 3]
            out_ids.append(wid)
            out_pts.append(q)
    return np.asarray(out_ids, np.int32), np.asarray(out_pts, np.float32)


def write_outputs(out_dir: str, result: EvalResult, state=None, cfg=None):
    """Write the four reference-format artifacts: estimated_trajectory.txt,
    estimated_trajectory_scaled.txt, errors.txt and (with a state)
    estimated_world_points.txt."""
    os.makedirs(out_dir, exist_ok=True)
    F = result.poses_world.shape[0]
    est_t = result.poses_world[:, :3, 3]
    with open(os.path.join(out_dir, "estimated_trajectory.txt"), "w") as f_raw, open(
        os.path.join(out_dir, "estimated_trajectory_scaled.txt"), "w"
    ) as f_scl, open(os.path.join(out_dir, "errors.txt"), "w") as f_err:
        for j in range(F):
            a = result.angles[j]
            f_raw.write(f"{j} {est_t[j,0]:g} {est_t[j,1]:g} {a:g}\n")
            st = est_t[j] * result.scale
            f_scl.write(f"{j} {st[0]:g} {st[1]:g} {a:g}\n")
            f_err.write(f"{j} {result.trans_err[j]:g} {result.rot_err_parity[j]:g}\n")
    if state is not None:
        ids, pts = world_points_output(state, cfg or EngineConfig(), result.scale)
        with open(os.path.join(out_dir, "estimated_world_points.txt"), "w") as f:
            for wid, p in zip(ids, pts):
                f.write(f"{wid} {p[0]:g} {p[1]:g} {p[2]:g}\n")


def scale_from_norm_ratio(points_est, points_gt):
    """Average of per-point norm ratios (the reference's alternative scale
    estimator, compute_scale)."""
    n_est = np.linalg.norm(points_est, axis=-1)
    n_gt = np.linalg.norm(points_gt, axis=-1)
    ok = (n_est > 0) & (n_gt > 0)
    if not ok.any():
        return 1.0
    return float(np.mean(n_gt[ok] / n_est[ok]))


def rotation_error_geodesic(R_est, R_gt):
    """Geodesic angle between rotations."""
    R_err = np.einsum("...ij,...kj->...ik", R_est, R_gt)
    tr = R_err[..., 0, 0] + R_err[..., 1, 1] + R_err[..., 2, 2]
    return np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0))


def rpe(poses_world, gt_T, delta: int = 1, scale: float = 1.0, cam_to_image=None):
    """Relative pose error over frame gaps of ``delta``: (trans_rmse,
    rot_rmse), with the estimated relative rotations conjugated from camera
    axes back to world axes."""
    if cam_to_image is None:
        cam_to_image = EngineConfig().cam_to_image()
    C = cam_to_image[:3, :3]
    P = poses_world.copy()
    P[:, :3, 3] *= scale

    def rel(T):
        return np.einsum("fij,fjk->fik", np.linalg.inv(T[:-delta]), T[delta:])

    dP, dQ = rel(P), rel(gt_T)
    dP_R = np.einsum("ij,fjk,lk->fil", C, dP[:, :3, :3], C)
    dP_t = np.einsum("ij,fj->fi", C, dP[:, :3, 3])
    t_err = np.linalg.norm(dP_t - dQ[:, :3, 3], axis=1)
    r_err = rotation_error_geodesic(dP_R, dQ[:, :3, :3])
    return float(np.sqrt((t_err**2).mean())), float(np.sqrt((r_err**2).mean()))


def metrics_dict(result: EvalResult) -> dict:
    rpe_t, rpe_r = rpe(result.poses_world, result.gt_T, scale=result.scale)
    return {
        "scale": result.scale,
        "ate_rmse": result.ate_rmse,
        "rpe_trans_rmse": rpe_t,
        "rpe_rot_rmse": rpe_r,
        "trans_err_mean": float(result.trans_err.mean()),
        "trans_err_max": float(result.trans_err.max()),
        "trans_err_final": float(result.trans_err[-1]),
        "ate_robot": result.ate_robot,
        "trans_err_robot_mean": float(result.trans_err_robot.mean()),
        "trans_err_robot_max": float(result.trans_err_robot.max()),
        "rot_err_parity_mean": float(result.rot_err_parity.mean()),
        "rot_err_fixed_mean": float(result.rot_err_fixed.mean()),
    }
