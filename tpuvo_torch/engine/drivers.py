"""The reference's four executables as library entry points (twin of
``tpuvo/engine/drivers.py``):

  * run_icp               — exec/icp_test.cpp (the canonical pipeline)
  * run_vo                — exec/vo.cpp (kernel 1000, fixed 5 GN rounds,
                            path-length-ratio scale, duplicate-landmark count)
  * run_match_test        — exec/match_points_test.cpp
  * run_pose_recovery     — exec/pose_recovery_test.cpp
  * run_triangulate_test  — exec/triangulate_points_test.cpp

Each runs on ``device`` (the card by default).  Where the JAX twin vmaps
the F-1 consecutive pairs, the port puts them on the lane axis of
``match_descriptors`` and ``twoview.bootstrap_pose``: one batched call for
all pairs, and the results pulled to the host together at the end.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpuvo_torch.config import EngineConfig, PICPConfig
from tpuvo_torch.data.loader import FrameObservations
from tpuvo_torch.engine import vo
from tpuvo_torch.engine.state import to_host
from tpuvo_torch.ops import lie, twoview
from tpuvo_torch.ops.match import match_descriptors, match_stats


def run_icp(seq: FrameObservations, cfg: EngineConfig | None = None, seed: int = 42,
            device="cuda"):
    """The canonical icp_test pipeline."""
    return vo.run_sequence(seq, cfg, seed, device=device)


def duplicate_landmark_count(state) -> int:
    """check_world_points_sanity: number of GT ids owning more than one map
    entry."""
    ids = to_host(state.map_id_real)[to_host(state.map_valid)]
    counts = np.bincount(ids[ids >= 0], minlength=1000)
    return int((counts > 1).sum())


def path_length_scale(poses, gt_xyt, cfg: EngineConfig) -> float:
    """vo.cpp's scale: ground-truth path length over the estimated one
    (camera-in-world poses axis-remapped to the world)."""
    poses_world = np.einsum("ij,fjk->fik", cfg.cam_to_image(), to_host(poses))
    gt_T = lie.augment_pose(torch.as_tensor(np.asarray(gt_xyt, np.float32))).numpy()
    est_len = np.linalg.norm(np.diff(poses_world[:, :3, 3], axis=0), axis=1).sum()
    gt_len = np.linalg.norm(np.diff(gt_T[:, :3, 3], axis=0), axis=1).sum()
    return float(gt_len / est_len) if est_len > 0 else 1.0


def run_vo(seq: FrameObservations, cfg: EngineConfig | None = None, seed: int = 42,
           device="cuda"):
    """The vo.cpp driver variant: icp_test's skeleton, but PICP at kernel
    threshold 1000 with a fixed 5 rounds and no convergence check, and the
    final scale from the path-length ratio."""
    cfg = cfg or EngineConfig()
    cfg = cfg.replace(picp=PICPConfig(
        kernel_threshold=1000.0,
        max_iterations=5,
        convergence_threshold=0.0,  # never triggers: rel >= 0 > -eps
    ))
    state, logs, poses, diag = vo.run_sequence(seq, cfg, seed, device=device)
    return state, logs, poses, {**diag,
                                "scale_path_ratio": path_length_scale(poses, seq.gt_pose, cfg),
                                "duplicates": duplicate_landmark_count(state)}


class MatchTestRow(NamedTuple):
    frame: int
    possible: int
    found: int
    correct: int


def run_match_test(seq: FrameObservations, cfg: EngineConfig | None = None, device="cuda"):
    """match_points_test: match every consecutive pair (the pairs as lanes
    of one call), report possible/found/GT-correct counts."""
    cfg = cfg or EngineConfig()
    fr = vo.frames_of(seq, 0, seq.uv.shape[0], device)
    res = match_descriptors(fr.desc[:-1], fr.valid[:-1], fr.desc[1:], fr.valid[1:],
                            cfg.matcher.distance_threshold, cfg.matcher.ratio_threshold)
    st = match_stats(res, fr.id_real[:-1], fr.valid[:-1], fr.id_real[1:], fr.valid[1:])
    p, f, c = to_host(torch.stack(st))
    return [MatchTestRow(i, int(p[i]), int(f[i]), int(c[i])) for i in range(len(p))]


def run_pose_recovery(seq: FrameObservations, cfg: EngineConfig | None = None, seed: int = 42,
                      device="cuda", sample_idx=None):
    """pose_recovery_test: chain two-view essential-matrix poses over
    consecutive pairs (unit-norm translations — scale drift is expected),
    axis-remap, return ((F, 4, 4) chained poses, inliers per pair).

    The F-1 pairs are the lanes of one match and one RANSAC, each pair its
    own draw; sample_idx: optional (F-1, H, 8) minimal sets replacing it."""
    cfg = cfg or EngineConfig()
    fr = vo.frames_of(seq, 0, seq.uv.shape[0], device)
    res = match_descriptors(fr.desc[:-1], fr.valid[:-1], fr.desc[1:], fr.valid[1:],
                            cfg.matcher.distance_threshold, cfg.matcher.ratio_threshold)
    T21s, rres, _ = twoview.bootstrap_pose(
        vo.make_generator(seed), vo._K(cfg, fr.uv.device), fr.uv[:-1],
        vo._take_rows(fr.uv[1:], res.idx), res.valid, cfg.ransac, sample_idx)
    T21s, n_inl = to_host(T21s), to_host(rres.num_inliers)
    poses = [np.eye(4, dtype=np.float32)]
    for T21 in T21s:
        poses.append(poses[-1] @ T21)
    poses_world = np.einsum("ij,fjk->fik", cfg.cam_to_image(), np.stack(poses))
    return poses_world, [int(x) for x in n_inl]


def run_triangulate_test(seq: FrameObservations, world, cfg: EngineConfig | None = None,
                         seed: int = 42, device="cuda", sample_idx=None):
    """triangulate_points_test: bootstrap on frames 0-1, triangulate, and
    return (id_real, estimated-remapped point, GT point) triples for
    comparison against world.dat.  sample_idx: as ``vo.bootstrap``'s."""
    cfg = cfg or EngineConfig()
    fr = vo.frames_of(seq, 0, 2, device)
    state, _ = vo.bootstrap_jit(vo.make_generator(seed), vo.frame_at(fr, 0), vo.frame_at(fr, 1),
                                cfg, sample_idx)
    n = int(state.map_count)
    ids = to_host(state.map_id_real)[:n]
    pts = to_host(state.map_xyz)[:n]
    cam_to_image = cfg.cam_to_image()
    pts_world = pts @ cam_to_image[:3, :3].T + cam_to_image[:3, 3]
    gt_lookup = {int(i): world.xyz[k] for k, i in enumerate(world.ids)}
    gt = np.stack([gt_lookup.get(int(i), np.full(3, np.nan)) for i in ids])
    return ids, pts_world, gt
