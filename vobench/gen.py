"""The benchmark's inputs: the configuration's recorded sequence (a random
landmark world, a planar or looped camera path, and the frames a pinhole
camera sees along it, padded to ``max_obs`` keypoints with 10-dim
descriptors), drawn from the configuration's own seed, then each problem's
own pixel noise, drawn from ``--seed``.

The arithmetic is the synthetic world of the project's test data (uniform
landmarks with unique uniform descriptors; the keypoints kept by a fixed
per-landmark saliency times depth squared), kept here so that a later
change to the program's own generator leaves the benchmark's inputs as
they are.  Everything is numpy on the host; ``to_device`` moves a batch of
sequences in one copy per field.
"""

from __future__ import annotations

import numpy as np

FIELDS = ("uv", "desc", "id_meas", "id_real", "valid")


def world(seed: int, n_landmarks: int, xy_extent: float, z_range, desc_dim: int):
    rng = np.random.default_rng(seed)
    xyz = np.concatenate([rng.uniform(-xy_extent, xy_extent, (n_landmarks, 2)),
                          rng.uniform(z_range[0], z_range[1], (n_landmarks, 1))],
                         axis=1).astype(np.float32)
    desc = rng.uniform(-1.0, 1.0, (n_landmarks, desc_dim)).astype(np.float32)
    return xyz, desc


def planar_path(n_frames: int, step: float = 0.2, turn: float = 0.02, seed: int = 0):
    """Forward-dominant planar path: (F, 3) (x, y, theta)."""
    rng = np.random.default_rng(seed)
    poses = np.zeros((n_frames, 3), np.float32)
    for i in range(1, n_frames):
        x, y, th = poses[i - 1]
        th = th + turn + 0.01 * rng.standard_normal()
        poses[i] = [x + step * np.cos(th), y + step * np.sin(th), th]
    return poses


def loop_path(n_frames: int, step: float = 1.0, seed: int = 0, turn_frames: int = 12):
    """Closed square circuit, four straights and four 90-degree turns."""
    rng = np.random.default_rng(seed)
    straight = max((n_frames - 4 * turn_frames) // 4, 1)
    phase = []
    for _ in range(4):
        phase += [0.0] * straight + [(np.pi / 2) / turn_frames] * turn_frames
    phase += [0.0] * max(n_frames - len(phase), 0)
    poses = np.zeros((n_frames, 3), np.float32)
    for i in range(1, n_frames):
        x, y, th = poses[i - 1]
        th = th + phase[i - 1] + 0.002 * rng.standard_normal()
        poses[i] = [x + step * np.cos(th), y + step * np.sin(th), th]
    return poses


def K_of(cam: dict) -> np.ndarray:
    return np.array([[cam["fx"], 0.0, cam["cx"]], [0.0, cam["fy"], cam["cy"]],
                     [0.0, 0.0, 1.0]], np.float32)


def mount(cam: dict) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.array(cam["cam_to_image_rotation"], np.float32)
    T[:3, 3] = np.array(cam["cam_to_image_translation"], np.float32)
    return T


def render(xyz, desc, path, cam: dict, max_obs: int, pixel_noise: float, seed: int) -> dict:
    """Frames (F, max_obs, ...) of the world seen along ``path``; id_real is
    the landmark, id_meas the keypoint's index in its frame."""
    rng = np.random.default_rng(seed)
    K = K_of(cam)
    M = mount(cam)
    F = len(path)
    saliency = rng.uniform(size=len(xyz)).astype(np.float32)
    out = dict(uv=np.zeros((F, max_obs, 2), np.float32),
               desc=np.zeros((F, max_obs, desc.shape[1]), np.float32),
               id_meas=np.full((F, max_obs), -1, np.int32),
               id_real=np.full((F, max_obs), -1, np.int32),
               valid=np.zeros((F, max_obs), bool))
    for i, (x, y, th) in enumerate(path):
        c, s = np.cos(th), np.sin(th)
        T_wr = np.eye(4, dtype=np.float32)
        T_wr[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        T_wr[:3, 3] = [x, y, 0.0]
        T_cw = np.linalg.inv(T_wr @ M)
        p = xyz @ T_cw[:3, :3].T + T_cw[:3, 3]
        with np.errstate(divide="ignore", invalid="ignore"):
            ph = p @ K.T
            uv = ph[:, :2] / ph[:, 2:3]
        ok = (p[:, 2] > 0) & np.isfinite(uv).all(1)
        ok &= (uv[:, 0] >= 0) & (uv[:, 0] <= cam["width"] - 1)
        ok &= (uv[:, 1] >= 0) & (uv[:, 1] <= cam["height"] - 1)
        sel = np.nonzero(ok)[0]
        if len(sel) > max_obs:
            score = saliency[sel] * np.maximum(p[sel, 2], 1.0) ** 2
            sel = sel[np.argsort(score)[:max_obs]]
        n = len(sel)
        obs = uv[sel]
        if pixel_noise > 0:
            obs = obs + pixel_noise * rng.standard_normal(obs.shape)
        out["uv"][i, :n] = obs
        out["desc"][i, :n] = desc[sel]
        out["id_real"][i, :n] = sel
        out["id_meas"][i, :n] = np.arange(n)
        out["valid"][i, :n] = True
    return out


def sequence(config: dict) -> dict:
    """The configuration's recorded sequence: its world and path
    (``config["data"]``), rendered with the configuration's pixel noise, all
    drawn from the configuration's own ``data.seed``.  It is the same for
    every run: a run's seed varies only each problem's noise (``problems``),
    the RANSAC draws and what the check samples, so the work a run does is
    the same from seed to seed."""
    d = config["data"]
    cam = config["camera"]
    rng = np.random.default_rng(d["seed"])
    path_seed, world_seed, render_seed = (int(x) for x in rng.integers(0, 2**31, 3))
    if d["path"] == "planar":
        path = planar_path(d["frames"], d["step_m"], seed=path_seed)
    else:
        path = loop_path(d["frames"], d["step_m"], seed=path_seed)
    extent = float(np.abs(path[:, :2]).max()) + d["world_margin_m"]
    xyz, desc = world(world_seed, d["landmarks"], extent, d["z_range_m"],
                      config["engine"]["desc_dim"])
    seq = render(xyz, desc, path, cam, config["engine"]["max_obs"], d["pixel_noise_px"],
                 render_seed)
    seq["path"] = path
    return seq


def problems(seq: dict, n: int, noise_px: float, seed: int) -> dict:
    """n problems (n, F, N, ...): the sequence with each problem's own
    ``noise_px`` of pixel noise on its valid keypoints, drawn at once over
    the frame axis."""
    rng = np.random.default_rng(seed)
    noise = noise_px * rng.standard_normal((n,) + seq["uv"].shape).astype(np.float32)
    out = {k: np.broadcast_to(seq[k], (n,) + seq[k].shape) for k in FIELDS}
    out["uv"] = seq["uv"][None] + noise * seq["valid"][None, ..., None]
    return out


def to_device(batch: dict, device) -> dict:
    import torch

    dt = dict(uv=torch.float32, desc=torch.float32, id_meas=torch.int32, id_real=torch.int32,
              valid=torch.bool)
    return {k: torch.as_tensor(np.array(batch[k]), dtype=dt[k], device=device)
            for k in FIELDS}


def problem_seed(seed: int, j: int) -> int:
    """The RANSAC seed of problem j (a sequence of a stream) of a run."""
    return (seed * 1_000_003 + 7919 * j) % (2**62)
