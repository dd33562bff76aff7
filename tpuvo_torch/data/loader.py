"""Dataset parsers -> fixed-capacity padded numpy arrays (twin of
``tpuvo/data/loader.py``, same formats, same arrays).

File formats (reverse-engineered from the reference parsers)::

    meas-%05d.dat   seq: <i>
                    gt_pose: <x> <y> <theta>
                    odom_pose: <x> <y> <theta>
                    point <id_meas> <id_real> <u> <v> <d0> ... <d9>   (one per observation)
    world.dat       <id> <x> <y> <z> <d0> ... <d9>                    (one per landmark)
    trajectoy.dat   <id> <odom_x> <odom_y> <odom_theta> <gt_x> <gt_y> <gt_theta>   [sic]
    camera.dat      see ``EngineConfig.from_camera_dat``

Parsing runs once on the host.  ``load_sequence`` uses the native C++
parser (``tpuvo_torch.data.native``) when the host has a C++ compiler and
this module's Python parser otherwise; unlike the JAX twin it does not
fall back on any error: a native build or parse that fails raises.
``tpuvo_torch.data.writer`` writes these formats.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

from tpuvo_torch.config import DESC_DIM, MAX_OBS, EngineConfig


class FrameObservations(NamedTuple):
    """Structure-of-arrays batch of per-frame observations (padded, numpy).

    Shapes (F = number of frames, N = max_obs):
      uv (F, N, 2) f32, desc (F, N, D) f32, id_meas (F, N) i32,
      id_real (F, N) i32 (ground-truth landmark id), valid (F, N) bool,
      n_obs (F,) i32, gt_pose (F, 3) f32 (x, y, theta), odom_pose (F, 3) f32.
    """

    uv: np.ndarray
    desc: np.ndarray
    id_meas: np.ndarray
    id_real: np.ndarray
    valid: np.ndarray
    n_obs: np.ndarray
    gt_pose: np.ndarray
    odom_pose: np.ndarray

    @property
    def num_frames(self) -> int:
        return self.uv.shape[0]


class WorldPoints(NamedTuple):
    """Ground-truth landmark set."""

    xyz: np.ndarray      # (L, 3) float32
    desc: np.ndarray     # (L, D) float32
    ids: np.ndarray      # (L,) int32


def parse_measurement(path: str):
    """Parse one ``meas-%05d.dat`` file.

    Returns (seq, gt_pose(3,), odom_pose(3,), id_meas(n,), id_real(n,),
    uv(n,2), desc(n,D)) as numpy arrays.
    """
    seq = -1
    gt = np.zeros(3, np.float32)
    odom = np.zeros(3, np.float32)
    id_meas, id_real, uvs, descs = [], [], [], []
    with open(path) as f:
        for line in f:
            toks = line.split()
            if not toks:
                continue
            key = toks[0]
            if key == "seq:":
                seq = int(toks[1])
            elif key == "gt_pose:":
                gt = np.array([float(t) for t in toks[1:4]], np.float32)
            elif key == "odom_pose:":
                odom = np.array([float(t) for t in toks[1:4]], np.float32)
            elif key == "point":
                # point id_meas id_real u v d0..d9
                id_meas.append(int(toks[1]))
                id_real.append(int(toks[2]))
                uvs.append((float(toks[3]), float(toks[4])))
                descs.append([float(t) for t in toks[5 : 5 + DESC_DIM]])
    n = len(id_meas)
    return (
        seq,
        gt,
        odom,
        np.asarray(id_meas, np.int32),
        np.asarray(id_real, np.int32),
        np.asarray(uvs, np.float32).reshape(n, 2),
        np.asarray(descs, np.float32).reshape(n, DESC_DIM),
    )


def load_sequence(
    data_dir: str,
    n_frames: int = 121,
    prefix: str = "meas-",
    max_obs: int = MAX_OBS,
    use_native: bool = True,
) -> FrameObservations:
    """Load ``{data_dir}/{prefix}%05d.dat`` for i in [0, n_frames) into
    padded arrays.  use_native: the C++ parser when the host can build it
    (see the module docstring), else the Python parser below."""
    if use_native:
        from tpuvo_torch.data import native

        if native.library() is not None:
            return native.load_sequence(data_dir, n_frames, prefix, max_obs)
    F = n_frames
    uv = np.zeros((F, max_obs, 2), np.float32)
    desc = np.zeros((F, max_obs, DESC_DIM), np.float32)
    id_meas = np.full((F, max_obs), -1, np.int32)
    id_real = np.full((F, max_obs), -1, np.int32)
    valid = np.zeros((F, max_obs), bool)
    n_obs = np.zeros((F,), np.int32)
    gt_pose = np.zeros((F, 3), np.float32)
    odom_pose = np.zeros((F, 3), np.float32)

    for i in range(F):
        path = os.path.join(data_dir, f"{prefix}{i:05d}.dat")
        _, gt, odom, im, ir, p_uv, p_desc = parse_measurement(path)
        n = len(im)
        if n > max_obs:
            raise ValueError(f"{path}: {n} observations exceeds max_obs={max_obs}")
        uv[i, :n] = p_uv
        desc[i, :n] = p_desc
        id_meas[i, :n] = im
        id_real[i, :n] = ir
        valid[i, :n] = True
        n_obs[i] = n
        gt_pose[i] = gt
        odom_pose[i] = odom

    return FrameObservations(uv, desc, id_meas, id_real, valid, n_obs, gt_pose, odom_pose)


def load_world_points(path: str) -> WorldPoints:
    """Parse world.dat; short and malformed lines are skipped, like the
    reference."""
    xyz, desc, ids = [], [], []
    with open(path) as f:
        for line in f:
            toks = line.split()
            if len(toks) < 4 + DESC_DIM:
                continue
            try:
                row = [float(t) for t in toks[: 4 + DESC_DIM]]
            except ValueError:
                continue
            ids.append(int(row[0]))
            xyz.append(row[1:4])
            desc.append(row[4 : 4 + DESC_DIM])
    return WorldPoints(
        np.asarray(xyz, np.float32),
        np.asarray(desc, np.float32),
        np.asarray(ids, np.int32),
    )


def load_trajectory(path: str):
    """Parse trajectoy.dat [sic]: columns (id, odom xy-theta, gt xy-theta).

    Returns (odom (F,3) float32, gt (F,3) float32).
    """
    rows = np.loadtxt(path, dtype=np.float64)
    return rows[:, 1:4].astype(np.float32), rows[:, 4:7].astype(np.float32)


def load_camera_config(path: str, **overrides) -> EngineConfig:
    """Parse camera.dat into an EngineConfig."""
    return EngineConfig.from_camera_dat(path, **overrides)
