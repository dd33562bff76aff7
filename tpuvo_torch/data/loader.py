"""Padded per-frame observation types (the ``.dat`` parsers are not ported
yet; see ``tpuvo/data/loader.py`` for the file formats)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


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
