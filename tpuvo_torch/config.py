"""Typed configuration for the whole engine.

Field-for-field mirror of ``tpuvo/config.py`` (same names, same defaults), so
one set of keyword arguments builds both packages' configs.  The reference
constants behind each default are documented there.

Option strings are unchanged.  ``"pallas"`` — in ``PICPConfig.backend`` and
``MatcherConfig.method`` — selects the port's hand-written CUDA kernel
(``ops/cuda/``) for CUDA tensors; for CPU tensors the same option runs the
kernel's plain PyTorch version.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np

DESC_DIM = 10          # descriptor length
MAX_OBS = 128          # max observations per frame
MAP_CAPACITY = 512     # landmark map capacity
N_GT_LANDMARKS = 1000  # world.dat size


@dataclass(frozen=True)
class MatcherConfig:
    """Brute-force descriptor matcher thresholds.

    method: "direct" expands (a-b)^2; "mxu" uses |a|^2+|b|^2-2ab with the
    inner product as one matmul; "mxu_bf16" feeds the cross term in bf16
    (fp32 accumulation).  "pallas" is the fused top-2 kernel: on CUDA
    tensors the hand-written kernel of ``ops/cuda/match_kernel.py`` (the
    (N, M) distance matrix never materializes), on CPU tensors its plain
    PyTorch version.
    """

    distance_threshold: float = 0.2
    ratio_threshold: float = 0.8
    method: str = "direct"


@dataclass(frozen=True)
class PICPConfig:
    """Projective-ICP Gauss-Newton schedule (see tpuvo/config.py for the
    reference line each default comes from).

    backend: "xla" or "pallas", the JAX package's names.  Both launch the
    whole GN loop as one CUDA kernel (``ops/cuda/picp_kernel.py``) on CUDA
    tensors — the port's one device program for the loop, as XLA's
    while_loop is JAX's — and run its plain PyTorch version
    (``ops/picp.solve``, ``solve_unrolled``) on CPU tensors.  They differ
    as in JAX: "pallas" ignores ``unrolled_rounds`` and refuses
    ``annealed_kernel`` without per-lane thresholds; the kernel itself
    runs the annealed schedule and the unrolled cap.
    """

    kernel_threshold: float = 3000.0
    damping: float = 1.0
    max_iterations: int = 50
    convergence_threshold: float = 1e-5
    min_num_inliers: int = 0
    keep_outliers: bool = False
    min_matches_reuse_pose: int = 0
    unrolled_rounds: int = 0
    annealed_kernel: bool = False
    anneal_mult: float = 4.0
    backend: str = "xla"


@dataclass(frozen=True)
class RansacConfig:
    """Essential-matrix RANSAC: a fixed-size batch of 8-point minimal solves."""

    num_hypotheses: int = 512
    sample_size: int = 8
    inlier_threshold_px: float = 1.0
    seed: int = 42


@dataclass(frozen=True)
class BAConfig:
    """Sliding-window bundle adjustment: the local BA inside SLAM tracking
    and the global refiners (``ba/window.py``, ``engine/ba_refine.py``)."""

    window: int = 10
    max_landmarks: int = MAP_CAPACITY
    max_obs_per_frame: int = MAX_OBS
    iterations: int = 10
    damping: float = 1.0e-6
    huber_threshold: float = 3000.0
    keep_outliers: bool = False
    cull_bounds: bool = True
    lm_adaptive: bool = True
    damping_init: float = 1.0
    assembly: str = "segsum"
    compact_cap: int | None = None
    compact_method: str = "sort"

    def replace(self, **kw) -> "BAConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class EngineConfig:
    """Full engine configuration (camera, capacities, tracker options)."""

    fx: float = 180.0
    fy: float = 180.0
    cx: float = 320.0
    cy: float = 240.0
    width: int = 640
    height: int = 480
    z_near: float = 0.0
    z_far: float = 5.0
    cam_to_image_rotation: Tuple[Tuple[float, float, float], ...] = (
        (0.0, 0.0, 1.0),
        (-1.0, 0.0, 0.0),
        (0.0, -1.0, 0.0),
    )
    cam_to_image_translation: Tuple[float, float, float] = (0.2, 0.0, 0.0)

    n_frames: int = 121
    max_obs: int = MAX_OBS
    map_capacity: int = MAP_CAPACITY
    desc_dim: int = DESC_DIM

    mode: str = "parity"  # "parity" | "fixed"

    gate_new_landmarks: bool | None = None
    landmark_max_reproj_px: float = 5.0
    triangulation_refine_iters: int = 2
    max_new_landmarks_per_frame: int = 32
    map_evict_age: int = 0
    landmark_min_parallax_rad: float = 0.01
    fuse_frame_matchers: bool = False
    motion_model_init: bool = False
    motion_model_alpha: float = 0.5
    log_stats: bool = True
    scan_unroll: int = 1
    local_ba_window: int = 16
    local_ba_every: int = 2
    local_ba_iterations: int = 6
    local_ba_stride: int = 1
    local_ba_compact_cap: int | None = 512
    local_ba_damping_init: float = 0.01

    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    picp: PICPConfig = field(default_factory=PICPConfig)
    ransac: RansacConfig = field(default_factory=RansacConfig)
    ba: BAConfig = field(default_factory=BAConfig)

    @property
    def gating_enabled(self) -> bool:
        if self.gate_new_landmarks is not None:
            return self.gate_new_landmarks
        return self.mode == "fixed"

    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )

    def cam_to_image(self) -> np.ndarray:
        """4x4 camera->world axis remap; the 0.2 m offset only in fixed mode."""
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.array(self.cam_to_image_rotation, dtype=np.float32)
        if self.mode == "fixed":
            T[:3, 3] = np.array(self.cam_to_image_translation, dtype=np.float32)
        return T

    def mount_T(self) -> np.ndarray:
        """4x4 camera-in-robot mount transform, always with the x-offset."""
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.array(self.cam_to_image_rotation, dtype=np.float32)
        T[:3, 3] = np.array(self.cam_to_image_translation, dtype=np.float32)
        return T

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def from_camera_dat(path: str, **overrides) -> "EngineConfig":
        """Parse ``camera.dat`` (the reference never reads it).

        Format::

            camera matrix:
            <3x3>
            cam_transform:
            <4x4>
            z_near: <f>
            z_far:  <f>
            width:  <i>
            height: <i>
        """
        with open(path) as f:
            text = f.read()
        nums = lambda line: [float(x) for x in line.split()]

        lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
        K_rows, T_rows = [], []
        scalars = {}
        i = 0
        while i < len(lines):
            ln = lines[i]
            if ln.startswith("camera matrix"):
                K_rows = [nums(lines[i + j]) for j in (1, 2, 3)]
                i += 4
            elif ln.startswith("cam_transform"):
                T_rows = [nums(lines[i + j]) for j in (1, 2, 3, 4)]
                i += 5
            else:
                m = re.match(r"(\w+):\s*(-?[\d.]+)", ln)
                if m:
                    scalars[m.group(1)] = float(m.group(2))
                i += 1
        K = np.array(K_rows, dtype=np.float32)
        T = np.array(T_rows, dtype=np.float32)
        cfg = dict(
            fx=float(K[0, 0]),
            fy=float(K[1, 1]),
            cx=float(K[0, 2]),
            cy=float(K[1, 2]),
            width=int(scalars.get("width", 640)),
            height=int(scalars.get("height", 480)),
            z_near=float(scalars.get("z_near", 0.0)),
            z_far=float(scalars.get("z_far", 5.0)),
            cam_to_image_rotation=tuple(tuple(float(v) for v in row[:3]) for row in T[:3]),
            cam_to_image_translation=tuple(float(row[3]) for row in T[:3]),
        )
        cfg.update(overrides)
        return EngineConfig(**cfg)


DEFAULT_CONFIG = EngineConfig()
