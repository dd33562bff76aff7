"""VO state: a NamedTuple of fixed-capacity tensors (twin of
``tpuvo/engine/state.py``), plus converters to and from the numpy form
of either package's state — they let both packages step from one state.

The batched tracker gives every field a leading lane axis B (pose (B, 4,
4), map_xyz (B, C, 3), map_count (B,), ...): the layout of a ``jax.vmap``
of the JAX twin, so its batched state converts straight across.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpuvo_torch.config import EngineConfig


class VOState(NamedTuple):
    pose: torch.Tensor         # (4, 4) camera-in-world pose of the latest frame
    map_xyz: torch.Tensor      # (C, 3) landmark positions (world = camera-0 frame)
    map_desc: torch.Tensor     # (C, D) landmark appearance descriptors
    map_id_real: torch.Tensor  # (C,) int32 GT landmark id oracle (from first view)
    map_id_meas: torch.Tensor  # (C,) int32 measurement id of the first view
    map_valid: torch.Tensor    # (C,) bool slot occupancy
    map_count: torch.Tensor    # () int32 occupied slots
    vel: torch.Tensor          # (4, 4) last relative motion (constant-velocity init)
    map_last_seen: torch.Tensor  # (C,) int32 frame of the last 2D-3D match
    frame_idx: torch.Tensor    # () int32 frames tracked so far (0 after bootstrap)


_DTYPES = {
    "pose": torch.float32, "map_xyz": torch.float32, "map_desc": torch.float32,
    "map_id_real": torch.int32, "map_id_meas": torch.int32, "map_valid": torch.bool,
    "map_count": torch.int32, "vel": torch.float32, "map_last_seen": torch.int32,
    "frame_idx": torch.int32,
}


def check_device(device) -> None:
    """The entry points and converters run on the card unless the caller
    asks for the CPU; without a card they raise rather than fall back."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: no CUDA device is available "
                           "(pass device='cpu' to run on the CPU)")


def empty_state(cfg: EngineConfig, device="cuda", lanes: int | None = None) -> VOState:
    """The state before the bootstrap on ``device`` (the card by default);
    ``lanes``: a leading lane axis of that size (None: no lane axis)."""
    check_device(device)
    C, D = cfg.map_capacity, cfg.desc_dim
    B = () if lanes is None else (lanes,)
    kw = dict(device=device)
    eye = torch.eye(4, dtype=torch.float32, **kw).expand(B + (4, 4))
    return VOState(
        pose=eye.clone(),
        vel=eye.clone(),
        map_xyz=torch.zeros(B + (C, 3), dtype=torch.float32, **kw),
        map_desc=torch.zeros(B + (C, D), dtype=torch.float32, **kw),
        map_id_real=torch.full(B + (C,), -1, dtype=torch.int32, **kw),
        map_id_meas=torch.full(B + (C,), -1, dtype=torch.int32, **kw),
        map_valid=torch.zeros(B + (C,), dtype=torch.bool, **kw),
        map_count=torch.zeros(B, dtype=torch.int32, **kw),
        map_last_seen=torch.zeros(B + (C,), dtype=torch.int32, **kw),
        frame_idx=torch.zeros(B, dtype=torch.int32, **kw),
    )


def tuple_from_numpy(cls, dtypes: dict, fields, device="cuda"):
    """A NamedTuple ``cls`` of tensors on ``device`` (the card by default)
    from arrays keyed by field name (a mapping, or any object with those
    attributes — e.g. the JAX package's twin of ``cls``); ``dtypes`` maps
    each field to its tensor dtype."""
    check_device(device)
    get = fields.__getitem__ if isinstance(fields, dict) else (lambda k: getattr(fields, k))
    return cls(**{k: torch.as_tensor(np.array(get(k)), dtype=dtypes[k], device=device)
                  for k in cls._fields})


def to_host(x) -> np.ndarray:
    """A numpy copy of a tensor on any device; any other array as numpy."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def tuple_to_numpy(tup) -> dict:
    """Field name -> numpy array (host copy) of a NamedTuple of tensors."""
    return {k: to_host(getattr(tup, k)) for k in tup._fields}


def state_from_numpy(fields, device="cuda") -> VOState:
    """VOState from numpy arrays keyed by field name (see tuple_from_numpy)."""
    return tuple_from_numpy(VOState, _DTYPES, fields, device)


def state_to_numpy(state: VOState) -> dict:
    """Field name -> numpy array (host copy)."""
    return tuple_to_numpy(state)


class FrameLog(NamedTuple):
    """Per-frame diagnostics (the reference's stdout narration, structured);
    each field gains the state's lane axis in front, and ``scan_tracker``
    stacks frames after it."""

    pose: torch.Tensor           # (4, 4) camera-in-world after tracking
    num_inliers: torch.Tensor    # PICP inliers
    chi_inliers: torch.Tensor
    iterations: torch.Tensor
    converged: torch.Tensor
    n_map_matches: torch.Tensor  # 2D-3D matches
    n_map_correct: torch.Tensor  # ... of which GT-correct (id_real oracle)
    n_frame_matches: torch.Tensor  # 2D-2D matches
    n_new_points: torch.Tensor   # landmarks triangulated this frame
    map_count: torch.Tensor
    n_dropped_candidates: torch.Tensor  # candidates beyond the per-frame cap
    n_dropped_overflow: torch.Tensor    # appends beyond map capacity
