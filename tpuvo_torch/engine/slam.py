"""SLAM-mode tracking: the frame-to-frame tracker with an interleaved local
bundle-adjustment backend (twin of ``tpuvo/engine/slam.py``).

Plain monocular tracking hands scale from frame to frame through single
PICP solves; on KITTI-scale forward motion (~1 m/frame) that handoff
collapses (ATE 28 on the 200-frame loop fixture).  Every ``local_ba_every``
frames a windowed BA re-estimates the last W keyframe poses (spaced
``local_ba_stride`` apart) and their landmarks jointly, from ring buffers
of each frame's 2D-3D correspondences as the tracker computed them, plus
the founding observation of each landmark it triangulated.

The frame loop is a Python loop over ``slam_step``.  The frame counter k is
a host ``int``, so whether the BA fires (``k >= W·S and k % E == 0``)
costs no sync; the window and its ring slots are Python slices and a
``torch.roll`` of the (R, Nb) buffers, and every carried tensor is updated
out of place, so a carry handed to ``slam_step`` is never changed.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpuvo_torch.ba.window import BAProblem, ba_solve
from tpuvo_torch.config import BAConfig, EngineConfig
from tpuvo_torch.engine import vo
from tpuvo_torch.engine.state import VOState, state_from_numpy, state_to_numpy
from tpuvo_torch.ops import lie


class SLAMCarry(NamedTuple):
    """What ``slam_step`` carries from frame to frame (the JAX scan carry)."""

    state: VOState
    poses_all: torch.Tensor  # (F, 4, 4) camera-in-world, BA-corrected
    buf_lm: torch.Tensor     # (R, Nb) int64 map slot per observation, slot = frame % R
    buf_valid: torch.Tensor  # (R, Nb) bool
    buf_uv: torch.Tensor     # (R, Nb, 2) float32 pixels
    n_ba: int                # local BA runs so far
    k: int                   # index of the frame the next step tracks


def carry_from_numpy(carry, device="cuda") -> SLAMCarry:
    """SLAMCarry on ``device`` (the card by default) from the numpy form of
    either package's carry: a sequence (state, poses_all, buf_lm, buf_valid,
    buf_uv, n_ba, k) whose state is a VOState-like object or a mapping of
    numpy arrays."""
    state, poses_all, buf_lm, buf_valid, buf_uv, n_ba, k = carry
    t = lambda x, dt: torch.as_tensor(np.array(x), dtype=dt, device=device)
    return SLAMCarry(state_from_numpy(state, device), t(poses_all, torch.float32),
                     t(buf_lm, torch.int64), t(buf_valid, torch.bool),
                     t(buf_uv, torch.float32), int(n_ba), int(k))


def carry_to_numpy(carry: SLAMCarry) -> tuple:
    """(state dict, poses_all, buf_lm, buf_valid, buf_uv, n_ba, k) on the host."""
    h = lambda x: x.detach().cpu().numpy()
    return (state_to_numpy(carry.state), h(carry.poses_all), h(carry.buf_lm),
            h(carry.buf_valid), h(carry.buf_uv), carry.n_ba, carry.k)


def _check_evict_age(cfg: EngineConfig) -> None:
    """Ring-buffer observations reference map slots for up to W*S+E
    frames; reusing a slot inside that horizon would silently bind old
    observations to a NEW landmark in the local BA — fail loud."""
    horizon = cfg.local_ba_window * cfg.local_ba_stride + cfg.local_ba_every
    if 0 < cfg.map_evict_age <= horizon:
        raise ValueError(
            f"map_evict_age={cfg.map_evict_age} must exceed the ring "
            f"horizon local_ba_window*local_ba_stride+local_ba_every="
            f"{horizon} in SLAM mode")


def _local_ba_cfg(cfg: EngineConfig) -> BAConfig:
    return BAConfig(
        window=cfg.local_ba_window,
        iterations=cfg.local_ba_iterations,
        huber_threshold=cfg.ba.huber_threshold,
        lm_adaptive=cfg.ba.lm_adaptive,
        max_landmarks=cfg.map_capacity,
        cull_bounds=False,  # refinement semantics (see BAConfig.cull_bounds)
        # the JAX package's TPU choices, kept for config parity: the port
        # runs the same code for "onehot"/"segsum" and "mask"/"sort"
        assembly="onehot",
        compact_cap=cfg.local_ba_compact_cap,
        compact_method="mask",
        damping_init=cfg.local_ba_damping_init,
    )


def init_carry(state: VOState, n_frames: int, n_obs: int, cfg: EngineConfig) -> SLAMCarry:
    """The carry after the bootstrap: identity poses, empty ring buffers,
    next frame 1 — on the state's device."""
    dev = state.pose.device
    Nb = n_obs + cfg.max_new_landmarks_per_frame
    R = cfg.local_ba_window * cfg.local_ba_stride
    return SLAMCarry(
        state,
        torch.eye(4, dtype=torch.float32, device=dev).expand(n_frames, 4, 4).clone(),
        torch.zeros((R, Nb), dtype=torch.int64, device=dev),
        torch.zeros((R, Nb), dtype=torch.bool, device=dev),
        torch.zeros((R, Nb, 2), dtype=torch.float32, device=dev),
        0, 1)


def _set_row(x, i: int, value):
    out = x.clone()
    out[i] = value
    return out


def track_and_record(carry: SLAMCarry, curr: vo.Frame, nxt: vo.Frame, cfg: EngineConfig):
    """The tracking half of ``slam_step``: track frame k and write its pose
    and its map observations (matches + founding observations of its new
    landmarks) into poses_all[k] and ring slot k % R.  k is unchanged."""
    state, poses_all, buf_lm, buf_valid, buf_uv, n_ba, k = carry
    slot = k % (cfg.local_ba_window * cfg.local_ba_stride)
    state, log, (m_idx, m_valid, new_slots, new_uv, new_valid) = vo.track_step(
        state, curr, nxt, cfg, return_matches=True)
    return SLAMCarry(
        state, _set_row(poses_all, k, log.pose),
        _set_row(buf_lm, slot, torch.cat([m_idx, new_slots])),
        _set_row(buf_valid, slot, torch.cat([m_valid, new_valid])),
        _set_row(buf_uv, slot, torch.cat([nxt.uv, new_uv], 0)), n_ba, k), log


def local_ba_due(k: int, cfg: EngineConfig) -> bool:
    """Whether the local BA runs after tracking frame k — host ints only,
    so deciding costs no sync."""
    return k >= cfg.local_ba_window * cfg.local_ba_stride and k % cfg.local_ba_every == 0


def local_ba_window(k: int, cfg: EngineConfig) -> slice:
    """The frames of the local window at frame k: W keyframes spaced S
    apart ending at k (it starts at frame >= S, since the BA runs from
    k >= W·S on)."""
    S = cfg.local_ba_stride
    return slice(k - S * (cfg.local_ba_window - 1), k + 1, S)


def local_ba_problem(carry: SLAMCarry, cfg: EngineConfig):
    """(BAProblem, window slice of poses_all) of the local window at frame
    carry.k, against the whole map; poses 0, 1 of the window are fixed
    (gauge + scale anchor to the prefix)."""
    W, S = cfg.local_ba_window, cfg.local_ba_stride
    R, k = W * S, carry.k
    win = local_ba_window(k, cfg)
    # frame f lives in ring slot f % R: the window's slots are (k - S·(W-1)
    # + S·i) % R = (k + S + S·i) % R — every S-th row of the ring rolled to
    # start at slot (k + S) % R
    start = (k + S) % R
    ring = lambda b: torch.roll(b, -start, 0)[::S]
    dev = carry.poses_all.device
    prob = BAProblem(
        poses=lie.inv_se3(carry.poses_all[win]), points=carry.state.map_xyz,
        obs_uv=ring(carry.buf_uv), obs_lm=ring(carry.buf_lm), obs_valid=ring(carry.buf_valid),
        point_valid=carry.state.map_valid, fixed=torch.arange(W, device=dev) < 2)
    return prob, win


def local_ba(carry: SLAMCarry, cfg: EngineConfig) -> SLAMCarry:
    """Solve the local window and write back its free poses and the map
    when the solve stayed finite."""
    prob, win = local_ba_problem(carry, cfg)
    prob2, _ = ba_solve(prob, vo._K(cfg, prob.points.device), cfg.width, cfg.height,
                        _local_ba_cfg(cfg))
    ok = torch.isfinite(prob2.poses).all() & torch.isfinite(prob2.points).all()
    win_poses = carry.poses_all[win]
    upd = torch.where((ok & ~prob.fixed)[:, None, None], lie.inv_se3(prob2.poses), win_poses)
    # keyframe-only correction: non-keyframe poses keep their tracked
    # values; later frames track from the corrected poses_all[k]
    poses_all = carry.poses_all.clone()
    poses_all[win] = upd
    state = carry.state._replace(map_xyz=torch.where(ok, prob2.points, carry.state.map_xyz))
    return carry._replace(state=state, poses_all=poses_all)


def slam_step(carry: SLAMCarry, curr: vo.Frame, nxt: vo.Frame, cfg: EngineConfig):
    """One SLAM step: track + ring-buffer write + the local BA when it is
    due.  Returns (carry', FrameLog).  Shared by ``run_sequence_slam`` and
    ``OnlineSLAM``."""
    carry, log = track_and_record(carry, curr, nxt, cfg)
    ran = local_ba_due(carry.k, cfg)
    if ran:
        carry = local_ba(carry, cfg)
    # poses_all[k] is log.pose when BA did not run and the BA-corrected
    # newest pose when it did — either way the tracker resumes from it
    state = carry.state._replace(pose=carry.poses_all[carry.k])
    return carry._replace(state=state, n_ba=carry.n_ba + int(ran), k=carry.k + 1), log


def carry_to(carry: SLAMCarry, device) -> SLAMCarry:
    """The carry's tensors on ``device`` (its counters stay host ints)."""
    return SLAMCarry(VOState(*(x.to(device) for x in carry.state)),
                     *(x.to(device) for x in carry[1:5]), carry.n_ba, carry.k)


def run_sequence_slam(seq, cfg: EngineConfig | None = None, seed: int = 42,
                      device="cuda"):
    """End-to-end SLAM-mode VO: bootstrap + tracking with local BA, on
    ``device`` (the card by default, as ``vo.run_sequence``).

    Same returns as ``vo.run_sequence``: (final state, logs, poses (F, 4, 4)
    camera-in-world, diag).  The poses include the local-BA corrections;
    ``logs.pose`` keeps the raw per-frame tracking estimates."""
    cfg = cfg or EngineConfig()
    _check_evict_age(cfg)
    F = seq.uv.shape[0]
    frames = vo.frames_of(seq, 0, F, device)
    state, diag = vo.bootstrap(vo.make_generator(seed), vo.frame_at(frames, 0),
                               vo.frame_at(frames, 1), cfg)
    carry = init_carry(state, F, frames.uv.shape[1], cfg)
    logs = []
    for i in range(F - 1):
        carry, log = slam_step(carry, vo.frame_at(frames, i), vo.frame_at(frames, i + 1), cfg)
        logs.append(log)
    diag = dict(diag)
    diag["n_local_ba_runs"] = carry.n_ba
    return carry.state, vo._stack_logs(logs, True), carry.poses_all, diag


class OnlineSLAM:
    """Streaming SLAM session: OnlineVO's interface with the local-BA
    backend — the same ``slam_step`` as ``run_sequence_slam``, so the two
    give the same trajectory.

        s = OnlineSLAM(cfg, max_frames=1000)
        s.start(f0, f1)
        for frame in stream:
            pose = s.step(frame)     # BA-corrected camera-in-world
        s.poses[: s.frame_count]     # trajectory incl. retro-corrections
    """

    def __init__(self, cfg: EngineConfig | None = None, max_frames: int = 1024,
                 seed: int = 42):
        self.cfg = cfg or EngineConfig()
        self.max_frames = max_frames
        self._generator = vo.make_generator(seed)
        self._carry: SLAMCarry | None = None
        self._prev = None
        self.frame_count = 0

    def start(self, f0: vo.Frame, f1: vo.Frame) -> dict:
        _check_evict_age(self.cfg)
        state, diag = vo.bootstrap(self._generator, f0, f1, self.cfg)
        self._carry = init_carry(state, self.max_frames, f0.uv.shape[0], self.cfg)
        self._prev = f0
        self.frame_count = 1  # frame 0's identity; +1 per step
        return diag

    def step(self, frame: vo.Frame):
        if self._carry is None:
            raise RuntimeError("call start(f0, f1) before step()")
        if self.frame_count >= self.max_frames:
            raise RuntimeError("max_frames exceeded — raise the buffer size")
        self._carry, _ = slam_step(self._carry, self._prev, frame, self.cfg)
        self._prev = frame
        self.frame_count += 1
        return self._carry.poses_all[self.frame_count - 1]

    @property
    def state(self) -> VOState:
        return self._carry.state

    @property
    def poses(self):
        """(max_frames, 4, 4) camera-in-world, BA-corrected; rows from
        ``frame_count`` on are identity padding."""
        return self._carry.poses_all

    @property
    def n_local_ba_runs(self) -> int:
        return self._carry.n_ba
