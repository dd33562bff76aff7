"""SLAM-mode tracking: the frame-to-frame tracker with an interleaved local
bundle-adjustment backend (twin of ``tpuvo/engine/slam.py``).

Plain monocular tracking hands scale from frame to frame through single
PICP solves; on KITTI-scale forward motion (~1 m/frame) that handoff
collapses (ATE 28 on the 200-frame loop fixture).  Every ``local_ba_every``
frames a windowed BA re-estimates the last W keyframe poses (spaced
``local_ba_stride`` apart) and their landmarks jointly, from ring buffers
of each frame's 2D-3D correspondences as the tracker computed them, plus
the founding observation of each landmark it triangulated.

The step indexes as the JAX step does (``tpuvo/engine/slam.py:146-183``):
from a device copy of the frame counter k, ``poses_all[k]``, the ring slot
``k % R`` and the window ``idxs = k - S·(W-1-arange(W))`` (slots ``idxs %
R``) are gathers and ``index_copy`` scatters, so a CUDA graph of the step
is right for every k.  The host keeps its int ``k`` and ``n_ba``: whether
the BA fires (``k >= W·S and k % E == 0``) is a host decision, the twin of
the JAX step's ``lax.cond``, and costs no sync.  Every carried tensor is
updated out of place, so a carry handed to ``slam_step`` is never changed.

On the card ``run_sequence_slam`` and ``OnlineSLAM`` replay the step as one
of two CUDA graphs a config and shape, with and without the local BA
(``slam_step_jit``, the JAX package's); the carry stays in the graphs'
buffers from frame to frame.  On the CPU they run ``slam_step``.
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
from tpuvo_torch.utils import graphs


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


def _device_k(carry: SLAMCarry):
    """The carry's frame counter as a (1,) int64 index on its device (a
    fill, not a copy from the host)."""
    return torch.full((1,), carry.k, dtype=torch.int64, device=carry.poses_all.device)


def _put(x, i, row):
    """A copy of x with x[i] = row, i a (1,) device index."""
    return x.index_copy(0, i, row[None].to(x.dtype))


def _record(carry: SLAMCarry, k, curr: vo.Frame, nxt: vo.Frame, cfg: EngineConfig):
    """Track frame k (a (1,) device index) and write its pose and its map
    observations (matches + founding observations of its new landmarks)
    into poses_all[k] and ring slot k % R."""
    slot = k % (cfg.local_ba_window * cfg.local_ba_stride)
    state, log, (m_idx, m_valid, new_slots, new_uv, new_valid) = vo.track_step(
        carry.state, curr, nxt, cfg, return_matches=True)
    return carry._replace(
        state=state, poses_all=_put(carry.poses_all, k, log.pose),
        buf_lm=_put(carry.buf_lm, slot, torch.cat([m_idx, new_slots])),
        buf_valid=_put(carry.buf_valid, slot, torch.cat([m_valid, new_valid])),
        buf_uv=_put(carry.buf_uv, slot, torch.cat([nxt.uv, new_uv], 0))), log


def track_and_record(carry: SLAMCarry, curr: vo.Frame, nxt: vo.Frame, cfg: EngineConfig):
    """The tracking half of ``slam_step``: track frame k and write its pose
    and its map observations into poses_all[k] and ring slot k % R.  k is
    unchanged."""
    return _record(carry, _device_k(carry), curr, nxt, cfg)


def local_ba_due(k: int, cfg: EngineConfig) -> bool:
    """Whether the local BA runs after tracking frame k — host ints only,
    so deciding costs no sync."""
    return k >= cfg.local_ba_window * cfg.local_ba_stride and k % cfg.local_ba_every == 0


def local_ba_window(k: int, cfg: EngineConfig) -> slice:
    """The frames of the local window at frame k, as a host slice: W
    keyframes spaced S apart ending at k (it starts at frame >= S, since
    the BA runs from k >= W·S on)."""
    S = cfg.local_ba_stride
    return slice(k - S * (cfg.local_ba_window - 1), k + 1, S)


def _window(carry: SLAMCarry, k, cfg: EngineConfig):
    """(BAProblem, window frame indices (W,) on the device, window poses)
    of the local window at frame k (a (1,) device index), against the whole
    map; poses 0, 1 of the window are fixed (gauge + scale anchor to the
    prefix)."""
    W, S = cfg.local_ba_window, cfg.local_ba_stride
    ar = torch.arange(W, device=k.device)
    idxs = k - S * (W - 1 - ar)       # keyframes spaced S apart ending at k
    ring = idxs % (W * S)             # frame f lives in ring slot f % R
    win_poses = carry.poses_all.index_select(0, idxs)
    prob = BAProblem(
        poses=lie.inv_se3(win_poses), points=carry.state.map_xyz,
        obs_uv=carry.buf_uv.index_select(0, ring), obs_lm=carry.buf_lm.index_select(0, ring),
        obs_valid=carry.buf_valid.index_select(0, ring), point_valid=carry.state.map_valid,
        fixed=ar < 2)
    return prob, idxs, win_poses


def local_ba_problem(carry: SLAMCarry, cfg: EngineConfig):
    """(BAProblem, window slice of poses_all) of the local window at frame
    carry.k (see ``_window``)."""
    return _window(carry, _device_k(carry), cfg)[0], local_ba_window(carry.k, cfg)


def _local_ba(carry: SLAMCarry, k, cfg: EngineConfig) -> SLAMCarry:
    """Solve the local window at frame k (a (1,) device index) and write
    back its free poses and the map when the solve stayed finite."""
    prob, idxs, win_poses = _window(carry, k, cfg)
    prob2, _ = ba_solve(prob, vo._K(cfg, prob.points.device), cfg.width, cfg.height,
                        _local_ba_cfg(cfg))
    ok = torch.isfinite(prob2.poses).all() & torch.isfinite(prob2.points).all()
    upd = torch.where((ok & ~prob.fixed)[:, None, None], lie.inv_se3(prob2.poses), win_poses)
    # keyframe-only correction: non-keyframe poses keep their tracked
    # values; later frames track from the corrected poses_all[k]
    state = carry.state._replace(map_xyz=torch.where(ok, prob2.points, carry.state.map_xyz))
    return carry._replace(state=state, poses_all=carry.poses_all.index_copy(0, idxs, upd))


def _step(carry: SLAMCarry, k, curr: vo.Frame, nxt: vo.Frame, cfg: EngineConfig, due: bool):
    """The body of ``slam_step`` at frame k (a (1,) device index): track,
    record, and the local BA when ``due``; the counters are left as they
    were.  Returns (carry', FrameLog)."""
    carry, log = _record(carry, k, curr, nxt, cfg)
    if due:
        carry = _local_ba(carry, k, cfg)
    # poses_all[k] is log.pose when BA did not run and the BA-corrected
    # newest pose when it did — either way the tracker resumes from it
    state = carry.state._replace(pose=carry.poses_all.index_select(0, k)[0])
    return carry._replace(state=state), log


def slam_step(carry: SLAMCarry, curr: vo.Frame, nxt: vo.Frame, cfg: EngineConfig):
    """One SLAM step: track + ring-buffer write + the local BA when it is
    due.  Returns (carry', FrameLog).  The eager step that the graphs of
    ``slam_step_jit``, ``run_sequence_slam`` and ``OnlineSLAM`` capture."""
    due = local_ba_due(carry.k, cfg)
    carry2, log = _step(carry, _device_k(carry), curr, nxt, cfg, due)
    return carry2._replace(n_ba=carry.n_ba + int(due), k=carry.k + 1), log


# ------------------------------------------------------ the captured steps --
# Buffers of a SLAM Program (utils/graphs): the carry's tensors ("carry",
# whose counters are unused), the counter k on the device, and either the
# whole sequence ("frames", the frame pair read at k - 1 and k) or one frame
# pair ("prev", "frame").  Two graphs: branch True runs the local BA.


def _carried(b: dict):
    return (*b["carry"].state, *b["carry"][1:5], b["k"], *b.get("prev", ()))


def _load_carry(b: dict, carry: SLAMCarry):
    vo._load(b["carry"].state, carry.state)
    vo._load(b["carry"][1:5], carry[1:5])
    b["k"].fill_(carry.k)


def _carry_out(b: dict, n_ba: int, k: int) -> SLAMCarry:
    c = b["carry"]
    return SLAMCarry(vo._clone(c.state), *(x.clone() for x in c[1:5]), n_ba, k)


def _program(name: str, carry: SLAMCarry, frames: dict, cfg: EngineConfig):
    def make():
        b = dict(carry=SLAMCarry(vo._clone(carry.state), *(x.clone() for x in carry[1:5]),
                                 None, None),
                 k=torch.zeros(1, dtype=torch.int64, device=carry.poses_all.device),
                 logs=None, **{n: vo._clone(f) for n, f in frames.items()})
        if "frames" in frames:
            b["steps"] = frames["frames"].uv.shape[0] - 1
        return graphs.Program(name, b, _carried(b))

    return graphs.cached((name, cfg, graphs.signature((carry[:5], *frames.values()))), make)


def _body(cfg: EngineConfig, due: bool, pair: bool):
    def body(b):
        k = b["k"]
        if pair:
            curr, nxt = vo.Frame(*b["prev"]), vo.Frame(*b["frame"])
        else:
            curr, nxt = vo._at(b["frames"], 0, k - 1), vo._at(b["frames"], 0, k)
        carry, log = _step(b["carry"], k, curr, nxt, cfg, due)
        if not pair:
            vo._record(b, log, 0, k - 1)
        vo._load(b["carry"].state, carry.state)
        vo._load(b["carry"][1:5], carry[1:5])
        k.add_(1)
        if pair:
            vo._load(b["prev"], b["frame"])  # the next step's current frame
            return log

    return body


def slam_step_jit(carry: SLAMCarry, curr: vo.Frame, nxt: vo.Frame, cfg: EngineConfig):
    """``slam_step`` as a CUDA graph on the card (the JAX package's
    ``slam_step_jit``): the carry and the frame pair are copied into the
    graph's buffers, the graph of the step's branch (with or without the
    local BA, decided on the host) is replayed, and the new carry and log
    are copied out.  On the CPU, ``slam_step`` itself."""
    if not graphs.on_card(carry.poses_all):
        return slam_step(carry, curr, nxt, cfg)
    prog = _program("slam_step", carry, dict(prev=curr, frame=nxt), cfg)
    prog.claim(None)
    b = prog.buffers
    _load_carry(b, carry)
    vo._load(b["prev"], curr)
    vo._load(b["frame"], nxt)
    due = local_ba_due(carry.k, cfg)
    log = prog.replay(due, _body(cfg, due, pair=True))
    return _carry_out(b, carry.n_ba + int(due), carry.k + 1), vo._clone(log)


def carry_to(carry: SLAMCarry, device) -> SLAMCarry:
    """The carry's tensors on ``device`` (its counters stay host ints)."""
    return SLAMCarry(VOState(*(x.to(device) for x in carry.state)),
                     *(x.to(device) for x in carry[1:5]), carry.n_ba, carry.k)


def run_sequence_slam(seq, cfg: EngineConfig | None = None, seed: int = 42,
                      device="cuda"):
    """End-to-end SLAM-mode VO: bootstrap + tracking with local BA, on
    ``device`` (the card by default, as ``vo.run_sequence``).  On the card
    the sequence is copied into the step's graphs once, and a frame is one
    replay of the branch the host picks; the logs are stacked in the graph.

    Same returns as ``vo.run_sequence``: (final state, logs, poses (F, 4, 4)
    camera-in-world, diag).  The poses include the local-BA corrections;
    ``logs.pose`` keeps the raw per-frame tracking estimates."""
    cfg = cfg or EngineConfig()
    _check_evict_age(cfg)
    F = seq.uv.shape[0]
    frames = vo.frames_of(seq, 0, F, device)
    state, diag = vo.bootstrap_jit(vo.make_generator(seed), vo.frame_at(frames, 0),
                                   vo.frame_at(frames, 1), cfg)
    carry = init_carry(state, F, frames.uv.shape[1], cfg)
    if graphs.on_card(carry.poses_all):
        prog = _program("run_sequence_slam", carry, dict(frames=frames), cfg)
        b = prog.buffers
        _load_carry(b, carry)
        vo._load(b["frames"], frames)
        n_ba = 0
        for k in range(1, F):
            due = local_ba_due(k, cfg)
            prog.replay(due, _body(cfg, due, pair=False))
            n_ba += due
        carry, logs = _carry_out(b, n_ba, F), vo._clone(b["logs"])
    else:
        steps = []
        for i in range(F - 1):
            carry, log = slam_step(carry, vo.frame_at(frames, i), vo.frame_at(frames, i + 1),
                                   cfg)
            steps.append(log)
        logs = vo._stack_logs(steps, True)
    diag = dict(diag)
    diag["n_local_ba_runs"] = carry.n_ba
    return carry.state, logs, carry.poses_all, diag


class OnlineSLAM:
    """Streaming SLAM session: OnlineVO's interface with the local-BA
    backend — the same step as ``run_sequence_slam``, so the two give the
    same trajectory.

        s = OnlineSLAM(cfg, max_frames=1000)
        s.start(f0, f1)
        for frame in stream:
            pose = s.step(frame)     # BA-corrected camera-in-world
        s.poses[: s.frame_count]     # trajectory incl. retro-corrections

    On the card a step replays a graph of ``slam_step_jit`` and the carry
    stays in its buffers between steps (sessions share the graphs as
    ``vo.OnlineVO``'s do); ``carry``, ``state`` and ``poses`` are copies.
    """

    def __init__(self, cfg: EngineConfig | None = None, max_frames: int = 1024,
                 seed: int = 42):
        self.cfg = cfg or EngineConfig()
        self.max_frames = max_frames
        self._generator = vo.make_generator(seed)
        self._carry: SLAMCarry | None = None  # its tensors are stale while _holds()
        self._prev = None
        self._prog = None  # the graphs' Program, on the card
        self.frame_count = 0

    def _holds(self) -> bool:
        return self._prog is not None and self._prog.owner is self

    def release(self, prog):
        """Take the session's carry out of ``prog``'s buffers (another caller
        is about to use them)."""
        self._carry = _carry_out(prog.buffers, self._carry.n_ba, self._carry.k)
        self._prev = vo._clone(prog.buffers["prev"])

    def start(self, f0: vo.Frame, f1: vo.Frame) -> dict:
        _check_evict_age(self.cfg)
        state, diag = vo.bootstrap_jit(self._generator, f0, f1, self.cfg)
        if self._holds():
            self._prog.owner = None
        self._prog = None
        self._carry = init_carry(state, self.max_frames, f0.uv.shape[0], self.cfg)
        self._prev = f0
        self.frame_count = 1  # frame 0's identity; +1 per step
        return diag

    def step(self, frame: vo.Frame):
        if self._carry is None:
            raise RuntimeError("call start(f0, f1) before step()")
        if self.frame_count >= self.max_frames:
            raise RuntimeError("max_frames exceeded — raise the buffer size")
        c = self._carry
        if not graphs.on_card(frame.uv):
            self._carry, _ = slam_step(c, self._prev, frame, self.cfg)
            self._prev = frame
            pose = self._carry.poses_all[self.frame_count]
        else:
            if self._prog is None or not self._prog.live:  # (dropped by the cache)
                self._prog = _program("slam_step", c, dict(prev=self._prev, frame=frame),
                                      self.cfg)
            b = self._prog.buffers
            if not self._prog.claim(self):
                _load_carry(b, c)
                vo._load(b["prev"], self._prev)
            vo._load(b["frame"], frame)
            due = local_ba_due(c.k, self.cfg)
            self._prog.replay(due, _body(self.cfg, due, pair=True))
            self._carry = c._replace(n_ba=c.n_ba + int(due), k=c.k + 1)
            pose = b["carry"].poses_all[self.frame_count].clone()
        self.frame_count += 1
        return pose

    @property
    def carry(self) -> SLAMCarry:
        """The session's carry (a copy of the graphs' buffers on the card)."""
        if self._holds():
            return _carry_out(self._prog.buffers, self._carry.n_ba, self._carry.k)
        return self._carry

    @property
    def state(self) -> VOState:
        return self.carry.state

    @property
    def poses(self):
        """(max_frames, 4, 4) camera-in-world, BA-corrected; rows from
        ``frame_count`` on are identity padding."""
        if self._holds():
            return self._prog.buffers["carry"].poses_all.clone()
        return self._carry.poses_all

    @property
    def n_local_ba_runs(self) -> int:
        return self._carry.n_ba
