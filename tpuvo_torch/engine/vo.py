"""The VO engine: two-view bootstrap + per-frame tracking (twin of
``tpuvo/engine/vo.py``).

  bootstrap (frames 0, 1):
    match 2D-2D -> essential-matrix RANSAC -> pose recovery -> DLT
    triangulation of every match into the initial map (the pose stays
    identity: the bootstrap pose is not pushed to the trajectory)

  per frame:
    match the next frame against the map (2D-3D)
    PICP from the previous pose (or a constant-velocity prediction)
    match the current frame against the next (2D-2D)
    triangulate the matches not yet in the map, gate them, append

The frame loop is a Python loop over ``track_step``.  On CUDA tensors with
``matcher.method="pallas"`` and ``picp.backend="pallas"``, ``track_step``
makes no host round-trip: no ``.item()``, no ``bool(tensor)``, no
boolean-mask indexing — map growth and candidate compaction are
``index_copy_`` scatters into a spare dump row.  (The plain PICP loop
checks its done flags on the host once per GN round.)
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import torch

from tpuvo_torch.config import EngineConfig
from tpuvo_torch.engine.state import FrameLog, VOState, empty_state
from tpuvo_torch.ops import lie, picp, triangulate, twoview
from tpuvo_torch.ops.camera import project_points
from tpuvo_torch.ops.match import match_descriptors, match_descriptors_pair


class Frame(NamedTuple):
    """One frame's padded observations (a leading frame axis when stacked)."""

    uv: torch.Tensor       # (N, 2) float32
    desc: torch.Tensor     # (N, D) float32
    id_meas: torch.Tensor  # (N,) int32
    id_real: torch.Tensor  # (N,) int32
    valid: torch.Tensor    # (N,) bool


def _tensor(x, dtype, device):
    return torch.as_tensor(x, dtype=dtype, device=device)


def _check_device(device) -> None:
    """The entry points run on the card unless the caller asks for the CPU;
    without a card they raise rather than fall back."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: no CUDA device is available "
                           "(pass device='cpu' to run on the CPU)")


def frames_of(seq, lo: int, hi: int, device="cuda") -> Frame:
    """Frames [lo, hi) of a FrameObservations as one stacked Frame on
    ``device`` (the card by default)."""
    _check_device(device)
    return Frame(
        _tensor(seq.uv[lo:hi], torch.float32, device),
        _tensor(seq.desc[lo:hi], torch.float32, device),
        _tensor(seq.id_meas[lo:hi], torch.int32, device),
        _tensor(seq.id_real[lo:hi], torch.int32, device),
        _tensor(seq.valid[lo:hi], torch.bool, device),
    )


def frame_of(seq, i: int, device="cuda") -> Frame:
    return frame_at(frames_of(seq, i, i + 1, device), 0)


def frame_at(frames: Frame, i: int) -> Frame:
    """Frame i of a stacked Frame (views, no copy)."""
    return Frame(*(x[i] for x in frames))


@functools.lru_cache(maxsize=None)
def _K(cfg: EngineConfig, device: torch.device):
    # one host->device copy per (config, device), not one per step
    return torch.as_tensor(cfg.K(), device=device)


def _append_to_map(state: VOState, xyz, desc, id_real, id_meas, new_mask,
                   reuse_slots: bool = False):
    """Masked append preserving candidate order (push_back semantics).

    reuse_slots=False: candidates land in sequential slots from
    ``map_count``.  True (eviction on): candidates fill the free slots
    (``~map_valid``) in ascending slot order.  Candidates past capacity are
    dropped.  The scatter is ``index_copy_`` into the map plus one dump row
    (index C) that takes every dropped candidate and is then cut off — the
    same slots in the same order as the JAX twin's one-hot matmul.

    Returns (state, n_added, cand_slots (N,) — the slot each candidate
    landed in, C when dropped — and ok (N,) bool, actually inserted).
    """
    C = state.map_xyz.shape[0]
    dev = xyz.device
    offs = torch.cumsum(new_mask.to(torch.int32), 0) - 1  # position among kept
    if reuse_slots:
        free = ~state.map_valid
        rank = torch.cumsum(free.to(torch.int64), 0) - 1
        n_free = torch.sum(free)
        ok = new_mask & (offs < n_free)
        # slot_of_rank[r] = the free slot of rank r (non-free slots -> dump)
        slot_of_rank = torch.full((C + 1,), C, dtype=torch.int64, device=dev)
        slot_of_rank.index_copy_(0, torch.where(free, rank, C),
                                 torch.arange(C, dtype=torch.int64, device=dev))
        cand_slots = torch.where(ok, slot_of_rank[torch.clamp(offs, min=0).long()], C)
    else:
        pos = state.map_count + offs
        ok = new_mask & (pos < C)
        cand_slots = torch.where(ok, pos, C).long()

    def put(old, vals):
        ext = torch.cat([old, old[:1]], 0)  # row C: the dump
        return ext.index_copy_(0, cand_slots, vals.to(old.dtype))[:C]

    hit = put(torch.zeros(C, dtype=torch.bool, device=dev), ok)
    map_valid = state.map_valid | hit
    return (
        state._replace(
            map_xyz=put(state.map_xyz, xyz),
            map_desc=put(state.map_desc, desc),
            map_id_real=put(state.map_id_real, id_real),
            map_id_meas=put(state.map_id_meas, id_meas),
            map_valid=map_valid,
            map_count=torch.sum(map_valid).to(torch.int32),
            # the founding observation counts as "seen now" for eviction
            map_last_seen=torch.where(hit, state.frame_idx, state.map_last_seen),
        ),
        torch.sum(ok).to(torch.int32),
        cand_slots,
        ok,
    )


def bootstrap(generator, f0: Frame, f1: Frame, cfg: EngineConfig,
              sample_idx=None) -> Tuple[VOState, dict]:
    """Two-view initialization.  Returns the initial state (pose = identity)
    and diagnostics including the recovered camera-1 pose T_boot.

    generator: the torch.Generator of the RANSAC draws (see
    ``make_generator``); sample_idx: optional (H, 8) indices that replace
    the draw.
    """
    dev = f0.uv.device
    K = _K(cfg, dev)
    res = match_descriptors(
        f0.desc, f0.valid, f1.desc, f1.valid,
        cfg.matcher.distance_threshold, cfg.matcher.ratio_threshold,
        cfg.matcher.method,
    )
    uv2 = f1.uv[res.idx]
    T_boot, rres, _ = twoview.bootstrap_pose(
        generator, K, f0.uv, uv2, res.valid, cfg.ransac, sample_idx)
    # triangulate ALL matches (no inlier mask — the reference's quirk)
    pts, _ = triangulate.triangulate_two_view(
        K, torch.eye(4, dtype=torch.float32, device=dev), T_boot, f0.uv, uv2,
        refine_iterations=cfg.triangulation_refine_iters,
    )
    state, n_added, _, _ = _append_to_map(
        empty_state(cfg, dev), pts, f0.desc, f0.id_real, f0.id_meas, res.valid)
    diag = {
        "T_boot": T_boot,
        "n_matches": torch.sum(res.valid),
        "n_ransac_inliers": rres.num_inliers,
        "n_map_points": n_added,
    }
    return state, diag


def track_step(state: VOState, curr: Frame, nxt: Frame, cfg: EngineConfig,
               kernel_threshold=None, return_matches: bool = False):
    """One tracking iteration.  Returns (state, FrameLog), plus
    ``(m_map.idx, m_map.valid, new_slots, new_uv, new_valid)`` when
    return_matches (the frame's map observations and its new landmarks)."""
    dev = state.pose.device
    K = _K(cfg, dev)
    mc = cfg.matcher
    state = state._replace(frame_idx=state.frame_idx + 1)

    # --- 2D-3D: next frame vs map (and, when fused, the 2D-2D match) -----
    m_img = None
    if mc.method == "pallas":
        m_map = match_descriptors(nxt.desc, nxt.valid, state.map_desc, state.map_valid,
                                  mc.distance_threshold, mc.ratio_threshold, "pallas")
        m_img = match_descriptors(curr.desc, curr.valid, nxt.desc, nxt.valid,
                                  mc.distance_threshold, mc.ratio_threshold, "mxu")
    elif cfg.fuse_frame_matchers:
        m_map, m_img = match_descriptors_pair(
            nxt.desc, nxt.valid, state.map_desc, state.map_valid,
            curr.desc, curr.valid, nxt.desc, nxt.valid,
            mc.distance_threshold, mc.ratio_threshold)
    else:
        m_map = match_descriptors(nxt.desc, nxt.valid, state.map_desc, state.map_valid,
                                  mc.distance_threshold, mc.ratio_threshold, mc.method)
    n_map_correct = torch.sum(m_map.valid & (nxt.id_real == state.map_id_real[m_map.idx]))

    # --- landmark lifecycle: mark matched slots seen, evict stale ones ---
    if cfg.map_evict_age > 0:
        C = state.map_xyz.shape[0]
        hits = torch.zeros(C, dtype=torch.int32, device=dev).index_add_(
            0, m_map.idx, m_map.valid.to(torch.int32))
        last_seen = torch.where(hits > 0, state.frame_idx, state.map_last_seen)
        stale = state.map_valid & (state.frame_idx - last_seen > cfg.map_evict_age)
        state = state._replace(map_last_seen=last_seen, map_valid=state.map_valid & ~stale)

    # --- PICP from the previous pose (or a constant-velocity prediction) --
    if cfg.motion_model_init:
        step_v = (lie.scale_motion(state.vel, cfg.motion_model_alpha)
                  if cfg.motion_model_alpha != 1.0 else state.vel)
        T_prev = state.pose @ step_v
    else:
        T_prev = state.pose
    T_init = lie.inv_se3(T_prev)  # world-in-camera initial guess
    solver_args = (state.map_xyz, nxt.uv, m_map.idx, m_map.valid, cfg.width, cfg.height,
                   cfg.picp)
    if cfg.picp.backend == "pallas" and kernel_threshold is None:
        if cfg.picp.annealed_kernel:
            raise ValueError(
                "picp.backend='pallas' does not support "
                "annealed_kernel=True; use backend='xla' for the "
                "annealed schedule")
        from tpuvo_torch.ops.cuda.picp_kernel import solve_cuda

        sol = solve_cuda(cfg.K(), T_init, *solver_args)
    elif cfg.picp.unrolled_rounds > 0:
        sol = picp.solve_unrolled(K, T_init, *solver_args, kernel_threshold,
                                  rounds=cfg.picp.unrolled_rounds)
    else:
        sol = picp.solve(K, T_init, *solver_args, kernel_threshold)
    new_pose = lie.inv_se3(sol.T)  # camera-in-world
    # keep the previous pose on match starvation or a non-finite solve
    n_matches = torch.sum(m_map.valid)
    healthy = (n_matches >= cfg.picp.min_matches_reuse_pose) & torch.all(
        torch.isfinite(new_pose))
    new_pose = torch.where(healthy, new_pose, state.pose)
    wic_prev = lie.inv_se3(state.pose) if cfg.motion_model_init else T_init
    wic_new = torch.where(healthy, sol.T, wic_prev)

    # --- 2D-2D: curr -> next; keep matches whose next point is not mapped -
    if m_img is None:
        m_img = match_descriptors(curr.desc, curr.valid, nxt.desc, nxt.valid,
                                  mc.distance_threshold, mc.ratio_threshold, mc.method)
    is_new = m_img.valid & ~m_map.valid[m_img.idx]

    # --- compact the candidates (order kept) to Kc slots, triangulate ------
    Kc = cfg.max_new_landmarks_per_frame
    offs_new = torch.cumsum(is_new.to(torch.int32), 0) - 1
    slot = torch.where(is_new & (offs_new < Kc), offs_new, Kc).long()

    def compact(x):
        out = torch.zeros((Kc + 1,) + x.shape[1:], dtype=x.dtype, device=dev)
        return out.index_copy_(0, slot, x)[:Kc]  # row Kc: the dump

    uv1_c = compact(curr.uv)
    uv2_c = compact(nxt.uv[m_img.idx])
    desc_c = compact(curr.desc)
    idr_c = compact(curr.id_real)
    idm_c = compact(curr.id_meas)
    c_valid = compact(torch.ones_like(is_new))

    pts, finite = triangulate.triangulate_two_view(
        K, None, None, uv1_c, uv2_c, refine_iterations=cfg.triangulation_refine_iters,
        wic1=wic_prev, wic2=wic_new)
    keep = c_valid
    if cfg.gating_enabled:
        thr = cfg.landmark_max_reproj_px
        uv1_re, ok1 = project_points(K, wic_prev, pts, cfg.width, cfg.height)
        uv2_re, ok2 = project_points(K, wic_new, pts, cfg.width, cfg.height)
        e1 = torch.sum((uv1_re - uv1_c) ** 2, -1)
        e2 = torch.sum((uv2_re - uv2_c) ** 2, -1)
        # parallax between the two viewing rays (low-parallax depth is
        # unobservable and poisons later pose solves)
        r1 = pts - state.pose[:3, 3][None, :]
        r2 = pts - new_pose[:3, 3][None, :]
        cosang = torch.sum(r1 * r2, -1) / torch.clamp(
            torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1), min=1e-20)
        parallax_ok = cosang < math.cos(cfg.landmark_min_parallax_rad)
        keep = (keep & ok1 & ok2 & (e1 < thr * thr) & (e2 < thr * thr)
                & finite & parallax_ok)
    if cfg.motion_model_init:
        vel_new = torch.where(healthy, lie.inv_se3(state.pose) @ new_pose, state.vel)
    else:
        vel_new = state.vel
    state2, n_added, cand_slots, cand_ok = _append_to_map(
        state._replace(pose=new_pose, vel=vel_new), pts, desc_c, idr_c, idm_c, keep,
        reuse_slots=cfg.map_evict_age > 0)

    log = FrameLog(
        pose=new_pose,
        num_inliers=sol.num_inliers,
        chi_inliers=sol.chi_inliers,
        iterations=sol.iterations,
        converged=sol.converged,
        n_map_matches=n_matches,
        n_map_correct=n_map_correct,
        n_frame_matches=torch.sum(m_img.valid),
        n_new_points=n_added,
        map_count=state2.map_count,
        n_dropped_candidates=torch.sum(is_new & (offs_new >= Kc)).to(torch.int32),
        n_dropped_overflow=(torch.sum(keep) - n_added).to(torch.int32),
    )
    if return_matches:
        return state2, log, (m_map.idx, m_map.valid, cand_slots, uv2_c, cand_ok)
    return state2, log


def _stack_logs(logs, log_stats: bool) -> FrameLog:
    poses = torch.stack([lg.pose for lg in logs])
    if not log_stats:  # poses only; the stats are zero-filled, as in JAX
        z = torch.zeros(poses.shape[0], device=poses.device)
        zi = z.to(torch.int32)
        return FrameLog(poses, zi, z, zi, z > 0.5, zi, zi, zi, zi, zi, zi, zi)
    return FrameLog(poses, *(torch.stack([getattr(lg, f) for lg in logs])
                             for f in FrameLog._fields[1:]))


def scan_tracker(state: VOState, frames_curr: Frame, frames_next: Frame,
                 cfg: EngineConfig, kernel_threshold=None):
    """The full-sequence tracker: ``track_step`` over stacked frames.
    Returns (final state, FrameLog with a leading frame axis)."""
    logs = []
    for i in range(frames_curr.uv.shape[0]):
        state, log = track_step(state, frame_at(frames_curr, i), frame_at(frames_next, i),
                                cfg, kernel_threshold)
        logs.append(log)
    return state, _stack_logs(logs, cfg.log_stats)


def full_run(generator, f0: Frame, f1: Frame, frames_curr: Frame,
             frames_next: Frame, cfg: EngineConfig, sample_idx=None):
    """Bootstrap + full-sequence tracking.  Returns (final state, FrameLog)."""
    state, _ = bootstrap(generator, f0, f1, cfg, sample_idx)
    return scan_tracker(state, frames_curr, frames_next, cfg)


def make_generator(seed: int) -> torch.Generator:
    """The RANSAC generator: on the CPU whatever the run's device, so a seed
    draws the same hypotheses on the CPU and on the card."""
    return torch.Generator().manual_seed(seed)


def run_sequence(seq, cfg: EngineConfig | None = None, seed: int = 42,
                 device="cuda", sample_idx=None):
    """End-to-end VO over a FrameObservations on ``device`` (the card by
    default; ``device="cpu"`` runs the plain versions of the kernels).
    Returns (final state, logs, poses (F, 4, 4) camera-in-world incl. the
    identity first pose, diag)."""
    cfg = cfg or EngineConfig()
    F = seq.uv.shape[0]
    frames = frames_of(seq, 0, F, device)
    state, diag = bootstrap(make_generator(seed), frame_at(frames, 0),
                            frame_at(frames, 1), cfg, sample_idx)
    curr = Frame(*(x[:F - 1] for x in frames))
    nxt = Frame(*(x[1:] for x in frames))
    state, logs = scan_tracker(state, curr, nxt, cfg)
    eye = torch.eye(4, dtype=torch.float32, device=logs.pose.device)[None]
    return state, logs, torch.cat([eye, logs.pose], 0), diag


class OnlineVO:
    """Streaming interface: feed frames one at a time.

        vo = OnlineVO(cfg)
        vo.start(frame0, frame1)          # two-view bootstrap; frames on the run's device
        for frame in stream:
            pose = vo.step(frame)         # (4, 4) camera-in-world
    """

    def __init__(self, cfg: EngineConfig | None = None, seed: int = 42):
        self.cfg = cfg or EngineConfig()
        self._generator = make_generator(seed)
        self.state: VOState | None = None
        self._prev: Frame | None = None
        self.frame_count = 0

    def start(self, f0: Frame, f1: Frame) -> dict:
        """Two-view bootstrap.  ``frame_count`` counts trajectory poses: 1
        after start (frame 0's identity), +1 per ``step``; frame 1 is used
        by the bootstrap AND as the first tracked frame."""
        self.state, diag = bootstrap(self._generator, f0, f1, self.cfg)
        self._prev = f0
        self.frame_count = 1
        return diag

    def step(self, frame: Frame):
        """Track one new frame; returns the (4, 4) camera-in-world pose."""
        if self.state is None:
            raise RuntimeError("call start(f0, f1) before step()")
        self.state, log = track_step(self.state, self._prev, frame, self.cfg)
        self._prev = frame
        self.frame_count += 1
        return log.pose
