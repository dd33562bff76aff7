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

``track_step`` makes no host round-trip: no ``.item()``, no
``bool(tensor)``, no boolean-mask indexing — map growth and candidate
compaction are ``index_copy_`` scatters into a spare dump row.  On CUDA
tensors every PICP solve is the fused kernel
(``ops/cuda/picp_kernel.solve_cuda``, under either ``picp.backend``), and
the matcher of ``matcher.method="pallas"`` the top-2 kernel.

Compiled programs (the JAX package's ``bootstrap_jit``, ``scan_tracker_jit``,
``full_run_jit``, ``make_tracker``, ``track_step_jit``): on the card the step
is captured as a CUDA graph once per (cfg, shapes) (``utils/graphs``) and
replayed once a frame, both kernels inside it.  ``scan_tracker_jit`` copies
the state and the stacked frames into the graph's buffers once a call; each
replay reads its frame pair at a device step counter, writes the new state
back into the buffers and its log into a stacked log, so a frame costs the
host one ``cudaGraphLaunch``.  ``track_step_jit`` and ``OnlineVO`` copy one
frame in a step.  ``bootstrap_jit`` is the bootstrap's graph, one replay a
sequence: its eigensolvers are kernel C (``ops/cuda/smalleig``), and its
RANSAC uniforms are drawn on the host generator and copied in before the
replay, so a seed draws the same hypotheses on the CPU and on the card.
Every entry point bootstraps through it.  On the CPU every entry point runs
the eager functions.  ``track_step``, ``scan_tracker`` and ``bootstrap`` stay
the eager functions the graphs are compared with, as the un-jitted JAX
ones.

Lanes: ``bootstrap``, ``track_step``, ``scan_tracker`` and ``full_run`` take
an optional leading lane axis B — B distinct sequences tracked together,
each with its own map (the twin of ``jax.vmap`` over the JAX package's
functions, bench.py:236-239).  One body serves both forms: every op indexes
from the right (``...``), and the per-lane scatters flatten the lanes with
a row offset per lane.  Without a lane axis the body runs the single
sequence's own ops (no offsets).  On the card the step's small products are
written out (``ops/linalg_small.matmul_small``), so a lane of a batch steps
as the same sequence alone, bit for bit (with the motion model off: its
compose products are still the card's own).  A step of B lanes launches
each kernel once for all of them.
"""

from __future__ import annotations

import functools
import math
import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

from tpuvo_torch.config import EngineConfig
from tpuvo_torch.engine.state import FrameLog, VOState, check_device, empty_state
from tpuvo_torch.ops import lie, triangulate, twoview
from tpuvo_torch.ops.camera import project_points
from tpuvo_torch.ops.cuda.picp_kernel import solve_cuda
from tpuvo_torch.ops.match import match_descriptors, match_descriptors_pair
from tpuvo_torch.utils import graphs


class Frame(NamedTuple):
    """One frame's padded observations: (N, ...) per field, with optional
    leading lane (B) and frame (F) axes, lanes first."""

    uv: torch.Tensor       # (N, 2) float32
    desc: torch.Tensor     # (N, D) float32
    id_meas: torch.Tensor  # (N,) int32
    id_real: torch.Tensor  # (N,) int32
    valid: torch.Tensor    # (N,) bool


def _tensor(x, dtype, device):
    return torch.as_tensor(x, dtype=dtype, device=device)


_FIELDS = (("uv", torch.float32), ("desc", torch.float32), ("id_meas", torch.int32),
           ("id_real", torch.int32), ("valid", torch.bool))


def frames_of(seq, lo: int, hi: int, device="cuda") -> Frame:
    """Frames [lo, hi) of a FrameObservations as one stacked Frame on
    ``device`` (the card by default)."""
    check_device(device)
    return Frame(*(_tensor(getattr(seq, k)[lo:hi], dt, device) for k, dt in _FIELDS))


def lanes_of(seqs, device="cuda") -> Frame:
    """B FrameObservations of equal shape as one lane-batched Frame
    (B, F, N, ...) on ``device``: the input of ``run_batch``."""
    check_device(device)
    return Frame(*(_tensor(np.stack([getattr(s, k) for s in seqs]), dt, device)
                   for k, dt in _FIELDS))


def frame_of(seq, i: int, device="cuda") -> Frame:
    return frame_at(frames_of(seq, i, i + 1, device), 0)


def frame_at(frames: Frame, i: int) -> Frame:
    """Frame i of a stacked Frame (F, ...) (views, no copy)."""
    return Frame(*(x[i] for x in frames))


def lane_frame_at(frames: Frame, i: int) -> Frame:
    """Frame i of every lane of a lane-batched Frame (B, F, ...) (views)."""
    return Frame(*(x[:, i] for x in frames))


@functools.lru_cache(maxsize=None)
def _K(cfg: EngineConfig, device: torch.device):
    # one host->device copy per (config, device), not one per step
    return torch.as_tensor(cfg.K(), device=device)


# ------------------------------------------------------------- lane axis --
# A lane axis, where there is one, is the single leading axis of every state
# field and frame: (B, C, ...) maps, (B, N, ...) frames.  Row scatters into
# (lanes..., W, ...) tensors go through their (n_lanes·W + 1, ...)
# flattening, whose last row is a dump for dropped entries.


@functools.lru_cache(maxsize=None)
def _lane_base(lanes: int, width: int, device: torch.device):
    # (B, 1) row offsets b·width, made once per shape and device
    return (torch.arange(lanes, device=device) * width)[:, None]


def _flat_rows(local, width: int):
    """Lane-local row indices (..., n) into a (..., width, ...) tensor, where
    ``width`` marks a dropped entry, as indices (n_lanes·n,) into its
    flattening whose last row (n_lanes·width) is the dump.  Without lanes,
    or with one, the local index is the flat one."""
    if local.dim() == 1 or local.shape[0] == 1:
        return local.reshape(-1)
    B = local.shape[0]
    flat = torch.where(local < width, local + _lane_base(B, width, local.device), B * width)
    return flat.reshape(-1)


def _scatter_rows(old, flat, vals, n_lane_axes: int):
    """A copy of old (lanes..., W, ...) with row flat[k] of its flattening
    set to the k-th row of vals (lanes..., n, ...) flattened alike (see
    _flat_rows): ONE ``index_copy_`` for every lane, into a dump row that is
    then cut off."""
    rows = old.flatten(0, n_lane_axes)
    ext = torch.cat([rows, rows[:1]], 0)  # the dump
    ext.index_copy_(0, flat, vals.flatten(0, n_lane_axes).to(old.dtype))
    return ext[:rows.shape[0]].view(old.shape)


def _take_rows(x, idx):
    """x[..., idx[..., i], :] for x (..., M, k) and idx (..., n): (..., n, k)."""
    return torch.gather(x, -2, idx[..., None].expand(idx.shape + x.shape[-1:]))


def _append_to_map(state: VOState, xyz, desc, id_real, id_meas, new_mask,
                   reuse_slots: bool = False):
    """Masked append preserving candidate order (push_back semantics), per
    lane.

    reuse_slots=False: candidates land in sequential slots from
    ``map_count``.  True (eviction on): candidates fill the free slots
    (``~map_valid``) in ascending slot order.  Candidates past capacity are
    dropped.  The scatter is ``index_copy_`` into the lanes' maps flattened
    with one dump row that takes every dropped candidate and is then cut
    off — the same slots in the same order as the JAX twin's one-hot
    matmul.

    Returns (state, n_added, cand_slots (..., N) — the slot each candidate
    landed in, C when dropped — and ok (..., N) bool, actually inserted).
    """
    lanes, C = state.map_valid.shape[:-1], state.map_valid.shape[-1]
    nl = len(lanes)
    dev = xyz.device
    offs = torch.cumsum(new_mask.to(torch.int32), -1) - 1  # position among kept
    if reuse_slots:
        free = ~state.map_valid
        rank = torch.cumsum(free.to(torch.int64), -1) - 1
        n_free = torch.sum(free, -1, keepdim=True)
        ok = new_mask & (offs < n_free)
        # slot_of_rank[..., r] = the lane's free slot of rank r (non-free slots -> dump)
        slots = torch.arange(C, dtype=torch.int64, device=dev)
        slot_of_rank = _scatter_rows(torch.full(lanes + (C,), C, dtype=torch.int64, device=dev),
                                     _flat_rows(torch.where(free, rank, C), C),
                                     slots.expand(lanes + (C,)), nl)
        cand_slots = torch.where(ok, torch.gather(slot_of_rank, -1,
                                                  torch.clamp(offs, min=0).long()), C)
    else:
        pos = state.map_count[..., None] + offs
        ok = new_mask & (pos < C)
        cand_slots = torch.where(ok, pos, C).long()
    flat = _flat_rows(cand_slots, C)
    put = lambda old, vals: _scatter_rows(old, flat, vals, nl)

    hit = put(torch.zeros(lanes + (C,), dtype=torch.bool, device=dev), ok)
    map_valid = state.map_valid | hit
    return (
        state._replace(
            map_xyz=put(state.map_xyz, xyz),
            map_desc=put(state.map_desc, desc),
            map_id_real=put(state.map_id_real, id_real),
            map_id_meas=put(state.map_id_meas, id_meas),
            map_valid=map_valid,
            map_count=torch.sum(map_valid, -1).to(torch.int32),
            # the founding observation counts as "seen now" for eviction
            map_last_seen=torch.where(hit, state.frame_idx[..., None], state.map_last_seen),
        ),
        torch.sum(ok, -1).to(torch.int32),
        cand_slots,
        ok,
    )


_DIAG = ("T_boot", "n_matches", "n_ransac_inliers", "n_map_points")


def bootstrap(generator, f0: Frame, f1: Frame, cfg: EngineConfig,
              sample_idx=None) -> Tuple[VOState, dict]:
    """Two-view initialization.  Returns the initial state (pose = identity)
    and diagnostics including the recovered camera-1 pose T_boot.

    generator: the torch.Generator of the RANSAC draws (see
    ``make_generator``); the lanes draw from it together, each its own
    hypotheses.  sample_idx: optional ((B,) H, 8) indices that replace the
    draw.
    """
    uniforms = None
    if sample_idx is None:
        uniforms = twoview.hypothesis_uniforms(generator, f0.valid.shape,
                                               cfg.ransac.num_hypotheses).to(f0.uv.device)
    state, diag = _bootstrap(f0, f1, cfg, sample_idx, uniforms)
    return state, dict(zip(_DIAG, diag))


def _bootstrap(f0: Frame, f1: Frame, cfg: EngineConfig, sample_idx, uniforms):
    """The bootstrap given its RANSAC draw on the frames' device, as indices
    or as the draw's uniforms: no host read, so ``bootstrap_jit``'s graph
    captures it.  Returns (state, the diagnostics in ``_DIAG``'s order)."""
    dev = f0.uv.device
    K = _K(cfg, dev)
    res = match_descriptors(
        f0.desc, f0.valid, f1.desc, f1.valid,
        cfg.matcher.distance_threshold, cfg.matcher.ratio_threshold,
        cfg.matcher.method,
    )
    uv2 = _take_rows(f1.uv, res.idx)
    T_boot, rres, _ = twoview.bootstrap_pose(
        None, K, f0.uv, uv2, res.valid, cfg.ransac, sample_idx, uniforms)
    # triangulate ALL matches (no inlier mask — the reference's quirk)
    pts, _ = triangulate.triangulate_two_view(
        K, torch.eye(4, dtype=torch.float32, device=dev), T_boot, f0.uv, uv2,
        refine_iterations=cfg.triangulation_refine_iters,
    )
    state, n_added, _, _ = _append_to_map(
        empty_state(cfg, dev, lanes=f0.uv.shape[0] if f0.uv.dim() == 3 else None), pts,
        f0.desc, f0.id_real, f0.id_meas, res.valid)
    return state, (T_boot, torch.sum(res.valid, -1), rres.num_inliers, n_added)


def track_step(state: VOState, curr: Frame, nxt: Frame, cfg: EngineConfig,
               kernel_threshold=None, return_matches: bool = False):
    """One tracking iteration of every lane.  Returns (state, FrameLog),
    plus ``(m_map.idx, m_map.valid, new_slots, new_uv, new_valid)`` when
    return_matches (the frame's map observations and its new landmarks).

    kernel_threshold: optional robust threshold overriding
    ``cfg.picp.kernel_threshold`` — a float, or one per lane ((B,) tensor;
    the threshold sweep)."""
    dev = state.pose.device
    K = _K(cfg, dev)
    mc = cfg.matcher
    lanes, C = state.map_valid.shape[:-1], state.map_valid.shape[-1]
    n_lanes = math.prod(lanes)
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
    n_map_correct = torch.sum(
        m_map.valid & (nxt.id_real == torch.gather(state.map_id_real, -1, m_map.idx)), -1)

    # --- landmark lifecycle: mark matched slots seen, evict stale ones ---
    if cfg.map_evict_age > 0:
        hits = torch.zeros(n_lanes * C, dtype=torch.int32, device=dev).index_add_(
            0, _flat_rows(m_map.idx, C), m_map.valid.reshape(-1).to(torch.int32)
        ).view(lanes + (C,))
        last_seen = torch.where(hits > 0, state.frame_idx[..., None], state.map_last_seen)
        stale = state.map_valid & (state.frame_idx[..., None] - last_seen > cfg.map_evict_age)
        state = state._replace(map_last_seen=last_seen, map_valid=state.map_valid & ~stale)

    # --- PICP from the previous pose (or a constant-velocity prediction) --
    if cfg.motion_model_init:
        step_v = (lie.scale_motion(state.vel, cfg.motion_model_alpha)
                  if cfg.motion_model_alpha != 1.0 else state.vel)
        T_prev = state.pose @ step_v
    else:
        T_prev = state.pose
    T_init = lie.inv_se3(T_prev)  # world-in-camera initial guess
    # One branch per branch of the JAX step.  Each is ``solve_cuda``: on the
    # card the fused kernel, whose round loop never reads the host (the twin
    # of JAX's on-device while_loop); on the CPU its plain version.  K goes
    # as the config's host array.  Lanes with their own thresholds (the
    # sweep) may anneal under either backend, as JAX's vmapped sweep routes
    # to its XLA solver, which anneals.
    solver_args = (cfg.K(), T_init, state.map_xyz, nxt.uv, m_map.idx, m_map.valid,
                   cfg.width, cfg.height, cfg.picp, kernel_threshold)
    if cfg.picp.backend == "pallas" and not (cfg.picp.annealed_kernel
                                             and kernel_threshold is not None):
        if cfg.picp.annealed_kernel:
            raise ValueError(
                "picp.backend='pallas' does not support "
                "annealed_kernel=True; use backend='xla' for the "
                "annealed schedule")
        sol = solve_cuda(*solver_args)
    elif cfg.picp.unrolled_rounds > 0:
        sol = solve_cuda(*solver_args, rounds=cfg.picp.unrolled_rounds)
    else:
        sol = solve_cuda(*solver_args)
    new_pose = lie.inv_se3(sol.T)  # camera-in-world
    # keep the previous pose on match starvation or a non-finite solve
    n_matches = torch.sum(m_map.valid, -1)
    healthy = ((n_matches >= cfg.picp.min_matches_reuse_pose)
               & torch.all(torch.isfinite(new_pose).flatten(-2), -1))[..., None, None]
    new_pose = torch.where(healthy, new_pose, state.pose)
    wic_prev = lie.inv_se3(state.pose) if cfg.motion_model_init else T_init
    wic_new = torch.where(healthy, sol.T, wic_prev)

    # --- 2D-2D: curr -> next; keep matches whose next point is not mapped -
    if m_img is None:
        m_img = match_descriptors(curr.desc, curr.valid, nxt.desc, nxt.valid,
                                  mc.distance_threshold, mc.ratio_threshold, mc.method)
    is_new = m_img.valid & ~torch.gather(m_map.valid, -1, m_img.idx)

    # --- compact the candidates (order kept) to Kc slots, triangulate ------
    Kc = cfg.max_new_landmarks_per_frame
    offs_new = torch.cumsum(is_new.to(torch.int32), -1) - 1
    slot = _flat_rows(torch.where(is_new & (offs_new < Kc), offs_new, Kc).long(), Kc)

    def compact(x):
        rest = x.shape[len(lanes) + 1:]
        out = torch.zeros((n_lanes * Kc + 1,) + rest, dtype=x.dtype, device=dev)
        out.index_copy_(0, slot, x.flatten(0, len(lanes)))
        return out[:n_lanes * Kc].view(lanes + (Kc,) + rest)  # the last row: the dump

    uv1_c = compact(curr.uv)
    uv2_c = compact(_take_rows(nxt.uv, m_img.idx))
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
        r1 = pts - state.pose[..., None, :3, 3]
        r2 = pts - new_pose[..., None, :3, 3]
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
        n_frame_matches=torch.sum(m_img.valid, -1),
        n_new_points=n_added,
        map_count=state2.map_count,
        n_dropped_candidates=torch.sum(is_new & (offs_new >= Kc), -1).to(torch.int32),
        n_dropped_overflow=(torch.sum(keep, -1) - n_added).to(torch.int32),
    )
    if return_matches:
        return state2, log, (m_map.idx, m_map.valid, cand_slots, uv2_c, cand_ok)
    return state2, log


def _poses_only(poses, dim: int) -> FrameLog:
    """The logs of ``log_stats=False``: poses, the stats zero-filled (as in JAX)."""
    z = torch.zeros(poses.shape[:dim + 1], device=poses.device)
    zi = z.to(torch.int32)
    return FrameLog(poses, zi, z, zi, z > 0.5, zi, zi, zi, zi, zi, zi, zi)


def _stack_logs(logs, log_stats: bool, dim: int = 0) -> FrameLog:
    """Per-frame logs stacked along a frame axis at ``dim`` (1 after a
    lane axis)."""
    poses = torch.stack([lg.pose for lg in logs], dim)
    if not log_stats:
        return _poses_only(poses, dim)
    return FrameLog(poses, *(torch.stack([getattr(lg, f) for lg in logs], dim)
                             for f in FrameLog._fields[1:]))


def scan_tracker(state: VOState, frames_curr: Frame, frames_next: Frame,
                 cfg: EngineConfig, kernel_threshold=None):
    """The full-sequence tracker: ``track_step`` over stacked frames
    ((B,) F, N, ...).  Returns (final state, FrameLog with a frame axis
    after the lane axis, if any)."""
    axis = state.pose.dim() - 2  # the frame axis: after the lane axis
    logs = []
    for i in range(frames_curr.uv.shape[axis]):
        state, log = track_step(state, Frame(*(x.select(axis, i) for x in frames_curr)),
                                Frame(*(x.select(axis, i) for x in frames_next)), cfg,
                                kernel_threshold)
        logs.append(log)
    return state, _stack_logs(logs, cfg.log_stats, dim=axis)


# ------------------------------------------------------ the captured steps --
# Each Program (utils/graphs) holds the step's static buffers: the carried
# state, its frames, the threshold tensor of a sweep and, for a scan, a device
# step counter ``i`` and the stacked logs.  The bodies below run inside the
# graph; they write the new state back into the buffers.


def _clone(tup):
    """A copy of a NamedTuple of tensors."""
    return type(tup)(*(x.clone() for x in tup))


def _load(dst, src):
    """Copy a NamedTuple of tensors into the buffers ``dst``."""
    for d, s in zip(dst, src):
        d.copy_(s)


def _threshold(thr):
    return thr.clone() if isinstance(thr, torch.Tensor) else thr


def _load_threshold(b, thr):
    if isinstance(thr, torch.Tensor):
        b["thr"].copy_(thr)


def _at(frames: Frame, axis: int, i) -> Frame:
    """Frame i of stacked frames along ``axis``, i a (1,) index on the
    device (read inside the graph)."""
    return Frame(*(x.index_select(axis, i).squeeze(axis) for x in frames))


def _record(b: dict, log: FrameLog, axis: int, row):
    """Write a step's log into row ``row`` (a (1,) device index) of the
    stacked logs, made on the first call (a warm-up call, before capture)."""
    if b["logs"] is None:
        n = b["steps"]
        b["logs"] = FrameLog(*(x.new_empty(x.shape[:axis] + (n,) + x.shape[axis:]) for x in log))
    for s, x in zip(b["logs"], log):
        s.index_copy_(axis, row, x.unsqueeze(axis))


def _scan_body(cfg: EngineConfig, axis: int):
    def body(b):
        i = b["i"]
        state, log = track_step(b["state"], _at(b["curr"], axis, i), _at(b["nxt"], axis, i),
                                cfg, b["thr"])
        _record(b, log, axis, i)
        _load(b["state"], state)
        i.add_(1)

    return body


def scan_tracker_jit(state: VOState, frames_curr: Frame, frames_next: Frame,
                     cfg: EngineConfig, kernel_threshold=None):
    """``scan_tracker`` with its step as a CUDA graph on the card (the JAX
    package's ``scan_tracker_jit``): the state, the frames and a threshold
    tensor are copied into the graph's buffers, the step is replayed once a
    frame, and the final state and stacked logs are copied out (a later call
    overwrites the buffers, not what it returned).  One capture per (cfg,
    shapes); on the CPU, ``scan_tracker`` itself."""
    if not graphs.on_card(state.pose):
        return scan_tracker(state, frames_curr, frames_next, cfg, kernel_threshold)
    axis = state.pose.dim() - 2
    thr = kernel_threshold

    def make():
        b = dict(state=_clone(state), curr=_clone(frames_curr), nxt=_clone(frames_next),
                 thr=_threshold(thr), i=torch.zeros(1, dtype=torch.int64, device=state.pose.device),
                 steps=frames_curr.uv.shape[axis], logs=None)
        return graphs.Program("scan_tracker", b, (*b["state"], b["i"]))

    prog = graphs.cached(("scan_tracker", cfg, graphs.signature(
        (state, frames_curr, frames_next, thr))), make)
    b = prog.buffers
    _load(b["state"], state)
    _load(b["curr"], frames_curr)
    _load(b["nxt"], frames_next)
    _load_threshold(b, thr)
    b["i"].zero_()
    body = _scan_body(cfg, axis)
    for _ in range(b["steps"]):
        prog.replay(None, body)
    logs = _clone(b["logs"]) if cfg.log_stats else _poses_only(b["logs"].pose.clone(), axis)
    return _clone(b["state"]), logs


def _step_body(cfg: EngineConfig, return_matches: bool):
    def body(b):
        state, *out = track_step(b["state"], b["prev"], b["frame"], cfg, b["thr"],
                                 return_matches)
        _load(b["state"], state)
        _load(b["prev"], b["frame"])  # the next step's current frame
        return out

    return body


def _step_program(state: VOState, curr: Frame, nxt: Frame, cfg: EngineConfig, thr,
                  return_matches: bool):
    def make():
        b = dict(state=_clone(state), prev=_clone(curr), frame=_clone(nxt), thr=_threshold(thr))
        return graphs.Program("track_step", b, (*b["state"], *b["prev"]))

    return graphs.cached(("track_step", cfg, return_matches,
                          graphs.signature((state, curr, nxt, thr))), make)


def track_step_jit(state: VOState, curr: Frame, nxt: Frame, cfg: EngineConfig,
                   kernel_threshold=None, return_matches: bool = False):
    """``track_step`` as a CUDA graph on the card (the JAX package's
    ``track_step_jit``): the state and the frame pair are copied into the
    graph's buffers, the step replayed, and the new state and outputs copied
    out.  One capture per (cfg, shapes, ``return_matches``, threshold form);
    on the CPU, ``track_step`` itself."""
    if not graphs.on_card(state.pose):
        return track_step(state, curr, nxt, cfg, kernel_threshold, return_matches)
    prog = _step_program(state, curr, nxt, cfg, kernel_threshold, return_matches)
    prog.claim(None)
    b = prog.buffers
    _load(b["state"], state)
    _load(b["prev"], curr)
    _load(b["frame"], nxt)
    _load_threshold(b, kernel_threshold)
    out = prog.replay(None, _step_body(cfg, return_matches))
    res = (_clone(b["state"]), _clone(out[0]))
    return res + (tuple(x.clone() for x in out[1]),) if return_matches else res


def bootstrap_jit(generator, f0: Frame, f1: Frame, cfg: EngineConfig, sample_idx=None):
    """``bootstrap`` as a CUDA graph on the card (the JAX package's
    ``bootstrap_jit``): the frames are copied into the graph's buffers and
    the RANSAC draw with them, as uniforms drawn on the host generator into
    pinned memory (the same draw as ``bootstrap``'s) or as the given
    ``sample_idx``; one replay (the match, kernel B under
    ``matcher.method="pallas"``, the RANSAC with kernel C, the
    triangulation and the map append), then the state and the diagnostics
    copied out.  One capture per (cfg, shapes, ``sample_idx`` given or not);
    on the CPU, ``bootstrap`` itself."""
    if not graphs.on_card(f0.uv):
        return bootstrap(generator, f0, f1, cfg, sample_idx)
    dev = f0.uv.device
    H = cfg.ransac.num_hypotheses

    def make():
        b = dict(f0=_clone(f0), f1=_clone(f1))
        if sample_idx is None:
            b["u"] = torch.empty(f0.valid.shape[:-1] + (H, f0.valid.shape[-1]), device=dev)
        else:
            b["idx"] = torch.empty(sample_idx.shape, dtype=torch.int64, device=dev)
        return graphs.Program("bootstrap", b, ())

    prog = graphs.cached(("bootstrap", cfg, graphs.signature((f0, f1, sample_idx))), make)
    b = prog.buffers
    _load(b["f0"], f0)
    _load(b["f1"], f1)
    if sample_idx is None:
        # a fresh pinned block each call: the host allocator reuses it only
        # once the copy has run
        host = torch.empty(b["u"].shape, pin_memory=dev.type == "cuda")
        b["u"].copy_(twoview.hypothesis_uniforms(generator, f0.valid.shape, H, out=host),
                     non_blocking=True)
    else:
        b["idx"].copy_(sample_idx, non_blocking=True)
    state, diag = prog.replay(None, _bootstrap_body(cfg))
    return _clone(state), {k: v.clone() for k, v in zip(_DIAG, diag)}


def _bootstrap_body(cfg: EngineConfig):
    def body(b):
        return _bootstrap(b["f0"], b["f1"], cfg, b.get("idx"), b.get("u"))

    return body


def full_run(generator, f0: Frame, f1: Frame, frames_curr: Frame,
             frames_next: Frame, cfg: EngineConfig, sample_idx=None):
    """Bootstrap + full-sequence tracking.  Returns (final state, FrameLog)."""
    state, _ = bootstrap(generator, f0, f1, cfg, sample_idx)
    return scan_tracker(state, frames_curr, frames_next, cfg)


def full_run_jit(generator, f0: Frame, f1: Frame, frames_curr: Frame,
                 frames_next: Frame, cfg: EngineConfig, sample_idx=None):
    """``full_run`` as the JAX package's ``full_run_jit`` runs it:
    ``bootstrap_jit``, then ``scan_tracker_jit`` (on the card one bootstrap
    replay, then the scan's, with no host read between them).  The bench's
    latency section."""
    state, _ = bootstrap_jit(generator, f0, f1, cfg, sample_idx)
    return scan_tracker_jit(state, frames_curr, frames_next, cfg)


def make_tracker(cfg: EngineConfig):
    """The full-sequence tracker for ``cfg`` as a callable
    ``(state, frames_curr, frames_next) -> (state, logs)``: the JAX twin's
    compiled ``scan_tracker``, here ``scan_tracker_jit`` (one capture per
    shape, whatever the number of calls)."""
    return lambda s, fc, fn: scan_tracker_jit(s, fc, fn, cfg)


def make_generator(seed: int) -> torch.Generator:
    """The RANSAC generator: on the CPU whatever the run's device, so a seed
    draws the same hypotheses on the CPU and on the card."""
    return torch.Generator().manual_seed(seed)


def run_sequence(seq, cfg: EngineConfig | None = None, seed: int = 42,
                 device="cuda", sample_idx=None):
    """End-to-end VO over a FrameObservations on ``device`` (the card by
    default; ``device="cpu"`` runs the plain versions of the kernels):
    ``bootstrap_jit``, then ``scan_tracker_jit``.  Returns (final state, logs,
    poses (F, 4, 4) camera-in-world incl. the identity first pose, diag)."""
    cfg = cfg or EngineConfig()
    F = seq.uv.shape[0]
    frames = frames_of(seq, 0, F, device)
    state, diag = bootstrap_jit(make_generator(seed), frame_at(frames, 0),
                                frame_at(frames, 1), cfg, sample_idx)
    curr = Frame(*(x[:F - 1] for x in frames))
    nxt = Frame(*(x[1:] for x in frames))
    state, logs = scan_tracker_jit(state, curr, nxt, cfg)
    eye = torch.eye(4, dtype=torch.float32, device=logs.pose.device)[None]
    return state, logs, torch.cat([eye, logs.pose], 0), diag


def run_batch(frames: Frame, cfg: EngineConfig | None = None, seed: int = 42,
              sample_idx=None):
    """End-to-end VO over B distinct sequences at once: a lane-batched Frame
    (B, F, N, ...) (see ``lanes_of``) on its device, each lane with its
    own RANSAC draw.  The twin of bench.py's throughput mode (the vmapped
    bootstrap and scan_tracker): ``bootstrap_jit``, then ``scan_tracker_jit``.
    Returns (final state, logs, poses (B, F, 4, 4) camera-in-world incl. the
    identity first pose, diag), each with a leading lane axis."""
    cfg = cfg or EngineConfig()
    state, diag = bootstrap_jit(make_generator(seed), lane_frame_at(frames, 0),
                                lane_frame_at(frames, 1), cfg, sample_idx)
    curr = Frame(*(x[:, :-1] for x in frames))
    nxt = Frame(*(x[:, 1:] for x in frames))
    state, logs = scan_tracker_jit(state, curr, nxt, cfg)
    B = frames.uv.shape[0]
    eye = torch.eye(4, dtype=torch.float32, device=logs.pose.device).expand(B, 1, 4, 4)
    return state, logs, torch.cat([eye, logs.pose], 1), diag


def run_threshold_sweep(seq, thresholds, cfg: EngineConfig | None = None, seed: int = 42,
                        device="cuda", sample_idx=None):
    """The robust-threshold sweep (BASELINE.json config 2; twin of the JAX
    package's ``run_threshold_sweep``): the whole tracker over one
    sequence with a lane per threshold, e.g. [1000, 3000, 10000] as three
    lanes of one batched run.  The bootstrap does not depend on the
    threshold: it runs once and every lane starts from it.  On the card
    each step is one kernel-A launch for all lanes, each with its own
    threshold (annealed too, under ``picp.annealed_kernel``), in the
    replayed graph of ``scan_tracker_jit``.  Returns (states, logs, poses
    (B, F, 4, 4)) with a leading threshold axis."""
    cfg = cfg or EngineConfig()
    F = seq.uv.shape[0]
    frames = frames_of(seq, 0, F, device)
    thr = torch.as_tensor(thresholds, dtype=torch.float32, device=device)
    B = thr.shape[0]
    state, _ = bootstrap_jit(make_generator(seed), frame_at(frames, 0), frame_at(frames, 1),
                             cfg, sample_idx)
    # one copy of the shared bootstrap per lane (each lane's map then grows
    # on its own); the frames are shared views (lane stride 0)
    states = VOState(*(x.expand((B,) + x.shape).contiguous() for x in state))
    lanes = lambda fr: Frame(*(x.expand((B,) + x.shape) for x in fr))
    states, logs = scan_tracker_jit(states, lanes(Frame(*(x[:F - 1] for x in frames))),
                                    lanes(Frame(*(x[1:] for x in frames))), cfg,
                                    kernel_threshold=thr)
    eye = torch.eye(4, dtype=torch.float32, device=logs.pose.device).expand(B, 1, 4, 4)
    return states, logs, torch.cat([eye, logs.pose], 1)


class OnlineVO:
    """Streaming interface: feed frames one at a time.

        vo = OnlineVO(cfg)
        vo.start(frame0, frame1)          # two-view bootstrap; frames on the run's device
        for frame in stream:
            pose = vo.step(frame)         # (4, 4) camera-in-world
        vo.state                          # the VOState (a copy, on the card)

    On the card a step is the graph of ``track_step_jit``, and the session's
    state stays in the graph's buffers between steps: a step copies the new
    frame in, replays, and copies the pose out.  Sessions of one config and
    shape share the graph; one that finds another's state in it asks that
    session to take its state out first (``release``).

    ``checkpoint(path)`` / ``OnlineVO.resume(path, cfg)`` save and restore
    a session (the npz layout of ``run_sequence_chunked``).
    """

    def __init__(self, cfg: EngineConfig | None = None, seed: int = 42):
        self.cfg = cfg or EngineConfig()
        self._generator = make_generator(seed)
        self._state: VOState | None = None
        self._prev: Frame | None = None
        self._prog = None  # the graph's Program, on the card
        self.frame_count = 0

    def _holds(self) -> bool:
        return self._prog is not None and self._prog.owner is self

    def release(self, prog):
        """Take the session's state out of ``prog``'s buffers (another
        caller is about to use them)."""
        self._state = _clone(prog.buffers["state"])
        self._prev = _clone(prog.buffers["prev"])

    def _set(self, state: VOState, prev: Frame):
        if self._holds():
            self._prog.owner = None
        self._prog = None
        self._state, self._prev = state, prev

    @property
    def state(self) -> VOState | None:
        return _clone(self._prog.buffers["state"]) if self._holds() else self._state

    @property
    def prev(self) -> Frame | None:
        """The last frame fed (the next step's current frame)."""
        return Frame(*self._prog.buffers["prev"]) if self._holds() else self._prev

    def start(self, f0: Frame, f1: Frame) -> dict:
        """Two-view bootstrap.  ``frame_count`` counts trajectory poses: 1
        after start (frame 0's identity), +1 per ``step``; frame 1 is used
        by the bootstrap AND as the first tracked frame."""
        state, diag = bootstrap_jit(self._generator, f0, f1, self.cfg)
        self._set(state, f0)
        self.frame_count = 1
        return diag

    def step(self, frame: Frame):
        """Track one new frame; returns the (4, 4) camera-in-world pose."""
        if self._state is None and not self._holds():
            raise RuntimeError("call start(f0, f1) before step()")
        if not graphs.on_card(frame.uv):
            self._state, log = track_step(self._state, self._prev, frame, self.cfg)
            self._prev = frame
            pose = log.pose
        else:
            if self._prog is None or not self._prog.live:  # (dropped by the cache)
                self._prog = _step_program(self._state, self._prev, frame, self.cfg, None, False)
            b = self._prog.buffers
            if not self._prog.claim(self):
                _load(b["state"], self._state)
                _load(b["prev"], self._prev)
            _load(b["frame"], frame)
            log, = self._prog.replay(None, _step_body(self.cfg, False))
            pose = log.pose.clone()
        self.frame_count += 1
        return pose

    def checkpoint(self, path: str):
        """Save the session (state, frame count, the previous frame) in the
        JAX package's npz layout."""
        from tpuvo_torch.utils.checkpoint import save_state

        save_state(path, self.state, self.frame_count,
                   extra={f"prev_{k}": v for k, v in self.prev._asdict().items()})

    @classmethod
    def resume(cls, path: str, cfg: EngineConfig | None = None, seed: int = 42,
               device="cuda") -> "OnlineVO":
        """A session restored from ``checkpoint`` (of either package) onto
        ``device``."""
        from tpuvo_torch.utils.checkpoint import load_state

        vo = cls(cfg, seed)
        state, vo.frame_count, extra = load_state(path, device)
        vo._set(state, Frame(*(_tensor(extra[f"prev_{k}"], dt, device) for k, dt in _FIELDS)))
        return vo


def run_sequence_chunked(seq, cfg: EngineConfig | None = None, seed: int = 42,
                         checkpoint_path: str | None = None, checkpoint_every: int = 30,
                         resume: bool = True, max_chunks: int | None = None, device="cuda"):
    """Checkpointed tracking: ``scan_tracker_jit`` over chunks of
    ``checkpoint_every`` steps, with a checkpoint (state + poses so far, the
    JAX package's npz layout) after each.

    The same ``track_step`` calls as ``run_sequence``, chunk edges aside
    (on the card one capture per chunk length).  With ``resume=True`` an
    existing checkpoint at ``checkpoint_path`` restarts tracking
    mid-sequence, and the trajectory matches the uninterrupted run.
    ``max_chunks`` stops after that many chunks (a crash between
    checkpoints, for resume tests).  Nothing leaves the device inside a
    chunk: the host pulls the state once per checkpoint.

    Returns (state, poses (F, 4, 4), step_idx) — step_idx < F-1 when
    stopped by max_chunks.
    """
    from tpuvo_torch.utils.checkpoint import load_state, save_state

    cfg = cfg or EngineConfig()
    F = seq.uv.shape[0]
    n_steps = F - 1
    frames = frames_of(seq, 0, F, device)
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        state, step, extra = load_state(checkpoint_path, device)
        pose_chunks = [_tensor(extra["poses"], torch.float32, device)]
    else:
        state, _ = bootstrap_jit(make_generator(seed), frame_at(frames, 0), frame_at(frames, 1),
                                 cfg)
        step = 0
        pose_chunks = [torch.zeros((0, 4, 4), dtype=torch.float32, device=device)]

    chunks_run = 0
    while step < n_steps and (max_chunks is None or chunks_run < max_chunks):
        hi = min(step + checkpoint_every, n_steps)
        state, logs = scan_tracker_jit(state, Frame(*(x[step:hi] for x in frames)),
                                       Frame(*(x[step + 1:hi + 1] for x in frames)), cfg)
        pose_chunks.append(logs.pose)
        step = hi
        chunks_run += 1
        if checkpoint_path:
            save_state(checkpoint_path, state, step, extra={"poses": torch.cat(pose_chunks)})

    eye = torch.eye(4, dtype=torch.float32, device=device)[None]
    return state, torch.cat([eye, *pose_chunks]), step
