"""BA refinement of a tracked trajectory (twin of ``tpuvo/engine/ba_refine.py``).

  * ``refine_trajectory`` — a W-frame window slides with 50% overlap;
    each window's first two poses are fixed (gauge + scale anchor to the
    refined prefix), its frames are matched against the frozen map, and
    the Schur BA solver writes back poses and landmarks.
  * ``refine_trajectory_global`` — joint BA over ALL poses and landmarks,
    graduated: one coarse sweep (no bounds cull, saturating kernel at a
    huge threshold), then fine sweeps until the robust chi plateaus.
  * ``refine_trajectory_loop`` — loop closure + PGO (``ba/loop.py``), then
    the global refiner.

Everything stays on the run's device; the host reads one chi per sweep.
The loop refine's stages run under spans (``utils/profiling.span``):
``tpuvo.refine`` around it all, ``tpuvo.refine.topology``,
``tpuvo.refine.close_loops`` (with ``ba/loop``'s own inside) and one
``tpuvo.refine.sweep.coarse`` / ``tpuvo.refine.sweep.fine`` a sweep, each
sweep's span closed after the host has read its chi.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuvo_torch.ba.window import BAProblem, ba_solve
from tpuvo_torch.config import BAConfig, EngineConfig
from tpuvo_torch.engine import vo
from tpuvo_torch.ops import lie
from tpuvo_torch.ops.match import match_descriptors
from tpuvo_torch.utils.profiling import span


def _global_topology(map_desc, point_valid, desc, valid, cfg: EngineConfig):
    """Frozen correspondence topology: every frame's (F, N) descriptors
    matched against the map -> (obs_lm (F, N), obs_valid (F, N)).

    With ``matcher.method="pallas"`` all F frames go to the matcher as ONE
    (F·N)-row query — one launch of the CUDA top-2 kernel.  The kernel runs
    one block per query row and the plain version treats every row alone,
    so each row gets the answer it gets in a per-frame call.  The other
    methods build an (N, M) distance matrix per call and stay per frame."""
    F, N, D = desc.shape
    mc = cfg.matcher
    if mc.method == "pallas":
        r = match_descriptors(desc.reshape(F * N, D), valid.reshape(F * N), map_desc,
                              point_valid, mc.distance_threshold, mc.ratio_threshold,
                              "pallas")
        return r.idx.reshape(F, N), r.valid.reshape(F, N)
    rs = [match_descriptors(desc[f], valid[f], map_desc, point_valid, mc.distance_threshold,
                            mc.ratio_threshold, mc.method) for f in range(F)]
    return torch.stack([r.idx for r in rs]), torch.stack([r.valid for r in rs])


def _poses_on(poses, device):
    """(F, 4, 4) float32 poses on ``device`` from a tensor or any array."""
    if not isinstance(poses, torch.Tensor):
        poses = torch.as_tensor(np.array(poses, np.float32))
    return poses.to(device=device, dtype=torch.float32)


def _seq_tensors(seq, device):
    fr = vo.frames_of(seq, 0, seq.uv.shape[0], device)
    return fr.uv, fr.desc, fr.valid


def _refine_run(poses_all, points, point_valid, map_desc, desc, valid, obs_uv, K,
                cfg: EngineConfig, ba_cfg: BAConfig, n_windows: int, step: int):
    """The windowed sweep.  Returns (poses_all, points, (chis, inliers,
    skipped)) with one entry per window."""
    W = ba_cfg.window
    fixed = torch.arange(W, device=points.device) < 2
    obs_lm, obs_valid = _global_topology(map_desc, point_valid, desc, valid, cfg)
    ys = []
    for w in range(n_windows):
        sl = slice(w * step, w * step + W)
        win_poses = poses_all[sl]
        prob = BAProblem(poses=lie.inv_se3(win_poses), points=points, obs_uv=obs_uv[sl],
                         obs_lm=obs_lm[sl], obs_valid=obs_valid[sl],
                         point_valid=point_valid, fixed=fixed)
        prob2, stats = ba_solve(prob, K, cfg.width, cfg.height, ba_cfg)
        # a diverged (non-finite) window is skipped: its frames keep the
        # incoming poses and points
        ok = torch.isfinite(prob2.poses).all()
        upd = torch.where((ok & ~fixed)[:, None, None], lie.inv_se3(prob2.poses), win_poses)
        poses_all = poses_all.clone()
        poses_all[sl] = upd
        pt_ok = ok & torch.isfinite(prob2.points).all(1)
        points = torch.where(pt_ok[:, None], prob2.points, points)
        ys.append((stats.chi, stats.num_inliers, ~ok))
    return poses_all, points, tuple(torch.stack(y) for y in zip(*ys))


def _global_sweep(poses_all, points, point_valid, obs_uv, obs_lm, obs_valid, K,
                  cfg: EngineConfig, ba_cfg: BAConfig, record=None):
    """One full-trajectory BA sweep, poses 0/1 fixed.  Returns (poses,
    points, chi, inliers, skipped).  record: ``ba_solve``'s."""
    F = poses_all.shape[0]
    fixed = torch.arange(F, device=points.device) < 2
    prob = BAProblem(poses=lie.inv_se3(poses_all), points=points, obs_uv=obs_uv,
                     obs_lm=obs_lm, obs_valid=obs_valid, point_valid=point_valid,
                     fixed=fixed)
    prob2, stats = ba_solve(prob, K, cfg.width, cfg.height, ba_cfg, record=record)
    ok = torch.isfinite(prob2.poses).all()
    poses_out = torch.where((ok & ~fixed)[:, None, None], lie.inv_se3(prob2.poses), poses_all)
    pt_ok = ok & torch.isfinite(prob2.points).all(1)
    points_out = torch.where(pt_ok[:, None], prob2.points, points)
    return poses_out, points_out, stats.chi, stats.num_inliers, ~ok


def refine_trajectory_global(state, seq, poses, cfg: EngineConfig | None = None,
                             ba_cfg: BAConfig | None = None, n_sweeps: int = 2,
                             max_sweeps: int = 10, rel_improvement_stop: float = 0.01,
                             topology=None, record=None):
    """Joint BA over ALL poses + landmarks, on the device of ``state``.

    poses: (F, 4, 4) camera-in-world.  Returns (refined poses, refined
    map_xyz, stats list — one per sweep).  Sweep 0 is coarse, the rest
    fine; once ``n_sweeps`` (and at least 2) have run, fine sweeps go on
    while the fine robust chi improves by more than
    ``rel_improvement_stop`` per sweep, up to ``max(max_sweeps,
    n_sweeps)``.  topology: optional precomputed ``(obs_lm, obs_valid)``.

    record: None, or a dict whose ``sweeps`` receives one dict a sweep, as
    tensors on the run's device (references, no copies): ``kind``
    ("coarse" or "fine"), the poses and points it started from
    (``poses_before``, ``points_before``) and returned (``poses_after``,
    ``points_after``), its ``chi``, ``inliers`` and ``skipped``, and its
    LM iterations (``solve``: ``ba/window.ba_solve``'s record)."""
    cfg = cfg or EngineConfig()
    ba_cfg = ba_cfg or BAConfig()
    dev = state.map_xyz.device
    K = vo._K(cfg, dev)
    poses_all = _poses_on(poses, dev)
    points, point_valid = state.map_xyz, state.map_valid
    obs_uv, desc, valid = _seq_tensors(seq, dev)
    if topology is not None:
        obs_lm, obs_valid = topology
    else:
        obs_lm, obs_valid = _global_topology(state.map_desc, point_valid, desc, valid, cfg)

    # graduated robustness: sweep 0 is COARSE (cheirality cull only, a
    # saturating kernel at a huge threshold), so loop correspondences whose
    # residuals are hundreds of pixels at the drifted estimate still pull;
    # later sweeps tighten to the caller's threshold
    coarse_cfg = ba_cfg.replace(keep_outliers=True, cull_bounds=False,
                                huber_threshold=max(ba_cfg.huber_threshold, 1.0e8))
    fine_cfg = ba_cfg.replace(cull_bounds=False)

    stats_out = []
    prev_fine_chi = None
    i = 0
    max_sweeps = max(max_sweeps, n_sweeps)
    sweeps = record.setdefault("sweeps", []) if record is not None else None
    while i < max_sweeps:
        sweep_cfg = coarse_cfg if i == 0 else fine_cfg
        kind = "coarse" if i == 0 else "fine"
        before = poses_all, points
        solve = {} if sweeps is not None else None
        with span("refine.sweep." + kind):
            poses_all, points, chi_t, inliers, skipped = _global_sweep(
                poses_all, points, point_valid, obs_uv, obs_lm, obs_valid, K, cfg, sweep_cfg,
                record=solve)
            chi = float(chi_t)
        if sweeps is not None:
            sweeps.append(dict(kind=kind, poses_before=before[0], points_before=before[1],
                               poses_after=poses_all, points_after=points, chi=chi_t,
                               inliers=inliers, skipped=skipped, solve=solve))
        stats_out.append({"sweep": i, "chi": chi, "inliers": int(inliers),
                          "skipped": bool(skipped)})
        i += 1
        if i >= n_sweeps and i > 1:
            # stop when the FINE objective plateaus (coarse chi uses a
            # different kernel and is not comparable)
            if prev_fine_chi is not None and chi >= prev_fine_chi * (1.0 - rel_improvement_stop):
                break
        if sweep_cfg is fine_cfg:
            prev_fine_chi = chi
    return poses_all, points, stats_out


def refine_trajectory_loop(state, seq, poses, cfg: EngineConfig | None = None,
                           ba_cfg: BAConfig | None = None, n_sweeps: int = 3, record=None):
    """Loop-closure refinement: detect loops, PGO, then the graduated
    global BA on the same frozen topology.  Returns (poses, points, stats)
    with a leading PGO stats entry.

    Spans: ``tpuvo.refine`` around the whole refine; inside it
    ``tpuvo.refine.topology``, ``tpuvo.refine.close_loops`` (holding
    ``tpuvo.loop.covis``, ``.reloc``, ``.pgo.l2``, ``.pgo.robust``) and
    one ``tpuvo.refine.sweep.coarse`` / ``.fine`` a sweep.

    record: None, or a dict that receives each stage's inputs and outputs
    by name, as tensors on the run's device (references, no copies):
    ``poses_in`` (the tracked poses as the refine took them), the topology
    ``obs_lm`` and ``obs_valid`` (F, N), ``loops`` (``close_loops``'s
    record: co-visibility, pairs, uniforms, loop edges, each PGO pass) and
    ``sweeps`` (``refine_trajectory_global``'s: each sweep's poses and
    points before and after, with its chi); each PGO pass and each sweep
    also hands out its LM iterations.  A later implementation (a
    captured graph of a stage, say) must still hand out these names with
    these meanings: the benchmark's check starts each stage of a plain
    reference from them.  With None nothing is kept and nothing copied."""
    from tpuvo_torch.ba.loop import close_loops

    with span("refine"):
        cfg = cfg or EngineConfig()
        ba_cfg = ba_cfg or BAConfig(window=int(poses.shape[0]), iterations=15,
                                    huber_threshold=500.0)
        dev = state.map_xyz.device
        K = vo._K(cfg, dev)
        poses0 = _poses_on(poses, dev)
        uv, desc, valid = _seq_tensors(seq, dev)
        with span("refine.topology"):
            obs_lm, obs_valid = _global_topology(state.map_desc, state.map_valid, desc, valid,
                                                 cfg)
        loops = {} if record is not None else None
        with span("refine.close_loops"):
            poses_pgo, n_loops, chi = close_loops(
                K, poses0, state.map_xyz, state.map_valid, uv, obs_lm, obs_valid,
                cfg.width, cfg.height, record=loops)
        if record is not None:
            record.update(poses_in=poses0, obs_lm=obs_lm, obs_valid=obs_valid, loops=loops)
        poses_ref, points_ref, stats = refine_trajectory_global(
            state, seq, poses_pgo, cfg, ba_cfg, n_sweeps=n_sweeps, topology=(obs_lm, obs_valid),
            record=record)
        return poses_ref, points_ref, [{"stage": "pgo", "n_loop_edges": int(n_loops),
                                         "chi": float(chi)}] + stats


def refine_trajectory(state, seq, poses, cfg: EngineConfig | None = None,
                      ba_cfg: BAConfig | None = None):
    """Windowed refinement.  poses: (F, 4, 4) camera-in-world.  Returns
    (refined poses (F, 4, 4), refined map_xyz (C, 3), stats per window)."""
    cfg = cfg or EngineConfig()
    ba_cfg = ba_cfg or BAConfig()
    W = ba_cfg.window
    F = seq.uv.shape[0]
    dev = state.map_xyz.device
    poses0 = _poses_on(poses, dev)
    step = max(W // 2, 1)
    n_windows = len(range(0, F - W + 1, step))
    if n_windows == 0:
        return poses0, state.map_xyz, []
    obs_uv, desc, valid = _seq_tensors(seq, dev)
    poses_ref, points_ref, (chis, inliers, skipped) = _refine_run(
        poses0, state.map_xyz, state.map_valid, state.map_desc, desc, valid, obs_uv,
        vo._K(cfg, dev), cfg, ba_cfg, n_windows, step)
    chis, inliers, skipped = (x.cpu().numpy() for x in (chis, inliers, skipped))
    return poses_ref, points_ref, [
        {"window": int(i * step), "chi": float(chis[i]), "inliers": int(inliers[i]),
         "skipped": bool(skipped[i])} for i in range(n_windows)]
