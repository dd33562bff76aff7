"""Command-line interface: ``python -m tpuvo_torch <subcommand>``, the twin
of ``python -m tpuvo`` (``tpuvo/cli.py``): the same subcommands, flags,
printed JSON and files written.

  run          — canonical icp_test pipeline; writes the reference-format
                 artifacts + headless plots (--online: frame by frame
                 through OnlineVO; --checkpoint-every N: chunked with
                 checkpoint and resume)
  vo           — the vo.cpp driver variant (kernel 1000, fixed 5 rounds,
                 path-length scale)
  match-test   — per-pair matcher precision probe (match_points_test)
  pose-recovery— chained two-view odometry (pose_recovery_test)
  triangulate  — bootstrap-only landmark dump vs world.dat
  ba           — bundle adjustment of a window of a tracked run
  slam         — SLAM-mode tracking (interleaved local BA) + optional
                 loop-closure/global refinement; writes run artifacts
  sweep        — the robust-threshold sweep (a lane per threshold)
  refine       — tracking + BA refinement of the whole trajectory
  bench        — the benchmark (``tpuvo_torch/bench.py``): one JSON line
                 from the accuracy gate, latency, throughput and SLAM
                 sections; reads ``TPUVO_DATA`` and ``TPUVO_BENCH_*``, not
                 --data, --frames or --mode

Everything runs on the card unless ``--device cpu`` is given (the part
``JAX_PLATFORMS`` plays for the JAX CLI); without a card the CLI raises, as
``run_sequence`` does, and never carries on on the CPU.  ``--matcher pallas``
runs the hand-written top-2 kernel for every frame's map match.  Every
PICP solve on the card is the hand-written GN kernel, so no flag selects it
(the JAX CLI has none either).

Launched by ``torchrun`` (``torchrun --nproc_per_node N -m tpuvo_torch
...``), the CLI first joins the process group the launcher describes
(``parallel.mesh.maybe_distributed_init``: NCCL on the card, gloo with
``--device cpu``), as the JAX CLI joins ``jax.distributed``; a failed join
raises.  No subcommand shards its work yet, so a launch of more than one
rank exits with an error before any work (each rank would run the whole
pipeline and write the same files).  Without the launcher's variables it
runs as one process.

``--data`` defaults to ``data`` in the working directory, the
reference's layout.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def _load(args):
    from tpuvo_torch.config import EngineConfig, MatcherConfig
    from tpuvo_torch.data import load_camera_config, load_sequence

    camera_dat = os.path.join(args.data, "camera.dat")
    if os.path.exists(camera_dat):
        cfg = load_camera_config(camera_dat, mode=args.mode)
    else:
        cfg = EngineConfig(mode=args.mode)
    if getattr(args, "evict_age", 0):
        cfg = cfg.replace(map_evict_age=args.evict_age)
    if getattr(args, "matcher", None):
        cfg = cfg.replace(matcher=MatcherConfig(method=args.matcher))
    seq = load_sequence(args.data, args.frames)
    return cfg, seq


def _write_run(args, res, state, cfg, logs, summary: dict, printed: dict):
    """The run artifacts, metrics.jsonl and the printed JSON."""
    from tpuvo_torch.engine import plots
    from tpuvo_torch.engine.eval import write_outputs
    from tpuvo_torch.utils.metrics import MetricsLogger, log_frame_logs

    os.makedirs(args.out, exist_ok=True)
    write_outputs(args.out, res, state, cfg)
    plots.render_all(args.out, res, state, cfg)
    logger = MetricsLogger(os.path.join(args.out, "metrics.jsonl"))
    if logs is not None:
        log_frame_logs(logger, logs)
    map_count = int(state.map_count)
    logger.log({"event": "summary", **summary, "map_count": map_count})
    logger.close()
    print(json.dumps({"map_count": map_count, **printed}, indent=2))


def cmd_run(args):
    import torch

    from tpuvo_torch.engine import vo
    from tpuvo_torch.engine.drivers import run_icp
    from tpuvo_torch.engine.eval import evaluate, metrics_dict

    cfg, seq = _load(args)
    logs = None
    if args.online:
        # streaming session: one frame at a time through OnlineVO (the
        # serving interface) — the same track_step as the batch run
        sess = vo.OnlineVO(cfg, seed=args.seed)
        sess.start(vo.frame_of(seq, 0, args.device), vo.frame_of(seq, 1, args.device))
        plist = [torch.eye(4, dtype=torch.float32, device=args.device)]
        for i in range(1, seq.uv.shape[0]):
            plist.append(sess.step(vo.frame_of(seq, i, args.device)))
        state, poses = sess.state, torch.stack(plist)
    elif args.checkpoint_every > 0:
        # checkpointed chunked tracking with automatic resume (the
        # checkpoint lives under --out; delete it to restart from scratch)
        os.makedirs(args.out, exist_ok=True)
        state, poses, _ = vo.run_sequence_chunked(
            seq, cfg, seed=args.seed,
            checkpoint_path=os.path.join(args.out, "checkpoint.npz"),
            checkpoint_every=args.checkpoint_every, device=args.device)
    else:
        state, logs, poses, _ = run_icp(seq, cfg, seed=args.seed, device=args.device)
    res = evaluate(poses, seq.gt_pose, cfg)
    m = metrics_dict(res)
    _write_run(args, res, state, cfg, logs, m, m)


def cmd_vo(args):
    from tpuvo_torch.engine.drivers import run_vo
    from tpuvo_torch.engine.eval import evaluate, metrics_dict

    cfg, seq = _load(args)
    state, logs, poses, diag = run_vo(seq, cfg, seed=args.seed, device=args.device)
    res = evaluate(poses, seq.gt_pose, cfg)
    print(json.dumps({
        "map_count": int(state.map_count),
        "scale_path_ratio": diag["scale_path_ratio"],
        "duplicate_landmarks": diag["duplicates"],
        **metrics_dict(res),
    }, indent=2))


def cmd_match_test(args):
    from tpuvo_torch.engine.drivers import run_match_test

    cfg, seq = _load(args)
    rows = run_match_test(seq, cfg, device=args.device)
    total_f = sum(r.found for r in rows)
    total_c = sum(r.correct for r in rows)
    for r in rows:
        print(f"frame {r.frame:3d}: possible {r.possible:4d} found {r.found:4d} correct {r.correct:4d}")
    print(f"TOTAL: found {total_f} correct {total_c} precision {total_c/max(total_f,1):.4f}")


def cmd_pose_recovery(args):
    from tpuvo_torch.engine.drivers import run_pose_recovery

    cfg, seq = _load(args)
    poses_world, inliers = run_pose_recovery(seq, cfg, seed=args.seed, device=args.device)
    print(f"chained {len(poses_world)} poses; mean pair inliers {np.mean(inliers):.1f}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        np.savetxt(
            os.path.join(args.out, "chained_trajectory.txt"),
            np.c_[np.arange(len(poses_world)), poses_world[:, 0, 3], poses_world[:, 1, 3]],
            fmt="%g",
        )


def cmd_triangulate(args):
    from tpuvo_torch.data import load_world_points
    from tpuvo_torch.engine.drivers import run_triangulate_test

    cfg, seq = _load(args)
    world = load_world_points(os.path.join(args.data, "world.dat"))
    ids, pts, gt = run_triangulate_test(seq, world, cfg, seed=args.seed, device=args.device)
    for i in range(min(len(ids), args.limit)):
        print(f"id {int(ids[i]):4d} est {pts[i].round(3).tolist()} gt {gt[i].round(3).tolist()}")
    print(f"({len(ids)} landmarks triangulated)")


def cmd_ba(args):
    from tpuvo_torch.ba.window import ba_solve, build_problem_from_vo
    from tpuvo_torch.config import BAConfig
    from tpuvo_torch.engine import vo
    from tpuvo_torch.engine.drivers import run_icp
    from tpuvo_torch.ops import lie

    cfg, seq = _load(args)
    state, logs, poses, diag = run_icp(seq, cfg, seed=args.seed, device=args.device)
    lo = max(0, args.window_start)
    hi = min(seq.uv.shape[0], lo + args.window)
    idxs = list(range(lo, hi))
    prob = build_problem_from_vo(state, seq, idxs, cfg)
    # world-in-camera poses of the window from the tracked trajectory
    prob = prob._replace(poses=lie.inv_se3(poses[lo:hi]))
    ba_cfg = BAConfig(window=len(idxs), iterations=args.iterations)
    prob2, stats = ba_solve(prob, vo._K(cfg, poses.device), cfg.width, cfg.height, ba_cfg)
    print(json.dumps({
        "window": idxs,
        "iterations": args.iterations,
        "chi": float(stats.chi),
        "num_inliers": int(stats.num_inliers),
        "num_obs": int(stats.num_obs),
    }, indent=2))


def cmd_slam(args):
    """SLAM-mode tracking (local BA interleaved with the tracker,
    engine/slam.py) + optional loop-closure refinement:
      python -m tpuvo_torch slam --out out_slam                 # tracking only
      python -m tpuvo_torch slam --refine loop --out out_slam   # + PGO/global BA
    """
    from tpuvo_torch.engine.eval import evaluate, metrics_dict
    from tpuvo_torch.engine.slam import run_sequence_slam

    cfg, seq = _load(args)
    # local-BA shape overrides (long sequences want W32-40/S2, see the
    # JAX package's EngineConfig.local_ba_stride landscape)
    if args.window:
        cfg = cfg.replace(local_ba_window=args.window)
    if args.every:
        cfg = cfg.replace(local_ba_every=args.every)
    if args.stride:
        cfg = cfg.replace(local_ba_stride=args.stride)
    state, logs, poses, diag = run_sequence_slam(seq, cfg, seed=args.seed, device=args.device)
    res = evaluate(poses, seq.gt_pose, cfg)
    out = {"n_local_ba_runs": int(diag["n_local_ba_runs"]),
           "tracked": metrics_dict(res)}
    if args.refine != "none":
        from tpuvo_torch.config import BAConfig
        from tpuvo_torch.engine.ba_refine import (refine_trajectory_global,
                                                  refine_trajectory_loop)

        gcfg = BAConfig(window=poses.shape[0], iterations=args.iterations,
                        huber_threshold=500.0, max_landmarks=cfg.map_capacity)
        refiner = (refine_trajectory_loop if args.refine == "loop"
                   else refine_trajectory_global)
        poses, points2, stats = refiner(state, seq, poses, cfg, gcfg, n_sweeps=args.sweeps)
        state = state._replace(map_xyz=points2)
        res = evaluate(poses, seq.gt_pose, cfg)  # refined trajectory
        out["refined"] = metrics_dict(res)
    _write_run(args, res, state, cfg, logs, out.get("refined", out["tracked"]), out)


def cmd_sweep(args):
    """Batched inlier-rejection sweep (BASELINE config 2)."""
    from tpuvo_torch.engine.eval import evaluate, metrics_dict
    from tpuvo_torch.engine.state import to_host
    from tpuvo_torch.engine.vo import run_threshold_sweep

    cfg, seq = _load(args)
    thresholds = [float(t) for t in args.thresholds.split(",")]
    states, logs, poses = run_threshold_sweep(seq, thresholds, cfg, seed=args.seed,
                                              device=args.device)
    poses, map_count = to_host(poses), to_host(states.map_count)
    out = {}
    for i, t in enumerate(thresholds):
        m = metrics_dict(evaluate(poses[i], seq.gt_pose, cfg))
        out[str(t)] = {**m, "map_count": int(map_count[i])}
    print(json.dumps(out, indent=2))


def cmd_refine(args):
    """Tracking + BA refinement over the whole trajectory.

    --strategy global (default): joint BA over all poses + landmarks,
    gauge anchored at the trajectory start — the accuracy refiner.
    --strategy windowed: overlapping-window sweep (local smoothing only).
    --strategy posegraph: windowed BA for local relative poses, then a
    pose-graph solve fusing the window estimates globally.
    --strategy loop: loop-closure detection + PnP relocalization + PGO +
    graduated global BA (ba/loop.py — the full drift-repair stack).
    """
    from tpuvo_torch.config import BAConfig
    from tpuvo_torch.engine.ba_refine import (refine_trajectory,
                                              refine_trajectory_global,
                                              refine_trajectory_loop)
    from tpuvo_torch.engine.drivers import run_icp
    from tpuvo_torch.engine.eval import evaluate, metrics_dict

    cfg, seq = _load(args)
    state, logs, poses, diag = run_icp(seq, cfg, seed=args.seed, device=args.device)
    m0 = metrics_dict(evaluate(poses, seq.gt_pose, cfg))
    if args.strategy in ("global", "loop"):
        refiner = refine_trajectory_global if args.strategy == "global" else refine_trajectory_loop
        poses2, points2, stats = refiner(
            state, seq, poses, cfg,
            BAConfig(window=seq.uv.shape[0], iterations=args.iterations),
            n_sweeps=args.sweeps,
        )
    elif args.strategy == "posegraph":
        # hierarchical SLAM shape: windowed BA for accurate LOCAL relative
        # poses, then a pose graph fusing the overlapping window estimates
        # with the odometry backbone into one consistent trajectory
        from tpuvo_torch.ba.posegraph import build_graph, pgo_solve, window_edges

        poses_w, _, stats = refine_trajectory(
            state, seq, poses, cfg,
            BAConfig(window=args.window, iterations=args.iterations),
        )
        W = args.window
        edges = window_edges(poses_w, W, max(W // 2, 1))
        graph2, pgo_stats = pgo_solve(build_graph(poses, extra_edges=[edges]), iterations=20)
        poses2 = graph2.poses
        stats = stats + [{"pgo_chi": float(pgo_stats.chi),
                          "pgo_inliers": int(pgo_stats.num_inliers)}]
    else:
        poses2, points2, stats = refine_trajectory(
            state, seq, poses, cfg,
            BAConfig(window=args.window, iterations=args.iterations),
        )
    m1 = metrics_dict(evaluate(poses2, seq.gt_pose, cfg))
    print(json.dumps({
        "strategy": args.strategy,
        "tracked": m0, "refined": m1,
        "windows": len(stats),
        "skipped": sum(s.get("skipped", False) for s in stats),
    }, indent=2))


def cmd_bench(args):
    from tpuvo_torch import bench

    bench.main(device=args.device)


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpuvo_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data", default="data", help="dataset dir")
    p.add_argument("--frames", type=int, default=121)
    # "fixed" (landmark gating, wrapped angles) is the production default;
    # "parity" reproduces the reference's fragile unfiltered map
    p.add_argument("--mode", default="fixed", choices=["parity", "fixed"])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--evict-age", type=int, default=0,
                   help="landmark lifecycle: evict map slots unmatched for "
                        "this many frames and recycle them (0 = append-only)")
    p.add_argument("--matcher", default="",
                   choices=["", "direct", "mxu", "mxu_bf16", "pallas"],
                   help="descriptor matcher backend (pallas = the hand-written "
                        "CUDA top-2 kernel, the large-map path)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where everything runs (cuda needs a card: without one "
                        "the CLI raises unless --device cpu is given)")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("run")
    s.add_argument("--out", default="output")
    s.add_argument("--online", action="store_true",
                   help="stream frames one at a time through the OnlineVO "
                        "serving session (identical trajectory to batch)")
    s.add_argument("--checkpoint-every", type=int, default=0,
                   help="checkpoint the tracker state every N frames "
                        "(0 = off); an existing checkpoint resumes")
    s.set_defaults(fn=cmd_run)
    s = sub.add_parser("vo"); s.set_defaults(fn=cmd_vo)
    s = sub.add_parser("match-test"); s.set_defaults(fn=cmd_match_test)
    s = sub.add_parser("pose-recovery"); s.add_argument("--out", default=""); s.set_defaults(fn=cmd_pose_recovery)
    s = sub.add_parser("triangulate"); s.add_argument("--limit", type=int, default=20); s.set_defaults(fn=cmd_triangulate)
    s = sub.add_parser("ba")
    s.add_argument("--window", type=int, default=10)
    s.add_argument("--window-start", type=int, default=0)
    s.add_argument("--iterations", type=int, default=10)
    s.set_defaults(fn=cmd_ba)
    s = sub.add_parser("slam")
    s.add_argument("--out", default="output_slam")
    s.add_argument("--refine", default="none", choices=["none", "global", "loop"])
    s.add_argument("--iterations", type=int, default=15)
    s.add_argument("--sweeps", type=int, default=3)
    s.add_argument("--window", type=int, default=0,
                   help="local-BA window size W (0 = engine default 16)")
    s.add_argument("--every", type=int, default=0,
                   help="run local BA every E frames (0 = default 2)")
    s.add_argument("--stride", type=int, default=0,
                   help="keyframe spacing S of the local window (0 = "
                        "default 1; long sequences: W32-40, S2)")
    s.set_defaults(fn=cmd_slam)
    s = sub.add_parser("sweep")
    s.add_argument("--thresholds", default="1000,3000,10000")
    s.set_defaults(fn=cmd_sweep)
    s = sub.add_parser("refine")
    s.add_argument("--strategy", default="global",
                   choices=["global", "windowed", "posegraph", "loop"])
    s.add_argument("--window", type=int, default=10)
    s.add_argument("--iterations", type=int, default=15)
    s.add_argument("--sweeps", type=int, default=2)
    s.set_defaults(fn=cmd_refine)
    s = sub.add_parser("bench"); s.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    from tpuvo_torch.engine.state import check_device

    check_device(args.device)  # no card: raise before any work
    # a torchrun launch joins its process group (no-op otherwise); a failed
    # join raises
    from tpuvo_torch.parallel.mesh import maybe_distributed_init

    world = maybe_distributed_init(args.device)
    if world > 1:
        raise SystemExit(f"{world} ranks: no subcommand shards its work yet, so each rank "
                         "would run the whole pipeline and write the same --out files; "
                         "launch with torchrun --nproc_per_node 1")
    args.fn(args)


if __name__ == "__main__":
    main()
