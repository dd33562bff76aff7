"""The benchmark: ``python -m tpuvo_torch bench`` (or ``python -m
tpuvo_torch.bench``), the twin of the JAX package's ``bench.py``.  Prints
ONE JSON line, the last line of stdout, with the same ``metric``, ``unit``
and keys, from the same sections, gates, environment variables and
defaults:

  * accuracy gate — the throughput configuration's single-sequence run
    (``bootstrap`` + ``make_tracker``) gated on ATE <= 0.25 and mean
    translational error <= 0.30, plus the per-frame golden gate against
    ``<data>/../output/estimated_trajectory_scaled.txt`` when it exists;
  * latency — ``vo.full_run_jit`` (as ``bench.py:188``) under the latency
    profile (fused frame matchers, ``picp.backend="pallas"``), one warm run
    gated on its own ATE, 2 untimed runs, then ``TPUVO_BENCH_LAT_REPS`` runs
    each timed alone to a synchronize: the median, min and max of F / wall;
  * throughput — ``vo.run_batch`` over ``TPUVO_BENCH_BATCH`` distinct
    lanes (each its own 0.25 px pixel noise and RANSAC draw): B·F / the
    mean wall of 5 runs after a warm one;
  * SLAM (on by default on the card, off on the CPU) — ``run_sequence_slam``
    on the 200-frame loop circuit with an 8192-slot map (kernel B for
    every map match), a median of 3 timed runs, then one timed
    ``refine_trajectory_loop``, gated on ate_slam <= 1.0 and ate_refined
    <= 0.2.

On the card every section's PICP solves launch kernel A
(``ops/cuda/picp_kernel``), whichever ``picp.backend`` its profile names,
and the refine's loop closure polishes its PnP in one launch; on the CPU
they run its plain version.  The tracker's and the SLAM step of every
section is a CUDA graph replayed once a frame (``make_tracker``,
``full_run_jit``, ``run_batch`` and ``run_sequence_slam`` reach them), as
the JAX bench times compiled programs; the refine stays eager.

The headline is max(latency, throughput) frames/s; ``vs_baseline`` is it
over ``CPP_BASELINE_FPS``, zeroed when the gate of the section that
supplies it fails.

Differences from the JAX bench, each forced by the platform:
  * ``relay_floor_ms`` is the median of 15 synchronized ``x + 1.0`` on an
    (8, 128) fp32 tensor, as in JAX; on the card it reads the launch and
    synchronize floor (there is no relay), and ``fps_latency_ondevice_est``
    is F over the latency wall less that floor.  Both are kept so the key
    set is the JAX bench's.
  * Randomness is a ``torch.Generator`` (``vo.make_generator``): a fresh one
    from seed 42 for each run, as JAX reuses ``PRNGKey(42)``, so every
    latency rep draws the same hypotheses.  The lanes' pixel noise is drawn
    with numpy from seed 1000 (``lane_uv``); ``run_batch`` draws each lane's
    RANSAC hypotheses from one generator.  So the lanes' trajectories are
    not JAX's; no lane is gated.
  * Inputs are built and moved to the device before each timed loop, as
    JAX's are; the refine is timed on its first call, as in JAX, but here
    that call builds no kernel (the SLAM runs built kernel B).
  * No compilation cache: the kernels are built once into the build
    directory (``ops/cuda/build.py``).  ``TPUVO_DATA`` defaults to ``data``
    in the working directory, the layout the CLI reads.
  * ``device`` is the card's name (``torch.cuda.get_device_name``), or
    ``cpu``.

``main(device="cuda")`` raises without a card (``device="cpu"`` runs the
kernels' plain versions), prints the line and returns the dict.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import time

import numpy as np
import torch

from tpuvo_torch.config import BAConfig, EngineConfig, MatcherConfig, PICPConfig, RansacConfig
from tpuvo_torch.data import load_sequence, synthetic
from tpuvo_torch.engine import vo
from tpuvo_torch.engine.eval import evaluate, metrics_dict

# The C++ reference (Release, -O3) on one core of the JAX package's
# development host CPU, frames/s over the 121-frame sequence (BASELINE.md,
# "Measured C++ baseline").  A CPU reading, not a reading of any chip.
CPP_BASELINE_FPS = 3584.35
LANE_NOISE = 0.25  # px, each lane's detector-level pixel noise


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def _sync(device):
    return torch.cuda.synchronize if _on_card(device) else (lambda: None)


def configs(device="cuda"):
    """(throughput and gate config, latency profile, SLAM profile) from the
    environment, with the JAX bench's names and defaults.  Where the JAX
    bench keys a default on a non-CPU backend, this keys it on the card:
    ``picp.backend="pallas"`` in the latency profile (kernel A runs on the
    card under "xla" too), kernel B in the SLAM profile."""
    card = _on_card(device)
    cfg = EngineConfig(
        mode=os.environ.get("TPUVO_BENCH_MODE", "fixed"),
        fuse_frame_matchers=os.environ.get("TPUVO_BENCH_FUSED", "0") == "1",
        motion_model_init=os.environ.get("TPUVO_BENCH_MOTION", "0") == "1",
        matcher=MatcherConfig(method=os.environ.get("TPUVO_BENCH_MATCHER", "mxu_bf16")),
        # rel-chi 1e-4 (kernel A on the card under either backend, as every
        # PICP solve there); 2 triangulation polish iterations
        picp=PICPConfig(convergence_threshold=1e-4,
                        unrolled_rounds=int(os.environ.get("TPUVO_BENCH_GN_UNROLL", "0")),
                        backend=os.environ.get("TPUVO_BENCH_PICP", "xla")),
        triangulation_refine_iters=int(os.environ.get("TPUVO_BENCH_REFINE", "2")),
    )
    cfg_lat = dataclasses.replace(
        cfg,
        scan_unroll=int(os.environ.get("TPUVO_BENCH_SCAN_UNROLL", "8")),  # no-op in the port
        log_stats=os.environ.get("TPUVO_BENCH_LAT_STATS", "0") == "1",
        fuse_frame_matchers=os.environ.get("TPUVO_BENCH_LAT_FUSED", "1") == "1",
        ransac=RansacConfig(
            num_hypotheses=int(os.environ.get("TPUVO_BENCH_LAT_RANSAC", "256"))),
        max_new_landmarks_per_frame=int(os.environ.get("TPUVO_BENCH_LAT_NEWLM", "24")),
        picp=dataclasses.replace(
            cfg.picp,
            backend=os.environ.get("TPUVO_BENCH_LAT_PICP", "pallas" if card else "xla")),
    )
    sf = int(os.environ.get("TPUVO_BENCH_SLAM_FRAMES", "200"))
    scap = int(os.environ.get("TPUVO_BENCH_SLAM_CAP", "8192"))
    cfg_slam = EngineConfig(
        mode="fixed", n_frames=sf, map_capacity=scap, fuse_frame_matchers=True,
        matcher=MatcherConfig(method=os.environ.get("TPUVO_BENCH_SLAM_MATCHER",
                                          "pallas" if card else "mxu")),
        # picp.backend "xla", as in JAX: kernel A on the card all the same
        picp=PICPConfig(convergence_threshold=1e-4),
        ba=dataclasses.replace(EngineConfig().ba, max_landmarks=scap),
    )
    return cfg, cfg_lat, cfg_slam


def bench_sequence(cfg: EngineConfig, data_dir: str):
    """The dataset at ``data_dir`` when it exists, else a synthetic sequence
    of the same shape (it walks off its +-10 m world, so the accuracy gates
    read false on it, as in the JAX bench)."""
    if os.path.isdir(data_dir):
        return load_sequence(data_dir, cfg.n_frames)
    world = synthetic.make_world(0, n_landmarks=1000)
    gt = synthetic.make_planar_trajectory(cfg.n_frames)
    return synthetic.render_sequence(world, gt, cfg, pixel_noise=0.1)


def lane_uv(seq, lanes: int, salt: int = 0):
    """Every lane's pixels (B, F, N, 2): the sequence's uv plus LANE_NOISE px
    of noise times valid, drawn with numpy from seed 1000 + salt once over
    the whole frame axis, so frame i's two views (next, then current) see
    the same pixels."""
    rng = np.random.default_rng(1000 + salt)
    noise = LANE_NOISE * rng.standard_normal((lanes,) + seq.uv.shape).astype(np.float32)
    return seq.uv[None] + noise * seq.valid[None, ..., None]


def slam_sequence(cfg_slam: EngineConfig):
    """The SLAM section's KITTI-scale loop circuit: cfg_slam.n_frames frames
    at 1 m a frame in a 20,000-landmark world sized to the path, 0.3 px."""
    sf = cfg_slam.n_frames
    sgt = synthetic.make_loop_trajectory(sf, step=1.0, seed=7)
    sext = float(np.abs(sgt[:, :2]).max()) + 15.0
    sworld = synthetic.make_world(7, n_landmarks=20000, xy_extent=sext, z_range=(0.0, 8.0))
    return synthetic.render_sequence(sworld, sgt, cfg_slam, pixel_noise=0.3, seed=7)


def split(frames: vo.Frame):
    """(frame 0, frame 1, frames [0, F-1), frames [1, F)) of a stacked Frame
    (views)."""
    return (vo.frame_at(frames, 0), vo.frame_at(frames, 1),
            vo.Frame(*(x[:-1] for x in frames)), vo.Frame(*(x[1:] for x in frames)))


def _with_identity(pose):
    eye = torch.eye(4, dtype=torch.float32, device=pose.device)[None]
    return torch.cat([eye, pose], 0)


def accuracy_gate(seq, frames: vo.Frame, cfg: EngineConfig, data_dir: str) -> dict:
    """The hard accuracy gate of the throughput configuration: one
    single-sequence run.  Returns its metrics, ``accuracy_ok`` (with the
    golden gate), the golden keys and the final state."""
    f0, f1, curr, nxt = split(frames)
    state0, _ = vo.bootstrap_jit(vo.make_generator(42), f0, f1, cfg)
    state, logs = vo.make_tracker(cfg)(state0, curr, nxt)
    res = evaluate(_with_identity(logs.pose), seq.gt_pose, cfg)
    acc = metrics_dict(res)
    accuracy_ok = acc["ate_rmse"] <= 0.25 and acc["trans_err_mean"] <= 0.30
    # per-frame deviation from the reference's scaled trajectory; thresholds
    # 2x the JAX package's CPU fixed-mode envelope (mean 0.058 / max 0.137)
    golden, golden_ok = {}, True
    ref_traj = os.path.join(os.path.dirname(data_dir), "output",
                            "estimated_trajectory_scaled.txt")
    if os.path.exists(ref_traj):
        ref = np.loadtxt(ref_traj)
        est_t = res.poses_world[:, :3, 3] * res.scale
        if len(ref) == len(est_t):
            dev = np.linalg.norm(est_t[:, :2] - ref[:, 1:3], axis=1)
            golden = {"golden_dev_mean": round(float(dev.mean()), 4),
                      "golden_dev_max": round(float(dev.max()), 4)}
            golden_ok = dev.mean() <= 0.12 and dev.max() <= 0.30
        else:  # a frame-count override: the row-wise difference is undefined
            golden = {"golden_gate_skipped": f"len {len(est_t)} vs ref {len(ref)}"}
    return dict(acc=acc, accuracy_ok=bool(accuracy_ok and golden_ok), golden=golden,
                state=state)


def latency_run(frames: vo.Frame, cfg_lat: EngineConfig):
    """One latency rep: bootstrap + the whole tracker (its step a replayed
    CUDA graph on the card), from a fresh generator at seed 42.  Returns
    (final state, FrameLog)."""
    return vo.full_run_jit(vo.make_generator(42), *split(frames), cfg_lat)


def latency(seq, frames: vo.Frame, cfg_lat: EngineConfig, reps: int) -> dict:
    """The latency section (see the module docstring).  Returns the F/wall
    readings sorted, the launch-and-sync floor in seconds and the warm
    run's metrics and gate."""
    F = frames.uv.shape[0]
    sync = _sync(frames.uv.device)

    def run_once():
        _, lg = latency_run(frames, cfg_lat)
        sync()
        return lg

    lg = run_once()  # warm, gated on its own accuracy
    acc = metrics_dict(evaluate(_with_identity(lg.pose), seq.gt_pose, cfg_lat))
    ok = bool(acc["ate_rmse"] <= 0.25 and acc["trans_err_mean"] <= 0.30)
    run_once()
    run_once()
    x = torch.zeros((8, 128), dtype=torch.float32, device=frames.uv.device)
    trivial = lambda: x + 1.0
    trivial()
    sync()
    floor = []
    for _ in range(15):
        t0 = time.perf_counter()
        trivial()
        sync()
        floor.append(time.perf_counter() - t0)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run_once()
        times.append(time.perf_counter() - t0)
    return dict(fps=sorted(F / t for t in times), floor_s=sorted(floor)[len(floor) // 2],
                acc=acc, accuracy_ok=ok)


def throughput(lanes: vo.Frame, cfg: EngineConfig, reps: int = 5) -> float:
    """B·F / the mean wall of ``reps`` synchronized ``run_batch`` calls over
    a lane-batched Frame (B, F, ...), after a warm one."""
    B, F = lanes.uv.shape[:2]
    sync = _sync(lanes.uv.device)
    vo.run_batch(lanes, cfg, seed=42)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        vo.run_batch(lanes, cfg, seed=42)
        sync()
    return B * F / ((time.perf_counter() - t0) / reps)


def slam(cfg_slam: EngineConfig, device="cuda") -> dict:
    """The SLAM section: its keys of the JSON line (slam_fps zeroed when a
    gate fails)."""
    from tpuvo_torch.engine.ba_refine import refine_trajectory_loop
    from tpuvo_torch.engine.slam import run_sequence_slam

    sf, scap = cfg_slam.n_frames, cfg_slam.map_capacity
    sync = _sync(device)
    sseq = slam_sequence(cfg_slam)
    # the frames on the device before the timed runs (frames_of copies nothing then)
    dseq = sseq._replace(**{k: torch.as_tensor(getattr(sseq, k), device=device)
                            for k in vo.Frame._fields})
    state_s, _, poses_slam, _ = run_sequence_slam(dseq, cfg_slam, seed=7, device=device)  # warm
    sync()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run_sequence_slam(dseq, cfg_slam, seed=7, device=device)
        sync()
        walls.append(time.perf_counter() - t0)
    slam_fps = (sf - 1) / statistics.median(walls)
    m_slam = metrics_dict(evaluate(poses_slam, sseq.gt_pose, cfg_slam))
    gcfg = BAConfig(window=sf, iterations=15, huber_threshold=500.0, max_landmarks=scap)
    t0 = time.perf_counter()
    poses_ref, _, _ = refine_trajectory_loop(state_s, dseq, poses_slam, cfg_slam, gcfg,
                                             n_sweeps=3)
    sync()
    refine_s = time.perf_counter() - t0
    m_ref = metrics_dict(evaluate(poses_ref, sseq.gt_pose, cfg_slam))
    ok = m_slam["ate_rmse"] <= 1.0 and m_ref["ate_rmse"] <= 0.2
    return {
        "slam_fps": round(slam_fps, 1) if ok else 0.0,
        "ate_slam": round(m_slam["ate_rmse"], 4),
        "ate_refined": round(m_ref["ate_rmse"], 4),
        "slam_gate_ok": bool(ok),
        "slam_frames": sf,
        "slam_refine_s": round(refine_s, 2),
    }


def main(device="cuda") -> dict:
    """Run every section on ``device``, print the JSON line, return it."""
    vo.check_device(device)
    card = _on_card(device)
    cfg, cfg_lat, cfg_slam = configs(device)
    data_dir = os.environ.get("TPUVO_DATA", "data")
    seq = bench_sequence(cfg, data_dir)
    frames = vo.frames_of(seq, 0, seq.uv.shape[0], device)
    F = frames.uv.shape[0]

    gate = accuracy_gate(seq, frames, cfg, data_dir)
    acc = gate["acc"]
    lat_reps = int(os.environ.get("TPUVO_BENCH_LAT_REPS", "21"))
    lat = latency(seq, frames, cfg_lat, lat_reps)
    fps_all = lat["fps"]
    fps_latency = fps_all[len(fps_all) // 2]  # median

    B = int(os.environ.get("TPUVO_BENCH_BATCH", "256"))
    lanes = vo.lanes_of([seq._replace(uv=u) for u in lane_uv(seq, B)], device)
    fps_throughput = throughput(lanes, cfg)
    del lanes

    slam_keys = {}
    if os.environ.get("TPUVO_BENCH_SLAM", "1" if card else "0") == "1":
        slam_keys = slam(cfg_slam, device)

    fps = max(fps_latency, fps_throughput)
    # the gate of whichever section supplies the headline
    headline_ok = gate["accuracy_ok"] and (fps_throughput >= fps_latency
                                           or lat["accuracy_ok"])
    floor_s = lat["floor_s"]
    out = {
        "metric": "vo_frames_per_second",
        "value": round(fps, 1),
        "unit": "frames/s",
        "vs_baseline": round(fps / CPP_BASELINE_FPS, 3) if headline_ok else 0.0,
        "extra": {
            "accuracy_gate_ok": gate["accuracy_ok"],
            "fps_latency_1seq": round(fps_latency, 1),
            "latency_vs_baseline": (round(fps_latency / CPP_BASELINE_FPS, 3)
                                    if lat["accuracy_ok"] else 0.0),
            "latency_fps_min": round(fps_all[0], 1),
            "latency_fps_max": round(fps_all[-1], 1),
            "latency_reps": lat_reps,
            "relay_floor_ms": round(1e3 * floor_s, 2),
            "fps_latency_ondevice_est": round(F / max(F / fps_latency - floor_s, 1e-6), 1),
            "latency_accuracy_ok": lat["accuracy_ok"],
            "latency_ate_rmse": round(lat["acc"]["ate_rmse"], 4),
            "fps_throughput_batch": round(fps_throughput, 1),
            "batch": B,
            "device": torch.cuda.get_device_name(torch.device(device)) if card else "cpu",
            "ate_rmse": round(acc["ate_rmse"], 4),
            "trans_err_mean": round(acc["trans_err_mean"], 4),
            "ate_robot": round(acc["ate_robot"], 4),
            **gate["golden"],
            **slam_keys,
            "map_count": int(gate["state"].map_count),
            "cpp_baseline_fps": CPP_BASELINE_FPS,
        },
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
