#!/usr/bin/env python3
"""The spread of the bench's SLAM gate on the card, run after run.

    python tools/bench_slam_spread.py [RUNS]

Runs the SLAM section of ``python -m tpuvo_torch bench`` (its profile from
``tpuvo_torch.bench.configs``, its 200-frame loop circuit from
``bench.slam_sequence``) RUNS times (default 20) in this process: each run
is ``run_sequence_slam(seed=7)`` and one ``refine_trajectory_loop`` with the
bench's global-BA settings.  The card sums some reductions in no fixed
order (``index_add_``), so runs differ.  Per run it prints one JSON line:
ate_slam, ate_refined (the bench's gates: <= 1.0 and <= 0.2), the loop
edges, the PGO and sweep chis, kernel B's launches and the wall.  Then a
summary line (min / median / max of both ATEs, the runs that fail a gate)
and the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from tpuvo_torch import bench  # noqa: E402
from tpuvo_torch.config import BAConfig  # noqa: E402
from tpuvo_torch.engine import vo  # noqa: E402
from tpuvo_torch.engine.ba_refine import refine_trajectory_loop  # noqa: E402
from tpuvo_torch.engine.eval import evaluate, metrics_dict  # noqa: E402
from tpuvo_torch.engine.slam import run_sequence_slam  # noqa: E402
from tpuvo_torch.ops.cuda import match_kernel, picp_kernel  # noqa: E402


def one_run(dseq, sseq, cfg_slam) -> dict:
    sf, scap = cfg_slam.n_frames, cfg_slam.map_capacity
    torch.cuda.synchronize()
    picp_kernel.launches = match_kernel.launches = 0
    t0 = time.perf_counter()
    state, _, poses, _ = run_sequence_slam(dseq, cfg_slam, seed=7, device="cuda")
    gcfg = BAConfig(window=sf, iterations=15, huber_threshold=500.0, max_landmarks=scap)
    poses_ref, _, stats = refine_trajectory_loop(state, dseq, poses, cfg_slam, gcfg, n_sweeps=3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {
        "ate_slam": metrics_dict(evaluate(poses, sseq.gt_pose, cfg_slam))["ate_rmse"],
        "ate_refined": metrics_dict(evaluate(poses_ref, sseq.gt_pose, cfg_slam))["ate_rmse"],
        "loop_edges": stats[0]["n_loop_edges"],
        "chi": [s["chi"] for s in stats],
        "launches": [picp_kernel.launches, match_kernel.launches],
        "wall_s": wall,
    }


def main():
    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    vo.check_device("cuda")
    cfg_slam = bench.configs("cuda")[2]
    sseq = bench.slam_sequence(cfg_slam)
    dseq = sseq._replace(**{k: torch.as_tensor(getattr(sseq, k), device="cuda")
                            for k in vo.Frame._fields})
    rows = []
    for i in range(runs):
        r = one_run(dseq, sseq, cfg_slam)
        rows.append(r)
        print(json.dumps({"run": i, **r}), flush=True)
    summary = {}
    for k in ("ate_slam", "ate_refined"):
        v = sorted(r[k] for r in rows)
        summary[k] = [v[0], statistics.median(v), v[-1]]
    summary["gate_fails"] = [i for i, r in enumerate(rows)
                             if not (r["ate_slam"] <= 1.0 and r["ate_refined"] <= 0.2)]
    summary["launches"] = sorted({tuple(r["launches"]) for r in rows})
    print(json.dumps({"runs": runs, **summary}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
