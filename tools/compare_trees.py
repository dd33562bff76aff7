#!/usr/bin/env python3
"""Costs of the tracker's bootstrap, the BA and pose-graph assembly and the
capture cache on the card, compared across source trees (e.g. a commit and
its parent).

    python tools/compare_trees.py TREE [TREE ...]
    python tools/compare_trees.py --sharded-ba TREE [TREE ...]

Each TREE is the root of a checkout of this repository; each is measured in
a process of its own that imports that tree's ``tpuvo_torch`` and
``chip_smoke``, in the order given (give A B B A to see the drift between
calls).  Per tree, on the card, on ``chip_smoke.loop_fixture()`` (200
frames, an 8192-slot map, both kernels):

  * one local-BA solve (``engine/slam._local_ba`` at frame 18, a full
    window): the device's busy ms a solve (torch.profiler, 10 solves) and
    its wall;
  * ``run_sequence_slam``: frames/s, (F-1) / median wall of 3 after a warm
    run;
  * one ``close_loops`` call on that run's map and topology: median wall of
    3 after a warm call;
  * the capture cache: ``torch.cuda.memory_allocated`` and
    ``memory_reserved`` (after ``empty_cache``) after ``run_sequence`` on
    the first 105, 110, ..., 200 frames (20 lengths), then
    ``run_sequence_chunked`` at 3 chunk lengths, with the number of cached
    entries (a tree whose cache has a bound, ``graphs.CACHE_BYTES``, runs
    with it set to 64 MiB, so that the bound shows within 20 lengths);
  * the bench, ``python -m tpuvo_torch bench`` as a process in the tree, at
    its defaults: its latency, throughput and SLAM rates.

With ``--sharded-ba``, only phase 12's sharded BA at world size 1 (NCCL),
through the tree's own ``chip_smoke.sharded_ba_world1``: ms per GN
iteration of ``sharded_ba_solve`` and of the unsharded ``ba_solve`` (the
marginal between 2 and 22 iterations, median wall of 3 each).

Prints the card's name and power limit, then one JSON line per tree.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time


def walls(fn, n: int) -> list:
    import torch

    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def device_ms(fn, n: int) -> float:
    """The profiler's device time per call of fn() over n calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / n


def measure(tree: str) -> dict:
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from tpuvo_torch.ba.loop import close_loops
    from tpuvo_torch.engine import ba_refine, slam, vo
    from tpuvo_torch.utils import graphs

    assert os.path.dirname(os.path.abspath(vo.__file__)).startswith(os.path.abspath(tree))
    out = {"tree": tree}
    seq, cfg = cs.loop_fixture()
    F = seq.uv.shape[0]

    # one local-BA solve at frame 18, from an eager run's carry
    fr = vo.frames_of(seq, 0, 20, "cuda")
    st, _ = vo.bootstrap(vo.make_generator(7), vo.frame_at(fr, 0), vo.frame_at(fr, 1), cfg)
    carry = slam.init_carry(st, F, fr.uv.shape[1], cfg)
    for i in range(17):
        carry, _ = slam.slam_step(carry, vo.frame_at(fr, i), vo.frame_at(fr, i + 1), cfg)
    assert slam.local_ba_due(carry.k, cfg)
    k = slam._device_k(carry)
    solve = lambda: slam._local_ba(carry, k, cfg)
    out["local_ba_device_ms"] = device_ms(solve, 10)
    out["local_ba_wall_ms"] = 1e3 * statistics.median(walls(solve, 5))

    # run_sequence_slam and one close_loops call on its result
    state, _, poses, _ = slam.run_sequence_slam(seq, cfg, seed=7)
    w = walls(lambda: slam.run_sequence_slam(seq, cfg, seed=7), 3)
    out["slam_frames_per_s"] = (F - 1) / statistics.median(w)
    uv, desc, valid = ba_refine._seq_tensors(seq, "cuda")
    topo = ba_refine._global_topology(state.map_desc, state.map_valid, desc, valid, cfg)
    loops = lambda: close_loops(vo._K(cfg, "cuda"), poses, state.map_xyz, state.map_valid, uv,
                                *topo, cfg.width, cfg.height)
    loops()
    out["close_loops_ms"] = 1e3 * statistics.median(walls(loops, 3))

    # the capture cache over sequence lengths, then chunked runs
    def memory():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return dict(entries=len(graphs._cache),
                    allocated_mib=round(torch.cuda.memory_allocated() / 2**20, 1),
                    reserved_mib=round(torch.cuda.memory_reserved() / 2**20, 1))

    graphs.clear()
    if hasattr(graphs, "CACHE_BYTES"):
        graphs.CACHE_BYTES = 64 << 20
    out["cache_bound_mib"] = getattr(graphs, "CACHE_BYTES", 0) / 2**20 or None
    out["cache_start"] = memory()
    mem = []
    for n in range(105, 201, 5):
        vo.run_sequence(type(seq)(*(x[:n] for x in seq)), cfg, seed=7)  # the first n frames
        mem.append(dict(frames=n, **memory()))
    for every in (30, 40, 50):
        vo.run_sequence_chunked(seq, cfg, seed=7, checkpoint_every=every, device="cuda")
        mem.append(dict(chunked_every=every, **memory()))
    out["cache"] = mem
    out["cache_evictions"] = getattr(graphs, "evictions", None)

    # the bench as a user runs it, in the tree
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPUVO_")}
    with tempfile.TemporaryDirectory() as tmp:
        env["HOME"] = env["TMPDIR"] = tmp
        r = subprocess.run([sys.executable, "-m", "tpuvo_torch", "bench"], cwd=tree, env=env,
                           capture_output=True, text=True, timeout=900)
    if r.returncode:
        raise RuntimeError(f"bench failed: {r.stderr[-3000:]}")
    line = json.loads(r.stdout.strip().splitlines()[-1])
    extra = line.get("extra", {})
    out["bench"] = {k: extra.get(k) for k in ("fps_latency_1seq", "fps_throughput_batch",
                                              "slam_fps", "ate_rmse", "ate_slam", "ate_refined")}
    return out


def measure_sharded_ba(tree: str) -> dict:
    sys.path.insert(0, tree)
    import torch.distributed as dist

    import chip_smoke as cs
    from tpuvo_torch.parallel import mesh as pm

    assert os.path.dirname(os.path.abspath(pm.__file__)).startswith(os.path.abspath(tree))
    failed = []
    cs.check = lambda ok, msg: ok or failed.append(msg)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(cs.free_port()), RANK="0",
                      WORLD_SIZE="1", LOCAL_RANK="0")
    pm.maybe_distributed_init()
    summary = {}
    try:
        cs.sharded_ba_world1(summary, pm.local_mesh(1))
    finally:
        dist.destroy_process_group()
    return {"tree": tree, "sharded_ba": summary["sharded_ba"], "failed_checks": failed}


def main():
    if sys.argv[1:2] == ["--one"]:
        sharded = sys.argv[2] == "--sharded-ba"
        tree = sys.argv[3 if sharded else 2]
        print("RESULT " + json.dumps(measure_sharded_ba(tree) if sharded else measure(tree)),
              flush=True)
        return
    flags = [a for a in sys.argv[1:] if a == "--sharded-ba"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    for tree in [a for a in sys.argv[1:] if a not in flags]:
        tree = os.path.abspath(tree)
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", *flags, tree],
                           cwd=tree, capture_output=True, text=True, timeout=1500)
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
        if r.returncode or not lines:
            print(f"FAIL {tree} (exit {r.returncode}):\n{r.stdout[-2000:]}{r.stderr[-3000:]}")
            sys.exit(1)
        print(lines[-1][len("RESULT "):], flush=True)


if __name__ == "__main__":
    main()
