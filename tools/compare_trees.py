#!/usr/bin/env python3
"""Costs of the tracker's bootstrap, the BA and pose-graph assembly and the
capture cache on the card, compared across source trees (e.g. a commit and
its parent).

    python tools/compare_trees.py TREE [TREE ...]
    python tools/compare_trees.py --sharded-ba TREE [TREE ...]
    python tools/compare_trees.py --kernel-c TREE [TREE ...]

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

With ``--kernel-c``, kernel C (``ops/cuda/smalleig``) alone, on inputs
saved once to ``build/kernel_c/inputs.npz`` (beside this script) by the
first tree and read by every tree: the matrices the bootstrap hands it
(``chip_smoke.bootstrap_eig_inputs``: one lane of the loop fixture and the
B=256 lanes of phase 10's (a)), phase 2's gapped matrices (B = 1, 3, 256;
n = 2, 3, 5, 8; a repeated eigenvalue; sigma3 = 0; numpy seeds), the
edge lanes (an all-zero and a NaN matrix beside valid ones), and 9x9
matrices that leave ``sym_eig``'s fast paths with a finite answer (this
checkout's ``chip_smoke.off_fast_path_psd``: scaled by 2^60, 2^-62 and
2^-70, a subnormal diagonal entry, theta above 2^60) or are scaled by 2^70
(the rotation test's product overflows).  Per tree:
whether every output is bit-equal to the first tree's, each entry point's
kernel-only time on the bootstrap's matrices (torch.profiler by kernel
name, and CUDA events around 200 queued launches) with the Jacobi
rotations a matrix, ``sym_eig`` at n = 3 on the final E's AᵀA (the Jacobi
``svd3`` runs), and the bench's fallback ``ate_rmse``, ``ate_slam`` and
``ate_refined`` with its rates (``python -m tpuvo_torch bench`` in the
tree).

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

    out["bench"] = bench(tree)
    return out


def bench(tree: str) -> dict:
    """The bench as a user runs it, in the tree: its rates and ATEs."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPUVO_")}
    with tempfile.TemporaryDirectory() as tmp:
        env["HOME"] = env["TMPDIR"] = tmp
        r = subprocess.run([sys.executable, "-m", "tpuvo_torch", "bench"], cwd=tree, env=env,
                           capture_output=True, text=True, timeout=900)
    if r.returncode:
        raise RuntimeError(f"bench failed: {r.stderr[-3000:]}")
    line = json.loads(r.stdout.strip().splitlines()[-1])
    extra = line.get("extra", {})
    return {k: extra.get(k) for k in ("fps_latency_1seq", "fps_throughput_batch", "slam_fps",
                                      "ate_rmse", "ate_slam", "ate_refined")}


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_C_DIR = os.path.join(REPO, "build", "kernel_c")


def this_chip_smoke():
    """This checkout's ``chip_smoke`` (a tree compared may predate its
    matrices off kernel C's fast paths)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_c_inputs(cs) -> dict:
    """{name: (entry point, float32 array)}: kernel C's inputs, made on the
    card by this tree's ``chip_smoke`` (see the module docstring)."""
    import numpy as np

    out = {}
    for lanes, calls in cs.bootstrap_eig_inputs().items():
        for what, (entry, A) in zip(("AtA", "E8", "E"), calls):
            out[f"boot B={lanes} {what}"] = (entry, A)
        E = calls[2][1]
        out[f"boot B={lanes} E^T E (n=3)"] = ("sym_eig", E.mT @ E)
    for B in (1, 3, 256):
        out[f"gapped 9x9 B={B}"] = ("sym_eig", cs.gapped_psd(B, seed=B))
        out[f"gapped 3x3 B={B}"] = ("svd3", cs.gapped_mat3(B, seed=B))
    for n in (2, 3, 5, 8):
        out[f"gapped {n}x{n} B=5"] = ("sym_eig", cs.gapped_psd(5, seed=n, n=n))
    out["repeated eigenvalue B=4"] = ("sym_eig",
                                      cs.gapped_psd(4, 11, w=[1, 2, 2, 2, 3, 5, 5, 7, 9]))
    rng = np.random.default_rng(12)
    Uq, Vq = (np.linalg.qr(rng.standard_normal((256, 3, 3)))[0] for _ in range(2))
    out["sigma3 = 0 B=256"] = ("svd3", Uq @ np.diag([1.0, 1.0, 0.0]) @ Vq.swapaxes(-1, -2))
    A = cs.gapped_psd(4, 13).cpu().numpy()
    A[1], A[2] = 0.0, np.nan
    out["edges: zero, NaN B=4 9x9"] = ("sym_eig", A)
    M = np.random.default_rng(4).standard_normal((4, 3, 3))
    M[1], M[2] = 0.0, np.nan
    out["edges: zero, NaN B=4 3x3"] = ("svd3", M)
    here = this_chip_smoke()
    for name, A in here.off_fast_path_psd().items():
        out[f"off the fast paths: {name} B=4"] = ("sym_eig", A)
    # a_pp a_qq overflows: no pair is rotated, in any tree
    out["scaled 2^70 B=4"] = ("sym_eig", here.gapped_psd(*here.OFF_FAST_BASE) * 2.0 ** 70)
    return {k: (e, np.asarray(a.cpu() if hasattr(a, "cpu") else a, dtype=np.float32))
            for k, (e, a) in out.items()}


def measure_kernel_c(tree: str, index: int) -> dict:
    """Kernel C on the saved inputs (made here if absent): outputs to
    ``out_<index>.npz``, kernel-only times, and the bench."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from tpuvo_torch.ops.cuda import smalleig

    assert os.path.dirname(os.path.abspath(smalleig.__file__)).startswith(os.path.abspath(tree))
    path = os.path.join(KERNEL_C_DIR, "inputs.npz")
    if not os.path.exists(path):
        os.makedirs(KERNEL_C_DIR, exist_ok=True)
        made = kernel_c_inputs(cs)
        np.savez(path, **{f"{e}|{k}": a for k, (e, a) in made.items()})
    saved = np.load(path)
    outs, times = {}, {}
    for key in saved.files:
        entry, name = key.split("|", 1)
        A = torch.as_tensor(saved[key], device="cuda")
        res = (smalleig.sym_eig if entry == "sym_eig" else smalleig.svd3)(A)
        for i, x in enumerate(res):
            outs[f"{key}|{i}"] = x.cpu().numpy()
        if not name.startswith("boot"):
            continue
        B = A.reshape(-1, *A.shape[-2:]).shape[0]
        rot = torch.zeros(B, dtype=torch.int32, device="cuda")
        prepare = smalleig.prepare_sym_eig if entry == "sym_eig" else smalleig.prepare_svd3
        launch, _ = prepare(A, rotations=rot)
        launch()
        torch.cuda.synchronize()
        prof = cs.profiled_kernel_ms(launch, f"{entry}_kernel")
        events, fed = cs.queued_launch_ms(launch)
        times[f"{entry} {name}"] = dict(
            kernel_us=None if prof is None else prof * 1e3, events_us=events * 1e3,
            host_fed=fed, rotations_mean=float(rot.float().mean()),
            rotations_max=int(rot.max()))
    np.savez(os.path.join(KERNEL_C_DIR, f"out_{index}.npz"), **outs)
    return {"tree": tree, "kernel_c": times, "bench": bench(tree)}


def same_bits(x, y) -> bool:
    """Bit for bit (a NaN equals a NaN of the same bits)."""
    return x.shape == y.shape and bool((x.view("u4") == y.view("u4")).all())


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
        flag, tree = (sys.argv[2], sys.argv[3]) if sys.argv[2].startswith("--") else (None,
                                                                                     sys.argv[2])
        if flag == "--sharded-ba":
            result = measure_sharded_ba(tree)
        elif flag == "--kernel-c":
            result = measure_kernel_c(tree, int(sys.argv[4]))
        else:
            result = measure(tree)
        print("RESULT " + json.dumps(result), flush=True)
        return
    flags = [a for a in sys.argv[1:] if a in ("--sharded-ba", "--kernel-c")]
    kernel_c = "--kernel-c" in flags
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    if kernel_c:
        import shutil

        shutil.rmtree(KERNEL_C_DIR, ignore_errors=True)  # the inputs are made anew, once
    for i, tree in enumerate(a for a in sys.argv[1:] if a not in flags):
        tree = os.path.abspath(tree)
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", *flags, tree]
                           + ([str(i)] if kernel_c else []),
                           cwd=tree, capture_output=True, text=True, timeout=1500)
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
        if r.returncode or not lines:
            print(f"FAIL {tree} (exit {r.returncode}):\n{r.stdout[-2000:]}{r.stderr[-3000:]}")
            sys.exit(1)
        result = json.loads(lines[-1][len("RESULT "):])
        if kernel_c:
            import numpy as np

            first = np.load(os.path.join(KERNEL_C_DIR, "out_0.npz"))
            mine = np.load(os.path.join(KERNEL_C_DIR, f"out_{i}.npz"))
            differ = sorted({k.rsplit("|", 1)[0] for k in first.files
                             if not same_bits(first[k], mine[k])})
            result["outputs"] = len(first.files)
            result["bit_equal_to_first_tree"] = not differ
            result["inputs_differing"] = differ
        print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
