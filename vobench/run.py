"""Run one cell of the benchmark once:

    python3 -m vobench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is an entry of ``workloads`` in
``BENCHMARK.json``; its configuration, traffic mix, limits and per-layer
readers are found by name (``vobench/configs/<config>.json``,
``vobench/traffic/<traffic>.json``, the mix's ``vobench/drivers/<driver>.py``,
``vobench/limits/<cell>.json``, ``vobench/metrics/<metric>.py``).

A run: make the inputs from the seed, warm up every shape the mix uses
(set-up, ``setup_s``), measure for ``--seconds``, read the device's peak
memory, then (``--trace 1``) profile one slice of whole units and read the
per-layer metrics, then check what the window produced against the plain
reference.  The last line of standard output is one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error and the last key of that object.  Exit codes: 0 a result was
printed; 2 no card or too few; 3 the program could not be loaded; 4 the
process holds JAX or the JAX package.
"""

from __future__ import annotations

import os
import sys
import time


def _since_process_start() -> float:
    """Seconds since this process started (from /proc, 10 ms steps), or
    since this module was loaded where /proc is missing."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter() - _LOADED


_LOADED = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "tpuvo")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: ``tpuvo_torch`` is not ``tpuvo``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _args(argv):
    import argparse

    p = argparse.ArgumentParser(prog="python3 -m vobench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _one_core():
    """One process on one core with one CPU thread: the host's share of a
    unit (the bootstrap's draw, the launches, the copies) then reads the
    same from run to run, where threads that migrate or spin read up to
    ~10% apart (PERF.md section 2).  Set before torch is imported."""
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = "1"
    if hasattr(os, "sched_setaffinity"):
        os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})


def _caches():
    """Every build and kernel cache at a fixed path inside the checkout (the
    program's own kernel library already builds into ``build/tpuvo_torch``)."""
    base = os.path.join(ROOT, "build", "vobench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(base, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(base, "triton"))
    os.environ.setdefault("USE_FLAX", "0")


def run(argv=None, device="cuda", edit=None) -> int:
    """One run.  ``device="cpu"`` and ``edit(config, traffic)`` are for the
    tests: they run the same path at a size the CPU holds, with no card."""
    a = _args(argv)
    from vobench import manifest

    cell = manifest.cell(a.workload)
    config, traffic, limits = manifest.config(cell), manifest.traffic(cell), manifest.limits(cell)
    if edit is not None:
        edit(config, traffic)
    card = device == "cuda"
    if card:
        _one_core()
    t_torch = _since_process_start()
    import torch

    if card:
        torch.set_num_threads(1)
    if card and (not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"vobench: the cell needs {cell['chips']} CUDA device(s), found {n}",
              file=sys.stderr)
        return 2
    _caches()
    try:
        from vobench import program
    except Exception as e:  # the program is not in this checkout, or does not load
        print(f"vobench: cannot load the program: {type(e).__name__}: {e}", file=sys.stderr)
        return 3
    from vobench import check, drive, stats

    mod = manifest.driver(traffic)
    t_program = _since_process_start()
    driver = mod.make(config, traffic, a.seed, device)
    setup_s = _since_process_start()
    print(f"vobench: setup_s {setup_s:.3f}: start to torch {t_torch:.3f}, to the program "
          f"{t_program:.3f}, inputs {driver.t_inputs:.3f}, warm-up {driver.t_warm:.3f}",
          file=sys.stderr)
    win = driver.window(a.seconds)
    drive.sync(device)
    result = dict(correct=False, attempted=win["attempted"], failed=win["failed"])
    dev = dict(platform="gpu" if card else "cpu",
               kind=torch.cuda.get_device_name(0) if card else "cpu",
               count=cell["chips"],
               memory_peak_bytes=torch.cuda.max_memory_allocated() if card else 0)
    if a.trace:
        ctx = driver.traced()
        tr = ctx["trace"]
        ctx.update(cell=cell["name"], device=device, window=win)
        metrics = {}
        for m in manifest.per_layer(cell):
            v = manifest.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = dict(device_ops=tr.top_ops(10), idle_gaps=tr.idle_gaps(10))
        if card:
            dev["power_limit"] = _power_limit()
    else:
        metrics = {k: dict(value=v, unit=manifest.unit(k))
                   for k, v in win["metrics"].items()}
        metrics["setup_s"] = dict(value=setup_s, unit="s")
    result["metrics"] = metrics
    result["device"] = dev

    payload = driver.sample(traffic["check_problems"])
    del driver
    program.release()
    if card:
        torch.cuda.empty_cache()
    nums = mod.numbers(payload, config, device)
    ok, rows = check.judge(nums, limits)
    result["correct"] = bool(ok and win["attempted"] > 0 and win["failed"] == 0)

    bad = forbidden_modules()
    if bad:
        print(f"vobench: the process holds {', '.join(bad)}", file=sys.stderr)
        return 4
    lat = win.get("latencies") or [0.0]
    print("vobench: read unit_ms p10 %.4f p50 %.4f p90 %.4f max %.4f over %d units" % tuple(
        [1e3 * stats.percentile(lat, q) for q in (10, 50, 90)] + [1e3 * max(lat), len(lat)]),
        file=sys.stderr)
    for k, v in nums.items():
        if k not in limits["numbers"]:
            print(f"vobench: read {k} {v!r}", file=sys.stderr)
    for name, v, lim in rows:
        print(f"vobench: check {name} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}",
              file=sys.stderr)
    result["checked"] = {name: dict(value=v, limit=lim) for name, v, lim in rows}
    import json

    print(json.dumps(result), flush=True)
    return 0


def _power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


if __name__ == "__main__":
    sys.exit(run())
