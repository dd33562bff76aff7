#!/usr/bin/env python3
"""The plain PICP solver's host checks on the card, and the rates of the
paths that ran it, compared across source trees (e.g. a commit and its
parent).  On a tree whose every PICP solve on the card is the kernel, the
plain solver is measured by calling it directly, and its round counts on
the paths are empty.

    python tools/picp_host_checks.py TREE [TREE ...]

Each TREE is the root of a checkout of this repository; each is measured in a
process of its own that imports that tree's ``tpuvo_torch`` and
``chip_smoke``, in the order given (give A B B A to see the drift between
calls).  Per tree, on the card:

  * the host syncs of one plain ``picp.solve`` that runs all 50 GN rounds
    (torch's sync debug mode), and of one at the default stop on a
    noise-free problem;
  * the CLI's frames/s on ``chip_smoke.py`` phase 11's two fixtures
    (``cli.main(... --matcher pallas run)`` in process, median of 3 after a
    warm run);
  * cell (c) of phase 10 (B = 256 lanes of the 121-frame sequence, bench.py's
    configuration: the mxu_bf16 matcher and ``picp.backend="xla"``): B·F /
    median wall of 3 after a warm run;
  * in each warm run, how many GN rounds every plain ``picp.solve`` call ran
    (the most over its problems): {rounds: calls}.

Prints one JSON line per tree and the card's name and power limit.
"""

from __future__ import annotations

import collections
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time


def measure(tree: str) -> dict:
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from tpuvo_torch.config import EngineConfig, PICPConfig
    from tpuvo_torch.engine import vo
    from tpuvo_torch.ops import picp

    assert os.path.dirname(os.path.abspath(picp.__file__)).startswith(os.path.abspath(tree))
    out = {"tree": tree}
    K = torch.as_tensor(EngineConfig().K(), device="cuda")
    X, Z, V, T0 = (torch.as_tensor(a, device="cuda") for a in cs.picp_problem(0, noise=0.0))
    for key, cfg in (("syncs_50_rounds", PICPConfig(convergence_threshold=0.0)),
                     ("syncs_default_noise_free", PICPConfig())):
        args = (K, T0, X, Z, None, V, 640, 480, cfg)
        picp.solve(*args)
        out[key] = cs.count_syncs(lambda: picp.solve(*args))
        out[key.replace("syncs", "rounds")] = int(picp.solve(*args).iterations)

    solve = picp.solve

    def warm(key, fn):
        """fn() once, counting the rounds of every plain solve it makes."""
        rounds = collections.Counter()

        def counting(*a, **kw):
            r = solve(*a, **kw)
            rounds[int(r.iterations.max())] += 1
            return r

        picp.solve = counting
        try:
            fn()
        finally:
            picp.solve = solve
        out[f"rounds_{key}"] = dict(sorted(rounds.items()))

    with tempfile.TemporaryDirectory() as root:
        for name, (d, F, _, _) in cs.cli_datasets(root).items():
            argv = ["--data", d, "--frames", str(F), "--mode", "parity", "--matcher",
                    "pallas", "run", "--out", os.path.join(root, f"o_{name}")]
            warm(f"cli_{name}", lambda: cs.cli_main(argv))
            walls = [cs.cli_main(argv)[2] for _ in range(3)]
            out[f"cli_fps_{name}"] = F / statistics.median(walls)

    cfg = cs.batch_cfgs()["c"]
    seq, _ = cs.batch_fixture()
    fr = cs.lane_frames(seq, cs.BATCH, seed=3)
    warm("cell_c", lambda: vo.run_batch(fr, cfg, seed=42))
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vo.run_batch(fr, cfg, seed=42)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out["cell_c_frames_per_s"] = cs.BATCH * fr.uv.shape[1] / statistics.median(walls)
    out["cell_c_walls_s"] = walls
    return out


def main():
    if sys.argv[1:2] == ["--one"]:
        print("RESULT " + json.dumps(measure(sys.argv[2])), flush=True)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    for tree in sys.argv[1:]:
        tree = os.path.abspath(tree)
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree], cwd=tree,
                           capture_output=True, text=True, timeout=1200)
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
        if r.returncode or not lines:
            print(f"FAIL {tree} (exit {r.returncode}):\n{r.stdout[-2000:]}{r.stderr[-3000:]}")
            sys.exit(1)
        print(lines[-1][len("RESULT "):], flush=True)


if __name__ == "__main__":
    main()
