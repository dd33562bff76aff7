"""The control of a cell's check: the plain reference put in the program's
place, computed in the precision below the one the configuration states
(float32 with TF32 off, so TF32), on the cell's own inputs and at its own
size, then judged by the same check as a run.  Its readings set the upper
ends of the limits (PERF.md); the benchmark's own runs never run it.

    python3 -m vobench.control --workload <cell> --seeds 1,2,3 [--precision tf32]

``--precision``: ``tf32`` (the card's TF32, the control), ``tf32-emulated``
(TF32's rounding of every product's inputs, for a machine without it) or
``float32`` (the reference against itself: the floor of the check).
Prints one JSON line a seed.  It imports nothing of the program.
The mix's driver (``vobench/drivers``) says how the control runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from vobench import manifest


def control(cell_name: str, seed: int, precision: str, device="cuda", edit=None) -> dict:
    """The check's numbers of the control on the cell's inputs for ``seed``
    (the mix's driver's ``control``)."""
    cell = manifest.cell(cell_name)
    config, traffic = manifest.config(cell), manifest.traffic(cell)
    if edit is not None:
        edit(config, traffic)
    t = time.perf_counter()
    nums = manifest.driver(traffic).control(config, traffic, seed, precision, device)
    return dict(workload=cell_name, seed=seed, precision=precision,
                control_s=time.perf_counter() - t, **nums)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m vobench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--precision", default="tf32",
                   choices=("tf32", "tf32-emulated", "float32"))
    a = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for s in a.seeds.split(","):
        print(json.dumps(control(a.workload, int(s), a.precision)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
