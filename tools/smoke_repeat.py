#!/usr/bin/env python3
"""Run some of ``chip_smoke.py``'s phases again and again on the card, to
find a check that fails only now and then.

    python tools/smoke_repeat.py RUNS PHASE [PHASE ...]

PHASE is a ``chip_smoke`` function name without its ``phase_`` prefix that
takes the summary dict (``cli``, ``sharded``, ``bench``, ``slam_runs``,
``batch``, ``kernels``, ``runs``).  The card is checked and the kernels are
built once (``phase_card``); then each round runs the phases in the order
given.  A failed check does not end the run: it is printed as ``CHECK
FAILED (round r, phase p): message`` and the phase goes on (a check that
guards what follows may then raise, which is printed as ``RAISED``).  The
phases' own lines are printed as they come.  The last line is a JSON
summary: the failures by phase and round.
"""

from __future__ import annotations

import json
import os
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main():
    runs, phases = int(sys.argv[1]), sys.argv[2:]
    where = {"round": None, "phase": None}
    failures = []

    def check(cond, msg):
        if not cond:
            failures.append({**where, "msg": str(msg)[:2000]})
            print(f"CHECK FAILED (round {where['round']}, phase {where['phase']}): {msg}",
                  flush=True)

    chip_smoke.check = check
    chip_smoke.phase_card()
    for r in range(runs):
        for p in phases:
            where.update(round=r, phase=p)
            print(f"== round {r}: phase {p}", flush=True)
            try:
                getattr(chip_smoke, f"phase_{p}")({"paths": {}, "picp": {}, "match": {}})
            except Exception:  # noqa: BLE001  (recorded, then the next phase)
                failures.append({**where, "msg": "RAISED " + traceback.format_exc()[-2000:]})
                print(f"RAISED (round {r}, phase {p}):\n{traceback.format_exc()}", flush=True)
    print(json.dumps({"runs": runs, "phases": phases, "failures": failures}))


if __name__ == "__main__":
    main()
