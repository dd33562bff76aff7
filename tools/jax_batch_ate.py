"""The JAX package's own vmapped tracker on chip_smoke.py phase 10's lanes,
on the CPU: the reference behind chip_smoke.ATE_LIMITS.

    python tools/jax_batch_ate.py [--lanes 256] [--chunk 32] [--configs a,c]

Builds chip_smoke.batch_fixture()'s sequence and tpuvo_torch.bench.lane_uv's
per-lane pixel noise, then runs jax.vmap of the JAX package's bootstrap and
scan_tracker as bench.py:236-239 does (keys: jax.random.split of
PRNGKey(42)), in chunks of lanes, for configurations (a) and (c) of
chip_smoke.batch_cfgs in the JAX package's terms: its Pallas PICP solver has
no CPU mode, so both run its XLA solver (the same function), and (a)'s
pallas matcher runs in interpret mode.  Prints one JSON line per
configuration: the lanes' ATE (the JAX package's evaluator) median, 90th
percentile and max, and the seconds it took.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import chip_smoke  # noqa: E402
from tpuvo.config import EngineConfig, MatcherConfig, PICPConfig  # noqa: E402
from tpuvo.engine import vo  # noqa: E402
from tpuvo.engine.eval import evaluate  # noqa: E402
from tpuvo_torch import bench  # noqa: E402

CONFIGS = {
    "a": EngineConfig(mode="fixed", fuse_frame_matchers=True,
                      matcher=MatcherConfig(method="pallas"),
                      picp=PICPConfig(convergence_threshold=1e-4, backend="xla")),
    "c": EngineConfig(mode="fixed", matcher=MatcherConfig(method="mxu_bf16"),
                      picp=PICPConfig(convergence_threshold=1e-4, backend="xla")),
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, default=chip_smoke.BATCH)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--configs", default="a,c")
    args = ap.parse_args()
    seq, gt = chip_smoke.batch_fixture()
    uv = bench.lane_uv(seq, args.lanes, salt=3)
    F = seq.uv.shape[0]
    keys = jax.random.split(jax.random.PRNGKey(42), args.lanes)
    shared = {k: jnp.asarray(getattr(seq, k)) for k in ("desc", "id_meas", "id_real", "valid")}
    for name in args.configs.split(","):
        cfg = CONFIGS[name]

        @jax.jit
        def batched(k, uv_lanes):
            n = uv_lanes.shape[0]
            tile = lambda x: jnp.broadcast_to(x[None], (n,) + x.shape)
            fr = vo.Frame(uv_lanes, tile(shared["desc"]), tile(shared["id_meas"]),
                          tile(shared["id_real"]), tile(shared["valid"]))
            at = lambda i: jax.tree.map(lambda x: x[:, i], fr)
            s, _ = jax.vmap(lambda kk, a, b: vo.bootstrap(kk, a, b, cfg))(k, at(0), at(1))
            sl = lambda lo, hi: jax.tree.map(lambda x: x[:, lo:hi], fr)
            s, lg = jax.vmap(lambda st, c, nx: vo.scan_tracker(st, c, nx, cfg))(
                s, sl(0, F - 1), sl(1, F))
            return lg.pose

        t0 = time.perf_counter()
        ate = []
        for lo in range(0, args.lanes, args.chunk):
            hi = min(lo + args.chunk, args.lanes)
            poses = np.asarray(batched(keys[lo:hi], jnp.asarray(uv[lo:hi])))
            eye = np.broadcast_to(np.eye(4, dtype=np.float32), (hi - lo, 1, 4, 4))
            poses = np.concatenate([eye, poses], 1)
            ate += [float(evaluate(p, gt, cfg).ate_rmse) for p in poses]
        ate = np.array(ate)
        print(json.dumps({"config": name, "lanes": args.lanes, "frames": F,
                          "ate_median": float(np.median(ate)),
                          "ate_p90": float(np.percentile(ate, 90)), "ate_max": float(ate.max()),
                          "finite": bool(np.isfinite(ate).all()),
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
