#!/usr/bin/env python3
"""How two of ``chip_smoke.py``'s statistics move with the last bits of the
bootstrap: the tracker's ATE on the bench's synthetic fallback (phase 13's
bound) and the threshold sweep's lanes against single runs (phase 10), each
from a bootstrap whose eigensolvers are swapped for another equally valid
one.

    python3 tools/bootstrap_rounding.py      # on the card

Variants of (the refit's 9x9 eigenvector, the 3x3 SVDs): torch.linalg in
float32 (cuSOLVER), kernel C, LAPACK in float32 on the host, the float64
eigenvector of the same float32 matrix, inverse iteration, and mixes.  Each
line gives the bootstrap pose's largest difference from the cuSOLVER one,
the fallback's ate_rmse (one ``scan_tracker`` run of the bench's gate
configuration) and the sweep lanes' |dpose| statistics (the lane parity of
phase 10 from that bootstrap).  The eager steps run (no graphs), so each
variant runs as swapped.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from tpuvo_torch import bench  # noqa: E402
from tpuvo_torch.engine import vo  # noqa: E402
from tpuvo_torch.engine.eval import evaluate, metrics_dict  # noqa: E402
from tpuvo_torch.ops.cuda import smalleig  # noqa: E402
from tpuvo_torch.ops.linalg_small import smallest_eigvec_inverse_iteration  # noqa: E402


def main():
    c.check = lambda ok, m: None
    c.phase_card()
    kernel = (smalleig.sym_eig, smalleig.svd3)
    cusolver = (smalleig.sym_eig_reference, smalleig.svd3_reference)

    def on_host(fn):
        def run(A):
            return tuple(x.to(A.device) for x in fn(A.cpu()))
        return run

    def eig64(A):
        w, V = torch.linalg.eigh(A.double())
        return w.float(), (V * smalleig.canonical_signs(V)).float()

    def inverse_iteration(A):
        w, V = kernel[0](A)
        v = smallest_eigvec_inverse_iteration(A)
        V = V.clone()
        V[..., :, 0] = v * smalleig.canonical_signs(v[..., :, None])[..., 0, :]
        return w, V

    variants = {"cuSOLVER f32": cusolver,
                "kernel C": kernel,
                "LAPACK f32 on the host, kernel C svd3": (on_host(smalleig.sym_eig_reference),
                                                          kernel[1]),
                "LAPACK f32 on the host, cuSOLVER svd": (on_host(smalleig.sym_eig_reference),
                                                         cusolver[1]),
                "kernel C eig, cuSOLVER svd": (kernel[0], cusolver[1]),
                "cuSOLVER eig, kernel C svd3": (cusolver[0], kernel[1]),
                "float64 eig on the host, kernel C svd3": (on_host(eig64), kernel[1]),
                "inverse iteration, kernel C svd3": (inverse_iteration, kernel[1])}
    cfg_gate = bench.configs("cuda")[0]
    seqb = bench.bench_sequence(cfg_gate, os.path.join(c.REPO, "data"))
    f0, f1, curr, nxt = bench.split(vo.frames_of(seqb, 0, seqb.uv.shape[0], "cuda"))
    seq_a, _ = c.batch_fixture()
    cfg = c.batch_cfgs()["a"]
    fr1 = vo.frames_of(seq_a, 0, seq_a.uv.shape[0], "cuda")
    shared = vo.Frame(*(x.expand((3,) + x.shape) for x in fr1))
    eye = torch.eye(4, device="cuda")[None]
    ref = None
    try:
        for name, (eig, svd) in variants.items():
            smalleig.sym_eig, smalleig.svd3 = eig, svd
            with c.eager_steps():
                st, d = vo.bootstrap(vo.make_generator(42), f0, f1, cfg_gate)
                _, logs = vo.scan_tracker(st, curr, nxt, cfg_gate)
                ate = metrics_dict(evaluate(torch.cat([eye, logs.pose]), seqb.gt_pose,
                                            cfg_gate))["ate_rmse"]
                boot, _ = vo.bootstrap(vo.make_generator(42), vo.frame_at(fr1, 0),
                                       vo.frame_at(fr1, 1), cfg)
                boot = type(boot)(*(x.expand((3,) + x.shape).contiguous() for x in boot))
                r = c.lane_parity(shared, cfg, [1000.0, 3000.0, 10000.0], state=boot)
            ref = d["T_boot"] if ref is None else ref
            dp = r["dpose"]
            print(f"{name}: T_boot vs cuSOLVER's {float((d['T_boot'] - ref).abs().max()):.2e}; "
                  f"fallback ate_rmse {ate:.4f} ({ate / c.JAX_BENCH_ATE:.2f}x JAX's); sweep lanes "
                  f"|dpose| max {max(dp):.3e}, > 1e-4 on {sum(x > 1e-4 for x in dp)}, > 1e-3 on "
                  f"{sum(x > 1e-3 for x in dp)}, > 1e-2 on {sum(x > 1e-2 for x in dp)} of "
                  f"{len(dp)}; new-landmark count differs on {sum(x > 0 for x in r['dnew'])}",
                  flush=True)
    finally:
        smalleig.sym_eig, smalleig.svd3 = kernel


if __name__ == "__main__":
    main()
