#!/usr/bin/env python3
"""Which small ops of the tracker's step give a lane of a batch other bits
than the same arguments alone, on the card: torch's own products and
reductions beside the port's (``ops/linalg_small``, ``lie.inv_se3``,
``camera.project_points``, ``triangulate.triangulate_two_view``).

    python3 tools/lane_ops.py        # on the card

For each op and each batch shape (lanes B, points N), the op runs once on
the whole batch and once on each lane alone; a line counts the lanes whose
result is not bit-equal (``torch.equal``) to their row of the batch's.
Inputs are random, drawn from a seeded generator.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from tpuvo_torch.ops import camera, lie, triangulate  # noqa: E402
from tpuvo_torch.ops import linalg_small as ls  # noqa: E402


def lanes_differing(f, args, lanes) -> int:
    """Lanes b whose f(args with lane b taken) differs from f(args)[b];
    ``lanes``: which args carry the lane axis (the others are shared)."""
    whole = f(*args)
    whole = whole if isinstance(whole, tuple) else (whole,)
    B = next(a for a, lane in zip(args, lanes) if lane).shape[0]
    bad = 0
    for b in range(B):
        alone = f(*[a[b] if lane else a for a, lane in zip(args, lanes)])
        alone = alone if isinstance(alone, tuple) else (alone,)
        bad += not all(torch.equal(x, y[b]) for x, y in zip(alone, whole))
    return bad


def main(dev: str = "cuda"):
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g).to(dev)
    K = torch.tensor([[718.0, 0, 607.0], [0, 718.0, 185.0], [0, 0, 1]], device=dev)
    for B, N in ((8, 32), (256, 32), (3, 128)):
        T = lie.rt_to_T(lie.so3_exp(0.3 * r(B, 3)), 5 * r(B, 3))
        T2 = T @ lie.rt_to_T(lie.so3_exp(0.01 * r(B, 3)), 0.5 * r(B, 3))
        X = r(B, N, 3) * 5 + torch.tensor([0, 0, 20.0], device=dev)
        J, v4, M3, v3 = r(B, N, 4, 3), r(B, N, 4), r(B, N, 3, 3), r(B, N, 3)
        P = K @ T[..., :3, :4]
        uv1 = camera.project_points(K, T, X, 1241, 376)[0] + 0.3 * r(B, N, 2)
        uv2 = camera.project_points(K, T2, X, 1241, 376)[0] + 0.3 * r(B, N, 2)
        ops = (
            ("torch: K @ pose", lambda T: K @ T[..., :3, :4], (T,), (1,)),
            ("torch: pose R^T t (einsum ij,j->i)",
             lambda T: torch.einsum("...ij,...j->...i", T[..., :3, :3].mT, T[..., :3, 3]),
             (T,), (1,)),
            ("torch: points @ P^T", lambda X, P: X @ P[..., :3].mT, (X, P), (1, 1)),
            ("torch: einsum nki,nk->ni", lambda J, v: torch.einsum("...nki,...nk->...ni", J, v),
             (J, v4), (1, 1)),
            ("torch: einsum nki,nkj->nij",
             lambda J: torch.einsum("...nki,...nkj->...nij", J, J), (J,), (1,)),
            ("torch: sum(-1) of 4", lambda x: torch.sum(x * x, -1), (v4,), (1,)),
            ("torch: norm(-1) of 3", lambda x: torch.linalg.norm(x, dim=-1), (v3,), (1,)),
            ("linalg_small.solve3", ls.solve3, (M3, v3), (1, 1)),
            ("linalg_small.matmul_small: K @ pose", lambda T: ls.matmul_small(K, T[..., :3, :4]),
             (T,), (1,)),
            ("linalg_small.matmul_small: points @ P^T",
             lambda X, P: ls.matmul_small(X, P[..., :3].mT), (X, P), (1, 1)),
            ("linalg_small.tmatvec_small", ls.tmatvec_small, (J, v4), (1, 1)),
            ("lie.inv_se3", lie.inv_se3, (T,), (1,)),
            ("camera.project_points", lambda T, X: camera.project_points(K, T, X, 1241, 376),
             (T, X), (1, 1)),
            ("triangulate.triangulate_two_view",
             lambda a, b, u1, u2: triangulate.triangulate_two_view(
                 K, None, None, u1, u2, refine_iterations=2, wic1=a, wic2=b),
             (T, T2, uv1, uv2), (1, 1, 1, 1)),
        )
        for name, f, args, lanes in ops:
            print(f"B={B} N={N} {name}: lanes differing {lanes_differing(f, args, lanes)} of {B}",
                  flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:])
