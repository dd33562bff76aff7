"""Landmark-sharded distributed bundle adjustment (twin of
``tpuvo/parallel/ba_sharded.py``).

MegBA-style distributed Schur: landmarks (and the observations that
reference them) are partitioned over the ranks of a mesh axis; each rank
linearizes only its own observations, Schur-eliminates its landmark blocks
locally (block-diagonal, so no communication), and contributes a partial
reduced camera system.  The ONLY cross-rank traffic per iteration is one
``all_reduce`` of the (6W)^2 + 6W reduced system and three statistics,
independent of the landmark count.  Every rank then solves the same small
dense system and back-substitutes its own landmarks.

``shard_ba_problem`` is the host-side partitioner (numpy; its output is
bit-equal to the JAX package's).  The per-iteration math is the
single-card path's own ``ba_step`` (``tpuvo_torch/ba/window.py``), given
the all_reduce as its ``reduce`` hook.

Layout: a ``ShardedBAProblem`` carries a leading shard axis on its sharded
fields.  With all S shards (what ``shard_ba_problem`` returns) each rank
takes its own row, as ``shard_map``'s ``P(axis)`` does; with one row, that
row is the rank's own shard (``sharded_problem_from_numpy(..., shard=rank)``
keeps only it).  The step and the solve
return the rank's own shard (one row) with the replicated poses;
``gather_points`` collects the shards.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpuvo_torch.ba.window import BAProblem, BAStats, ba_step
from tpuvo_torch.config import BAConfig
from tpuvo_torch.engine.state import check_device, to_host
from tpuvo_torch.parallel.mesh import all_gather_stack, all_reduce_sum_, axis_info


class ShardedBAProblem(NamedTuple):
    """BAProblem re-laid-out with a leading shard axis.

    poses:       (W, 4, 4) — replicated
    points:      (S, Ls, 3) — landmark shard per rank (local index space)
    point_valid: (S, Ls)
    obs_uv:      (S, W, Np, 2) — observations owned by each shard
    obs_lm:      (S, W, Np) int32 — LOCAL landmark indices
    obs_valid:   (S, W, Np)
    fixed:       (W,) — replicated
    lm_perm:     (S, Ls) numpy: new local -> original local slot of every
                 shard (host bookkeeping for scattering results back)
    active:      per-shard observed-landmark prefix length
    """

    poses: torch.Tensor
    points: torch.Tensor
    point_valid: torch.Tensor
    obs_uv: torch.Tensor
    obs_lm: torch.Tensor
    obs_valid: torch.Tensor
    fixed: torch.Tensor
    lm_perm: np.ndarray
    active: int = 0


_SHARDED_DTYPES = {
    "poses": torch.float32, "points": torch.float32, "point_valid": torch.bool,
    "obs_uv": torch.float32, "obs_lm": torch.int32, "obs_valid": torch.bool,
    "fixed": torch.bool,
}
_SHARDED = ("points", "point_valid", "obs_uv", "obs_lm", "obs_valid")


def shard_ba_problem(problem: BAProblem, n_shards: int,
                     obs_pad_to: int | None = None) -> ShardedBAProblem:
    """Host-side partitioner: contiguous landmark blocks -> shards, and each
    observation moves to its landmark's owner (re-padded per (shard, frame)).
    Reads the problem to the host once (as JAX's ``np.asarray`` does) and
    returns all S shards on the problem's device (the card for arrays that
    are not tensors)."""
    dev = problem.poses.device if isinstance(problem.poses, torch.Tensor) else "cuda"
    poses, points, pvalid, obs_uv, obs_lm, obs_valid, fixed = (
        to_host(getattr(problem, k)) for k in
        ("poses", "points", "point_valid", "obs_uv", "obs_lm", "obs_valid", "fixed"))
    W, N = obs_lm.shape
    L = points.shape[0]
    Ls = -(-L // n_shards)
    L_pad = Ls * n_shards

    pts_pad = np.zeros((L_pad, 3), points.dtype)
    pts_pad[:L] = points
    pv_pad = np.zeros(L_pad, bool)
    pv_pad[:L] = pvalid

    owner = obs_lm // Ls          # (W, N) shard of each observation
    local = obs_lm - owner * Ls   # local landmark slot

    # per-(shard, frame) packing
    if obs_pad_to is None:
        obs_pad_to = 0
        for s in range(n_shards):
            for f in range(W):
                obs_pad_to = max(obs_pad_to, int(((owner[f] == s) & obs_valid[f]).sum()))
        obs_pad_to = max(8, obs_pad_to)
    s_uv = np.zeros((n_shards, W, obs_pad_to, 2), obs_uv.dtype)
    s_lm = np.zeros((n_shards, W, obs_pad_to), np.int32)
    s_valid = np.zeros((n_shards, W, obs_pad_to), bool)
    for s in range(n_shards):
        for f in range(W):
            rows = np.nonzero((owner[f] == s) & obs_valid[f])[0][:obs_pad_to]
            n = len(rows)
            s_uv[s, f, :n] = obs_uv[f, rows]
            s_lm[s, f, :n] = local[f, rows]
            s_valid[s, f, :n] = True

    # Active-first renumbering: each shard's OBSERVED landmarks move to the
    # front of its local index space, so the per-iteration Schur assembly
    # (Hll/Wfl/back-substitution) only touches an O(#local obs) prefix
    # instead of all Ls slots.
    pts_sh = pts_pad.reshape(n_shards, Ls, 3).copy()
    pv_sh = pv_pad.reshape(n_shards, Ls).copy()
    lm_perm = np.zeros((n_shards, Ls), np.int64)  # new local -> original local
    max_active = 8
    for s in range(n_shards):
        seen = np.unique(s_lm[s][s_valid[s]])
        rest = np.setdiff1d(np.arange(Ls), seen, assume_unique=False)
        perm = np.concatenate([seen, rest])
        lm_perm[s] = perm
        inv = np.empty(Ls, np.int64)
        inv[perm] = np.arange(Ls)
        s_lm[s] = inv[s_lm[s]].astype(np.int32)
        pts_sh[s] = pts_sh[s][perm]
        pv_sh[s] = pv_sh[s][perm]
        max_active = max(max_active, len(seen))
    active = min(Ls, -(-max_active // 8) * 8)

    return sharded_problem_from_numpy(dict(
        poses=poses, points=pts_sh, point_valid=pv_sh, obs_uv=s_uv, obs_lm=s_lm,
        obs_valid=s_valid, fixed=fixed, lm_perm=lm_perm, active=active), dev)


def sharded_problem_from_numpy(fields, device="cuda", shard: int | None = None
                               ) -> ShardedBAProblem:
    """ShardedBAProblem on ``device`` (the card by default) from arrays
    keyed by field name (a mapping, or an object with those attributes —
    e.g. the JAX package's ShardedBAProblem, or a ShardedBAProblem on any
    device).  ``shard``: keep only that shard's row of the sharded fields
    (a rank's own part)."""
    check_device(device)
    get = fields.get if isinstance(fields, dict) else lambda k: getattr(fields, k)
    arrays = {k: to_host(get(k)) for k in _SHARDED_DTYPES}
    if shard is not None:
        arrays.update({k: arrays[k][shard:shard + 1] for k in _SHARDED})
    return ShardedBAProblem(
        **{k: torch.as_tensor(arrays[k], dtype=dt).to(device)
           for k, dt in _SHARDED_DTYPES.items()},
        lm_perm=np.asarray(get("lm_perm")), active=int(get("active")))


def _own(x, rank: int, n_shard: int):
    """This rank's row of a sharded field (all S rows, or its own one)."""
    if x.shape[0] == n_shard:
        return x[rank]
    if x.shape[0] != 1:
        raise ValueError(f"a sharded field with {x.shape[0]} rows on a {n_shard}-rank axis")
    return x[0]


def _local_step(poses, points, point_valid, obs_uv, obs_lm, obs_valid, fixed,
                K, width, height, cfg: BAConfig, group, active: int = 0):
    """One rank's BA iteration: ``ba/window.ba_step`` on the rank's shard,
    with its one collective (the fused [S | b | stats] all_reduce).

    ``active``: observed landmarks occupy the first ``active`` local slots
    (see shard_ba_problem's renumbering); the step runs on that prefix only.

    Returns (new_poses, new_points, stats) with the stats already reduced.
    """
    La = active if active else points.shape[0]
    local = BAProblem(poses=poses, points=points[:La], obs_uv=obs_uv, obs_lm=obs_lm,
                      obs_valid=obs_valid, point_valid=point_valid[:La], fixed=fixed)
    new, stats = ba_step(local, K, width, height, cfg,
                         reduce=lambda buf: all_reduce_sum_(buf, group))
    return new.poses, torch.cat([new.points, points[La:]], 0), stats


def _solve(mesh, sp: ShardedBAProblem, K, width, height, cfg: BAConfig, axis: str,
           iterations: int):
    group, n_shard, rank = axis_info(mesh, axis)
    own = {k: _own(getattr(sp, k), rank, n_shard) for k in _SHARDED}
    K = torch.as_tensor(K, dtype=torch.float32, device=sp.poses.device)
    poses, points = sp.poses, own["points"]
    dev = sp.poses.device
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    stats = BAStats(torch.zeros((), dtype=torch.float32, device=dev), zero_i, zero_i)
    for _ in range(iterations):
        poses, points, stats = _local_step(
            poses, points, own["point_valid"], own["obs_uv"], own["obs_lm"],
            own["obs_valid"], sp.fixed, K, width, height, cfg, group, sp.active)
    out = sp._replace(poses=poses, points=points[None],
                      **{k: own[k][None] for k in _SHARDED if k != "points"})
    return out, stats


def sharded_ba_step(mesh, sp: ShardedBAProblem, K, width, height, cfg: BAConfig,
                    axis: str = "lm"):
    """One distributed BA iteration over the mesh axis.  Returns (the rank's
    shard with the new poses and points, reduced BAStats)."""
    return _solve(mesh, sp, K, width, height, cfg, axis, 1)


def sharded_ba_solve(mesh, sp: ShardedBAProblem, K, width, height, cfg: BAConfig,
                     axis: str = "lm"):
    """cfg.iterations distributed BA steps at fixed damping (the JAX twin's
    ``fori_loop``: identical work per iteration; ``lm_adaptive`` is not
    read).  A Python loop on tensors with no host sync."""
    return _solve(mesh, sp, K, width, height, cfg, axis, cfg.iterations)


def gather_points(sp: ShardedBAProblem, L: int, mesh=None, axis: str = "lm"):
    """Collect the sharded landmark estimates back to an (L, 3) numpy array,
    undoing the active-first renumbering.  A rank holding only its own shard
    gathers the others' over ``mesh`` first (a collective: every rank of
    the axis calls it)."""
    pts = sp.points
    if pts.shape[0] != sp.lm_perm.shape[0]:
        group, n_shard, rank = axis_info(mesh, axis)
        pts = all_gather_stack(_own(pts, rank, n_shard), group, n_shard)
    pts_sh = pts.detach().cpu().numpy()  # (S, Ls, 3)
    S, Ls, _ = pts_sh.shape
    out = np.zeros((S * Ls, 3), pts_sh.dtype)
    for s in range(S):
        out[s * Ls + np.asarray(sp.lm_perm[s])] = pts_sh[s]
    return out[:L]
