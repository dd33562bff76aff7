"""Batched brute-force descriptor matching with Lowe's ratio test (twin of
``tpuvo/ops/match.py``).

For every descriptor in set1, the best and second-best squared-L2 distance
over the valid rows of set2; accept iff ``best < distance_threshold`` and
``best/second < ratio_threshold``.  The result is a per-row index and
validity mask, never a dynamic-size list.  Every function takes optional
leading lane axes: (..., N, D) queries against (..., M, D) targets, one
target set per lane (the batched tracker matches each lane against its own
map).

Tie rule (the reference's strict ``<`` scan): the FIRST index attaining the
minimum wins — ``torch.argmin`` returns the first occurrence — and a
duplicate of the best at a later index becomes the second-best.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INF = float("inf")


class MatchResult(NamedTuple):
    """Per-row matching outcome.

    idx:    (..., N) int64 — index into set2 of the best match (garbage when invalid)
    valid:  (..., N) bool — passed both threshold and ratio tests
    best:   (..., N) float32 — best squared-L2 distance
    second: (..., N) float32 — second-best squared-L2 distance
    """

    idx: torch.Tensor
    valid: torch.Tensor
    best: torch.Tensor
    second: torch.Tensor


def descriptor_distances(desc1, desc2, method: str = "direct"):
    """(..., N, D) x (..., M, D) -> (..., N, M) squared-L2 distance matrix.

    ``direct`` expands the difference per pair; ``mxu`` uses
    |a|^2 + |b|^2 - 2ab with the cross term as one fp32 matmul;
    ``mxu_bf16`` rounds the cross term's inputs to bf16 and accumulates in
    fp32 (bf16 products are exact in fp32, so this is the JAX twin's
    ``preferred_element_type=f32`` product).
    """
    if method in ("mxu", "mxu_bf16"):
        n1 = torch.sum(desc1 * desc1, -1, keepdim=True)
        n2 = torch.sum(desc2 * desc2, -1).unsqueeze(-2)
        if method == "mxu_bf16":
            cross = desc1.bfloat16().float() @ desc2.bfloat16().float().mT
        else:
            cross = desc1 @ desc2.mT
        return n1 + n2 - 2.0 * cross
    diff = desc1[..., :, None, :] - desc2[..., None, :, :]
    return torch.sum(diff * diff, -1)


def top2_min(dist, col_valid):
    """Per-row (best, best_idx, second) of (..., N, M) distances with invalid
    columns masked to +inf.  col_valid: a mask that broadcasts against dist
    ((M,), (..., 1, M) per lane, or (..., N, M))."""
    masked = torch.where(col_valid, dist, INF)
    idx = torch.argmin(masked, dim=-1)
    best = torch.gather(masked, -1, idx[..., None])[..., 0]
    cols = torch.arange(masked.shape[-1], device=dist.device)
    second = torch.min(torch.where(cols == idx[..., None], INF, masked), dim=-1).values
    return best, idx, second


def accept_matches(best, second, valid1, distance_threshold, ratio_threshold):
    """Threshold + Lowe ratio acceptance of a top-2."""
    # inf second -> ratio 0 (passes), mirroring FLT_MAX division
    return (best < distance_threshold) & (best / second < ratio_threshold) & valid1


def match_descriptors(
    desc1,
    valid1,
    desc2,
    valid2,
    distance_threshold: float = 0.2,
    ratio_threshold: float = 0.8,
    method: str = "direct",
) -> MatchResult:
    """Match set1 -> set2 under threshold + Lowe ratio acceptance.

    desc1: (..., N, D), valid1: (..., N); desc2: (..., M, D), valid2: (..., M).
    method="pallas" routes to the fused top-2 kernel
    (``ops/cuda/match_kernel.py``): the CUDA kernel for CUDA tensors, its
    plain version for CPU tensors.
    """
    if method == "pallas":
        from tpuvo_torch.ops.cuda.match_kernel import match_descriptors_cuda

        return match_descriptors_cuda(
            desc1, valid1, desc2, valid2, distance_threshold, ratio_threshold)
    dist = descriptor_distances(desc1, desc2, method)
    best, idx, second = top2_min(dist, valid2.unsqueeze(-2))
    accept = accept_matches(best, second, valid1, distance_threshold, ratio_threshold)
    return MatchResult(idx=idx, valid=accept, best=best, second=second)


def match_descriptors_pair(
    q1, v_q1, t1, v_t1,
    q2, v_q2, t2, v_t2,
    distance_threshold: float = 0.2,
    ratio_threshold: float = 0.8,
) -> tuple:
    """Two independent matches, (q1 -> t1) and (q2 -> t2), as ONE distance
    matmul + top-2 chain: queries and targets are stacked and a block mask
    lets each query half see only its own target segment.
    Decision-identical to two ``match_descriptors(method="mxu")`` calls."""
    N1, T1 = q1.shape[-2], t1.shape[-2]
    q = torch.cat([q1, q2], -2)
    t = torch.cat([t1, t2], -2)
    tv = torch.cat([v_t1, v_t2], -1)
    dist = descriptor_distances(q, t, "mxu")
    rows_first = torch.arange(q.shape[-2], device=q.device) < N1
    cols_first = torch.arange(t.shape[-2], device=q.device) < T1
    best, idx, second = top2_min(dist, (rows_first[:, None] == cols_first[None, :])
                                 & tv.unsqueeze(-2))
    accept = accept_matches(best, second, torch.cat([v_q1, v_q2], -1),
                            distance_threshold, ratio_threshold)
    r1 = MatchResult(idx[..., :N1], accept[..., :N1], best[..., :N1], second[..., :N1])
    # a second-half row with no valid target argmins to column 0; clamp its
    # (masked) index into range instead of letting it go negative
    r2 = MatchResult(torch.clamp(idx[..., N1:] - T1, min=0), accept[..., N1:],
                     best[..., N1:], second[..., N1:])
    return r1, r2


class MatchStats(NamedTuple):
    possible: torch.Tensor  # pairs with equal id_real (the GT oracle count)
    found: torch.Tensor     # accepted matches
    correct: torch.Tensor   # accepted matches whose id_real agree


def match_stats(result: MatchResult, id1, valid1, id2, valid2) -> MatchStats:
    """GT-oracle statistics of one match call, per lane when the arguments
    have leading lane axes (id1 (..., N), id2 (..., M))."""
    pair_same = ((id1[..., :, None] == id2[..., None, :]) & valid1[..., :, None]
                 & valid2[..., None, :])
    possible = torch.sum(pair_same, (-2, -1))
    found = torch.sum(result.valid, -1)
    correct = torch.sum(result.valid & (id1 == torch.gather(id2, -1, result.idx)), -1)
    return MatchStats(possible, found, correct)
