"""Fused top-2 descriptor matcher: wrapper of ``csrc/match.cu``.

Replaces the TPU kernel ``tpuvo/ops/pallas/match_kernel.py:_tile_kernel``
(launched by ``match_topk_pallas``, wrapped by ``match_descriptors_pallas``).
On an H100 the main path's shape (128 queries against an 8192-slot map,
D = 10) is bound by the per-block scan latency, not by bandwidth or FLOPs.
The TPU kernel folded map tiles into a running accumulator over sequential
grid steps; CUDA blocks run in no order, so the kernel gives each query row
its own block, whose threads stride over the whole map and merge their
partial (best, idx, second) lexicographically on (dist, idx) — the
first-index tie rule holds whatever the merge order.  The acceptance test
runs in the same launch, so one call yields the whole ``MatchResult``.

For CPU tensors the wrapper runs ``match_topk_reference``, the plain
version; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from tpuvo_torch.ops.cuda import build
from tpuvo_torch.ops.match import MatchResult, accept_matches, top2_min

launches = 0  # kernel launches in this process (reset by callers that count)


def _ordered_dot(a, b):
    """sum_k a[..., k] * b[..., k], accumulated in index order."""
    acc = a[..., 0] * b[..., 0]
    for k in range(1, a.shape[-1]):
        acc = acc + a[..., k] * b[..., k]
    return acc


def match_topk_reference(desc1, valid1, desc2, valid2):
    """Plain version: (best, idx, second) per desc1 row over the valid desc2
    rows, with distance |a|^2 + |b|^2 - 2 a.b clamped at 0 and the
    first-index argmin.  valid1 is unused (as in the kernel's top-2).

    The three sums run in descriptor-index order (as in the kernel, not
    through a matmul's blocked order): a map entry equal to the query is
    then at distance exactly 0, and exact duplicates tie exactly, so the
    ratio test decides them as the kernel does.  The synthetic fixtures,
    which have no descriptor noise, re-triangulate landmarks whose map
    match failed, so duplicate descriptors are common there."""
    del valid1
    a, b = desc1[:, None, :], desc2[None, :, :]
    dist = torch.clamp(_ordered_dot(a, a) + _ordered_dot(b, b) - 2.0 * _ordered_dot(a, b),
                       min=0.0)
    return top2_min(dist, valid2)


def _launch(desc1, valid1, desc2, valid2, distance_threshold, ratio_threshold):
    global launches
    lib = build.library()
    d1 = desc1.float().contiguous()
    d2 = desc2.float().contiguous()
    v1 = valid1.to(torch.bool).contiguous()
    v2 = valid2.to(torch.bool).contiguous()
    N, D = d1.shape
    M = d2.shape[0]
    if d2.shape[1] != D or v1.shape != (N,) or v2.shape != (M,):
        raise ValueError(f"shape mismatch: desc1 {tuple(d1.shape)}, desc2 "
                         f"{tuple(d2.shape)}, valid1 {tuple(v1.shape)}, valid2 {tuple(v2.shape)}")
    build.check_device(d1, v1, d2, v2)
    best = torch.empty(N, dtype=torch.float32, device=d1.device)
    idx = torch.empty(N, dtype=torch.int64, device=d1.device)
    second = torch.empty(N, dtype=torch.float32, device=d1.device)
    accept = torch.empty(N, dtype=torch.bool, device=d1.device)
    stream = torch.cuda.current_stream(d1.device).cuda_stream
    err = lib.tpuvo_match_top2(
        d1.data_ptr(), v1.data_ptr(), d2.data_ptr(), v2.data_ptr(),
        best.data_ptr(), idx.data_ptr(), second.data_ptr(), accept.data_ptr(),
        N, M, D, float(distance_threshold), float(ratio_threshold), stream)
    build.check(err, "tpuvo_match_top2")
    launches += 1
    return MatchResult(idx=idx, valid=accept, best=best, second=second)


def match_descriptors_cuda(desc1, valid1, desc2, valid2,
                           distance_threshold: float = 0.2,
                           ratio_threshold: float = 0.8) -> MatchResult:
    """MatchResult of set1 -> set2 (twin of ``match_descriptors_pallas``).
    Rows with no valid map column return idx 0, masked by valid=False."""
    if not desc1.is_cuda:
        best, idx, second = match_topk_reference(desc1, valid1, desc2, valid2)
        accept = accept_matches(best, second, valid1, distance_threshold, ratio_threshold)
        return MatchResult(idx=idx, valid=accept, best=best, second=second)
    return _launch(desc1, valid1, desc2, valid2, distance_threshold, ratio_threshold)
