"""Fused top-2 descriptor matcher: wrapper of ``csrc/match.cu``.

Replaces the TPU kernel ``tpuvo/ops/pallas/match_kernel.py:_tile_kernel``
(launched by ``match_topk_pallas``, wrapped by ``match_descriptors_pallas``).
On an H100 the work is fp32 FMAs (2·N·M·D FLOP; D = 10 gives the tensor
cores nothing to do).  The TPU kernel folded map tiles into a running
accumulator over sequential grid steps; CUDA blocks run in no order, so the
kernel gives each block a tile of query rows (the query in registers),
streams the map through shared memory with |b|^2 computed once per row, and
splits the map across the blocks of a thread-block cluster, whose partial
(best, idx, second) merge through distributed shared memory
lexicographically on (dist, idx) — the first-index tie rule holds whatever
the merge order.  ``launch_plan`` picks the query tile and the cluster size
from the shape.  The acceptance test runs in the same launch, so one call
yields the whole ``MatchResult``.  Lanes — the batched tracker's B
sequences, each matched against its own map — are a third grid axis: one
launch matches every lane, each at its own lane stride (no copy of a lane
that is a view).

For CPU tensors the wrapper runs ``match_topk_reference``, the plain
version; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import functools
import math

import torch

from tpuvo_torch.ops.cuda import build
from tpuvo_torch.ops.match import MatchResult, accept_matches, top2_min

launches = 0  # kernel launches in this process (reset by callers that count)

MAX_D = 64             # descriptor widths the kernel takes (csrc/match.cu)
# (query rows per 128-thread block, queries per thread), widest first; 4
# queries a thread (one shared-memory row load feeds 4 of them) only at
# the engine's D = 10
QUERY_TILES = ((256, 4), (128, 4), (128, 1), (64, 1), (32, 1), (16, 1), (8, 1))
MAX_SPLITS = 8         # map splits = cluster size (the portable limit)
MAX_LANES = 65535      # the grid's z extent
BUSY_BLOCKS = 64       # blocks (SMs) the tracker's N = 128 should keep busy
BLOCKS_PER_SM = 4      # resident 4-warp blocks per SM worth splitting the map for
LANE_BLOCKS_PER_SM = 2  # the same with lanes, each streaming its own map (B=256:
                        # 2 splits beat 4 by 14-20% on an H100, PERF.md §6)


def tile_rows(D: int) -> int:
    """Map rows per staged tile (``Shape<DP, QPT>::kRows`` in csrc/match.cu)."""
    return 128 if D == 10 else 32


def launch_plan(N: int, M: int, D: int, sms: int, lanes: int = 1) -> tuple[int, int, int]:
    """(query rows per block, queries per thread, map splits) for ``lanes``
    (N, D) x (M, D) matches on a card with ``sms`` SMs.

    The query tile is the widest no wider than N (but the narrowest) that
    still gives BUSY_BLOCKS blocks with the widest cluster (16 rows at the
    tracker's N = 128: 64 blocks; 256 rows, 4 a thread, at the refiner's
    25,600: the map is read from L2 once per 256 queries; 128 rows, 4 a
    thread, for 256 lanes of 128).  The map splits are the fewest (a power
    of two, each at least one staged tile) that give BLOCKS_PER_SM blocks
    per SM (LANE_BLOCKS_PER_SM with lanes), at most MAX_SPLITS."""
    if not 1 <= D <= MAX_D:
        raise ValueError(f"the top-2 kernel takes descriptors of width 1..{MAX_D}, not {D}")
    if not 1 <= lanes <= MAX_LANES:
        raise ValueError(f"the top-2 kernel takes 1..{MAX_LANES} lanes, not {lanes}")
    tiles = [(qb, qpt) for qb, qpt in QUERY_TILES if qpt == 1 or D == 10]
    qb, qpt = next(((qb, qpt) for qb, qpt in tiles
                    if qb <= N and math.ceil(N / qb) * lanes * MAX_SPLITS >= BUSY_BLOCKS),
                   tiles[-1])
    if math.ceil(N / qb) > 65535:
        raise ValueError(f"{N} query rows exceed the kernel's grid (65535 x {qb})")
    q_tiles, m_tiles = math.ceil(N / qb) * lanes, max(1, math.ceil(M / tile_rows(D)))
    per_sm = BLOCKS_PER_SM if lanes == 1 else LANE_BLOCKS_PER_SM
    splits = 1
    while (splits < MAX_SPLITS and 2 * splits <= m_tiles and q_tiles * splits < per_sm * sms):
        splits *= 2
    return qb, qpt, splits


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _ordered_dot(a, b):
    """sum_k a[..., k] * b[..., k], accumulated in index order."""
    acc = a[..., 0] * b[..., 0]
    for k in range(1, a.shape[-1]):
        acc = acc + a[..., k] * b[..., k]
    return acc


def match_topk_reference(desc1, valid1, desc2, valid2):
    """Plain version: (best, idx, second) per desc1 row (..., N) over the
    valid desc2 rows of its lane, with distance |a|^2 + |b|^2 - 2 a.b
    clamped at 0 and the first-index argmin.  valid1 is unused (as in the
    kernel's top-2).

    The three sums run in descriptor-index order (as in the kernel, not
    through a matmul's blocked order): a map entry equal to the query is
    then at distance exactly 0, and exact duplicates tie exactly, so the
    ratio test decides them as the kernel does.  The synthetic fixtures,
    which have no descriptor noise, re-triangulate landmarks whose map
    match failed, so duplicate descriptors are common there."""
    del valid1
    a, b = desc1[..., :, None, :], desc2[..., None, :, :]
    dist = torch.clamp(_ordered_dot(a, a) + _ordered_dot(b, b) - 2.0 * _ordered_dot(a, b),
                       min=0.0)
    return top2_min(dist, valid2.unsqueeze(-2))


def prepare(desc1, valid1, desc2, valid2, distance_threshold, ratio_threshold):
    """Checked kernel arguments for CUDA tensors and freshly allocated
    outputs: returns (launch, result), where ``launch()`` enqueues one
    kernel that writes the ``MatchResult``.  desc1 (N, D), valid1 (N,),
    desc2 (M, D), valid2 (M,), or all four with a leading lane axis B."""
    batched = desc1.dim() == 3
    if not batched:
        desc1, valid1, desc2, valid2 = (x[None] for x in (desc1, valid1, desc2, valid2))
    B, N, D = desc1.shape
    M = desc2.shape[1]
    if desc2.shape != (B, M, D) or valid1.shape != (B, N) or valid2.shape != (B, M):
        raise ValueError(f"shape mismatch: desc1 {tuple(desc1.shape)}, desc2 "
                         f"{tuple(desc2.shape)}, valid1 {tuple(valid1.shape)}, "
                         f"valid2 {tuple(valid2.shape)}")
    (d1, s_d1), (v1, s_v1), (d2, s_d2), (v2, s_v2) = (
        build.lanes(x) for x in (desc1.float(), valid1.to(torch.bool), desc2.float(),
                                 valid2.to(torch.bool)))
    build.check_device(d1, v1, d2, v2)
    qb, qpt, splits = launch_plan(N, M, D, _sm_count(d1.device.index), B)
    lib = build.library()
    best = torch.empty((B, N), dtype=torch.float32, device=d1.device)
    idx = torch.empty((B, N), dtype=torch.int64, device=d1.device)
    second = torch.empty((B, N), dtype=torch.float32, device=d1.device)
    accept = torch.empty((B, N), dtype=torch.bool, device=d1.device)
    stream = torch.cuda.current_stream(d1.device).cuda_stream
    args = (d1.data_ptr(), v1.data_ptr(), d2.data_ptr(), v2.data_ptr(),
            best.data_ptr(), idx.data_ptr(), second.data_ptr(), accept.data_ptr(),
            B, N, M, D, s_d1, s_v1, s_d2, s_v2, qb, qpt, splits,
            float(distance_threshold), float(ratio_threshold), stream)

    # every buffer the kernel touches lives as long as launch does
    def launch(_alive=(d1, v1, d2, v2, best, idx, second, accept)):
        global launches
        build.check(lib.tpuvo_match_top2(*args), "tpuvo_match_top2")
        launches += 1

    result = MatchResult(idx=idx, valid=accept, best=best, second=second)
    return launch, (result if batched else MatchResult(*(x[0] for x in result)))


def match_descriptors_cuda(desc1, valid1, desc2, valid2,
                           distance_threshold: float = 0.2,
                           ratio_threshold: float = 0.8) -> MatchResult:
    """MatchResult of set1 -> set2 (twin of ``match_descriptors_pallas``),
    per lane when the arguments have a leading lane axis.  Rows with no
    valid map column return idx 0, masked by valid=False."""
    if not desc1.is_cuda:
        best, idx, second = match_topk_reference(desc1, valid1, desc2, valid2)
        accept = accept_matches(best, second, valid1, distance_threshold, ratio_threshold)
        return MatchResult(idx=idx, valid=accept, best=best, second=second)
    launch, result = prepare(desc1, valid1, desc2, valid2, distance_threshold, ratio_threshold)
    launch()
    return result
