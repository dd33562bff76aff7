#!/usr/bin/env python3
"""Kernel F against the dense product, on the card: the BA's reduced camera
system (``ba/window``) built from the pair blocks and from the dense (La, W)
coupling grid, at the local BA's and the global sweep's shapes and between
them (random landmark ids, 70% of the observations valid).

    python3 tools/kernel_f_times.py

For each (W frames, N observations a frame, La landmarks): the device time
of each path's reduction as an LM iteration runs it (its coupling blocks'
sum, S and b, the landmark steps), as the sum of its kernels' times (the
profiler) and from CUDA events around 10 reps queued behind a spin kernel; kernel F's own two kernels by the profiler, beside
their roofline bound (the nonzero blocks read once and S written once, or
their block products at the fp32 peak), a wrapper call and the plain
version's (events); and each path's peak device memory above its inputs.  One JSON line a shape on stdout.
"""

from __future__ import annotations

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from tpuvo_torch.ba import assembly, window  # noqa: E402
from tpuvo_torch.ops.cuda import schur  # noqa: E402

SHAPES = [(16, 432, 512), (16, 432, 1728), (16, 432, 3456), (16, 432, 6912),
          (200, 400, 1600), (200, 400, 3200), (200, 400, 8192)]


def inputs(W, N, La, seed=0):
    """Per-observation blocks and the per-landmark parts of one LM
    iteration, and both plans, on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lm = torch.randint(0, La, (W * N,), generator=g, device="cuda")
    valid = torch.rand(W * N, generator=g, device="cuda") < 0.7
    Wb = torch.randn(W * N, 6, 3, generator=g, device="cuda") * valid[:, None, None]
    f = torch.arange(W, device="cuda").repeat_interleave(N)
    by_lm = assembly.plan(lm, La)
    dense = assembly.plan(lm * W + f, La * W, order=by_lm.order)
    pairs = window.pair_plan(lm, valid, W, La)
    A = torch.randn(La, 3, 3, generator=g, device="cuda")
    B = torch.randn(W, 6, 6, generator=g, device="cuda")
    parts = dict(Hpp=B @ B.mT + 50 * torch.eye(6, device="cuda"),
                 bp=torch.randn(W, 6, generator=g, device="cuda"), Hll=A @ A.mT + 1.0,
                 bl=torch.randn(La, 3, generator=g, device="cuda"),
                 dx=0.01 * torch.randn(W, 6, generator=g, device="cuda"))
    return Wb, dense, pairs, parts


def dense_path(Wb, plan, p, W, La):
    Wfl = assembly.segment_sum(Wb, plan).reshape(La, W, 6, 3)
    S, b, Hinv = window.schur_parts(p["Hpp"], p["bp"], p["Hll"], p["bl"], Wfl, 1e-3)
    return S, b, window.backsubstitute(Hinv, p["bl"], Wfl, p["dx"])


def sparse_path(Wb, pairs, p):
    Wp = assembly.segment_sum(Wb, pairs.sums)
    S, b, Hinv = window.schur_parts_sparse(p["Hpp"], p["bp"], p["Hll"], p["bl"], Wp, pairs,
                                           1e-3)
    return S, b, schur.backsubstitute(Wp, Hinv, p["bl"], p["dx"], pairs.frame, pairs.lm_bounds)


def device_ms(fn, reps: int = 10):
    """Device time of fn() a call: every kernel's, copy's and fill's own time
    while it runs reps times, by the profiler (no idle gaps)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sum(e.self_device_time_total for e in ev) / reps / 1e3


def peak_bytes(fn):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def work(pairs, W, La):
    """(block products' flops, bytes) of kernel F's two launches: the pair
    blocks and their indices read once, Hinv and bl read once, S, b and
    the landmark steps written once."""
    n = int(pairs.lm_bounds[-1])
    k = pairs.lm_bounds.diff().double()
    flops = float((k * k).sum()) * 2 * 108 + n * 2 * (54 + 18 + 18 + 18) + La * 2 * 9
    nbytes = n * (72 + 8 * 3) + La * (36 + 12 + 8 + 12) + (36 * W * W + 6 * W + 36 * W) * 4
    return flops, nbytes


def main():
    chip_smoke.phase_card()  # the card's name and power limit; the build's registers
    schur_launches = schur.launches
    for W, N, La in SHAPES:
        Wb, dense, pairs, p = inputs(W, N, La)
        S1, b1, x1 = dense_path(Wb, dense, p, W, La)
        S2, b2, x2 = sparse_path(Wb, pairs, p)
        scale = float(S1.abs().max())
        dense_ms, fed_d = chip_smoke.queued_launch_ms(lambda: dense_path(Wb, dense, p, W, La), 10)
        sparse_ms, fed_s = chip_smoke.queued_launch_ms(lambda: sparse_path(Wb, pairs, p), 10)
        dense_dev = device_ms(lambda: dense_path(Wb, dense, p, W, La))
        sparse_dev = device_ms(lambda: sparse_path(Wb, pairs, p))
        Wp = assembly.segment_sum(Wb, pairs.sums)
        Hinv = window.invert_hll(p["Hll"], 1e-3)
        args = (Wp, Hinv, p["bl"], p["Hpp"], p["bp"], pairs.lm, pairs.frame, pairs.lm_bounds,
                pairs.by_frame.order, pairs.by_frame.bounds)
        f_reduce = chip_smoke.profiled_kernel_ms(lambda: schur.reduced_system(*args),
                                                 "schur_reduce_kernel")
        f_back = chip_smoke.profiled_kernel_ms(
            lambda: schur.backsubstitute(Wp, Hinv, p["bl"], p["dx"], pairs.frame,
                                         pairs.lm_bounds), "schur_backsub_kernel")
        call_ms = chip_smoke.cuda_ms(lambda: schur.reduced_system(*args))
        plain_ms = chip_smoke.cuda_ms(lambda: schur.reduced_system_reference(*args), 5)
        flops, nbytes = work(pairs, W, La)
        bound_ms, bound_by = chip_smoke.roofline(flops, nbytes)
        print(json.dumps(dict(
            W=W, N=N, La=La, density=round(N / La, 4), rule_sparse=window.sparse_schur(N, La),
            pairs=int(pairs.lm_bounds[-1]), dense_device_ms=dense_dev, sparse_device_ms=sparse_dev,
            dense_ms=dense_ms, sparse_ms=sparse_ms,
            host_fed=bool(fed_d and fed_s), kernel_f_reduce_us=None if f_reduce is None
            else f_reduce * 1e3, kernel_f_backsub_us=None if f_back is None else f_back * 1e3,
            bound_us=bound_ms * 1e3, bound_by=bound_by, wrapper_us=call_ms * 1e3,
            plain_ms=plain_ms,
            dense_peak_mb=peak_bytes(lambda: dense_path(Wb, dense, p, W, La)) / 1e6,
            sparse_peak_mb=peak_bytes(lambda: sparse_path(Wb, pairs, p)) / 1e6,
            S_gap=float((S1 - S2).abs().max()) / scale, b_gap=float((b1 - b2).abs().max()),
            x_gap=float((x1 - x2).abs().max()))), flush=True)
    print(f"kernel F launches: {schur.launches - schur_launches}", file=sys.stderr)


if __name__ == "__main__":
    main()
