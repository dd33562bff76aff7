"""Fused PICP solver: wrapper of ``csrc/picp.cu``.

Replaces the TPU kernel ``tpuvo/ops/pallas/picp_kernel.py:_make_kernel``
(launched by ``_solve_pallas_impl``, public entry ``solve_pallas``): the
whole Gauss-Newton loop for one pose in one kernel.  On an H100 the solve is
bound by latency — a chain of dependent rounds over ~128 points, each round
a reduction, a barrier and a serial 6x6 Cholesky — not by bytes or FLOPs.
The kernel gives each problem a 128-thread block, gathers and stages its
valid points in shared memory once, and solves every round from there; the
grid runs over the batch, so one launch solves B problems.  The
correspondence gather (``world_pts[corr_idx]``) happens inside the kernel,
and the kernel writes the typed ``PICPResult`` itself: a call launches one
kernel and nothing else.  K, the robust threshold and the GN schedule
(the annealed one too) are kernel arguments; the threshold may also be one
per problem (the threshold sweep's lanes), and K a CUDA tensor the kernel
reads itself.  Each input is read at its own lane stride, so the batched
tracker's lanes of larger tensors go in without a copy.

``solve_cuda`` is the one entry for a PICP solve: every solve on the card
(the tracker's, under either ``picp.backend``, the unrolled driver's, and
the PnP polish) launches the kernel, so none checks the host between GN
rounds.  For CPU tensors it runs ``tpuvo_torch.ops.picp.solve`` (or
``solve_unrolled``), the plain version; for CUDA tensors it launches the
kernel or raises.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from tpuvo_torch.config import PICPConfig
from tpuvo_torch.ops import picp
from tpuvo_torch.ops.cuda import build

launches = 0  # kernel launches in this process (reset by callers that count)

# points a problem may have: the kernel stages 5 floats per point in shared
# memory (a 6th under the annealed schedule), at most 227 KB a block on
# Hopper less 2 KB for its static buffers
MAX_POINTS = (227 * 1024 - 2048) // (6 * 4)


def empty_result(batch: tuple, device) -> picp.PICPResult:
    """The kernel's outputs, uninitialised, with the plain solver's dtypes."""
    f32, i32 = dict(dtype=torch.float32, device=device), dict(dtype=torch.int32, device=device)
    return picp.PICPResult(
        T=torch.empty(batch + (4, 4), **f32), num_inliers=torch.empty(batch, **i32),
        chi_inliers=torch.empty(batch, **f32), chi_outliers=torch.empty(batch, **f32),
        iterations=torch.empty(batch, **i32),
        converged=torch.empty(batch, dtype=torch.bool, device=device))


def on_card(t) -> bool:
    """Whether a solve whose pose lies on ``t``'s device launches the kernel."""
    return t.is_cuda


def pack_args(T_init, world_pts, image_uv, corr_idx, corr_valid, kernel_threshold=None):
    """The solve's arguments with T_init's leading batch axes (none, one or
    several) as one axis B: (lead, T, world, uv, idx, valid, thr).  Views
    where the strides allow, so lanes of larger tensors keep their stride;
    a threshold tensor is broadcast to the batch, (B,)."""
    lead = tuple(T_init.shape[:-2])
    n = math.prod(lead)
    flat = lambda t: None if t is None else t.reshape((n,) + tuple(t.shape[len(lead):]))
    thr = kernel_threshold
    if isinstance(thr, torch.Tensor):
        thr = torch.broadcast_to(thr, lead).reshape(n)
    return (lead, flat(T_init), flat(world_pts), flat(image_uv), flat(corr_idx),
            flat(corr_valid), thr)


def unpack_result(res, lead) -> picp.PICPResult:
    """A (B,)-batched PICPResult with the caller's leading axes again."""
    return picp.PICPResult(*(x.reshape(lead + tuple(x.shape[1:])) for x in res))


def _intrinsics(K):
    """(K on the card or None, fx, fy, cx, cy): a CUDA tensor goes to the
    kernel as a pointer, so it costs no host read; anything else as floats."""
    if isinstance(K, torch.Tensor) and K.is_cuda:
        return K.float().contiguous(), 0.0, 0.0, 0.0, 0.0
    Kh = K.detach().numpy() if isinstance(K, torch.Tensor) else np.asarray(K)
    return None, float(Kh[0, 0]), float(Kh[1, 1]), float(Kh[0, 2]), float(Kh[1, 2])


def prepare(K, T_init, world_pts, image_uv, corr_idx, corr_valid,
            width: int, height: int, cfg: PICPConfig, kernel_threshold=None):
    """Checked kernel arguments for CUDA tensors and freshly allocated
    outputs: returns (launch, result), where ``launch()`` enqueues one
    kernel that writes ``result``.  ``solve_cuda`` calls it once; a timing
    loop may call it many times into the same outputs."""
    lead, T0, world, uv, idx, valid, thr = pack_args(
        T_init, world_pts, image_uv, corr_idx, corr_valid, kernel_threshold)
    T0 = T0.float().contiguous()
    world, s_w = build.lanes(world.float())
    uv, s_uv = build.lanes(uv.float())
    idx, s_idx = (None, 0) if idx is None else build.lanes(idx.to(torch.int64))
    valid, s_v = build.lanes(valid.to(torch.bool))
    B, N = uv.shape[0], uv.shape[1]
    M = world.shape[1]
    if isinstance(thr, torch.Tensor):  # one per problem
        thr = thr.float().contiguous()
    else:
        kernel_threshold = cfg.kernel_threshold if thr is None else thr
        thr = None
    if (T0.shape != (B, 4, 4) or world.shape != (B, M, 3) or valid.shape != (B, N)
            or (idx is not None and idx.shape != (B, N)) or (idx is None and M != N)):
        raise ValueError("solve_cuda: inconsistent shapes "
                         f"T {tuple(T0.shape)} world {tuple(world.shape)} "
                         f"uv {tuple(uv.shape)} valid {tuple(valid.shape)}")
    if N > MAX_POINTS:
        raise ValueError(f"the fused PICP kernel takes at most {MAX_POINTS} points "
                         f"per problem, not {N}")
    Kd, fx, fy, cx, cy = _intrinsics(K)
    build.check_device(T0, world, uv, idx, valid, thr, Kd)
    lib = build.library()
    out = empty_result((B,), T0.device)
    stream = torch.cuda.current_stream(T0.device).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()
    args = (world.data_ptr(), ptr(idx), uv.data_ptr(), valid.data_ptr(), T0.data_ptr(),
            ptr(thr), ptr(Kd), *(x.data_ptr() for x in out), B, N, M, s_w, s_idx, s_uv, s_v,
            fx, fy, cx, cy, float(width), float(height),
            float(0.0 if thr is not None else kernel_threshold), float(cfg.damping),
            float(cfg.convergence_threshold), int(cfg.max_iterations),
            int(cfg.min_num_inliers), int(cfg.keep_outliers), int(cfg.annealed_kernel),
            float(cfg.anneal_mult), stream)

    # every buffer the kernel touches lives as long as launch does
    def launch(_alive=(T0, world, uv, idx, valid, thr, Kd, out)):
        global launches
        build.check(lib.tpuvo_picp_solve(*args), "tpuvo_picp_solve")
        launches += 1

    return launch, unpack_result(out, lead)


def solve_cuda(K, T_init, world_pts, image_uv, corr_idx, corr_valid,
               width: int, height: int, cfg: PICPConfig,
               kernel_threshold=None, rounds: int | None = None) -> picp.PICPResult:
    """``ops.picp.solve`` (``solve_unrolled`` when ``rounds`` is given) with
    the fused kernel on the card.

    T_init (..., 4, 4) with any leading batch axes, and the same axes on
    world_pts (..., M, 3), image_uv (..., N, 2), corr_idx (..., N) or None
    (world_pts already per observation, M = N) and corr_valid (..., N).
    kernel_threshold: None (``cfg.kernel_threshold``), a float, or a tensor
    of per-problem thresholds.  K: a (3, 3) array or tensor.  rounds: the
    unrolled driver's cap, which is ``solve`` with ``max_iterations=rounds``
    and no annealing (as JAX's ``solve_unrolled``), finished problems frozen.
    """
    if not on_card(T_init):
        Kt = torch.as_tensor(K, dtype=torch.float32, device=T_init.device)
        if rounds is not None:
            return picp.solve_unrolled(Kt, T_init, world_pts, image_uv, corr_idx, corr_valid,
                                       width, height, cfg, kernel_threshold, rounds=rounds)
        return picp.solve(Kt, T_init, world_pts, image_uv, corr_idx, corr_valid, width,
                          height, cfg, kernel_threshold)
    if rounds is not None:
        cfg = dataclasses.replace(cfg, max_iterations=rounds, annealed_kernel=False)
    launch, result = prepare(K, T_init, world_pts, image_uv, corr_idx, corr_valid,
                             width, height, cfg, kernel_threshold)
    launch()
    return result
