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
kernel and nothing else.  K, the robust threshold and the GN schedule are
kernel arguments; the threshold may also be one per problem (the
threshold sweep's lanes).  Each input is read at its own lane stride, so
the batched tracker's lanes of larger tensors go in without a copy.

For CPU tensors the wrapper runs ``tpuvo_torch.ops.picp.solve``, the plain
version; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuvo_torch.config import PICPConfig
from tpuvo_torch.ops import picp
from tpuvo_torch.ops.cuda import build

launches = 0  # kernel launches in this process (reset by callers that count)

# points a problem may have: the kernel stages 5 floats per point in shared
# memory, at most 227 KB a block on Hopper less its 1 KB of static buffers
MAX_POINTS = (227 * 1024 - 1024) // (5 * 4)


def empty_result(batch: tuple, device) -> picp.PICPResult:
    """The kernel's outputs, uninitialised, with the plain solver's dtypes."""
    f32, i32 = dict(dtype=torch.float32, device=device), dict(dtype=torch.int32, device=device)
    return picp.PICPResult(
        T=torch.empty(batch + (4, 4), **f32), num_inliers=torch.empty(batch, **i32),
        chi_inliers=torch.empty(batch, **f32), chi_outliers=torch.empty(batch, **f32),
        iterations=torch.empty(batch, **i32),
        converged=torch.empty(batch, dtype=torch.bool, device=device))


def prepare(K, T_init, world_pts, image_uv, corr_idx, corr_valid,
            width: int, height: int, cfg: PICPConfig, kernel_threshold=None):
    """Checked kernel arguments for CUDA tensors and freshly allocated
    outputs: returns (launch, result), where ``launch()`` enqueues one
    kernel that writes ``result``.  ``solve_cuda`` calls it once; a timing
    loop may call it many times into the same outputs."""
    if cfg.annealed_kernel:
        raise ValueError("the fused PICP kernel has no annealing schedule; "
                         "use picp.backend='xla' for annealed_kernel=True")
    Kh = K.detach().cpu().numpy() if isinstance(K, torch.Tensor) else np.asarray(K)
    batched = T_init.dim() == 3
    add = (lambda t: t) if batched else (lambda t: None if t is None else t[None])
    T0 = add(T_init).float().contiguous()
    world, s_w = build.lanes(add(world_pts).float())
    uv, s_uv = build.lanes(add(image_uv).float())
    idx, s_idx = (None, 0) if corr_idx is None else build.lanes(add(corr_idx).to(torch.int64))
    valid, s_v = build.lanes(add(corr_valid).to(torch.bool))
    B, N = uv.shape[0], uv.shape[1]
    M = world.shape[1]
    thr = None
    if isinstance(kernel_threshold, torch.Tensor):  # one per problem
        thr = kernel_threshold.float().reshape(-1).contiguous()
    elif kernel_threshold is None:
        kernel_threshold = cfg.kernel_threshold
    if (T0.shape != (B, 4, 4) or world.shape != (B, M, 3) or valid.shape != (B, N)
            or (idx is not None and idx.shape != (B, N)) or (idx is None and M != N)
            or (thr is not None and thr.shape != (B,))):
        raise ValueError("solve_cuda: inconsistent shapes "
                         f"T {tuple(T0.shape)} world {tuple(world.shape)} "
                         f"uv {tuple(uv.shape)} valid {tuple(valid.shape)}"
                         + ("" if thr is None else f" thresholds {tuple(thr.shape)}"))
    if N > MAX_POINTS:
        raise ValueError(f"the fused PICP kernel takes at most {MAX_POINTS} points "
                         f"per problem, not {N}")
    build.check_device(T0, world, uv, idx, valid, thr)
    lib = build.library()
    out = empty_result((B,), T0.device)
    stream = torch.cuda.current_stream(T0.device).cuda_stream
    args = (world.data_ptr(), None if idx is None else idx.data_ptr(), uv.data_ptr(),
            valid.data_ptr(), T0.data_ptr(), None if thr is None else thr.data_ptr(),
            *(x.data_ptr() for x in out), B, N, M, s_w, s_idx, s_uv, s_v,
            float(Kh[0, 0]), float(Kh[1, 1]), float(Kh[0, 2]), float(Kh[1, 2]),
            float(width), float(height), float(0.0 if thr is not None else kernel_threshold),
            float(cfg.damping), float(cfg.convergence_threshold), int(cfg.max_iterations),
            int(cfg.min_num_inliers), int(cfg.keep_outliers), stream)

    # every buffer the kernel touches lives as long as launch does
    def launch(_alive=(T0, world, uv, idx, valid, thr, out)):
        global launches
        build.check(lib.tpuvo_picp_solve(*args), "tpuvo_picp_solve")
        launches += 1

    return launch, (out if batched else picp.PICPResult(*(x[0] for x in out)))


def solve_cuda(K, T_init, world_pts, image_uv, corr_idx, corr_valid,
               width: int, height: int, cfg: PICPConfig,
               kernel_threshold=None) -> picp.PICPResult:
    """Drop-in replacement for ``ops.picp.solve`` with the fused kernel.

    Unbatched: T_init (4, 4), world_pts (M, 3), image_uv (N, 2), corr_idx
    (N,) or None (world_pts already per observation), corr_valid (N,).
    Batched: the same with a leading axis B on every argument.
    kernel_threshold: None (``cfg.kernel_threshold``), a float, or a (B,)
    tensor of per-problem thresholds.
    """
    if not T_init.is_cuda:
        Kh = K.detach().cpu().numpy() if isinstance(K, torch.Tensor) else np.asarray(K)
        return picp.solve(torch.as_tensor(Kh, dtype=torch.float32), T_init, world_pts,
                          image_uv, corr_idx, corr_valid, width, height, cfg, kernel_threshold)
    launch, result = prepare(K, T_init, world_pts, image_uv, corr_idx, corr_valid,
                             width, height, cfg, kernel_threshold)
    launch()
    return result
