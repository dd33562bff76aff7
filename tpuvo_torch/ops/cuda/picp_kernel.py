"""Fused PICP solver: wrapper of ``csrc/picp.cu``.

Replaces the TPU kernel ``tpuvo/ops/pallas/picp_kernel.py:_make_kernel``
(launched by ``_solve_pallas_impl``, public entry ``solve_pallas``): the
whole Gauss-Newton loop for one pose in one kernel.  On an H100 the solve is
bound by latency — a chain of dependent rounds over ~128 points, each round
a handful of reductions and a serial 6x6 Cholesky — not by bytes or FLOPs.
The kernel therefore keeps a problem inside one warp: lanes stride over the
points, the 30 sums are butterfly-reduced so every lane holds them, and
every lane solves and updates the pose redundantly, so the loop state is
warp-uniform and nothing diverges or waits on a block barrier.  The grid
runs over the batch: one launch solves B problems.  The correspondence
gather (``world_pts[corr_idx]``) happens inside the kernel.  K, the robust
threshold and the GN schedule are kernel arguments.

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


def solve_cuda(K, T_init, world_pts, image_uv, corr_idx, corr_valid,
               width: int, height: int, cfg: PICPConfig) -> picp.PICPResult:
    """Drop-in replacement for ``ops.picp.solve`` with the fused kernel.

    Unbatched: T_init (4, 4), world_pts (M, 3), image_uv (N, 2), corr_idx
    (N,) or None (world_pts already per observation), corr_valid (N,).
    Batched: the same with a leading axis B on every argument.
    """
    global launches
    # K's entries are kernel arguments: a CUDA K would cost a device->host
    # copy, so the tracker passes cfg.K() (numpy)
    Kh = K.detach().cpu().numpy() if isinstance(K, torch.Tensor) else np.asarray(K)
    if not T_init.is_cuda:
        Kt = torch.as_tensor(Kh, dtype=torch.float32)
        return picp.solve(Kt, T_init, world_pts, image_uv, corr_idx, corr_valid,
                          width, height, cfg)
    if cfg.annealed_kernel:
        raise ValueError("the fused PICP kernel has no annealing schedule; "
                         "use picp.backend='xla' for annealed_kernel=True")
    lib = build.library()
    batched = T_init.dim() == 3
    add = (lambda t: t) if batched else (lambda t: None if t is None else t[None])
    T0 = add(T_init).float().contiguous()
    world = add(world_pts).float().contiguous()
    uv = add(image_uv).float().contiguous()
    idx = add(corr_idx)
    idx = None if idx is None else idx.to(torch.int64).contiguous()
    valid = add(corr_valid).to(torch.bool).contiguous()
    B, N = uv.shape[0], uv.shape[1]
    M = world.shape[1]
    if (T0.shape != (B, 4, 4) or world.shape != (B, M, 3) or valid.shape != (B, N)
            or (idx is not None and idx.shape != (B, N)) or (idx is None and M != N)):
        raise ValueError("solve_cuda: inconsistent shapes "
                         f"T {tuple(T0.shape)} world {tuple(world.shape)} "
                         f"uv {tuple(uv.shape)} valid {tuple(valid.shape)}")
    build.check_device(T0, world, uv, idx, valid)
    T_out = torch.empty((B, 4, 4), dtype=torch.float32, device=T0.device)
    stats = torch.empty((B, 8), dtype=torch.float32, device=T0.device)
    stream = torch.cuda.current_stream(T0.device).cuda_stream
    err = lib.tpuvo_picp_solve(
        world.data_ptr(), None if idx is None else idx.data_ptr(), uv.data_ptr(),
        valid.data_ptr(), T0.data_ptr(), T_out.data_ptr(), stats.data_ptr(),
        B, N, M, float(Kh[0, 0]), float(Kh[1, 1]), float(Kh[0, 2]), float(Kh[1, 2]),
        float(width), float(height), float(cfg.kernel_threshold), float(cfg.damping),
        float(cfg.convergence_threshold), int(cfg.max_iterations),
        int(cfg.min_num_inliers), int(cfg.keep_outliers), stream)
    build.check(err, "tpuvo_picp_solve")
    launches += 1
    if not batched:
        T_out, stats = T_out[0], stats[0]
    return picp.PICPResult(
        T=T_out,
        num_inliers=stats[..., 0].to(torch.int32),
        chi_inliers=stats[..., 1],
        chi_outliers=stats[..., 2],
        iterations=stats[..., 3].to(torch.int32),
        converged=stats[..., 4] > 0.5,
    )
