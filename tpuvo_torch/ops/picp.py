"""Projective-ICP: Gauss-Newton on SE(3) with a saturating robust kernel
(twin of ``tpuvo/ops/picp.py``).

Per correspondence (image point z, world point X):
  * residual  e = pi(K · T · X) - z
  * Jacobian  J = Jp · K · [I | skew(-p_cam)]
  * chi = e·e; chi > threshold marks an outlier (weight sqrt(thr/chi),
    excluded from H, b unless keep_outliers)
  * H += damping·I; dx = solve(H, -b); T <- v2t_euler(dx) · T
  * no update when num_inliers < min_num_inliers (and the loop stops)
The solver runs <= max_iterations rounds and stops when the relative
improvement of chi_inliers drops below the convergence threshold.

``solve`` is the plain version of the fused CUDA kernel
(``ops/cuda/picp_kernel.py``): the CPU's path and the card's reference, as
every PICP solve on CUDA tensors goes through ``solve_cuda``.  Every
function takes an optional leading batch axis (T (B, 4, 4), points (B, N,
3), ...); batched problems stop independently, exactly as JAX's vmapped
while_loop freezes finished lanes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuvo_torch.config import PICPConfig
from tpuvo_torch.ops import lie
from tpuvo_torch.ops.camera import project_points_with_cam
from tpuvo_torch.ops.linalg_small import cholesky_solve6

# First-iteration sentinel for the previous-chi value.  The reference uses
# FLT_MAX; TPUs flush the subnormal 1/FLT_MAX to 0, so the JAX package uses
# 1e30, which behaves identically (first-round relative improvement ~1).
# Kept here so both packages (and the CUDA kernel) stop on the same round.
PREV_CHI_INIT = 1e30


class Linearization(NamedTuple):
    H: torch.Tensor            # (..., 6, 6)
    b: torch.Tensor            # (..., 6)
    num_inliers: torch.Tensor  # (...) int32
    chi_inliers: torch.Tensor  # (...) float32
    chi_outliers: torch.Tensor # (...) float32


class PICPResult(NamedTuple):
    T: torch.Tensor             # (..., 4, 4) final world-in-camera pose
    num_inliers: torch.Tensor   # (...) int32 — from the last linearization
    chi_inliers: torch.Tensor   # (...) float32
    chi_outliers: torch.Tensor  # (...) float32
    iterations: torch.Tensor    # (...) int32 — rounds actually executed
    converged: torch.Tensor     # (...) bool


def gather_points(world_pts, corr_idx):
    """world_pts[corr_idx] with an optional leading batch axis."""
    if corr_idx is None:
        return world_pts
    if corr_idx.dim() == 1:
        return world_pts[corr_idx]
    return torch.take_along_dim(world_pts, corr_idx[..., None], dim=-2)


def _thr_col(thr):
    """A per-problem threshold tensor broadcast against (..., N) chi."""
    return thr[..., None] if isinstance(thr, torch.Tensor) and thr.dim() > 0 else thr


def linearize(K, T, world_pts, image_uv, corr_idx, corr_valid, width: int,
              height: int, kernel_threshold, keep_outliers: bool = False
              ) -> Linearization:
    """Masked batch linearization: H, b and the inlier statistics.

    world_pts: (M, 3) map positions, or pre-gathered (N, 3) points when
    corr_idx is None; image_uv: (N, 2); corr_valid: (N,) bool.
    """
    X = gather_points(world_pts, corr_idx)
    uv, proj_ok, p_cam, phom = project_points_with_cam(K, T, X, width, height)
    e = uv - image_uv
    z = phom[..., 2]
    iz = 1.0 / torch.where(torch.abs(z) > 1e-12, z, torch.ones_like(z))
    k0, k1, k2 = K[0], K[1], K[2]
    a0 = phom[..., 0] * iz
    a1 = phom[..., 1] * iz
    C0 = iz[..., None] * (k0 - a0[..., None] * k2)
    C1 = iz[..., None] * (k1 - a1[..., None] * k2)
    w_ax = -p_cam
    J = torch.stack(
        [torch.cat([C0, torch.linalg.cross(C0, w_ax, dim=-1)], -1),
         torch.cat([C1, torch.linalg.cross(C1, w_ax, dim=-1)], -1)], -2
    )  # (..., N, 2, 6)

    valid = corr_valid & proj_ok
    # Zero masked rows BEFORE the reduction: a culled point can carry inf in
    # its Jacobian/residual, and inf * 0-weight = NaN would poison the sums.
    e = torch.where(valid[..., None], e, 0.0)
    J = torch.where(valid[..., None, None], J, 0.0)
    chi = torch.sum(e * e, -1)
    thr = _thr_col(kernel_threshold)
    is_inlier = chi <= thr
    lam = torch.where(is_inlier, 1.0, torch.sqrt(thr / torch.clamp(chi, min=1e-20)))
    contrib = valid if keep_outliers else valid & is_inlier
    w = lam * contrib.to(X.dtype)

    A = torch.cat([J, e[..., None]], -1)  # (..., N, 2, 7)
    H_aug = torch.einsum("...nki,...nkj,...n->...ij", A, A, w)
    in_mask = (valid & is_inlier).to(chi.dtype)
    out_mask = (valid & ~is_inlier).to(chi.dtype)
    return Linearization(
        H_aug[..., :6, :6], H_aug[..., :6, 6],
        torch.sum(in_mask, -1).to(torch.int32),
        torch.sum(chi * in_mask, -1), torch.sum(chi * out_mask, -1))


def one_round(K, T, world_pts, image_uv, corr_idx, corr_valid, width: int,
              height: int, cfg: PICPConfig, kernel_threshold=None):
    """One GN round. Returns (T', Linearization, ok)."""
    thr = cfg.kernel_threshold if kernel_threshold is None else kernel_threshold
    lin = linearize(K, T, world_pts, image_uv, corr_idx, corr_valid,
                    width, height, thr, cfg.keep_outliers)
    H = lin.H + cfg.damping * torch.eye(6, dtype=lin.H.dtype, device=lin.H.device)
    ok = lin.num_inliers >= cfg.min_num_inliers
    dx = cholesky_solve6(H, -lin.b)
    T_new = lie.v2t_euler(dx) @ T
    return torch.where(ok[..., None, None], T_new, T), lin, ok


def _annealed_thr(K, T, X, image_uv, corr_valid, width, height, cfg, thr_cfg):
    """max(thr, anneal_mult · median chi at the current estimate)."""
    uv_hat, ok, _, _ = project_points_with_cam(K, T, X, width, height)
    chi = torch.sum((uv_hat - image_uv) ** 2, -1)
    use = corr_valid & ok
    n = torch.sum(use, -1)
    chi_sorted = torch.sort(torch.where(use, chi, float("inf")), dim=-1).values
    k = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), min=0)
    med = torch.gather(chi_sorted, -1, k[..., None])[..., 0]
    med = torch.where(torch.isfinite(med), med, 0.0)
    return torch.clamp(cfg.anneal_mult * med, min=thr_cfg)


def _init_carry(T_init):
    batch, dev = T_init.shape[:-2], T_init.device
    f32 = dict(dtype=torch.float32, device=dev)
    return dict(
        prev=torch.full(batch, PREV_CHI_INIT, **f32),
        it=torch.zeros(batch, dtype=torch.int32, device=dev),
        done=torch.zeros(batch, dtype=torch.bool, device=dev),
        n_in=torch.zeros(batch, dtype=torch.int32, device=dev),
        chi_in=torch.zeros(batch, **f32), chi_out=torch.zeros(batch, **f32),
        conv=torch.zeros(batch, dtype=torch.bool, device=dev),
    )


def _advance(c, T, T2, lin, ok, cfg):
    """Apply one round to the problems not yet done; returns the new T."""
    curr = lin.chi_inliers
    prev = c["prev"]
    rel = torch.where(prev > 1e-10, torch.abs(prev - curr) / prev, 0.0)
    converged = ok & (rel < cfg.convergence_threshold)
    act = ~c["done"]
    sel = lambda new, old: torch.where(act, new, old)
    c["prev"] = sel(curr, prev)
    c["it"] = sel(c["it"] + 1, c["it"])
    c["n_in"] = sel(lin.num_inliers, c["n_in"])
    c["chi_in"] = sel(lin.chi_inliers, c["chi_in"])
    c["chi_out"] = sel(lin.chi_outliers, c["chi_out"])
    c["conv"] = sel(converged, c["conv"])
    c["done"] = c["done"] | (~ok) | converged
    return torch.where(act[..., None, None], T2, T)


def _result(T, c) -> PICPResult:
    return PICPResult(T, c["n_in"], c["chi_in"], c["chi_out"], c["it"], c["conv"])


def solve(K, T_init, world_pts, image_uv, corr_idx, corr_valid, width: int,
          height: int, cfg: PICPConfig, kernel_threshold=None) -> PICPResult:
    """Full GN loop with the relative-chi stopping rule, as a Python loop
    (one host check of the done flags per round: the CPU's path; on the
    card the kernel runs the loop without the host).  The plain version of
    the CUDA kernel."""
    X = gather_points(world_pts, corr_idx)  # constant across rounds
    thr_cfg = cfg.kernel_threshold if kernel_threshold is None else kernel_threshold
    c = _init_carry(T_init)
    T = T_init
    for _ in range(cfg.max_iterations):
        if bool(c["done"].all()):
            break
        thr = (_annealed_thr(K, T, X, image_uv, corr_valid, width, height, cfg, thr_cfg)
               if cfg.annealed_kernel else kernel_threshold)
        T2, lin, ok = one_round(K, T, X, image_uv, None, corr_valid,
                                width, height, cfg, thr)
        T = _advance(c, T, T2, lin, ok, cfg)
    return _result(T, c)


def solve_unrolled(K, T_init, world_pts, image_uv, corr_idx, corr_valid,
                   width: int, height: int, cfg: PICPConfig,
                   kernel_threshold=None, rounds: int = 8) -> PICPResult:
    """The same stopping rule as ``solve`` over a fixed number of rounds
    (finished problems are frozen by a done-mask select; no host check)."""
    X = gather_points(world_pts, corr_idx)
    c = _init_carry(T_init)
    T = T_init
    for _ in range(rounds):
        T2, lin, ok = one_round(K, T, X, image_uv, None, corr_valid,
                                width, height, cfg, kernel_threshold)
        T = _advance(c, T, T2, lin, ok, cfg)
    return _result(T, c)


def solve_fixed_rounds(K, T_init, world_pts, image_uv, corr_idx, corr_valid,
                       width: int, height: int, cfg: PICPConfig,
                       rounds: int = 5) -> PICPResult:
    """Exactly ``rounds`` GN rounds, no convergence check."""
    X = gather_points(world_pts, corr_idx)
    T = T_init
    for _ in range(rounds):
        T, lin, _ = one_round(K, T, X, image_uv, None, corr_valid, width, height, cfg)
    batch, dev = T_init.shape[:-2], T_init.device
    return PICPResult(T, lin.num_inliers, lin.chi_inliers, lin.chi_outliers,
                      torch.full(batch, rounds, dtype=torch.int32, device=dev),
                      torch.ones(batch, dtype=torch.bool, device=dev))
