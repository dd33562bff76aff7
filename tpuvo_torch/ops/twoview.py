"""Two-view bootstrap: 8-point essential matrix, batched RANSAC and
cheirality-based pose recovery (twin of ``tpuvo/ops/twoview.py``).

RANSAC is a fixed-size batch of minimal solves — one 0/1 membership matmul
builds every hypothesis's 9x9 normal matrix, inverse iteration solves them
all — then a masked inlier count per hypothesis, an argmax, and a refit on
the winner's inliers.  No data-dependent loop.

Conventions: x2^T E x1 = 0 with E = [t]x R; the recovered (R, t) satisfy
X_cam2 = R · X_cam1 + t with |t| = 1.

Sampling: the JAX package draws each hypothesis's 8 distinct indices by
Gumbel top-k from a JAX key.  Here the uniforms come from an explicit
``torch.Generator`` (``hypothesis_uniforms``, on the host) and become the
indices on the tensors' device (``samples_from_uniforms``, which a CUDA
graph captures), or the (H, S) indices are passed in as ``sample_idx``
(the tests pass JAX's own draw, since the two generators differ).

The 9x9 eigenvector of the refit and the 3x3 SVDs are kernel C on the card
(``ops/cuda/smalleig``: no host read, so the bootstrap is a graph), their
plain versions on the CPU; both fix the eigenvectors' and singular pairs'
signs the same way.

Every function takes an optional leading lane axis: correspondences
(B, N, 2), one RANSAC and one pose recovery per lane.  The lanes draw from
one generator, so lane b's draw differs from a single-lane run's.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from tpuvo_torch.config import RansacConfig
from tpuvo_torch.ops import lie, triangulate
from tpuvo_torch.ops.cuda import smalleig
from tpuvo_torch.ops.linalg_small import det3, smallest_eigvec_inverse_iteration


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device):
    """(the essential manifold's singular values [1, 1, 0], W of the
    decomposition), made once per device: the host-to-device copy runs in
    a graph's warm-up, never under its capture."""
    diag = torch.tensor([1.0, 1.0, 0.0], device=device)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], device=device)
    return diag, W


def normalize_points(uv, K):
    """Pixel -> normalized camera coordinates: (u-cx)/fx, (v-cy)/fy."""
    return torch.stack([(uv[..., 0] - K[0, 2]) / K[0, 0],
                        (uv[..., 1] - K[1, 2]) / K[1, 1]], -1)


def _epipolar_rows(x1, x2):
    """Rows [x2·x1, x2·y1, x2, y2·x1, y2·y1, y2, x1, y1, 1] (E row-major)."""
    a1, b1 = x1[..., 0], x1[..., 1]
    a2, b2 = x2[..., 0], x2[..., 1]
    return torch.stack([a2 * a1, a2 * b1, a2, b2 * a1, b2 * b1, b2, a1, b1,
                        torch.ones_like(a1)], -1)


def essential_8pt(x1, x2, weights=None):
    """Weighted 8-point E from normalized correspondences, projected to the
    essential manifold (singular values (1, 1, 0))."""
    A = _epipolar_rows(x1, x2)
    if weights is not None:
        A = A * weights[..., None]
    _, vecs = smalleig.sym_eig(A.mT @ A)
    E = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 3))
    U, _, Vt = smalleig.svd3(E)
    return (U * _constants(E.device)[0]) @ Vt


def sampson_error(E, x1, x2):
    """First-order geometric (Sampson) epipolar error in normalized coords."""
    x1h = torch.cat([x1, torch.ones_like(x1[..., :1])], -1)
    x2h = torch.cat([x2, torch.ones_like(x2[..., :1])], -1)
    Ex1 = x1h @ E.mT
    Etx2 = x2h @ E
    num = torch.sum(x2h * Ex1, -1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


class RansacResult(NamedTuple):
    E: torch.Tensor               # (..., 3, 3) refined essential matrix
    inliers: torch.Tensor         # (..., N) bool
    num_inliers: torch.Tensor     # (...) int
    best_hypothesis: torch.Tensor # (...) int (diagnostic)


def hypothesis_uniforms(generator, valid_shape, num_hypotheses: int, out=None):
    """The uniforms of the RANSAC draw for a (..., N) validity mask: one
    (..., H, N) ``torch.rand`` on the generator's device (all lanes in one
    draw; ``out``, e.g. a pinned host buffer, receives them).  A CPU
    generator gives the same samples to a CPU and a CUDA run."""
    shape = tuple(valid_shape[:-1]) + (num_hypotheses, valid_shape[-1])
    return torch.rand(shape, generator=generator, device=generator.device, out=out)


def samples_from_uniforms(u, valid, sample_size: int):
    """(..., H, S) distinct valid indices per hypothesis from the uniforms
    of ``hypothesis_uniforms`` on valid's device: Gumbel top-k (sampling
    without replacement, vectorized).  No host read."""
    u = torch.clamp(u, min=torch.finfo(u.dtype).tiny)
    gumbel = -torch.log(-torch.log(u))
    scores = torch.where(valid.unsqueeze(-2), gumbel, -float("inf"))
    return torch.topk(scores, sample_size, dim=-1).indices


def draw_samples(generator, valid, num_hypotheses: int, sample_size: int):
    """(..., H, S) distinct valid indices per hypothesis for a (..., N)
    validity mask, drawn from ``generator`` (the uniforms moved to valid's
    device)."""
    u = hypothesis_uniforms(generator, valid.shape, num_hypotheses)
    return samples_from_uniforms(u.to(valid.device), valid, sample_size)


def ransac_essential(generator, x1, x2, valid, cfg: RansacConfig, focal,
                     sample_idx=None, uniforms=None) -> RansacResult:
    """Batched RANSAC over ``cfg.num_hypotheses`` minimal sets, then the
    refit on the winner's inliers (kept only if it loses no inliers).
    sample_idx: optional (..., H, S) minimal sets replacing the draw;
    uniforms: optional (..., H, N) uniforms of the draw on x1's device
    (``hypothesis_uniforms``), replacing the generator."""
    N = x1.shape[-2]
    lanes = x1.shape[:-2]
    H = cfg.num_hypotheses
    if sample_idx is None:
        sample_idx = (draw_samples(generator, valid, H, cfg.sample_size) if uniforms is None
                      else samples_from_uniforms(uniforms, valid, cfg.sample_size))
    sample_idx = sample_idx.to(device=x1.device, dtype=torch.int64)

    rows = _epipolar_rows(x1, x2)  # (..., N, 9)
    member = torch.zeros(sample_idx.shape[:-1] + (N,), dtype=x1.dtype, device=x1.device)
    member.scatter_add_(-1, sample_idx, torch.ones_like(sample_idx, dtype=x1.dtype))
    P = (rows[..., :, None] * rows[..., None, :]).reshape(lanes + (N, 81))
    AtA = (member @ P).reshape(lanes + (-1, 9, 9))
    Es = smallest_eigvec_inverse_iteration(AtA).reshape(lanes + (-1, 3, 3))

    thr = (cfg.inlier_threshold_px / focal) ** 2
    ones = torch.ones(lanes + (1, N), dtype=x1.dtype, device=x1.device)
    x1h_T = torch.cat([x1.mT, ones], -2)  # (..., 3, N)
    x2h_T = torch.cat([x2.mT, ones], -2)
    Ex1 = torch.einsum("...hij,...jn->...hin", Es, x1h_T)
    Etx2 = torch.einsum("...hji,...jn->...hin", Es, x2h_T)
    num = torch.sum(x2h_T.unsqueeze(-3) * Ex1, dim=-2) ** 2
    den = (Ex1[..., 0, :] ** 2 + Ex1[..., 1, :] ** 2 + Etx2[..., 0, :] ** 2
           + Etx2[..., 1, :] ** 2)
    inl = (num / torch.clamp(den, min=1e-12) < thr) & valid.unsqueeze(-2)
    counts = torch.sum(inl, dim=-1)
    best = torch.argmax(counts, dim=-1)  # first maximum per lane, as jnp.argmax

    inl_best = _pick(inl, best)
    E_ref = essential_8pt(x1, x2, inl_best.to(x1.dtype))
    inl_ref = (sampson_error(E_ref, x1, x2) < thr) & valid
    better = torch.sum(inl_ref, -1) >= _pick(counts, best)
    E_fin = torch.where(better[..., None, None], E_ref, _pick(Es, best))
    inl_fin = torch.where(better[..., None], inl_ref, inl_best)
    return RansacResult(E_fin, inl_fin, torch.sum(inl_fin, -1), best)


def _pick(x, i):
    """x[..., i, ...]: entry i (one per lane) of the axis after the lanes'."""
    d = i.dim()
    return torch.take_along_dim(x, i.reshape(i.shape + (1,) * (x.dim() - d)), dim=d).squeeze(d)


def decompose_essential(E):
    """E -> two rotations + translation direction (the classic U W V^T)."""
    U, _, Vt = smalleig.svd3(E)
    U = U * torch.sign(det3(U))[..., None, None]
    Vt = Vt * torch.sign(det3(Vt))[..., None, None]
    W = _constants(E.device)[1]
    return U @ W @ Vt, U @ W.T @ Vt, U[..., :, 2]


class PoseResult(NamedTuple):
    R: torch.Tensor           # (..., 3, 3): X_cam2 = R X_cam1 + t
    t: torch.Tensor           # (..., 3), unit norm
    cheirality: torch.Tensor  # (..., N) bool — positive depth in both views
    num_good: torch.Tensor


def recover_pose(E, x1, x2, mask):
    """Pick among the 4 (R, t) candidates by cheirality voting over the
    masked correspondences (depth in (0, 50) in both views)."""
    R1, R2, t = decompose_essential(E)
    cands_R = torch.stack([R1, R1, R2, R2], -3)  # (..., 4, 3, 3)
    cands_t = torch.stack([t, -t, t, -t], -2)    # (..., 4, 3)
    goods = []
    for R, tt in zip(cands_R.unbind(-3), cands_t.unbind(-2)):
        _, z1, z2 = triangulate.triangulate_normalized(R, tt, x1, x2)
        goods.append((z1 > 0) & (z2 > 0) & (z1 < 50.0) & (z2 < 50.0) & mask)
    goods = torch.stack(goods, -2)  # (..., 4, N)
    counts = torch.sum(goods, dim=-1)
    best = torch.argmax(counts, dim=-1)  # first maximum per lane
    return PoseResult(_pick(cands_R, best), _pick(cands_t, best), _pick(goods, best),
                      _pick(counts, best))


def bootstrap_pose(generator, K, uv1, uv2, valid, cfg: RansacConfig,
                   sample_idx=None, uniforms=None):
    """RANSAC E + pose recovery.  Returns (camera-2-in-world 4x4 pose with
    world = camera-1 frame, RansacResult, PoseResult)."""
    x1 = normalize_points(uv1, K)
    x2 = normalize_points(uv2, K)
    rres = ransac_essential(generator, x1, x2, valid, cfg, K[0, 0], sample_idx, uniforms)
    pres = recover_pose(rres.E, x1, x2, rres.inliers)
    return lie.inv_se3(lie.rt_to_T(pres.R, pres.t)), rres, pres
