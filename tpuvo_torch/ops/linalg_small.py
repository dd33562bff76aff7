"""Closed-form small linear algebra for the per-frame path (twin of
``tpuvo/ops/linalg_small.py``): adjugate 3x3 solves, an unrolled Cholesky
for the PICP normal equations, inverse iteration for the RANSAC
hypotheses, and the inhomogeneous two-view DLT.  Branch-free elementwise
arithmetic, batched over leading dims, so no call needs a host round-trip.
``cholesky_solve_nan`` is the sync-free dense SPD solve of the BA and
pose-graph systems.
"""

from __future__ import annotations

import torch


# Products of small matrices for the tracker's step.  On the card they are
# written out term by term in elementwise ops: its batched and 2-D products
# (and its mat-vec products batched over points) pick their kernels, and so
# their rounding, by shape, and a lane of a batch would get other bits than
# the same arguments alone.  Written out, every element is summed in index
# order whatever the leading axes, so a lane steps as the sequence alone,
# bit for bit.  On the CPU they are torch's own products, which the tests
# against the JAX twin hold.


def matmul_terms(A, B):
    """A @ B for small (..., m, k) and (..., k, n), broadcast over leading
    axes, written out term by term (the card's form)."""
    out = A[..., :, 0:1] * B[..., 0:1, :]
    for k in range(1, A.shape[-1]):
        out = out + A[..., :, k:k + 1] * B[..., k:k + 1, :]
    return out


def matmul_small(A, B):
    """A @ B for small (..., m, k) and (..., k, n)."""
    return matmul_terms(A, B) if A.is_cuda else A @ B


def matvec_small(A, x):
    """A x for (..., m, k) and (..., k)."""
    if A.is_cuda:
        return matmul_terms(A, x[..., None])[..., 0]
    return torch.einsum("...ij,...j->...i", A, x)


def tmatvec_small(A, x):
    """Aᵀ x for per-point (..., N, k, m) and (..., N, k)."""
    if A.is_cuda:
        return matmul_terms(A.mT, x[..., None])[..., 0]
    return torch.einsum("...nki,...nk->...ni", A, x)


def det3(A):
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def inv3(A, eps: float = 0.0):
    """Adjugate inverse of (..., 3, 3); singular inputs yield large values."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    tiny = torch.where(det >= 0, torch.full_like(det, eps + 1e-30),
                       torch.full_like(det, -(eps + 1e-30)))
    inv_det = 1.0 / torch.where(torch.abs(det) > eps, det, tiny)
    adj = torch.stack(
        [torch.stack([A00, A01, A02], -1), torch.stack([A10, A11, A12], -1),
         torch.stack([A20, A21, A22], -1)], -2
    )
    return adj * inv_det[..., None, None]


def solve3(A, b):
    """x = A^-1 b for (..., 3, 3) @ (..., 3)."""
    return torch.einsum("...ij,...j->...i", inv3(A), b)


def cholesky_solve_unrolled(H, b, n: int):
    """Solve H x = b for SPD (..., n, n) H with a fully unrolled Cholesky."""
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = H[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        Ljj = torch.sqrt(torch.clamp(s, min=1e-30))
        L[j][j] = Ljj
        inv_Ljj = 1.0 / Ljj
        for i in range(j + 1, n):
            s = H[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_Ljj
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def cholesky_solve6(H, b):
    """Unrolled 6x6 SPD solve (PICP normal equations)."""
    return cholesky_solve_unrolled(H, b, 6)


def cholesky_solve_nan(S, rhs):
    """x = S^-1 rhs for SPD (n, n) S through a Cholesky factor; a matrix
    that is not positive definite yields NaN, never an exception.

    ``jax.scipy.linalg.cho_factor`` returns NaN on a non-PD matrix, and the
    BA and pose-graph LM loops rely on it: the non-finite step is rejected
    and lambda grows x4.  ``torch.linalg.cholesky`` raises instead, and on
    the card its error check syncs.  ``cholesky_ex`` returns ``info``
    without a check; a nonzero info poisons the factor with NaN.  The
    triangular solves are cuBLAS trsm calls, which do not sync either."""
    Lc, info = torch.linalg.cholesky_ex(S)
    Lc = torch.where(info[..., None, None] == 0, Lc, float("nan"))
    y = torch.linalg.solve_triangular(Lc, rhs[..., None], upper=False)
    return torch.linalg.solve_triangular(Lc.mT, y, upper=True)[..., 0]


def smallest_eigvec_inverse_iteration(A, iterations: int = 8, shift: float = 1e-6):
    """Smallest eigenvector of symmetric PSD (..., n, n) A by inverse
    iteration: solve (A + shift·(tr(A)+1)·I) x = v and normalize, from a
    deterministic all-ones start."""
    n = A.shape[-1]
    tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    Ad = A + shift * (tr + 1.0) * torch.eye(n, dtype=A.dtype, device=A.device)
    v = torch.ones(A.shape[:-1], dtype=A.dtype, device=A.device)
    for _ in range(iterations):
        v = cholesky_solve_unrolled(Ad, v, n)
        v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-30)
    return v


def solve_dlt3(A):
    """Inhomogeneous DLT: fix w = 1 in the (..., N, 4, 4) rows A·(X, 1) ≈ 0
    and least-squares solve for X.  Returns (X (..., N, 3), det (..., N) of
    the 3x3 normal matrix — ~0 flags a near-infinity point)."""
    A3 = A[..., :3]
    a4 = A[..., 3]
    N_mat = torch.einsum("...nki,...nkj->...nij", A3, A3)
    rhs = -tmatvec_small(A3, a4)
    return solve3(N_mat, rhs), det3(N_mat)
