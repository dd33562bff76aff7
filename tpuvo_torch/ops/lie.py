"""SE(3)/SO(3) charts and similarity alignment on tensors.

Twin of ``tpuvo/ops/lie.py``: the axis rotations ``rx``/``ry``/``rz``,
``v2t_euler`` (R = Rx(w0)·Ry(w1)·Rz(w2), the reference's
left-multiplicative GN update), the quaternion chart ``v2t_quat`` /
``quat_to_rot``, the heading ``yaw``, the ``se3_exp``/``se3_log``
chart of the BA and pose-graph solvers, the planar lift ``augment_pose``,
and ``umeyama`` Sim(3) alignment.  Transforms are 4x4
homogeneous float32 tensors; every function broadcasts over leading dims.
"""

from __future__ import annotations

import torch

from tpuvo_torch.ops.linalg_small import matmul_small, matvec_small


def rx(a):
    """Rotation about x."""
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack(
        [torch.stack([o, z, z], -1), torch.stack([z, c, -s], -1),
         torch.stack([z, s, c], -1)], -2
    )


def ry(a):
    """Rotation about y."""
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack(
        [torch.stack([c, z, s], -1), torch.stack([z, o, z], -1),
         torch.stack([-s, z, c], -1)], -2
    )


def rz(a):
    """Rotation about z."""
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack(
        [torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
         torch.stack([z, z, o], -1)], -2
    )


def skew(v):
    """Cross-product matrix, batched over leading dims."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack(
        [torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1),
         torch.stack([-y, x, o], -1)], -2
    )


def rt_to_T(R, t):
    """Assemble 4x4 homogeneous transform(s) from rotation + translation.

    Built by concatenation: a scalar store into a CUDA tensor
    (``T[..., 3, 3] = 1.0``) is a host->device copy that synchronizes."""
    t = t.expand(R.shape[:-2] + (3,))
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3].expand(R.shape[:-2] + (1, 4))
    return torch.cat([torch.cat([R, t[..., None]], -1), bottom], -2)


def v2t_euler(v):
    """6-vector -> SE(3): R = Rx(v3)·Ry(v4)·Rz(v5), t = v[:3] (entrywise,
    the same grouping as the JAX twin)."""
    ca, sa = torch.cos(v[..., 3]), torch.sin(v[..., 3])
    cb, sb = torch.cos(v[..., 4]), torch.sin(v[..., 4])
    cc, sc = torch.cos(v[..., 5]), torch.sin(v[..., 5])
    sasb = sa * sb
    casb = ca * sb
    R = torch.stack(
        [
            torch.stack([cb * cc, -(cb * sc), sb], -1),
            torch.stack([sasb * cc + ca * sc, ca * cc - sasb * sc, -(sa * cb)], -1),
            torch.stack([-(casb * cc) + sa * sc, sa * cc + casb * sc, ca * cb], -1),
        ],
        -2,
    )
    return rt_to_T(R, v[..., :3])


def v2t_quat(v):
    """6-vector -> SE(3) via the unit quaternion's imaginary part v[3:6]
    (identity rotation when |v[3:6]| >= 1)."""
    w2 = torch.sum(v[..., 3:6] ** 2, -1)
    w = torch.sqrt(torch.clamp(1.0 - w2, min=0.0))
    q = torch.cat([w[..., None], v[..., 3:6]], -1)  # (w, x, y, z)
    R = torch.where((w2 < 1.0)[..., None, None], quat_to_rot(q),
                    torch.eye(3, dtype=v.dtype, device=v.device))
    return rt_to_T(R, v[..., :3])


def quat_to_rot(q):
    """Unit quaternion (w, x, y, z) -> rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        -2,
    )


def so3_exp(w):
    """Rodrigues SO(3) exponential."""
    return _so3_exp(w, torch.matmul)


def _so3_exp(w, matmul):
    """so3_exp with W² = matmul(W, W)."""
    theta2 = torch.sum(w * w, -1)
    theta = torch.sqrt(theta2 + 1e-32)
    W = skew(w)
    W2 = matmul(W, W)
    big = theta2 > 1e-12
    a = torch.where(big, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(big, (1.0 - torch.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R):
    """Rotation matrix -> axis-angle (atan2 form, finite at theta = 0)."""
    v = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
         R[..., 1, 0] - R[..., 0, 1]], -1
    )
    s2 = torch.sum(v * v, -1)
    sin_t = 0.5 * torch.sqrt(s2 + 1e-24)
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.atan2(sin_t, cos_t)
    scale = torch.where(s2 > 1e-12, theta / (2.0 * sin_t), 0.5 + theta * theta / 12.0)
    return v * scale[..., None]


def se3_exp(xi):
    """SE(3) exponential of twists (..., 6) = (v, w): the BA and pose-graph
    retraction."""
    v, w = xi[..., :3], xi[..., 3:6]
    theta2 = torch.sum(w * w, -1)
    theta = torch.sqrt(theta2 + 1e-32)
    W = skew(w)
    W2 = W @ W
    big = theta2 > 1e-12
    b = torch.where(big, (1.0 - torch.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    c = torch.where(big, (theta - torch.sin(theta)) / (theta2 * theta), 1.0 / 6.0)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    return rt_to_T(so3_exp(w), torch.einsum("...ij,...j->...i", V, v))


def se3_log(T):
    """SE(3) logarithm (..., 4, 4) -> twists (..., 6) with
    se3_exp(se3_log(T)) = T: V^-1 = I - W/2 + coef·W² applied to t."""
    w = so3_log(T[..., :3, :3])
    theta2 = torch.sum(w * w, -1)
    theta = torch.sqrt(theta2 + 1e-32)
    W = skew(w)
    W2 = W @ W
    half = 0.5 * theta
    cot_term = torch.where(
        theta2 > 1e-12,
        (1.0 - half * torch.cos(half) / torch.clamp(torch.sin(half), min=1e-20)) / theta2,
        1.0 / 12.0 + theta2 / 720.0,
    )
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    Vinv = eye - 0.5 * W + cot_term[..., None, None] * W2
    return torch.cat([torch.einsum("...ij,...j->...i", Vinv, T[..., :3, 3]), w], -1)


def scale_motion(T, alpha):
    """Fractional rigid motion: (R, t) -> (exp(alpha·log R), alpha·t).

    The exponential's W² is ``matmul_small``'s: on the card torch's batched
    W @ W rounds some lanes of a 256-lane batch otherwise than each lane
    alone (``tools/lane_ops.py``), and this is the motion model's step.
    ``so3_exp`` (the BA's and PGO's retraction) keeps torch's product."""
    R = _so3_exp(alpha * so3_log(T[..., :3, :3]), matmul_small)
    return rt_to_T(R, alpha * T[..., :3, 3])


def inv_se3(T):
    """Inverse of rigid transform(s) without a general solve.

    Rᵀt is ``matvec_small``'s: on the card a lane of a batch gets the bits
    of the pose inverted alone (the tracker's PICP starts from this
    inverse)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    t = T[..., :3, 3]
    return rt_to_T(Rt, -matvec_small(Rt, t))


def transform_points(T, pts):
    """Apply 4x4 transform(s) to (..., N, 3) points."""
    return torch.einsum("...ij,...nj->...ni", T[..., :3, :3], pts) + T[..., None, :3, 3]


def augment_pose(pose_xyt):
    """Lift planar (x, y, theta) into SE(3)."""
    theta = pose_xyt[..., 2]
    t = torch.stack([pose_xyt[..., 0], pose_xyt[..., 1], torch.zeros_like(theta)], -1)
    return rt_to_T(rz(theta), t)


def yaw(T):
    """Planar heading: atan2(R10, R00)."""
    return torch.atan2(T[..., 1, 0], T[..., 0, 0])


def wrap_angle(a):
    """Wrap to (-pi, pi]."""
    return torch.atan2(torch.sin(a), torch.cos(a))


def umeyama(src, dst, mask=None, with_scale: bool = True):
    """Similarity T (4x4, T[:3,:3] = c·R) with dst ≈ c·R·src + t in the
    least-squares sense (Eigen::umeyama semantics, incl. its sign fix)."""
    w = (torch.ones(src.shape[0], dtype=src.dtype, device=src.device)
         if mask is None else mask.to(src.dtype))
    n = torch.sum(w)
    mu_s = torch.sum(src * w[:, None], 0) / n
    mu_d = torch.sum(dst * w[:, None], 0) / n
    sc = src - mu_s
    dc = dst - mu_d
    cov = (dc * w[:, None]).T @ sc / n
    var_s = torch.sum(torch.sum(sc * sc, -1) * w) / n
    U, D, Vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    S = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    R = U @ S @ Vt
    c = (torch.sum(D * torch.diagonal(S)) / torch.clamp(var_s, min=1e-12)
         if with_scale else torch.ones_like(var_s))
    t = mu_d - c * (R @ mu_s)
    return rt_to_T(c * R, t)
