"""tpuvo_torch triangulation and two-view geometry vs tpuvo's (CPU).

RANSAC takes JAX's own hypothesis draw (``sample_idx``), since the two
packages' generators differ.  E itself is not compared entry by entry: it
is the smallest eigenvector of the 8-point normal matrix AᵀA, which
float32 fixes only to ~eps·λmax / (λ1 - λ0), and the eigensolvers (and
the host's BLAS) land apart within that; each E is held instead to the
epipolar geometry of its correspondences (``assert_epipolar``), and poses
derived from it to that conditioning (``assert_pose_within``).
Points: 1e-3 (relative for the DLT, absolute after triangulate_two_view)
on 4-12 m depths over a 0.5 m baseline, where fp32 rounding in the 3x3
solves is amplified ~1e3x.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuvo.config import EngineConfig as JEngineConfig, RansacConfig as JRansacConfig
from tpuvo.data import synthetic
from tpuvo.ops import lie as jlie, triangulate as jtri, twoview as jtv
from tpuvo_torch.config import RansacConfig
from tpuvo_torch.ops import triangulate as ttri, twoview as ttv
import xdist_threads  # noqa: F401  (torch's share of the cores under xdist)

CFG = JEngineConfig()
K = CFG.K()
EPS = float(np.finfo(np.float32).eps)


def t(x):
    return torch.as_tensor(np.array(x))


def normal_spectrum(x1, x2, w=None):
    """Eigenvalues (ascending, float64) of the 8-point normal matrix AᵀA of
    normalized correspondences (..., N, 2), each row weighted by w."""
    A = ttv._epipolar_rows(torch.as_tensor(np.asarray(x1), dtype=torch.float64),
                           torch.as_tensor(np.asarray(x2), dtype=torch.float64))
    if w is not None:
        A = A * torch.as_tensor(np.asarray(w), dtype=torch.float64)[..., None]
    return torch.linalg.eigvalsh(A.mT @ A).numpy(), A.numpy()


def refit_kappa(x1, x2, w=None):
    """eps·λmax / (λ1 - λ0) of the 8-point normal matrix: to first order,
    the angle by which a float32 perturbation of AᵀA of eps·‖AᵀA‖ turns
    its null vector, and so E and the pose taken from it."""
    lam, _ = normal_spectrum(x1, x2, w)
    return EPS * lam[..., -1] / (lam[..., 1] - lam[..., 0])


def record_refits(mp):
    """Every 8-point refit's (x1, x2, weights) as ``twoview.essential_8pt``
    receives them, appended to the returned list (mp: a MonkeyPatch)."""
    calls, fit = [], ttv.essential_8pt
    mp.setattr(ttv, "essential_8pt", lambda x1, x2, weights=None: (
        calls.append((x1, x2, weights)), fit(x1, x2, weights))[1])
    return calls


def assert_epipolar(E, x1, x2):
    """E (3, 3) holds the epipolar geometry of x1, x2 as far as float32
    determines it.  Its singular values are (1, 1, 0) to 16 eps (two 3x3
    products of orthogonal float32 factors).  Its algebraic residual
    ‖A vec(E)‖ / ‖E‖ is at most sqrt(λ0) + 2·eps·λmax / sqrt(λ1 - λ0): a
    perturbation ΔM of AᵀA turns the null vector toward the others by
    ΔM / (λi - λ0) each, which raise the residual by ‖ΔM‖ / sqrt(λ1 - λ0)
    together, and ‖ΔM‖ <= eps·λmax for forming AᵀA in float32 and again
    for the eigensolver.  Well posed at any gap, unlike E's entries."""
    E = np.asarray(E, np.float64)
    np.testing.assert_allclose(np.linalg.svd(E, compute_uv=False), [1.0, 1.0, 0.0],
                               rtol=0, atol=16 * EPS)
    lam, A = normal_spectrum(x1, x2)
    bound = np.sqrt(max(lam[0], 0.0)) + 2 * EPS * lam[-1] / np.sqrt(lam[1] - lam[0])
    residual = np.linalg.norm(A @ E.reshape(9)) / np.linalg.norm(E)
    assert residual <= bound, (residual, bound)


def pose_angles(Ta, Tb):
    """(rotation angle, angle between the translations) of 4x4 poses
    (..., 4, 4), each accurate at small angles (chords, not arccos)."""
    Ta, Tb = np.asarray(Ta, np.float64), np.asarray(Tb, np.float64)
    angle = lambda chord: 2 * np.arcsin(np.minimum(chord, 1.0))
    unit = lambda v: v / np.linalg.norm(v, axis=-1, keepdims=True)
    rot = np.linalg.norm(Ta[..., :3, :3] - Tb[..., :3, :3], axis=(-2, -1)) / (2 * np.sqrt(2))
    return angle(rot), angle(np.linalg.norm(unit(Ta[..., :3, 3]) - unit(Tb[..., :3, 3]),
                                            axis=-1) / 2)


def assert_pose_within(Ta, Tb, kappa, what=""):
    """Two float32 poses taken from the same 8-point refit, each within
    ``kappa`` (``refit_kappa``) of the exact one to first order: their
    rotations and their translations' directions (sign included) agree
    within 2·kappa.  A translation's length is not compared."""
    rot, direction = pose_angles(Ta, Tb)
    assert np.all(rot <= 2 * kappa), (what, rot, kappa)
    assert np.all(direction <= 2 * kappa), (what, direction, kappa)


def two_view(seed=0, n=100, noise=0.0, outliers=0):
    """Two camera poses 0.5 m apart, projections of a random cloud."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 12, n)], 1)
    pts = pts.astype(np.float32)
    T1 = np.eye(4, dtype=np.float32)
    T2 = np.asarray(jlie.v2t_euler(jnp.asarray([0.5, 0.05, 0.1, 0.02, -0.05, 0.01], jnp.float32)))

    def proj(T):
        Tc = np.linalg.inv(T)
        pc = pts @ Tc[:3, :3].T + Tc[:3, 3]
        uv = (pc @ K.T)[:, :2] / pc[:, 2:3]
        return (uv + noise * rng.standard_normal(uv.shape)).astype(np.float32)

    uv1, uv2 = proj(T1), proj(T2)
    if outliers:
        uv2[:outliers] += rng.uniform(20, 60, (outliers, 2)).astype(np.float32)
    return pts, T1, T2, uv1, uv2


@pytest.mark.parametrize("method", ["inhomogeneous", "homogeneous"])
def test_triangulate_dlt_and_refine(method):
    pts, T1, T2, uv1, uv2 = two_view(noise=0.3)
    Kj = jnp.asarray(K)
    P1, P2 = jtri.projection_matrix(Kj, jnp.asarray(T1)), jtri.projection_matrix(Kj, jnp.asarray(T2))
    P1t, P2t = ttri.projection_matrix(t(K), t(T1)), ttri.projection_matrix(t(K), t(T2))
    np.testing.assert_allclose(P2t.numpy(), np.asarray(P2), rtol=1e-5, atol=1e-3)
    Xj, wj = jtri.triangulate_dlt(P1, P2, jnp.asarray(uv1), jnp.asarray(uv2), method)
    Xt, wt = ttri.triangulate_dlt(P1t, P2t, t(uv1), t(uv2), method)
    # depth of a point 12 m away over a 0.5 m baseline amplifies fp32
    # rounding ~1e3x: compare relative 1e-3 (not absolute) on the points
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=1e-3, atol=1e-4)
    Rj = jtri.refine_points(P1, P2, jnp.asarray(uv1), jnp.asarray(uv2), Xj, 2)
    Rt = ttri.refine_points(P1t, P2t, t(uv1), t(uv2), t(np.asarray(Xj)), 2)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), rtol=1e-3, atol=1e-4)


def test_triangulate_two_view_forms():
    """The pose form and the world-in-camera (wic1/wic2) form of
    ``vo.track_step`` agree with JAX's, and with each other."""
    pts, T1, T2, uv1, uv2 = two_view(seed=1, noise=0.2)
    Kj = jnp.asarray(K)
    pj, fj = jtri.triangulate_two_view(Kj, jnp.asarray(T1), jnp.asarray(T2),
                                       jnp.asarray(uv1), jnp.asarray(uv2))
    pt, ft = ttri.triangulate_two_view(t(K), t(T1), t(T2), t(uv1), t(uv2))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-3, atol=1e-4)
    assert np.array_equal(ft.numpy(), np.asarray(fj))
    w1, w2 = np.linalg.inv(T1).astype(np.float32), np.linalg.inv(T2).astype(np.float32)
    pw, _ = ttri.triangulate_two_view(t(K), None, None, t(uv1), t(uv2), wic1=t(w1), wic2=t(w2))
    np.testing.assert_allclose(pw.numpy(), pt.numpy(), rtol=1e-3, atol=1e-4)


def test_triangulate_normalized_and_sampson():
    pts, T1, T2, uv1, uv2 = two_view(seed=2)
    x1j, x2j = jtv.normalize_points(jnp.asarray(uv1), jnp.asarray(K)), jtv.normalize_points(
        jnp.asarray(uv2), jnp.asarray(K))
    x1t, x2t = ttv.normalize_points(t(uv1), t(K)), ttv.normalize_points(t(uv2), t(K))
    np.testing.assert_allclose(x1t.numpy(), np.asarray(x1j), rtol=1e-6, atol=1e-7)
    Tr = np.linalg.inv(T2).astype(np.float32)  # X_cam2 = R X_cam1 + t
    R, tr = Tr[:3, :3], Tr[:3, 3]
    _, z1j, z2j = jtri.triangulate_normalized(jnp.asarray(R), jnp.asarray(tr), x1j, x2j)
    _, z1t, z2t = ttri.triangulate_normalized(t(R), t(tr), x1t, x2t)
    np.testing.assert_allclose(z1t.numpy(), np.asarray(z1j), atol=1e-3)
    np.testing.assert_allclose(z2t.numpy(), np.asarray(z2j), atol=1e-3)
    E = np.asarray(jlie.skew(jnp.asarray(tr))) @ R
    np.testing.assert_allclose(ttv.sampson_error(t(E), x1t, x2t).numpy(),
                               np.asarray(jtv.sampson_error(jnp.asarray(E), x1j, x2j)), atol=1e-9)
    # the 8-point E: both hold the epipolar geometry of the noise-free
    # correspondences (assert_epipolar), which its entries need not show
    assert_epipolar(ttv.essential_8pt(x1t, x2t).numpy(), x1t, x2t)
    assert_epipolar(np.asarray(jtv.essential_8pt(x1j, x2j)), x1t, x2t)


def test_essential_8pt_check_fails_on_a_perturbed_E():
    """The planted fault for test_triangulate_normalized_and_sampson's E:
    the port's E with one entry moved by 3e-3 of its norm and projected
    back to singular values (1, 1, 0), which moves its entries by up to
    2.2e-3 (past twice the 1e-3 they were once held to), fails
    assert_epipolar on its residual."""
    _, _, _, uv1, uv2 = two_view(seed=2)
    x1t, x2t = ttv.normalize_points(t(uv1), t(K)), ttv.normalize_points(t(uv2), t(K))
    E = ttv.essential_8pt(x1t, x2t).numpy().astype(np.float64)
    E[2, 2] += 3e-3 * np.linalg.norm(E)
    U, _, Vt = np.linalg.svd(E)
    E = U @ np.diag([1.0, 1.0, 0.0]) @ Vt
    with pytest.raises(AssertionError):
        assert_epipolar(E, x1t, x2t)


def jax_sample_idx(key, valid, cfg):
    g = jax.random.gumbel(key, (cfg.num_hypotheses, valid.shape[0]))
    scores = jnp.where(jnp.asarray(valid)[None, :], g, -jnp.inf)
    return np.asarray(jax.lax.top_k(scores, cfg.sample_size)[1])


@pytest.mark.parametrize("outliers", [0, 15])
def test_ransac_and_bootstrap_pose_with_jax_samples(outliers):
    """Noise-free inliers: every decision must agree.  The refit's fp32
    9x9 eigenvector still differs between the libraries' eigensolvers at
    ~1e-3 (its eigenvalue sits at fp32 rounding), hence pose atol 2e-3."""
    pts, T1, T2, uv1, uv2 = two_view(seed=3, noise=0.0, outliers=outliers)
    valid = np.ones(len(uv1), bool)
    valid[-5:] = False
    jc, tc = JRansacConfig(num_hypotheses=128), RansacConfig(num_hypotheses=128)
    key = jax.random.PRNGKey(42)
    sidx = jax_sample_idx(key, valid, jc)
    Tj, rj, pj = jtv.bootstrap_pose(key, jnp.asarray(K), jnp.asarray(uv1), jnp.asarray(uv2),
                                    jnp.asarray(valid), jc)
    Tt, rt, pt = ttv.bootstrap_pose(None, t(K), t(uv1), t(uv2), t(valid), tc, sample_idx=t(sidx))
    assert int(rt.best_hypothesis) == int(rj.best_hypothesis)
    assert np.array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rt.num_inliers) == int(rj.num_inliers)
    assert np.array_equal(pt.cheirality.numpy(), np.asarray(pj.cheirality))
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=2e-3)
    if outliers:
        assert not rt.inliers.numpy()[:outliers].any()


def test_ransac_with_pixel_noise():
    """With 0.3 px noise the smallest eigenvector of the refit's fp32 A^T A
    is determined only to ~1e-2 (its eigenvalue gap is near fp32 rounding
    of the largest), and torch's and JAX's eigensolvers land differently:
    the same winning hypothesis, inlier masks that agree on >= 97% of the
    points, and bootstrap poses within 2e-2."""
    pts, T1, T2, uv1, uv2 = two_view(seed=3, noise=0.3, outliers=15)
    valid = np.ones(len(uv1), bool)
    jc, tc = JRansacConfig(num_hypotheses=128), RansacConfig(num_hypotheses=128)
    key = jax.random.PRNGKey(42)
    Tj, rj, _ = jtv.bootstrap_pose(key, jnp.asarray(K), jnp.asarray(uv1), jnp.asarray(uv2),
                                   jnp.asarray(valid), jc)
    Tt, rt, _ = ttv.bootstrap_pose(None, t(K), t(uv1), t(uv2), t(valid), tc,
                                   sample_idx=t(jax_sample_idx(key, valid, jc)))
    assert int(rt.best_hypothesis) == int(rj.best_hypothesis)
    assert np.mean(rt.inliers.numpy() == np.asarray(rj.inliers)) >= 0.97
    assert not rt.inliers.numpy()[:15].any()
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=2e-2)


def test_ransac_generator_draw_is_deterministic():
    """With no sample_idx the port draws from its generator: same seed, same
    hypotheses; distinct valid indices per hypothesis."""
    valid = torch.ones(60, dtype=torch.bool)
    valid[50:] = False
    a = ttv.draw_samples(torch.Generator().manual_seed(7), valid, 64, 8)
    b = ttv.draw_samples(torch.Generator().manual_seed(7), valid, 64, 8)
    assert torch.equal(a, b)
    assert (a < 50).all()
    assert all(len(set(row.tolist())) == 8 for row in a)


def test_decompose_recover_pose():
    pts, T1, T2, uv1, uv2 = two_view(seed=4)
    Tr = np.linalg.inv(T2).astype(np.float32)
    R, tr = Tr[:3, :3], Tr[:3, 3] / np.linalg.norm(Tr[:3, 3])
    E = (np.asarray(jlie.skew(jnp.asarray(tr))) @ R).astype(np.float32)
    x1, x2 = ttv.normalize_points(t(uv1), t(K)), ttv.normalize_points(t(uv2), t(K))
    pr = ttv.recover_pose(t(E), x1, x2, torch.ones(len(uv1), dtype=torch.bool))
    np.testing.assert_allclose(pr.R.numpy(), R, atol=1e-4)
    np.testing.assert_allclose(pr.t.numpy(), tr, atol=1e-4)
    R1, R2, tt = ttv.decompose_essential(t(E))
    for Rc in (R1, R2):
        np.testing.assert_allclose((Rc @ Rc.T).numpy(), np.eye(3), atol=1e-5)
        assert abs(float(torch.linalg.det(Rc)) - 1.0) < 1e-5
