"""tpuvo_torch vs tpuvo: config mirror, synthetic data, lie, camera and
small linear algebra, on the same numpy inputs (CPU).

Tolerance: rtol 1e-5 (with atol 1e-6 for entries near zero) — both sides
are fp32 with the same formulas; only the order of a few sums differs.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuvo.config as jcfg
import tpuvo_torch.config as tcfg
from tpuvo.data import synthetic as jsyn
from tpuvo.ops import camera as jcam, lie as jlie, linalg_small as jla
from tpuvo_torch.data import synthetic as tsyn
from tpuvo_torch.ops import camera as tcam, lie as tlie, linalg_small as tla
import xdist_threads  # noqa: F401  (torch's share of the cores under xdist)

RTOL, ATOL = 1e-5, 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def close(got, ref, rtol=RTOL, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


def t(x):
    return torch.as_tensor(np.array(x))


# ---------------------------------------------------------------- config --
@pytest.mark.parametrize("name", ["MatcherConfig", "PICPConfig", "RansacConfig",
                                  "BAConfig", "EngineConfig"])
def test_config_mirror(name):
    """Same field names and defaults, so one set of kwargs builds both."""
    jf = [(f.name, f.default if f.default is not dataclasses.MISSING else f.default_factory())
          for f in dataclasses.fields(getattr(jcfg, name))]
    tf = [(f.name, f.default if f.default is not dataclasses.MISSING else f.default_factory())
          for f in dataclasses.fields(getattr(tcfg, name))]
    assert [n for n, _ in jf] == [n for n, _ in tf]
    for (n, jd), (_, td) in zip(jf, tf):
        if dataclasses.is_dataclass(jd):
            jd, td = dataclasses.asdict(jd), dataclasses.asdict(td)
        assert jd == td, n


@pytest.mark.parametrize("kw", [{}, {"mode": "fixed"}, {"gate_new_landmarks": False, "mode": "fixed"},
                                {"fx": 200.0, "cy": 250.0}])
def test_config_derived(kw):
    j, p = jcfg.EngineConfig(**kw), tcfg.EngineConfig(**kw)
    assert j.gating_enabled == p.gating_enabled
    for fn in ("K", "cam_to_image", "mount_T"):
        assert np.array_equal(getattr(j, fn)(), getattr(p, fn)())


# ------------------------------------------------------------- synthetic --
def test_synthetic_bit_identical():
    cfg_j, cfg_t = jcfg.EngineConfig(), tcfg.EngineConfig()
    wj, wt = jsyn.make_world(3, 400, 7.0), tsyn.make_world(3, 400, 7.0)
    for a, b in zip(wj, wt):
        assert np.array_equal(a, b)
    assert np.array_equal(jsyn.make_planar_trajectory(20, seed=3),
                          tsyn.make_planar_trajectory(20, seed=3))
    assert np.array_equal(jsyn.make_loop_trajectory(60, seed=3),
                          tsyn.make_loop_trajectory(60, seed=3))
    gt = jsyn.make_planar_trajectory(12, seed=3)
    sj = jsyn.render_sequence(wj, gt, cfg_j, pixel_noise=0.3, descriptor_noise=0.01, seed=3)
    st = tsyn.render_sequence(wt, gt, cfg_t, pixel_noise=0.3, descriptor_noise=0.01, seed=3)
    for a, b in zip(sj, st):
        assert np.array_equal(a, b)


# ------------------------------------------------------------------- lie --
def _vecs(n=16, seed=0):
    return np.random.default_rng(seed).normal(0, 0.5, (n, 6)).astype(np.float32)


def test_lie_v2t_inv_transform():
    v = _vecs()
    close(tlie.v2t_euler(t(v)), jlie.v2t_euler(jnp.asarray(v)))
    T = np.asarray(jlie.v2t_euler(jnp.asarray(v)))
    close(tlie.inv_se3(t(T)), jlie.inv_se3(jnp.asarray(T)))
    pts = np.random.default_rng(1).normal(0, 3, (16, 20, 3)).astype(np.float32)
    close(tlie.transform_points(t(T), t(pts)), jlie.transform_points(jnp.asarray(T), jnp.asarray(pts)),
          atol=1e-5)
    R, tr = T[:, :3, :3], T[:, :3, 3]
    close(tlie.rt_to_T(t(R), t(tr)), jlie.rt_to_T(jnp.asarray(R), jnp.asarray(tr)))


def test_lie_scale_motion_so3():
    T = np.asarray(jlie.v2t_euler(jnp.asarray(_vecs(1, 2)[0] * 0.3)))
    for alpha in (0.5, 1.0, 0.0):
        close(tlie.scale_motion(t(T), alpha), jlie.scale_motion(jnp.asarray(T), alpha))
    w = _vecs(8, 3)[:, 3:]
    close(tlie.so3_exp(t(w)), jlie.so3_exp(jnp.asarray(w)))
    R = np.asarray(jlie.so3_exp(jnp.asarray(w)))
    close(tlie.so3_log(t(R)), jlie.so3_log(jnp.asarray(R)), atol=1e-5)


@pytest.mark.parametrize("alpha", [0.5, 0.0, 1.0])
def test_motion_model_written_out_products(alpha):
    """The motion model's products in the card's written-out form
    (``linalg_small.matmul_terms``, here on CPU tensors): the prediction
    pose @ step, the velocity inv(pose) @ new pose and ``scale_motion``'s
    square, against JAX's ``@`` and vmapped ``lie.scale_motion`` on seeded
    poses."""
    rng = np.random.default_rng(21)
    P, N, V = (np.asarray(jlie.v2t_euler(jnp.asarray(
        rng.normal(0, s, (16, 6)).astype(np.float32)))) for s in (1.0, 1.0, 0.1))
    close(tla.matmul_terms(t(P), t(V)), jnp.asarray(P) @ jnp.asarray(V), rtol=0, atol=1e-6)
    close(tla.matmul_terms(tlie.inv_se3(t(P)), t(N)),
          jlie.inv_se3(jnp.asarray(P)) @ jnp.asarray(N), rtol=0, atol=1e-6)
    Vt = t(V)
    R = tlie._so3_exp(alpha * tlie.so3_log(Vt[:, :3, :3]), tla.matmul_terms)
    close(tlie.rt_to_T(R, alpha * Vt[:, :3, 3]),
          jax.vmap(lambda T: jlie.scale_motion(T, alpha))(jnp.asarray(V)), rtol=0, atol=1e-6)


def test_lie_augment_wrap_umeyama():
    rng = np.random.default_rng(4)
    xyt = rng.normal(0, 2, (10, 3)).astype(np.float32)
    close(tlie.augment_pose(t(xyt)), jlie.augment_pose(jnp.asarray(xyt)))
    a = rng.uniform(-10, 10, 50).astype(np.float32)
    close(tlie.wrap_angle(t(a)), jlie.wrap_angle(jnp.asarray(a)), atol=1e-5)
    src = rng.normal(0, 3, (40, 3)).astype(np.float32)
    Ts = np.asarray(jlie.v2t_euler(jnp.asarray(_vecs(1, 5)[0])))
    dst = (1.7 * src @ Ts[:3, :3].T + Ts[:3, 3] + rng.normal(0, 0.01, (40, 3))).astype(np.float32)
    # SVD runs in another library: 1e-4 covers its last-digit differences
    close(tlie.umeyama(t(src), t(dst)), jlie.umeyama(jnp.asarray(src), jnp.asarray(dst)),
          rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- camera --
def test_camera_projection():
    K = jcfg.EngineConfig().K()
    rng = np.random.default_rng(6)
    pts = rng.uniform(-6, 6, (200, 3)).astype(np.float32)
    T = np.asarray(jlie.v2t_euler(jnp.asarray(_vecs(1, 6)[0] * 0.2)))
    uv_j, ok_j, pc_j, ph_j = jcam.project_points_with_cam(jnp.asarray(K), jnp.asarray(T),
                                                          jnp.asarray(pts), 640, 480)
    uv_t, ok_t, pc_t, ph_t = tcam.project_points_with_cam(t(K), t(T), t(pts), 640, 480)
    assert np.array_equal(ok_t.numpy(), np.asarray(ok_j))
    m = np.asarray(ok_j)
    close(uv_t[m], np.asarray(uv_j)[m], rtol=1e-5, atol=1e-3)
    close(pc_t, pc_j, atol=1e-5)
    close(ph_t, ph_j, atol=1e-3)
    uv2, ok2 = tcam.project_points(t(K), t(T), t(pts), 640, 480)
    assert np.array_equal(ok2.numpy(), m)


# ---------------------------------------------------------- linalg_small --
def _spd(n, batch, seed):
    A = np.random.default_rng(seed).normal(0, 1, (batch, n, n)).astype(np.float32)
    return (A @ A.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)).astype(np.float32)


def test_linalg_small_3x3():
    A = _spd(3, 20, 7)
    b = np.random.default_rng(8).normal(0, 1, (20, 3)).astype(np.float32)
    close(tla.det3(t(A)), jla.det3(jnp.asarray(A)), rtol=1e-5)
    close(tla.inv3(t(A)), jla.inv3(jnp.asarray(A)), rtol=1e-5, atol=1e-6)
    close(tla.solve3(t(A), t(b)), jla.solve3(jnp.asarray(A), jnp.asarray(b)), atol=1e-5)


def test_linalg_small_cholesky_eig_dlt():
    H = _spd(6, 10, 9)
    g = np.random.default_rng(10).normal(0, 1, (10, 6)).astype(np.float32)
    close(tla.cholesky_solve6(t(H), t(g)), jla.cholesky_solve6(jnp.asarray(H), jnp.asarray(g)),
          atol=1e-5)
    B = np.random.default_rng(11).normal(0, 1, (5, 12, 9)).astype(np.float32)
    AtA = B.transpose(0, 2, 1) @ B
    close(tla.smallest_eigvec_inverse_iteration(t(AtA)),
          jla.smallest_eigvec_inverse_iteration(jnp.asarray(AtA)), atol=1e-4)
    A = np.random.default_rng(12).normal(0, 1, (30, 4, 4)).astype(np.float32)
    Xt, dt = tla.solve_dlt3(t(A))
    Xj, dj = jla.solve_dlt3(jnp.asarray(A))
    close(Xt, Xj, rtol=1e-4, atol=1e-5)
    close(dt, dj, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------- no JAX --
def test_port_runs_without_jax():
    """The port imports no JAX: with ``jax`` made unimportable, the CLI and
    the bench import and a 10-frame run_sequence still runs on the CPU."""
    code = """
import sys
sys.modules["jax"] = None
import numpy as np
import tpuvo_torch
import tpuvo_torch.bench
import tpuvo_torch.cli
from tpuvo_torch.config import EngineConfig
from tpuvo_torch.data import synthetic
from tpuvo_torch.engine.vo import run_sequence
cfg = EngineConfig(map_capacity=256)
w = synthetic.make_world(1, 300, 8.0)
seq = synthetic.render_sequence(w, synthetic.make_planar_trajectory(10, seed=1), cfg, seed=1)
_, logs, poses, _ = run_sequence(seq, cfg, device="cpu")
assert poses.shape == (10, 4, 4) and bool(poses.isfinite().all())
assert not any(m == "jax" or m.startswith(("jax.", "tpuvo.")) for m in sys.modules
               if sys.modules[m] is not None)
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_lie_axis_rotations_quat_yaw():
    """rx, ry, v2t_quat, quat_to_rot, yaw against the JAX twins, on
    tests/test_lie.py's cases and random batches."""
    a = np.random.default_rng(6).uniform(-np.pi, np.pi, 12).astype(np.float32)
    for name in ("rx", "ry", "rz"):
        close(getattr(tlie, name)(t(a)), getattr(jlie, name)(jnp.asarray(a)))
        R = getattr(tlie, name)(torch.tensor(0.3))
        close(R @ R.T, np.eye(3), atol=1e-6)
    v = np.array([1.0, 2.0, 3.0, 0.1, -0.2, 0.3], np.float32)
    close(tlie.v2t_euler(t(v))[:3, :3],
          tlie.rx(torch.tensor(0.1)) @ tlie.ry(torch.tensor(-0.2)) @ tlie.rz(torch.tensor(0.3)),
          atol=1e-6)
    qv = np.concatenate([_vecs(10, 7)[:, :3], np.random.default_rng(7).uniform(
        -0.6, 0.6, (10, 3))], 1).astype(np.float32)
    qv = np.concatenate([qv, [[0, 0, 0, 0.1, 0.2, 0.05], [0, 0, 0, 1.0, 1.0, 1.0]]]).astype(
        np.float32)  # the w >= 1 branch last: identity rotation
    close(tlie.v2t_quat(t(qv)), jlie.v2t_quat(jnp.asarray(qv)))
    close(tlie.v2t_quat(t(qv[-1]))[:3, :3], np.eye(3))
    q = np.random.default_rng(8).normal(size=(9, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    close(tlie.quat_to_rot(t(q)), jlie.quat_to_rot(jnp.asarray(q)))
    T = np.asarray(jlie.v2t_euler(jnp.asarray(_vecs())))
    close(tlie.yaw(t(T)), jlie.yaw(jnp.asarray(T)))
