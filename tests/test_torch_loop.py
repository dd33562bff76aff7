"""tpuvo_torch's loop-closure stack vs tpuvo's: the se3 chart, DLT PnP and
RANSAC PnP (with JAX's own uniforms injected), pose-graph edge Jacobians
(including a satisfied edge), ``pgo_solve``, co-visibility (dense and
tiled), ``detect_loops`` on ties, ``close_loops`` on a small drifted loop,
and the three refiners on a short tracked fixture.

Tolerances: se3 and edge residuals/Jacobians atol 1e-5; DLT poses atol 1e-3
(fp32 12x12 eigh in another library, as the RANSAC refit in
test_torch_geometry); counts, pairs and inlier sets exact; PGO and
refined poses atol 1e-3 and landmarks rtol/atol 1e-2 (many LM iterations
of fp32 solves, each accepted on a chi comparison).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuvo.ba import loop as jloop, posegraph as jpg
from tpuvo.config import BAConfig as JBA, EngineConfig as JCfg
from tpuvo.data import synthetic
from tpuvo.engine import ba_refine as jref, vo as jvo
from tpuvo.ops import lie as jlie, pnp as jpnp
from tpuvo_torch.ba import loop as tloop, posegraph as tpg
from tpuvo_torch.config import BAConfig, EngineConfig
from tpuvo_torch.engine import ba_refine as tref
from tpuvo_torch.engine.state import state_from_numpy
from tpuvo_torch.ops import lie as tlie, pnp as tpnp
import xdist_threads  # noqa: F401  (torch's share of the cores under xdist)

CFG = JCfg()
KN = CFG.K()
KJ, KT = jnp.asarray(KN), torch.as_tensor(KN)


def T(x):
    return torch.as_tensor(np.array(x))


# ------------------------------------------------------------- se3 chart --
def test_se3_exp_log_match_jax():
    rng = np.random.default_rng(0)
    xi = rng.normal(0, 1, (64, 6)).astype(np.float32)
    xi[:8, 3:] *= 1e-7                      # the small-angle branches
    xi[8:16, 3:] = 0.0
    Ej = np.asarray(jax.jit(jax.vmap(jlie.se3_exp))(jnp.asarray(xi)))
    Et = tlie.se3_exp(T(xi))
    np.testing.assert_allclose(Et.numpy(), Ej, atol=1e-5)
    Lj = np.asarray(jax.jit(jax.vmap(jlie.se3_log))(jnp.asarray(Ej)))
    np.testing.assert_allclose(tlie.se3_log(T(Ej)).numpy(), Lj, atol=1e-5)
    inside = np.linalg.norm(xi[:, 3:], axis=1) < 3.0      # the chart's domain |θ| < π
    np.testing.assert_allclose(tlie.se3_log(Et).numpy()[inside], xi[inside], atol=1e-4)


# ------------------------------------------------------------------- PnP --
def random_pnp(seed, n=64, n_valid=None, noise_px=0.0):
    """tests/test_pnp.py:_random_pose_and_points."""
    rng = np.random.default_rng(seed)
    xi = rng.uniform(-1, 1, 6).astype(np.float32)
    xi[3:] *= 0.5
    Tw = np.array(jlie.se3_exp(jnp.asarray(xi)))
    Tw[:3, 3] = rng.uniform(-30, 30, 3)
    p_cam = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                      rng.uniform(2, 10, n)], -1).astype(np.float32)
    X = ((p_cam - Tw[:3, 3]) @ Tw[:3, :3]).astype(np.float32)
    ph = p_cam @ KN.T
    uv = (ph[:, :2] / ph[:, 2:]).astype(np.float32)
    if noise_px:
        uv = uv + noise_px * rng.standard_normal(uv.shape).astype(np.float32)
    valid = np.arange(n) < (n if n_valid is None else n_valid)
    return Tw, X, uv, valid


@pytest.mark.parametrize("seed,n_valid", [(0, 50), (1, 50), (2, 50), (3, 50), (6, 5)])
def test_pnp_dlt_matches_jax(seed, n_valid):
    """test_pnp.py's cases, batched in one call: the sign-invariant DLT
    (majority positive depth, R = U·diag(1,1,d)·Vᵀ) lands on JAX's pose."""
    Tw, X, uv, valid = random_pnp(seed, n_valid=n_valid)
    X2, uv2 = X.copy(), uv.copy()
    X2[~valid], uv2[~valid] = 1e4, -1e5          # poisoned invalid rows
    Tj, okj = jax.jit(jpnp.pnp_dlt)(KJ, jnp.asarray(X2), jnp.asarray(uv2), jnp.asarray(valid))
    Tt, okt = tpnp.pnp_dlt(KT, T(np.stack([X2, X])), T(np.stack([uv2, uv])), T(np.stack([valid] * 2)))
    assert bool(okt[0]) == bool(okj) == bool(okt[1])
    np.testing.assert_allclose(Tt[0].numpy(), np.asarray(Tj), atol=1e-3)
    np.testing.assert_allclose(Tt[1].numpy(), np.asarray(Tj), atol=1e-3)
    if n_valid >= 6:
        assert np.abs(Tt[0].numpy() - Tw).max() < 1e-3
    else:
        assert torch.equal(Tt[0], torch.eye(4))


def test_pnp_solve_matches_jax():
    Tw, X, uv, valid = random_pnp(7, noise_px=0.5)
    solve_j = jax.jit(jpnp.pnp_solve, static_argnums=(4, 5))
    Tj, okj = solve_j(KJ, jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid), 640, 480)
    Tt, okt = tpnp.pnp_solve(KT, T(X), T(uv), T(valid), 640, 480)
    assert bool(okt) == bool(okj)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-3)
    assert np.abs(Tt.numpy() - Tw).max() < 0.15


@partial(jax.jit, static_argnums=(1, 2))
def jax_uniforms(key, n, iterations=64):
    """pnp_ransac's per-hypothesis draws for ``key`` (tpuvo/ops/pnp.py)."""
    keys = jax.random.split(key, iterations)
    return jax.vmap(lambda k: jax.random.uniform(k, (n,), minval=1e-9, maxval=1.0))(keys)


def test_pnp_ransac_matches_jax_with_its_uniforms():
    """Gross outliers and points behind the camera; the port draws its
    hypotheses from JAX's own uniforms, so both pick the same samples."""
    cases = []
    for seed in (11, 12, 13):
        Tw, X, uv, valid = random_pnp(seed, n=48, noise_px=0.3)
        rng = np.random.default_rng(seed)
        bad = rng.choice(40, 8, replace=False)
        uv[bad] += rng.uniform(40, 120, (8, 2)).astype(np.float32)
        X[bad[:2]] = -X[bad[:2]]
        valid[44:] = False
        cases.append((Tw, X, uv, valid))
    keys = [jax.random.PRNGKey(s) for s in range(3)]
    U = np.stack([np.asarray(jax_uniforms(k, 48)) for k in keys])
    Tt, okt, nt = tpnp.pnp_ransac(None, KT, *(T(np.stack(a)) for a in list(zip(*cases))[1:]),
                                  640, 480, uniforms=T(U))
    ransac_j = jax.jit(jpnp.pnp_ransac, static_argnames=("width", "height"))
    for b, (Tw, X, uv, valid) in enumerate(cases):
        Tj, okj, nj = ransac_j(keys[b], KJ, jnp.asarray(X), jnp.asarray(uv),
                               jnp.asarray(valid), width=640, height=480)
        assert bool(okt[b]) == bool(okj) and int(nt[b]) == int(nj)
        np.testing.assert_allclose(Tt[b].numpy(), np.asarray(Tj), atol=1e-3)
        assert np.abs(Tt[b].numpy() - Tw).max() < 0.1
    # the generator path draws its own hypotheses (another consensus set)
    # and lands as close to the truth
    g = torch.Generator().manual_seed(5)
    Tg, okg, _ = tpnp.pnp_ransac(g, KT, *(T(np.stack(a)) for a in list(zip(*cases))[1:]), 640, 480)
    assert bool(okg.all())
    assert np.abs(Tg.numpy() - np.stack([c[0] for c in cases])).max() < 0.1


def test_topk_stable_breaks_ties_by_lower_index():
    x = T(np.array([3.0, 5.0, 5.0, 1.0, 5.0, 3.0, 3.0], np.float32))
    got = tpnp.topk_stable(x, 5)
    want = np.asarray(jax.lax.top_k(jnp.asarray(x.numpy()), 5)[1])
    assert np.array_equal(got.numpy(), want) and list(want) == [1, 2, 4, 0, 5]


# ------------------------------------------------------------- pose graph --
def circle_gt(F=24, radius=5.0):
    v = [[radius * np.cos(2 * np.pi * k / F), radius * np.sin(2 * np.pi * k / F), 0, 0, 0,
          2 * np.pi * k / F + np.pi / 2] for k in range(F)]
    return tlie.se3_exp(T(np.asarray(v, np.float32))).numpy()


def noisy_chain(gt, seed=3, sigma_t=0.03, sigma_r=0.01):
    rng = np.random.default_rng(seed)
    rels, poses = [], [gt[0]]
    for i in range(gt.shape[0] - 1):
        Z = np.linalg.inv(gt[i]) @ gt[i + 1]
        n = np.concatenate([sigma_t * rng.standard_normal(3), sigma_r * rng.standard_normal(3)])
        Zn = tlie.se3_exp(T(n.astype(np.float32))).numpy() @ Z
        rels.append(Zn)
        poses.append(poses[-1] @ Zn)
    return np.stack(rels).astype(np.float32), np.stack(poses).astype(np.float32)


def test_edge_jacobians_match_jax_including_a_satisfied_edge():
    """jacfwd under vmap == JAX's jacfwd; on a satisfied edge (r = 0, the
    rotation error exactly I) the Jacobian stays finite."""
    gt = circle_gt(12)
    rels, dead = noisy_chain(gt)
    Ti, Tj = dead[:-1], dead[1:]
    Z = np.concatenate([rels[:5], np.linalg.inv(Ti[5:]) @ Tj[5:]]).astype(np.float32)
    rt, Jit, Jjt = tpg._edge_lin(T(Ti), T(Tj), T(Z))
    out = jax.jit(jax.vmap(jpg._edge_lin))(jnp.asarray(Ti), jnp.asarray(Tj), jnp.asarray(Z))
    for a, b in zip((rt, Jit, Jjt), out):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    assert torch.isfinite(Jit).all() and torch.isfinite(Jjt).all()
    sat = torch.eye(4).expand(1, 4, 4)
    r0, Ji0, Jj0 = tpg._edge_lin(sat, sat, sat)
    assert torch.equal(r0, torch.zeros(1, 6))
    assert torch.isfinite(Ji0).all()
    np.testing.assert_allclose(Jj0[0].numpy(), np.eye(6), atol=1e-6)
    np.testing.assert_allclose(Ji0[0].numpy(), -np.eye(6), atol=1e-6)


def test_pgo_solve_matches_jax():
    gt = circle_gt(24)
    rels, dead = noisy_chain(gt, seed=5)
    F = 24
    lc = [(0, 12), (3, 21), (0, 23)]
    eij = np.concatenate([np.stack([np.arange(F - 1), np.arange(1, F)], -1), lc]).astype(np.int32)
    eT = np.concatenate([rels, np.stack([np.linalg.inv(gt[i]) @ gt[j] for i, j in lc])])
    ew = np.concatenate([np.ones(F - 1), np.full(3, 10.0)]).astype(np.float32)
    fields = dict(poses=dead, edges_ij=eij, edges_T=eT.astype(np.float32), edges_w=ew,
                  fixed=np.arange(F) == 0)
    gj = jpg.PoseGraph(**{k: jnp.asarray(v) for k, v in fields.items()})
    gt_ = tpg.graph_from_numpy(gj, "cpu")
    lin_j = jax.jit(jpg.linearize_pgo)
    for thr in (1.0, 1e8):
        Hj, bj, cj, nj = lin_j(gj, thr)
        Ht, bt, ct, nt = tpg.linearize_pgo(gt_, thr, tpg.assembly_plans(gt_))
        np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), atol=1e-3, rtol=1e-5)
        np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=1e-4)
        assert int(nt) == int(nj)
        oj, sj = jpg.pgo_solve(gj, iterations=15, kernel_threshold=thr)
        ot, st = tpg.pgo_solve(gt_, iterations=15, kernel_threshold=thr)
        np.testing.assert_allclose(ot.poses.numpy(), np.asarray(oj.poses), atol=1e-3)
        np.testing.assert_allclose(float(st.chi), float(sj.chi), rtol=1e-3, atol=1e-6)
        assert int(st.num_inliers) == int(sj.num_inliers)
    ate = lambda p: float(np.sqrt(np.mean(np.sum((p[:, :3, 3] - gt[:, :3, 3]) ** 2, -1))))
    assert ate(ot.poses.numpy()) < 0.5 * ate(dead)
    assert tpg.graph_to_numpy(gt_)["edges_ij"].dtype == np.int64


def test_graph_builders_match_jax():
    gt = circle_gt(20)
    _, dead = noisy_chain(gt, seed=7)
    for a, b in zip(tpg.odometry_edges(T(dead), 2.0), jpg.odometry_edges(jnp.asarray(dead), 2.0)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    we_t = tpg.window_edges(T(dead), window=8, step=4, skip=2)
    we_j = jpg.window_edges(jnp.asarray(dead), window=8, step=4, skip=2)
    for a, b in zip(we_t, we_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    gt_ = tpg.build_graph(dead, extra_edges=[we_t])
    gj = jpg.build_graph(dead, extra_edges=[we_j])
    for k in tpg.PoseGraph._fields:
        np.testing.assert_allclose(getattr(gt_, k).numpy(), np.asarray(getattr(gj, k)), atol=1e-5)
    out, _ = tpg.pgo_solve(gt_, iterations=10)
    np.testing.assert_allclose(out.poses.numpy()[:, :3, 3], dead[:, :3, 3], atol=1e-2)


# ---------------------------------------------------------- co-visibility --
def test_covisibility_dense_and_tiled_match_jax():
    rng = np.random.default_rng(0)
    F, N, L = 37, 24, 1000
    lm = rng.integers(0, L, (F, N)).astype(np.int32)
    lm[0, :4] = lm[0, 0]                                  # duplicate ids in a frame
    valid = rng.random((F, N)) < 0.8
    dense_j = np.asarray(jloop.covisibility_counts(jnp.asarray(lm), jnp.asarray(valid), L))
    dense_t = tloop.covisibility_counts(T(lm), T(valid), L)
    assert np.array_equal(dense_t.numpy(), dense_j)
    for tile in (64, 128, 333):
        assert np.array_equal(tloop.covisibility_counts(T(lm), T(valid), L, tile).numpy(), dense_j)
    C = tloop.covisibility_counts(T(np.array([[5, 99_000, 0], [99_000, 5, 1]])), torch.ones(2, 3, dtype=torch.bool), 100_000)
    assert np.array_equal(C.numpy(), [[3, 2], [2, 3]])   # auto-tiled above 16k


def test_detect_loops_ties_match_jax_top_k():
    """Integer counts tie across the top-k cut: the port keeps JAX's order
    (lower flat index first)."""
    F = 12
    C = np.zeros((F, F), np.float32)
    for i, j in [(0, 9), (1, 10), (2, 11), (0, 11), (1, 9), (2, 10)]:
        C[i, j] = C[j, i] = 20.0                          # six pairs tie at 20
    C[0, 10] = C[10, 0] = 30.0
    C[0, 2] = C[2, 0] = 50.0                              # gap too small
    C[3, 11] = C[11, 3] = 5.0                             # too few shared
    for k in (2, 4, 8):
        pj, sj, vj = jloop.detect_loops(jnp.asarray(C), 5, 10, k)
        pt, st, vt = tloop.detect_loops(T(C), 5, 10, k)
        assert np.array_equal(pt.numpy(), np.asarray(pj)), k
        assert np.array_equal(vt.numpy(), np.asarray(vj)), k
        assert np.array_equal(st.numpy(), np.asarray(sj)), k
    assert [tuple(p) for p in pt.numpy()[:4]] == [(0, 10), (0, 9), (0, 11), (1, 9)]


# --------------------------------------------------------- loop + refine --
def loop_fixture(F=48, seed=3):
    """A small drifted loop: GT camera poses with a growing drift twist, the
    world landmarks as the map, and the renderer's GT ids as matches."""
    gt = synthetic.make_loop_trajectory(F, step=0.5, seed=seed, turn_frames=6)
    ext = float(np.abs(gt[:, :2]).max()) + 10.0
    world = synthetic.make_world(seed, n_landmarks=1500, xy_extent=ext, z_range=(0.0, 6.0))
    seq = synthetic.render_sequence(world, gt, CFG, pixel_noise=0.3, seed=seed)
    poses = np.stack([synthetic.camera_pose_from_gt(g, CFG) for g in gt]).astype(np.float32)
    drift = np.array([0.4, -0.3, 0.1, 0.0, 0.0, 0.08], np.float32)
    xi = np.linspace(0, 1, F, dtype=np.float32)[:, None] * drift
    drifted = (tlie.se3_exp(T(xi)).numpy() @ poses).astype(np.float32)
    obs_lm = np.where(seq.valid, seq.id_real, 0).astype(np.int32)
    return seq, world, poses, drifted, obs_lm


def test_close_loops_matches_jax():
    seq, world, gt_poses, drifted, obs_lm = loop_fixture()
    F, N = obs_lm.shape
    mv = np.ones(world.xyz.shape[0], bool)
    args = (drifted, world.xyz, mv, seq.uv, obs_lm, seq.valid)
    pj, nj, cj = jloop.close_loops(KJ, *map(jnp.asarray, args), 640, 480)
    pairs_j = jax.jit(lambda lm, v: jloop.detect_loops(
        jloop.covisibility_counts(lm, v, mv.shape[0]), 30, 12, 32)[0])
    pairs = pairs_j(jnp.asarray(obs_lm), jnp.asarray(seq.valid))
    key = jax.random.PRNGKey(0)
    U = np.stack([np.asarray(jax_uniforms(jax.random.fold_in(key, int(i) * F + int(j)), N))
                  for i, j in np.asarray(pairs)])
    pt, nt, ct = tloop.close_loops(KT, *map(T, args), 640, 480, uniforms=T(U))
    assert int(nt) == int(nj) > 0
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-3)
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-2, atol=1e-4)
    ate = lambda p: float(np.sqrt(np.mean(np.sum((p[:, :3, 3] - gt_poses[:, :3, 3]) ** 2, -1))))
    assert ate(pt.numpy()) < 0.5 * ate(drifted)
    # the generator path: its own draws, the same repair
    pg, ng, _ = tloop.close_loops(KT, *map(T, args), 640, 480)
    assert int(ng) == int(nt) and ate(pg.numpy()) < 0.5 * ate(drifted)


def pnp_cases():
    """test_pnp_ransac_matches_jax_with_its_uniforms's three problems."""
    cases = []
    for seed in (11, 12, 13):
        _, X, uv, valid = random_pnp(seed, n=48, noise_px=0.3)
        rng = np.random.default_rng(seed)
        uv[rng.choice(40, 8, replace=False)] += rng.uniform(40, 120, (8, 2)).astype(np.float32)
        valid[44:] = False
        cases.append((X, uv, valid))
    return [T(np.stack(a)) for a in zip(*cases)]


def polish_run(fn):
    """(the call, its batch shape, the polish threshold, the PICP rounds)"""
    if fn == "close_loops":
        seq, world, _, drifted, obs_lm = loop_fixture()
        args = (drifted, world.xyz, np.ones(world.xyz.shape[0], bool), seq.uv, obs_lm,
                seq.valid)
        return lambda: tloop.close_loops(KT, *map(T, args), 640, 480)[0], (32,), 9 * 64.0
    X, uv, valid = pnp_cases()
    if fn == "pnp_ransac":
        g = lambda: torch.Generator().manual_seed(5)
        return lambda: tpnp.pnp_ransac(g(), KT, X, uv, valid, 640, 480)[0], (3,), 9 * 64.0
    shape = lambda a: a[[0, 1, 2, 2, 1, 0]].reshape((2, 3) + a.shape[1:])  # two batch axes
    return (lambda: tpnp.pnp_solve(KT, shape(X), shape(uv), shape(valid), 640, 480)[0],
            (2, 3), 1.0e6)


@pytest.mark.parametrize("fn", ["pnp_ransac", "pnp_solve", "close_loops"])
def test_pnp_polish_launches_the_kernel_on_the_card_only(monkeypatch, fn):
    """The PnP polish (the RANSAC refit's, pnp_solve's, and so close_loops'
    E = 32 loop pairs) on a CUDA device: ONE kernel call for the whole
    batch, per-observation points (corr_idx None), its threshold (9 thr^2
    or pnp_solve's permissive one), 10 rounds at rel-chi 1e-6 and the
    caller's K tensor, no plain loop; on the CPU the plain loop once and
    never the kernel.  The kernel's stand-in is the plain solve of what it
    was handed, so both routes give the same poses bit for bit."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_picp import kernel_route

    run, batch, thr = polish_run(fn)
    poses = {}
    for card in (True, False):
        with monkeypatch.context() as mp:
            seen = kernel_route(mp, card)
            poses[card] = run()
        if card:
            assert seen["plain"] == [] and len(seen["kernel"]) == 1
            call = seen["kernel"][0]
            assert call["batch"] == batch and not call["gathered"] and call["thr"] == thr
            assert call["K"] is KT
            assert (call["cfg"].max_iterations, call["cfg"].convergence_threshold,
                    call["cfg"].annealed_kernel) == (10, 1e-6, False)
        else:
            assert seen == {"kernel": [], "plain": ["solve"]}
    assert torch.equal(poses[True], poses[False])


@pytest.fixture(scope="module")
def tracked():
    """A 12-frame JAX tracker run: its state, poses and sequence."""
    cfg = JCfg(mode="fixed", map_capacity=512)
    world = synthetic.make_world(21, n_landmarks=600, xy_extent=9.0)
    gt = synthetic.make_planar_trajectory(12, step=0.25, turn=0.03, seed=21)
    seq = synthetic.render_sequence(world, gt, cfg, pixel_noise=0.4, seed=21)
    state, _, poses, _ = jvo.run_sequence(seq, cfg)
    return cfg, seq, state, np.asarray(poses)


@pytest.mark.parametrize("which", ["global", "windowed", "loop"])
def test_refiners_match_jax(tracked, which):
    jc, seq, sj, poses = tracked
    tc = EngineConfig(mode="fixed", map_capacity=512)
    st = state_from_numpy(sj, "cpu")
    if which == "global":
        kw = dict(window=12, iterations=6)
        oj = jref.refine_trajectory_global(sj, seq, poses, jc, JBA(**kw), n_sweeps=2, max_sweeps=3)
        ot = tref.refine_trajectory_global(st, seq, poses, tc, BAConfig(**kw), n_sweeps=2,
                                           max_sweeps=3)
    elif which == "windowed":
        oj = jref.refine_trajectory(sj, seq, poses, jc, JBA(window=6, iterations=4))
        ot = tref.refine_trajectory(st, seq, poses, tc, BAConfig(window=6, iterations=4))
    else:
        kw = dict(window=12, iterations=6, huber_threshold=500.0)
        oj = jref.refine_trajectory_loop(sj, seq, poses, jc, JBA(**kw), n_sweeps=2)
        ot = tref.refine_trajectory_loop(st, seq, poses, tc, BAConfig(**kw), n_sweeps=2)
    np.testing.assert_allclose(ot[0].numpy(), np.asarray(oj[0]), atol=1e-3)
    v = np.asarray(sj.map_valid)
    np.testing.assert_allclose(ot[1].numpy()[v], np.asarray(oj[1])[v], rtol=1e-2, atol=1e-2)
    assert len(ot[2]) == len(oj[2])
    for a, b in zip(ot[2], oj[2]):
        assert a.keys() == b.keys()
        for k in a:
            if k == "chi":
                np.testing.assert_allclose(a[k], b[k], rtol=1e-3, atol=1e-6)
            else:
                assert a[k] == b[k], k
