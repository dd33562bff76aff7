"""tpuvo_torch.ba.window vs tpuvo.ba.window on the same numpy-seeded windows
(W=8, L=256, the windows of tests/test_ba.py:make_ba_problem).

Tolerances: normal-equation blocks rtol 1e-5 of each block's largest
entry (fp32 sums in another order); the reduced camera matrix S entry by
entry to the forward error of its sums (``schur_bound``); solved poses
atol 1e-5, points atol 1e-3 (a landmark seen twice at 0.3 px noise moves
~1e-4 per 1e-7 of pose); integer stats and renumberings exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuvo.ba import window as jw
from tpuvo.config import BAConfig as JBA, EngineConfig as JCfg
from tpuvo.data import synthetic
from tpuvo.ops import lie as jlie
from tpuvo_torch.ba import assembly, window as tw
from tpuvo_torch.config import BAConfig, EngineConfig
from tpuvo_torch.ops import lie as tl
from tpuvo_torch.ops.cuda import schur
from tpuvo_torch.ops.linalg_small import cholesky_solve_nan
import xdist_threads  # noqa: F401  (torch's share of the cores under xdist)

CFG = JCfg()
KN = CFG.K()
KJ, KT = jnp.asarray(KN), torch.as_tensor(KN)
WH = (CFG.width, CFG.height)
# JAX's functions jitted once per config: called eagerly, JAX compiles
# every primitive on its own, and a fresh fori_loop body on every call
se3_exp_j = jax.jit(jlie.se3_exp)
linearize_j = jax.jit(jw.linearize_ba, static_argnums=(2, 3, 4))
ba_step_j = jax.jit(jw.ba_step, static_argnums=(2, 3, 4))
ba_solve_j = jax.jit(jw.ba_solve, static_argnums=(2, 3, 4), static_argnames=("compact",))
per_obs_blocks_j = jax.jit(jw._per_obs_blocks, static_argnums=(5, 6, 7, 8, 9))
eval_robust_chi_j = jax.jit(jw.eval_robust_chi, static_argnums=(2, 3, 4))
invert_hll_j, schur_parts_j, finalize_reduced_j, schur_reduce_j, backsubstitute_j = map(
    jax.jit, (jw.invert_hll, jw.schur_parts, jw.finalize_reduced, jw.schur_reduce,
              jw.backsubstitute))


def make_problem(W=8, L=256, noise_px=0.3, pose_noise=0.02, point_noise=0.03, seed=3):
    """tests/test_ba.py:make_ba_problem as numpy fields (poses 0, 1 fixed)."""
    rng = np.random.default_rng(seed)
    world = synthetic.make_world(seed, n_landmarks=L, xy_extent=6.0)
    gt = synthetic.make_planar_trajectory(W, step=0.25, turn=0.05, seed=seed)
    seq = synthetic.render_sequence(world, gt, CFG, pixel_noise=noise_px, seed=seed)
    poses = np.stack([np.linalg.inv(synthetic.camera_pose_from_gt(g, CFG)) for g in gt])
    poses = poses.astype(np.float32)
    for i in range(2, W):
        xi = pose_noise * rng.standard_normal(6).astype(np.float32)
        poses[i] = np.asarray(se3_exp_j(jnp.asarray(xi))) @ poses[i]
    points = world.xyz + point_noise * rng.standard_normal(world.xyz.shape)
    fixed = np.arange(W) < 2
    return dict(poses=poses, points=points.astype(np.float32), obs_uv=seq.uv[:W],
                obs_lm=np.where(seq.valid, seq.id_real, 0).astype(np.int32)[:W],
                obs_valid=seq.valid[:W], point_valid=np.ones(L, bool), fixed=fixed)


def both(fields):
    return (jw.BAProblem(**{k: jnp.asarray(v) for k, v in fields.items()}),
            tw.problem_from_numpy(fields, "cpu"))


def close_rel(t, j, rtol=1e-5, msg=""):
    j = np.asarray(j)
    scale = max(float(np.abs(j).max()), 1.0)
    np.testing.assert_allclose(t.numpy(), j, atol=rtol * scale, rtol=0, err_msg=msg)


EPS = float(np.finfo(np.float32).eps)


def schur_bound(Hpp, Wfl, Hll_inv_t, Hll_inv_j):
    """Entrywise bound (6W, 6W) on the difference of two float32
    evaluations of S = Hpp - Σ_l W_l Hll⁻¹_l W_lᵀ, computed in float64 from
    the inputs.  Each evaluation forms W Hll⁻¹ (3-term sums: eps·3 of
    |W||Hll⁻¹||W|ᵀ once multiplied by W) and sums 3L products and Hpp
    into each entry (eps·(3L + 1) of the magnitudes summed into it); the
    two Hll⁻¹, each of the same Hll and held to each other by
    ``invert_hll``'s comparison, differ by their own difference carried
    through W.  S cancels most of Hpp, so a bound relative to S, or to
    max |Hpp|, is not one the sums obey."""
    Hpp, W, Ht, Hj = (np.asarray(x, np.float64) for x in (Hpp, Wfl, Hll_inv_t, Hll_inv_j))
    nW, L = Hpp.shape[0], W.shape[0]
    aW = np.abs(W)
    WH = np.einsum("lfij,ljk->lfik", W, Hj)
    summed = (np.einsum("lfik,lgjk->figj", np.abs(WH), aW)
              + np.einsum("fij,fg->figj", np.abs(Hpp), np.eye(nW)))
    chained = np.einsum("lfij,ljk,lgmk->figm", aW, np.abs(Hj), aW)
    inverses = np.einsum("lfij,ljk,lgmk->figm", aW, np.abs(Ht - Hj), aW)
    one = EPS * (3 * chained + (3 * L + 1) * summed)
    return (2 * one + inverses).reshape(6 * nW, 6 * nW)


def assert_within(t, j, bound, what):
    d = np.abs(np.asarray(t, np.float64) - np.asarray(j, np.float64))
    worst = float(np.max(d / np.maximum(bound, 1e-300)))
    assert worst <= 1.0, f"{what}: {worst:.3g} times its bound"


LIN_CFGS = {
    "default": {},
    "refine": dict(cull_bounds=False, keep_outliers=True, huber_threshold=1e8),
    # robust weights on most rows; keep_outliers keeps the weight continuous
    # (a hard inlier cut at 0.5 px² flips rows on 1e-7 differences)
    "robust": dict(huber_threshold=0.5, keep_outliers=True),
}
# sqrt(thr/chi) turns chi's fp32 rounding at small chi into a ~1e-4
# relative change of the weight
LIN_RTOL = {"default": 1e-5, "refine": 1e-5, "robust": 1e-4}


@pytest.mark.parametrize("name", sorted(LIN_CFGS))
@pytest.mark.parametrize("assembly", ["segsum", "onehot"])
def test_linearize_matches_jax(name, assembly):
    """The port's one index_add_ assembly against both of JAX's."""
    jp, tp = both(make_problem())
    kw = LIN_CFGS[name]
    lj = linearize_j(jp, KJ, *WH, JBA(assembly=assembly, **kw))
    lt = tw.linearize_ba(tp, KT, *WH, BAConfig(assembly=assembly, **kw), tw.assembly_plans(tp))
    for i, k in enumerate(("Hpp", "bp", "Hll", "bl", "Wfl")):
        assert lt[i].shape == lj[i].shape, k
        close_rel(lt[i], lj[i], LIN_RTOL[name], msg=k)
    np.testing.assert_allclose(float(lt[5].chi), float(lj[5].chi), rtol=1e-5)
    assert int(lt[5].num_inliers) == int(lj[5].num_inliers)
    assert int(lt[5].num_obs) == int(lj[5].num_obs)


def test_per_obs_blocks_match_jax():
    p = make_problem(W=2)
    X = p["points"][p["obs_lm"][1]]
    args = (p["poses"][1], X, p["obs_uv"][1], p["obs_valid"][1])
    oj = per_obs_blocks_j(KJ, *map(jnp.asarray, args), *WH, 3000.0, False, True)
    ot = tw._per_obs_blocks(KT, *map(torch.as_tensor, args), *WH, 3000.0, False, True)
    for a, b in zip(ot, oj):
        if a.dtype == torch.bool:
            assert np.array_equal(a.numpy(), np.asarray(b))
        else:
            close_rel(a, b)


def schur_inputs():
    p = make_problem()
    lj = linearize_j(both(p)[0], KJ, *WH, JBA())
    return p, lj, [torch.as_tensor(np.array(x)) for x in lj[:5]]


def assert_schur_matches_jax(lt, lj, fixed, damping):
    """schur_parts' and schur_reduce's S against JAX's, entry by entry
    within ``schur_bound`` (the gauge-fixed S: its free block scaled as
    finalize_reduced scales it, plus that step's own rounding)."""
    Sj, bj, Hj = schur_parts_j(*lj[:5], damping)
    St, bt, Ht = tw.schur_parts(*lt, damping)
    bound = schur_bound(lj[0], lj[4], Ht, Hj)
    assert_within(St, Sj, bound, "S")
    close_rel(bt, bj, msg="b_red")
    Rj = schur_reduce_j(*lj[:5], jnp.asarray(fixed), damping)
    Rt = tw.schur_reduce(*lt, torch.as_tensor(fixed), damping)
    free = np.repeat(~fixed, 6)
    scale = np.outer(free, free) * (1.0 + damping * np.eye(free.size))
    assert_within(Rt[0], Rj[0], bound * scale + 4 * EPS * np.abs(np.asarray(Rj[0])), "S reduced")
    close_rel(Rt[2], Rj[2])


def test_schur_pieces_match_jax():
    """invert_hll, schur_parts, finalize_reduced, schur_reduce,
    backsubstitute and eval_robust_chi, each fed the same inputs."""
    p, lj, lt = schur_inputs()
    jp, tp = both(p)
    fixed = p["fixed"]
    for damping in (1e-6, 0.3):
        close_rel(tw.invert_hll(lt[2], damping), invert_hll_j(lj[2], damping))
        assert_schur_matches_jax(lt, lj, fixed, damping)
        Sj, bj, _ = schur_parts_j(*lj[:5], damping)
        Fj = finalize_reduced_j(Sj, bj, jnp.asarray(fixed), damping)
        Ft = tw.finalize_reduced(torch.as_tensor(np.array(Sj)), torch.as_tensor(np.array(bj)),
                                 torch.as_tensor(fixed), damping)
        close_rel(Ft[0], Fj[0])
        close_rel(Ft[1], Fj[1])
    dx = np.random.default_rng(0).normal(0, 1e-2, (8, 6)).astype(np.float32)
    Hinv = invert_hll_j(lj[2], 1e-6)
    # landmark steps through near-singular Hll blocks: the points' atol 1e-3
    close_rel(tw.backsubstitute(torch.as_tensor(np.array(Hinv)), lt[3], lt[4],
                                torch.as_tensor(dx)),
              backsubstitute_j(Hinv, lj[3], lj[4], jnp.asarray(dx)), rtol=1e-3)
    for cull in (True, False):
        cj = eval_robust_chi_j(jp, KJ, *WH, JBA(cull_bounds=cull, huber_threshold=2.0))
        ct = tw.eval_robust_chi(tp, KT, *WH, BAConfig(cull_bounds=cull, huber_threshold=2.0))
        np.testing.assert_allclose(float(ct), float(cj), rtol=1e-5)


@pytest.mark.parametrize("damping", [1e-6, 0.3])
def test_schur_check_fails_on_a_dropped_block(damping):
    """The planted fault for test_schur_pieces_match_jax's S: the port's
    S without the landmark that adds the most to it (its W block zeroed)
    fails the comparison at either damping."""
    p, lj, lt = schur_inputs()
    WHW = np.einsum("lfij,ljk,lgmk->lfigm", *(np.asarray(x, np.float64) for x in (
        lj[4], invert_hll_j(lj[2], damping), lj[4])))
    lt[4] = lt[4].clone()
    lt[4][np.argmax(np.abs(WHW).reshape(len(WHW), -1).max(1))] = 0.0
    with pytest.raises(AssertionError, match="^S: "):
        assert_schur_matches_jax(lt, lj, p["fixed"], damping)


@pytest.mark.parametrize("damping", [1e-6, 1e-2])
def test_ba_step_matches_jax(damping):
    jp, tp = both(make_problem(seed=1))
    rj, sj = ba_step_j(jp, KJ, *WH, JBA(), damping)
    rt, st = tw.ba_step(tp, KT, *WH, BAConfig(), damping, plans=tw.assembly_plans(tp))
    np.testing.assert_allclose(rt.poses.numpy(), np.asarray(rj.poses), atol=1e-5)
    np.testing.assert_allclose(rt.points.numpy(), np.asarray(rj.points), atol=1e-3)
    assert int(st.num_inliers) == int(sj.num_inliers)


@pytest.mark.parametrize("L,La,rows,cols", [(64, 33, 4, 12), (512, 65, 6, 50), (100, 10, 4, 20)])
def test_compact_active_matches_jax_sort_and_mask(L, La, rows, cols):
    """One port renumbering == JAX's argsort AND sort-free variants,
    including the capped-overflow sentinel case."""
    rng = np.random.default_rng(L)
    lm = rng.integers(0, L, size=(rows, cols)).astype(np.int32)
    valid = rng.random((rows, cols)) > 0.3
    t_lm, t_old = tw._compact_active(torch.as_tensor(lm), torch.as_tensor(valid), L, La)
    for fn in (jw._compact_active, jw._compact_active_mask):
        j_lm, j_old = jax.jit(fn, static_argnums=(2, 3))(jnp.asarray(lm), jnp.asarray(valid), L, La)
        assert np.array_equal(t_lm.numpy(), np.asarray(j_lm))
        assert np.array_equal(t_old.numpy(), np.asarray(j_old))


SOLVE_CFGS = {
    "lm-sort": dict(iterations=15, damping=1e-3),
    "lm-mask-onehot": dict(iterations=8, compact_method="mask", assembly="onehot"),
    "fixed-damping": dict(iterations=6, lm_adaptive=False),
    "cap64": dict(iterations=6, compact_cap=64, compact_method="mask"),
    "refine": dict(iterations=6, cull_bounds=False, keep_outliers=True, huber_threshold=1e8),
}


@pytest.mark.parametrize("name,compact", [(n, True) for n in sorted(SOLVE_CFGS)]
                         + [("lm-sort", False), ("fixed-damping", False)])
def test_ba_solve_matches_jax(name, compact):
    jp, tp = both(make_problem(L=400))
    kw = SOLVE_CFGS[name]
    rj, sj = ba_solve_j(jp, KJ, *WH, JBA(**kw), compact=compact)
    rt, st = tw.ba_solve(tp, KT, *WH, BAConfig(**kw), compact=compact)
    np.testing.assert_allclose(rt.poses.numpy(), np.asarray(rj.poses), atol=1e-5)
    np.testing.assert_allclose(rt.points.numpy(), np.asarray(rj.points), atol=1e-3)
    assert int(st.num_inliers) == int(sj.num_inliers)
    assert int(st.num_obs) == int(sj.num_obs)
    np.testing.assert_allclose(float(st.chi), float(sj.chi), rtol=1e-4)
    # untouched landmarks keep their exact values
    seen = np.zeros(400, bool)
    seen[np.asarray(jp.obs_lm)[np.asarray(jp.obs_valid)]] = True
    assert np.array_equal(rt.points.numpy()[~seen], np.asarray(jp.points)[~seen])


def test_compact_cap_drops_not_corrupts():
    """A cap below the unique-landmark count drops the overflow (visible in
    num_obs, as in JAX) and the solve stays finite."""
    jp, tp = both(make_problem(L=400))
    exact = tw.ba_solve(tp, KT, *WH, BAConfig(iterations=3))[1]
    pb, sb = tw.ba_solve(tp, KT, *WH, BAConfig(iterations=3, compact_cap=32))
    _, sj = ba_solve_j(jp, KJ, *WH, JBA(iterations=3, compact_cap=32))
    assert int(sb.num_obs) < int(exact.num_obs)
    assert int(sb.num_obs) == int(sj.num_obs)
    assert torch.isfinite(pb.poses).all() and torch.isfinite(pb.points).all()


def test_singular_system_gives_nan_and_a_rejected_step():
    """A non-PD reduced system yields a NaN step, never an exception (JAX's
    cho_factor returns NaN; torch.linalg.cholesky would raise), and the LM
    loop rejects it: a free pose with no observations and zero damping
    leaves a zero row in S."""
    S = torch.zeros(6, 6)
    S[:3, :3] = torch.eye(3)
    with pytest.raises(Exception):
        torch.linalg.cholesky(S)
    assert torch.isnan(cholesky_solve_nan(S, torch.ones(6))).all()
    assert torch.isfinite(cholesky_solve_nan(S + torch.eye(6), torch.ones(6))).all()

    p = make_problem(seed=2)
    p["obs_valid"] = p["obs_valid"].copy()
    p["obs_valid"][5] = False                       # pose 5: free and unobserved
    jp, tp = both(p)
    kw = dict(iterations=4, damping=0.0, damping_init=0.0)
    rt, st = tw.ba_step(tp, KT, *WH, BAConfig(**kw), 0.0, plans=tw.assembly_plans(tp))
    assert torch.isnan(rt.poses[2:]).any()
    rt, st = tw.ba_solve(tp, KT, *WH, BAConfig(**kw))
    rj, sj = ba_solve_j(jp, KJ, *WH, JBA(**kw))
    assert np.isnan(np.asarray(ba_step_j(jp, KJ, *WH, JBA(**kw), 0.0)[0].poses)).any()
    # every trial step was rejected: the problem comes back unchanged
    assert torch.equal(rt.poses, tp.poses) and torch.equal(rt.points, tp.points)
    assert np.array_equal(np.asarray(rj.poses), p["poses"])
    np.testing.assert_allclose(float(st.chi), float(sj.chi), rtol=1e-5)


def test_build_problem_from_vo_matches_jax():
    from tpuvo.engine.state import VOState as JState
    from tpuvo_torch.engine.state import state_from_numpy

    cfg = JCfg(map_capacity=300)
    world = synthetic.make_world(4, n_landmarks=300, xy_extent=6.0)
    gt = synthetic.make_planar_trajectory(6, seed=4)
    seq = synthetic.render_sequence(world, gt, cfg, pixel_noise=0.2, seed=4)
    # a map holding the world's first 300 landmarks with the descriptors
    # the renderer gives them (frame 0's observations)
    C = 300
    fields = dict(pose=np.eye(4, dtype=np.float32), vel=np.eye(4, dtype=np.float32),
                  map_xyz=world.xyz[:C], map_desc=world.desc[:C],
                  map_id_real=np.arange(C, dtype=np.int32),
                  map_id_meas=np.arange(C, dtype=np.int32), map_valid=np.arange(C) < 250,
                  map_count=np.int32(250), map_last_seen=np.zeros(C, np.int32),
                  frame_idx=np.int32(0))
    sj = JState(**{k: jnp.asarray(v) for k, v in fields.items()})
    st = state_from_numpy(fields, "cpu")
    pj = jw.build_problem_from_vo(sj, seq, [1, 3, 4], cfg)
    pt = tw.build_problem_from_vo(st, seq, [1, 3, 4], EngineConfig(map_capacity=300))
    for k in jw.BAProblem._fields:
        a, b = getattr(pt, k).numpy(), np.asarray(getattr(pj, k))
        if k == "obs_lm":
            v = np.asarray(pj.obs_valid)
            assert np.array_equal(a[v], b[v])
        else:
            assert np.array_equal(a, b), k
    assert int(pt.obs_valid.sum()) > 50


def test_problem_converters_round_trip():
    p = make_problem(W=3, L=64)
    jp, _ = both(p)
    tp = tw.problem_from_numpy(jp, "cpu")
    back = tw.problem_to_numpy(tp)
    for k, v in p.items():
        assert np.array_equal(back[k], v), k
    assert tp.obs_lm.dtype == torch.int64


# ------------------------------------------------- the sparse reduction --
def sparse_inputs(damping):
    """make_problem's linearization with the dense plans and with a
    ``PairPlan``: (dense parts, pair blocks, the plan, Hll⁻¹)."""
    tp = tw.problem_from_numpy(make_problem(), "cpu")
    by_lm, by_lm_frame = tw.assembly_plans(tp)
    lm, _, valid = tw._gather_obs(tp)
    (W, _), L = tp.obs_lm.shape, tp.points.shape[0]
    pairs = tw.pair_plan(lm.reshape(-1), valid.reshape(-1), W, L)
    dense = tw.linearize_ba(tp, KT, *WH, BAConfig(), (by_lm, by_lm_frame))
    Wp = tw.linearize_ba(tp, KT, *WH, BAConfig(), (by_lm, pairs))[4]
    return dense[:5], Wp, pairs, tw.invert_hll(dense[2], damping)


def sums_bound(n, *magnitudes):
    """The bound 2·eps·n·Σ|terms| on the difference of two float32
    evaluations of sums of at most n rounded terms each, ``magnitudes``
    the float64 |terms| summed into each entry."""
    return 2 * EPS * n * sum(magnitudes)


def assert_sparse_matches_dense(dense, Wp, pairs, Hinv, damping):
    """schur_parts_sparse's S and b_red, and the pair blocks' landmark
    steps, against the dense path on the same inputs, entry by entry."""
    Hpp, bp, Hll, bl, Wfl = dense
    S, b, _ = tw.schur_parts(Hpp, bp, Hll, bl, Wfl, damping)
    S2, b2, Hinv2 = tw.schur_parts_sparse(Hpp, bp, Hll, bl, Wp, pairs, damping)
    assert torch.equal(Hinv2, Hinv)
    assert_within(S2, S, schur_bound(Hpp, Wfl, Hinv, Hinv), "S")
    aW, aH, abl, L = (np.abs(np.asarray(x, np.float64)) for x in (Wfl, Hinv, bl, Wfl.shape[0]))
    b_terms = np.einsum("lfij,ljk,lk->fi", aW, aH, abl).reshape(-1)
    assert_within(b2, b, sums_bound(3 * L + 4, b_terms, np.abs(np.asarray(bp)).reshape(-1)),
                  "b_red")
    dx = torch.as_tensor(np.random.default_rng(0).normal(0, 1e-2, (Hpp.shape[0], 6)), dtype=torch.float32)
    rhs = abl + np.einsum("lfij,fi->lj", aW, np.abs(dx.numpy()))
    assert_within(schur.backsubstitute(Wp, Hinv, bl, dx, pairs.frame, pairs.lm_bounds),
                  tw.backsubstitute(Hinv, bl, Wfl, dx),
                  sums_bound(6 * Hpp.shape[0] + 4, np.einsum("lij,lj->li", aH, rhs)), "dx_l")


@pytest.mark.parametrize("damping", [1e-6, 0.3])
def test_sparse_schur_matches_dense(damping):
    """The pair blocks are the dense grid's nonzero blocks bit for bit (the
    same entries summed in the same order; an invalid observation's are
    zero), and the reduced system and landmark steps built from them agree
    with the dense path's within their sums' rounding, at either damping."""
    dense, Wp, pairs, Hinv = sparse_inputs(damping)
    Wfl = dense[4]
    n = int(pairs.lm_bounds[-1])
    grid = torch.zeros_like(Wfl)
    grid[pairs.lm[:n], pairs.frame[:n]] = Wp[:n]
    assert torch.equal(grid, Wfl) and not Wp[n:].any()
    assert_sparse_matches_dense(dense, Wp, pairs, Hinv, damping)


@pytest.mark.parametrize("damping", [1e-6, 0.3])
@pytest.mark.parametrize("fault", ["wrong frame", "dropped"])
def test_sparse_check_fails_on_a_misplaced_block(fault, damping):
    """The planted faults for test_sparse_schur_matches_dense: the pair
    that adds the most to S given to a frame that does not see its
    landmark, or dropped (its block zeroed), fails the comparison."""
    dense, Wp, pairs, Hinv = sparse_inputs(damping)
    n = int(pairs.lm_bounds[-1])
    Y = torch.einsum("pij,pjk->pik", Wp[:n], Hinv[pairs.lm[:n]])
    k = int(torch.einsum("pik,pjk->pij", Y, Wp[:n]).abs().flatten(1).max(1).values.argmax())
    if fault == "dropped":
        Wp = Wp.clone()
        Wp[k] = 0.0
    else:
        l, W = int(pairs.lm[k]), dense[0].shape[0]
        seen = set(pairs.frame[pairs.lm_bounds[l]:pairs.lm_bounds[l + 1]].tolist())
        frame = pairs.frame.clone()
        frame[k] = next(f for f in range(W) if f not in seen)
        pairs = pairs._replace(frame=frame, by_frame=assembly.plan(frame, W))
    with pytest.raises(AssertionError, match="^S: "):
        assert_sparse_matches_dense(dense, Wp, pairs, Hinv, damping)


def random_problem(W, N, L, seed=0):
    """A BAProblem of W frames x N observations over L landmarks, 70% of
    the observations valid, for the plans (no geometry)."""
    g = torch.Generator().manual_seed(seed)
    return tw.BAProblem(
        poses=torch.eye(4).expand(W, 4, 4).clone(), points=torch.zeros(L, 3),
        obs_uv=torch.zeros(W, N, 2), obs_lm=torch.randint(0, L, (W, N), generator=g),
        obs_valid=torch.rand(W, N, generator=g) < 0.7, point_valid=torch.ones(L, dtype=torch.bool),
        fixed=torch.arange(W) < 2)


@pytest.mark.parametrize("shape,sparse", [((16, 432, 512), False), ((200, 400, 8192), True)],
                         ids=["local BA", "global sweep"])
def test_the_shape_picks_the_reduction(shape, sparse):
    """The rule 8·N <= La picks the dense product at the local BA's shape
    (W 16, N 432, compacted to 512 landmarks: up to 84% of the blocks
    nonzero) and the pair blocks at the global sweep's (W 200, N 400,
    8,192 landmarks: 4.9%); a pair plan holds each (landmark, frame) of a
    valid observation once, in ascending order, each landmark's pairs
    within its bounds and each frame's in ascending landmark."""
    W, N, L = shape
    assert tw.sparse_schur(N, L) == sparse
    prob = random_problem(W, N, L)
    plans = tw.assembly_plans(prob)
    assert isinstance(plans[1], tw.PairPlan if sparse else tw.CouplingGrid)
    assert plans[1].sparse == sparse
    if not sparse:
        return
    pairs = plans[1]
    valid = prob.obs_valid.reshape(-1)
    lm, f = prob.obs_lm.reshape(-1)[valid], torch.arange(W).repeat_interleave(N)[valid]
    keys = torch.unique(lm * W + f)
    n = keys.numel()
    assert pairs.lm.shape == (W * N,) and int(pairs.lm_bounds[-1]) == n
    assert torch.equal(pairs.lm[:n] * W + pairs.frame[:n], keys)
    assert (pairs.lm[n:] == L).all() and (pairs.frame[n:] == W).all()
    assert torch.equal(pairs.lm_bounds, torch.searchsorted(pairs.lm, torch.arange(L + 1)))
    by_f = pairs.by_frame.order[:n]
    assert torch.equal(pairs.frame[by_f], torch.sort(pairs.frame[:n]).values)
    assert torch.equal(pairs.by_frame.bounds, torch.searchsorted(pairs.frame[by_f], torch.arange(W + 1)))
    key = pairs.frame[by_f] * L + pairs.lm[by_f]
    assert (key[1:] > key[:-1]).all()


def test_ba_step_at_the_local_ba_shape_is_the_dense_path():
    """At the local BA's shape (16 frames of 432 observation slots over 512
    landmarks) ``ba_step`` is the dense path written out, bit for bit."""
    p = make_problem(W=16, L=512)
    pad = 432 - p["obs_lm"].shape[1]
    for k in ("obs_uv", "obs_lm", "obs_valid"):
        p[k] = np.concatenate([p[k], np.zeros((16, pad, *p[k].shape[2:]), p[k].dtype)], 1)
    tp = tw.problem_from_numpy(p, "cpu")
    plans = tw.assembly_plans(tp)
    assert tp.obs_lm.shape == (16, 432) and not plans[1].sparse
    got, stats = tw.ba_step(tp, KT, *WH, BAConfig(), 1e-3, plans=plans)
    Hpp, bp, Hll, bl, Wfl, ref_stats = tw.linearize_ba(tp, KT, *WH, BAConfig(), plans)
    S, b, Hinv = tw.schur_parts(Hpp, bp, Hll, bl, Wfl, 1e-3)
    S, b = tw.finalize_reduced(S, b, tp.fixed, 1e-3)
    dx = cholesky_solve_nan(S, -b).reshape(-1, 6)
    poses = torch.where(tp.fixed[:, None, None], tp.poses, tl.se3_exp(dx) @ tp.poses)
    upd = tp.point_valid & (Hll[:, 0, 0] + Hll[:, 1, 1] + Hll[:, 2, 2] > 0)
    points = torch.where(upd[:, None], tp.points + tw.backsubstitute(Hinv, bl, Wfl, dx), tp.points)
    assert torch.equal(got.poses, poses) and torch.equal(got.points, points)
    assert all(torch.equal(a, b) for a, b in zip(stats, ref_stats))


@pytest.mark.parametrize("name,compact", [("lm-sort", True), ("refine", False)])
def test_sparse_ba_solve_matches_jax(name, compact):
    """A solve that takes the pair blocks (8 frames of 128 observations
    over 1,100 landmarks, or 1,025 compacted) against JAX's dense one, at
    the dense solves' tolerances."""
    p = make_problem(L=1100)
    jp, tp = both(p)
    La = min(1100, 8 * 128 + 1) if compact else 1100
    assert tw.sparse_schur(tp.obs_lm.shape[1], La)
    kw = SOLVE_CFGS[name]
    rj, sj = ba_solve_j(jp, KJ, *WH, JBA(**kw), compact=compact)
    rt, st = tw.ba_solve(tp, KT, *WH, BAConfig(**kw), compact=compact)
    np.testing.assert_allclose(rt.poses.numpy(), np.asarray(rj.poses), atol=1e-5)
    np.testing.assert_allclose(rt.points.numpy(), np.asarray(rj.points), atol=1e-3)
    assert int(st.num_inliers) == int(sj.num_inliers)
    assert int(st.num_obs) == int(sj.num_obs)
    np.testing.assert_allclose(float(st.chi), float(sj.chi), rtol=1e-4)
