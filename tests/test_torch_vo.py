"""tpuvo_torch engine vs tpuvo's: the map append, the bootstrap, and
``track_step`` started from JAX's own state (``state_from_numpy``) for every
branch; whole runs of the two synthetic fixtures of tests/test_engine.py at
the same bounds; the streaming and batch entry points (CPU).

Per-step tolerances: pose atol 1e-4 (fp32 GN at a converged pose, sums in
another order); counts and map slots exact; GN iterations +/-1 (the
relative-chi stop is knife-edge under another summation order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuvo.config import EngineConfig as JCfg, MatcherConfig as JMatcher, PICPConfig as JPICP
from tpuvo.data import synthetic
from tpuvo.engine import state as jstate, vo as jvo
from tpuvo.ops import match as jmatch
from tpuvo_torch.config import EngineConfig, MatcherConfig, PICPConfig
from tpuvo_torch.engine import state as tstate, vo as tvo
from tpuvo_torch.engine.eval import evaluate, metrics_dict
import xdist_threads  # noqa: F401  (torch's share of the cores under xdist)

LOG_COUNTS = ("num_inliers", "n_map_matches", "n_map_correct", "n_frame_matches",
              "n_new_points", "map_count", "n_dropped_candidates", "n_dropped_overflow")


def both_cfgs(**kw):
    """The same configuration in both packages (matcher/picp as dicts)."""
    m, p = kw.pop("matcher", {}), kw.pop("picp", {})
    return (JCfg(matcher=JMatcher(**m), picp=JPICP(**p), **kw),
            EngineConfig(matcher=MatcherConfig(**m), picp=PICPConfig(**p), **kw))


def make_seq(cfg, seed=13, frames=10, noise=0.0):
    world = synthetic.make_world(seed, n_landmarks=300, xy_extent=8.0)
    gt = synthetic.make_planar_trajectory(frames, seed=seed)
    return synthetic.render_sequence(world, gt, cfg, pixel_noise=noise, seed=seed)


def jax_sample_idx(seed, f0, f1, cfg):
    """JAX's own RANSAC draw for its bootstrap (vo.bootstrap -> ransac)."""
    res = jmatch.match_descriptors(f0.desc, f0.valid, f1.desc, f1.valid,
                                   cfg.matcher.distance_threshold, cfg.matcher.ratio_threshold,
                                   cfg.matcher.method)
    key = jax.random.PRNGKey(seed)
    g = jax.random.gumbel(key, (cfg.ransac.num_hypotheses, f0.uv.shape[0]))
    scores = jnp.where(res.valid[None, :], g, -jnp.inf)
    return torch.as_tensor(np.array(jax.lax.top_k(scores, cfg.ransac.sample_size)[1]))


def to_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------ map append --
@pytest.mark.parametrize("reuse", [False, True])
def test_append_to_map_matches_jax(reuse):
    jc, tc = both_cfgs(mode="fixed", map_capacity=32, max_obs=16)
    rng = np.random.default_rng(0)
    fields = {k: np.asarray(v) for k, v in jstate.empty_state(jc)._asdict().items()}
    fields["map_valid"] = rng.random(32) < 0.7
    fields["map_count"] = np.int32(fields["map_valid"].sum() if reuse else 20)
    if not reuse:
        fields["map_valid"] = np.arange(32) < 20
    fields["frame_idx"] = np.int32(5)
    n = 16
    xyz = rng.normal(0, 3, (n, 3)).astype(np.float32)
    desc = rng.normal(0, 1, (n, 10)).astype(np.float32)
    ids = np.arange(n, dtype=np.int32) + 100
    mask = rng.random(n) < 0.8
    sj = jstate.VOState(**{k: jnp.asarray(v) for k, v in fields.items()})
    outj = jvo._append_to_map(sj, jnp.asarray(xyz), jnp.asarray(desc), jnp.asarray(ids),
                              jnp.asarray(ids + 1), jnp.asarray(mask), reuse_slots=reuse)
    st = tstate.state_from_numpy(fields, "cpu")
    outt = tvo._append_to_map(st, torch.as_tensor(xyz), torch.as_tensor(desc),
                              torch.as_tensor(ids), torch.as_tensor(ids + 1),
                              torch.as_tensor(mask), reuse_slots=reuse)
    for k in tstate.VOState._fields:
        assert np.array_equal(to_np(getattr(outt[0], k)), to_np(getattr(outj[0], k))), k
    assert int(outt[1]) == int(outj[1])
    assert np.array_equal(to_np(outt[2]), to_np(outj[2]))  # landing slots
    assert np.array_equal(to_np(outt[3]), to_np(outj[3]))


# ------------------------------------------------------------- bootstrap --
def test_bootstrap_matches_jax():
    jc, tc = both_cfgs(mode="fixed", map_capacity=256, max_obs=64)
    seq = make_seq(jc)
    f0j, f1j = jvo.frame_of(seq, 0), jvo.frame_of(seq, 1)
    sj, dj = jvo.bootstrap_jit(jax.random.PRNGKey(42), f0j, f1j, jc)
    st, dt = tvo.bootstrap(None, tvo.frame_of(seq, 0, "cpu"), tvo.frame_of(seq, 1, "cpu"), tc,
                           sample_idx=jax_sample_idx(42, f0j, f1j, jc))
    # the RANSAC refit's fp32 9x9 eigenvector differs between the two
    # libraries' eigensolvers at ~1e-3 (see test_torch_geometry)
    np.testing.assert_allclose(dt["T_boot"].numpy(), np.asarray(dj["T_boot"]), atol=2e-3)
    for k in ("n_matches", "n_ransac_inliers", "n_map_points"):
        assert int(dt[k]) == int(dj[k]), k
    for k in ("map_valid", "map_id_real", "map_id_meas", "map_count", "map_desc"):
        assert np.array_equal(to_np(getattr(st, k)), to_np(getattr(sj, k))), k
    # landmarks triangulated over the 0.2 m bootstrap baseline inherit the
    # T_boot difference, amplified by depth/baseline: relative 5e-2
    v = np.asarray(sj.map_valid)
    np.testing.assert_allclose(st.map_xyz.numpy()[v], np.asarray(sj.map_xyz)[v], rtol=5e-2, atol=5e-2)


# ------------------------------------------------------------ track_step --
BRANCHES = {
    "plain-parity": dict(),
    "fused-gating": dict(mode="fixed", fuse_frame_matchers=True),
    "pallas-matcher": dict(mode="fixed", matcher=dict(method="pallas")),
    "pallas-both": dict(mode="fixed", matcher=dict(method="pallas"),
                        picp=dict(backend="pallas", convergence_threshold=1e-4)),
    "motion-evict": dict(mode="fixed", motion_model_init=True, map_evict_age=2,
                         map_capacity=128, max_new_landmarks_per_frame=8),
    "unrolled-mxu_bf16": dict(mode="fixed", matcher=dict(method="mxu_bf16"),
                              picp=dict(unrolled_rounds=6)),
}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_track_step_from_jax_state(branch):
    """Teacher forcing: every step starts from JAX's state; the port's step
    must reproduce JAX's step (pose, logs and the whole new state).  JAX runs
    the XLA PICP solver (its Pallas solver has no CPU mode); the pallas
    matcher runs in interpret mode."""
    kw = dict(map_capacity=256, max_obs=64)
    kw.update(BRANCHES[branch])
    jc, tc = both_cfgs(**kw)
    jc = jc.replace(picp=dataclasses.replace(jc.picp, backend="xla"))
    seq = make_seq(jc, noise=0.3)
    F = seq.uv.shape[0]
    sj, _ = jvo.bootstrap_jit(jax.random.PRNGKey(42), jvo.frame_of(seq, 0), jvo.frame_of(seq, 1), jc)
    frames = tvo.frames_of(seq, 0, F, "cpu")
    for i in range(F - 1):
        st = tstate.state_from_numpy(sj, "cpu")
        sj2, lj = jvo.track_step_jit(sj, jvo.frame_of(seq, i), jvo.frame_of(seq, i + 1), jc)
        st2, lt = tvo.track_step(st, tvo.frame_at(frames, i), tvo.frame_at(frames, i + 1), tc)
        np.testing.assert_allclose(lt.pose.numpy(), np.asarray(lj.pose), atol=1e-4,
                                   err_msg=f"{branch} step {i}")
        for k in LOG_COUNTS:
            assert int(getattr(lt, k)) == int(getattr(lj, k)), (branch, i, k)
        assert abs(int(lt.iterations) - int(lj.iterations)) <= 1, (branch, i)
        for k in ("map_valid", "map_id_real", "map_id_meas", "map_last_seen", "map_count",
                  "frame_idx", "map_desc"):
            assert np.array_equal(to_np(getattr(st2, k)), to_np(getattr(sj2, k))), (branch, i, k)
        v = np.asarray(sj2.map_valid)
        np.testing.assert_allclose(st2.map_xyz.numpy()[v], np.asarray(sj2.map_xyz)[v],
                                   rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(st2.vel.numpy(), np.asarray(sj2.vel), atol=1e-4)
        sj = sj2


def test_make_tracker_matches_jax():
    """make_tracker(cfg) from JAX's bootstrap state: the same scan as JAX's
    compiled tracker (poses and counts; a short run, as the feedback loop
    grows last-bit differences), and bit-equal to the port's scan_tracker."""
    jc, tc = both_cfgs(map_capacity=256, max_obs=64)
    jc = jc.replace(picp=dataclasses.replace(jc.picp, backend="xla"))
    seq = make_seq(jc, noise=0.3, frames=5)
    F = seq.uv.shape[0]
    sj, _ = jvo.bootstrap_jit(jax.random.PRNGKey(42), jvo.frame_of(seq, 0), jvo.frame_of(seq, 1), jc)
    _, lj = jvo.make_tracker(jc)(sj, jvo.frames_of(seq, 0, F - 1), jvo.frames_of(seq, 1, F))
    frames = tvo.frames_of(seq, 0, F, "cpu")
    curr = tvo.Frame(*(x[:F - 1] for x in frames))
    nxt = tvo.Frame(*(x[1:] for x in frames))
    st, lt = tvo.make_tracker(tc)(tstate.state_from_numpy(sj, "cpu"), curr, nxt)
    np.testing.assert_allclose(lt.pose.numpy(), np.asarray(lj.pose), atol=1e-3)
    for k in LOG_COUNTS:
        assert np.array_equal(getattr(lt, k).numpy(), np.asarray(getattr(lj, k))), k
    st2, lt2 = tvo.scan_tracker(tstate.state_from_numpy(sj, "cpu"), curr, nxt, tc)
    assert all(torch.equal(a, b) for a, b in zip(lt, lt2))
    assert all(torch.equal(a, b) for a, b in zip(st, st2))


def test_annealed_with_pallas_backend_raises():
    _, tc = both_cfgs(mode="fixed", map_capacity=256, max_obs=64,
                      picp=dict(backend="pallas", annealed_kernel=True))
    seq = make_seq(tc, frames=3)
    fr = tvo.frames_of(seq, 0, 3, "cpu")
    state, _ = tvo.bootstrap(tvo.make_generator(1), tvo.frame_at(fr, 0), tvo.frame_at(fr, 1), tc)
    with pytest.raises(ValueError, match="annealed"):
        tvo.track_step(state, tvo.frame_at(fr, 0), tvo.frame_at(fr, 1), tc)


# ------------------------------------------------ PICP solves by device --
DISPATCH = {  # picp config, lane thresholds
    "xla": (dict(), None),
    "unrolled": (dict(unrolled_rounds=3), None),
    "pallas": (dict(backend="pallas"), None),
    "annealed, lane thresholds": (dict(backend="pallas", annealed_kernel=True),
                                  [500.0, 3000.0]),
    "annealed xla": (dict(annealed_kernel=True), None),
}


def dispatch_run(monkeypatch, card, picp, thresholds):
    """Two tracked frames (or the sweep's lanes) with every PICP solve
    routed as on the card or on the CPU; returns (what was routed, poses)."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_picp import kernel_route

    _, tc = both_cfgs(mode="fixed", map_capacity=256, max_obs=64, picp=picp)
    seq = make_seq(tc, frames=4, noise=0.3)
    with monkeypatch.context() as mp:
        seen = kernel_route(mp, card)
        if thresholds is None:
            _, _, poses, _ = tvo.run_sequence(seq, tc, device="cpu")
        else:
            _, _, poses = tvo.run_threshold_sweep(seq, thresholds, tc, device="cpu")
    return seen, poses


@pytest.mark.parametrize("name", sorted(DISPATCH))
def test_picp_solves_launch_the_kernel_on_the_card_only(monkeypatch, name):
    """Every track_step branch on a CUDA device hands its solve to the
    kernel (once a step, with the schedule the branch means: the unrolled
    driver as max_iterations = rounds and no annealing, the annealed
    schedule with the lanes' thresholds) and runs no plain loop; on the
    CPU the same branch runs the plain loop and never the kernel.  The
    kernel's stand-in is the plain solve of what it was handed, so the two
    routes give the same poses bit for bit."""
    picp, thresholds = DISPATCH[name]
    card, card_poses = dispatch_run(monkeypatch, True, picp, thresholds)
    cpu, cpu_poses = dispatch_run(monkeypatch, False, picp, thresholds)
    steps = card_poses.shape[-3] - 1  # every frame after the first is tracked
    assert card["plain"] == [] and cpu["kernel"] == []
    assert len(card["kernel"]) == len(cpu["plain"]) == steps
    want = "solve_unrolled" if "unrolled_rounds" in picp else "solve"
    assert set(cpu["plain"]) == {want}
    for call in card["kernel"]:
        cfg = call["cfg"]
        assert call["gathered"]  # gathered from the map by the match's indices
        assert isinstance(call["K"], np.ndarray)  # the config's host array
        if "unrolled_rounds" in picp:
            assert cfg.max_iterations == 3 and not cfg.annealed_kernel
        else:
            assert cfg.max_iterations == 50
            assert cfg.annealed_kernel == picp.get("annealed_kernel", False)
        if thresholds is None:
            assert call["thr"] is None and call["batch"] == ()
        else:
            assert call["batch"] == (2,) and call["thr"].tolist() == thresholds
    assert torch.equal(card_poses, cpu_poses)


@pytest.mark.parametrize("card", [False, True])
def test_annealed_pallas_raises_on_either_route_as_in_jax(monkeypatch, card):
    """backend='pallas' with annealed_kernel=True and no lane thresholds is
    a config error, as in JAX (tpuvo/engine/vo.py:274-284): it raises on
    the card route before any launch, and on the CPU."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_picp import kernel_route

    jc, tc = both_cfgs(mode="fixed", map_capacity=256, max_obs=64,
                       picp=dict(backend="pallas", annealed_kernel=True))
    seq = make_seq(tc, frames=3)
    sj, _ = jvo.bootstrap_jit(jax.random.PRNGKey(1), jvo.frame_of(seq, 0),
                              jvo.frame_of(seq, 1), jc)
    with pytest.raises(ValueError, match="annealed"):
        jvo.track_step(sj, jvo.frame_of(seq, 1), jvo.frame_of(seq, 2), jc)
    fr = tvo.frames_of(seq, 0, 3, "cpu")
    state, _ = tvo.bootstrap(tvo.make_generator(1), tvo.frame_at(fr, 0), tvo.frame_at(fr, 1), tc)
    seen = kernel_route(monkeypatch, card)
    with pytest.raises(ValueError, match="annealed"):
        tvo.track_step(state, tvo.frame_at(fr, 1), tvo.frame_at(fr, 2), tc)
    assert seen == {"kernel": [], "plain": []}


# ------------------------------------------------------------ whole runs --
@pytest.mark.parametrize("kernels", [False, True])
def test_synthetic_closed_loop(kernels):
    """tests/test_engine.py::test_synthetic_closed_loop through the port."""
    kw = dict(matcher=MatcherConfig(method="pallas"), picp=PICPConfig(backend="pallas")) if kernels else {}
    cfg = EngineConfig(**kw)
    world = synthetic.make_world(5, n_landmarks=800, xy_extent=8.0)
    gt = synthetic.make_planar_trajectory(40, step=0.2, turn=0.03, seed=5)
    seq = synthetic.render_sequence(world, gt, pixel_noise=0.0, seed=5)
    _, _, poses, _ = tvo.run_sequence(seq, cfg, device="cpu")
    m = metrics_dict(evaluate(poses, gt))
    assert m["trans_err_robot_mean"] < 0.05
    assert m["rot_err_fixed_mean"] < 0.02
    assert m["ate_robot"] < 0.05


@pytest.mark.parametrize("kernels", [False, True])
def test_synthetic_with_noise(kernels):
    """tests/test_engine.py::test_synthetic_with_noise through the port."""
    kw = dict(matcher=MatcherConfig(method="pallas"), picp=PICPConfig(backend="pallas")) if kernels else {}
    cfg = EngineConfig(**kw)
    world = synthetic.make_world(7, n_landmarks=800, xy_extent=8.0)
    gt = synthetic.make_planar_trajectory(30, step=0.2, turn=0.02, seed=7)
    seq = synthetic.render_sequence(world, gt, pixel_noise=0.3, seed=7)
    _, _, poses, _ = tvo.run_sequence(seq, cfg, device="cpu")
    assert metrics_dict(evaluate(poses, gt))["ate_rmse"] < 0.75


def test_evaluate_matches_jax():
    from tpuvo.engine.eval import evaluate as jevaluate, metrics_dict as jmetrics

    rng = np.random.default_rng(3)
    gt = synthetic.make_planar_trajectory(25, seed=3)
    cfg = JCfg()
    poses = np.stack([np.linalg.inv(synthetic.camera_pose_from_gt(g, cfg)) @
                      synthetic.camera_pose_from_gt(gt[0], cfg) for g in gt]).astype(np.float32)
    poses = np.linalg.inv(poses).astype(np.float32)
    poses[:, :3, 3] = 0.37 * poses[:, :3, 3] + rng.normal(0, 0.01, (25, 3)).astype(np.float32)
    mj, mt = jmetrics(jevaluate(poses, gt, cfg)), metrics_dict(evaluate(poses, gt))
    assert mj.keys() == mt.keys()
    for k in mj:
        np.testing.assert_allclose(mt[k], mj[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_streaming_and_batch_entry_points_agree():
    """OnlineVO, full_run and run_sequence take the same steps; log_stats
    False keeps the poses and zero-fills the stats (as in JAX)."""
    cfg = EngineConfig(mode="fixed", map_capacity=256, max_obs=64)
    seq = make_seq(cfg, seed=11, frames=12)
    F = seq.uv.shape[0]
    _, logs, poses, _ = tvo.run_sequence(seq, cfg, seed=42, device="cpu")
    sess = tvo.OnlineVO(cfg, seed=42)
    sess.start(tvo.frame_of(seq, 0, "cpu"), tvo.frame_of(seq, 1, "cpu"))
    online = [torch.eye(4)] + [sess.step(tvo.frame_of(seq, i, "cpu")) for i in range(1, F)]
    assert torch.equal(torch.stack(online), poses)
    assert sess.frame_count == F
    fr = tvo.frames_of(seq, 0, F, "cpu")
    _, lg = tvo.full_run(tvo.make_generator(42), tvo.frame_at(fr, 0), tvo.frame_at(fr, 1),
                         tvo.Frame(*(x[:-1] for x in fr)), tvo.Frame(*(x[1:] for x in fr)), cfg)
    assert torch.equal(lg.pose, poses[1:])
    _, lg2, poses2, _ = tvo.run_sequence(seq, cfg.replace(log_stats=False), seed=42, device="cpu")
    assert torch.equal(poses2, poses)
    assert int(lg2.num_inliers.sum()) == 0 and int(logs.num_inliers.sum()) > 0
