"""tpuvo_torch's drivers and CLI vs tpuvo's (CPU): the reference's four
executables as library calls, and ``python -m tpuvo_torch`` on a dataset
written in the reference layout.

Tolerances: run_match_test rows exact; run_pose_recovery with JAX's own
per-pair RANSAC draws, inlier counts exact, the first chained pose (the
axis remap) exactly and each pair's relative pose in rotation and
translation direction within its refit's conditioning (the refit's fp32
9x9 eigenvector is fixed only to eps·λmax / (λ1 - λ0), within which the
libraries' eigensolvers land apart; assert_pose_within); run_triangulate_test ids
exact, points within 5e-2 relative and absolute (test_torch_vo.py's
bootstrap landmarks: the T_boot difference amplified by depth); run_vo's
path-length scale 1e-6 on the same poses.
"""

import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_geometry import EPS, assert_pose_within, record_refits, refit_kappa
from tpuvo.config import EngineConfig as JCfg
from tpuvo.engine import drivers as jdrivers, state as jstate, vo as jvo
from tpuvo.ops import match as jmatch
from tpuvo_torch import cli
from tpuvo_torch.config import EngineConfig
from tpuvo_torch.data import synthetic
from tpuvo_torch.data.writer import write_dataset
from tpuvo_torch.engine import drivers, eval as teval, plots, vo
from tpuvo_torch.engine.state import state_from_numpy, state_to_numpy
import xdist_threads  # noqa: F401  (torch's share of the cores under xdist)

FRAMES = 12
RUN_FILES = ("estimated_trajectory.txt", "estimated_trajectory_scaled.txt", "errors.txt",
             "estimated_world_points.txt", "metrics.jsonl")


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """The closed-loop fixture of tests/test_engine.py cut to 12 frames, and
    its dataset in the reference layout: (seq, world, dir)."""
    world = synthetic.make_world(5, n_landmarks=800, xy_extent=8.0)
    gt = synthetic.make_planar_trajectory(FRAMES, step=0.2, turn=0.03, seed=5)
    seq = synthetic.render_sequence(world, gt, seed=5)
    return seq, world, write_dataset(str(tmp_path_factory.mktemp("data")), seq, world)


def jax_draws(keys, seq, cfg, pairs: bool):
    """JAX's own RANSAC minimal sets ((P,) H, 8): Gumbel top-k over each
    pair's match mask, as tpuvo/ops/twoview.ransac_essential draws them."""
    H, S = cfg.ransac.num_hypotheses, cfg.ransac.sample_size

    def one(k, d1, v1, d2, v2):
        res = jmatch.match_descriptors(d1, v1, d2, v2, cfg.matcher.distance_threshold,
                                       cfg.matcher.ratio_threshold, cfg.matcher.method)
        g = jnp.where(res.valid[None, :], jax.random.gumbel(k, (H, d1.shape[0])), -jnp.inf)
        return jax.lax.top_k(g, S)[1]

    d, v = jnp.asarray(seq.desc), jnp.asarray(seq.valid)
    if pairs:
        return torch.as_tensor(np.array(jax.vmap(one)(keys, d[:-1], v[:-1], d[1:], v[1:])))
    return torch.as_tensor(np.array(one(keys, d[0], v[0], d[1], v[1])))


# ---------------------------------------------------------------- drivers --
def test_run_match_test_rows_equal_jax(fixture):
    seq, _, _ = fixture
    rows_j = jdrivers.run_match_test(seq, JCfg())
    rows_t = drivers.run_match_test(seq, EngineConfig(), device="cpu")
    assert rows_t == rows_j and len(rows_t) == FRAMES - 1
    assert all(type(r) is drivers.MatchTestRow for r in rows_t)


@pytest.fixture(scope="module")
def pose_recovery(fixture):
    """Both packages' run_pose_recovery with JAX's draws: (port poses,
    inliers, JAX poses, inliers, each pair's refit_kappa)."""
    seq, _, _ = fixture
    jc, tc = JCfg(), EngineConfig()
    pj, inl_j = jdrivers.run_pose_recovery(seq, jc, seed=42)
    keys = jax.random.split(jax.random.PRNGKey(42), FRAMES - 1)
    with pytest.MonkeyPatch.context() as mp:
        refits = record_refits(mp)
        pt, inl_t = drivers.run_pose_recovery(seq, tc, seed=42, device="cpu",
                                              sample_idx=jax_draws(keys, seq, jc, pairs=True))
    (refit,) = refits
    return pt, inl_t, np.asarray(pj), inl_j, refit_kappa(*refit)


def assert_chains_agree(pt, pj, kappa):
    """The chained poses pose_0 = M (the axis remap), pose_k+1 = pose_k T_k:
    pose_0 exactly, and each pair's T_k = pose_k⁻¹ pose_k+1 (float64) by
    assert_pose_within, its bound widened by the chain's own float32
    rounding (4 eps a product)."""
    assert np.array_equal(pt[0], pj[0])
    rel = lambda p: np.linalg.inv(p[:-1].astype(np.float64)) @ p[1:].astype(np.float64)
    chain = 4 * EPS * np.arange(1, len(pt))
    assert_pose_within(rel(pt), rel(pj), kappa + chain, "pairs")


def test_run_pose_recovery_with_jax_draws(pose_recovery):
    pt, inl_t, pj, inl_j, kappa = pose_recovery
    assert inl_t == inl_j
    assert pt.shape == (FRAMES, 4, 4) and pt.dtype == np.float32
    assert_chains_agree(pt, pj, kappa)


def test_run_pose_recovery_check_fails_on_a_reversed_translation(pose_recovery):
    """The planted fault for test_run_pose_recovery_with_jax_draws: the
    port's chain with one pair's translation reversed (its pose moved back
    by twice that pair's step) fails the comparison."""
    pt, _, pj, _, kappa = pose_recovery
    bad = pt.astype(np.float64)
    step = bad[5, :3, 3] - bad[4, :3, 3]
    bad[5:, :3, 3] -= 2 * step
    with pytest.raises(AssertionError, match="pairs"):
        assert_chains_agree(bad.astype(np.float32), pj, kappa)


def test_run_triangulate_test_with_jax_draw(fixture):
    seq, world, _ = fixture
    jc = JCfg()
    ij, xj, gj = jdrivers.run_triangulate_test(seq, world, jc, seed=42)
    it, xt, gt = drivers.run_triangulate_test(seq, world, EngineConfig(), seed=42, device="cpu",
                                              sample_idx=jax_draws(jax.random.PRNGKey(42), seq,
                                                                   jc, pairs=False))
    assert np.array_equal(it, ij) and len(it) > 100
    np.testing.assert_allclose(xt, xj, rtol=5e-2, atol=5e-2)
    assert np.array_equal(gt, gj, equal_nan=True)


def test_run_vo_overrides_scale_and_duplicates(fixture, monkeypatch):
    """run_vo on the same state and poses (the tracker stubbed in both
    packages): the same PICP override, duplicate count and path-length
    scale."""
    seq, _, _ = fixture
    state, _, poses, _ = vo.run_sequence(seq, EngineConfig(), device="cpu")
    ids = state.map_id_real.clone()
    ids[1:4] = ids[0]  # one GT id owning four map entries, one owning two
    ids[5] = ids[6]
    fields = state_to_numpy(state._replace(map_id_real=ids))
    js = jstate.VOState(**{k: jnp.asarray(v) for k, v in fields.items()})
    seen = {}
    monkeypatch.setattr(jvo, "run_sequence", lambda s, cfg, seed: (
        seen.setdefault("jax", cfg), js, None, jnp.asarray(poses.numpy()), {})[1:])
    monkeypatch.setattr(vo, "run_sequence", lambda s, cfg, seed, device: (
        seen.setdefault("port", cfg), state_from_numpy(js, "cpu"), None, poses, {})[1:])
    *_, dj = jdrivers.run_vo(seq, JCfg(), seed=42)
    *_, dt = drivers.run_vo(seq, EngineConfig(), seed=42, device="cpu")
    assert dataclasses.asdict(seen["port"].picp) == dataclasses.asdict(seen["jax"].picp)
    assert seen["port"].picp.max_iterations == 5 and seen["port"].picp.kernel_threshold == 1000.0
    assert dt["duplicates"] == dj["duplicates"] == 2
    np.testing.assert_allclose(dt["scale_path_ratio"], dj["scale_path_ratio"], rtol=0, atol=1e-6)


# -------------------------------------------------------------------- CLI --
def cli_run(capsys, monkeypatch, argv, data):
    """cli.main on the CPU; returns (stdout, the poses the CLI evaluated)."""
    seen, evaluate = [], teval.evaluate
    monkeypatch.setattr(teval, "evaluate", lambda p, *a, **kw: (seen.append(p),
                                                                  evaluate(p, *a, **kw))[1])
    cli.main(["--device", "cpu", "--data", data, "--frames", str(FRAMES)] + argv)
    return capsys.readouterr().out, (seen[0] if seen else None)


def printed_json(out):
    return json.loads(out[out.index("{"):])


@pytest.fixture(scope="module")
def plain_run(fixture, tmp_path_factory):
    """``--matcher pallas run`` with its plots: (out dir, stdout, the poses
    the CLI evaluated)."""
    _, _, data = fixture
    out_dir = tmp_path_factory.mktemp("plain")
    with pytest.MonkeyPatch.context() as mp:
        seen, evaluate = [], teval.evaluate
        mp.setattr(teval, "evaluate", lambda p, *a, **kw: (seen.append(p), evaluate(p, *a, **kw))[1])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["--device", "cpu", "--data", data, "--frames", str(FRAMES),
                      "--matcher", "pallas", "run", "--out", str(out_dir)])
    return out_dir, buf.getvalue(), seen[0]


def test_cli_run_writes_artifacts(plain_run):
    """tests/test_cli.py::test_cli_run_writes_artifacts through the port:
    the same file set, and metrics.jsonl's records."""
    tmp_path, out, _ = plain_run
    summary = printed_json(out)
    assert summary["map_count"] > 50 and summary["ate_robot"] < 0.05
    for f in RUN_FILES + ("gt_vs_est_trajectory.png",):
        assert (tmp_path / f).exists(), f
    assert np.loadtxt(tmp_path / "estimated_trajectory.txt").shape == (FRAMES, 4)
    lines = [json.loads(ln) for ln in open(tmp_path / "metrics.jsonl")]
    assert [r["event"] for r in lines] == ["frame"] * (FRAMES - 1) + ["summary"]
    assert lines[-1]["ate_robot"] == summary["ate_robot"]


@pytest.mark.parametrize("mode", [["--online"], ["--checkpoint-every", "5"]])
def test_cli_run_modes_give_the_plain_trajectory(fixture, plain_run, tmp_path, capsys,
                                                 monkeypatch, mode):
    """run --online and run --checkpoint-every: exactly the plain run's
    trajectory and artifacts (the same track_step calls)."""
    _, _, data = fixture
    plain_dir, _, plain = plain_run
    monkeypatch.setattr(plots, "render_all", lambda *a, **kw: None)
    argv = ["--matcher", "pallas", "run", *mode, "--out", str(tmp_path)]
    _, got = cli_run(capsys, monkeypatch, argv, data)
    assert torch.equal(got, plain)
    for f in RUN_FILES[:4]:
        assert (tmp_path / f).read_bytes() == (plain_dir / f).read_bytes(), f
    if mode[0] == "--checkpoint-every":
        assert (tmp_path / "checkpoint.npz").exists()
        # a second call resumes from the finished checkpoint: the same poses
        _, again = cli_run(capsys, monkeypatch, argv, data)
        assert torch.equal(again, plain)


SUBCOMMANDS = {
    "vo": (["vo"], "duplicate_landmarks"),
    "match-test": (["match-test"], "TOTAL: found"),
    "pose-recovery": (["pose-recovery", "--out", "{tmp}"], "chained 12 poses"),
    "triangulate": (["triangulate", "--limit", "3"], "landmarks triangulated"),
    "ba": (["ba", "--window", "5", "--iterations", "3"], '"num_obs"'),
    "slam-refine-loop": (["--matcher", "pallas", "slam", "--window", "6", "--refine", "loop",
                          "--sweeps", "1", "--iterations", "5", "--out", "{tmp}"], '"refined"'),
    "sweep": (["sweep", "--thresholds", "1000,3000"], '"3000.0"'),
    "refine-global": (["refine", "--sweeps", "1", "--iterations", "5"], '"strategy": "global"'),
    "refine-windowed": (["refine", "--strategy", "windowed", "--window", "6"], '"windows": 3'),
    "refine-posegraph": (["refine", "--strategy", "posegraph", "--window", "6", "--iterations",
                          "3"], '"windows": 4'),
}


@pytest.mark.parametrize("name", sorted(SUBCOMMANDS))
def test_cli_subcommands(fixture, tmp_path, capsys, monkeypatch, name):
    _, _, data = fixture
    monkeypatch.setattr(plots, "render_all", lambda *a, **kw: None)
    argv, expect = SUBCOMMANDS[name]
    out, _ = cli_run(capsys, monkeypatch, [a.replace("{tmp}", str(tmp_path)) for a in argv], data)
    assert expect in out, out[-500:]
    if name == "slam-refine-loop":  # tests/test_cli.py::test_cli_slam_refine_loop's bound
        s = printed_json(out)
        assert s["n_local_ba_runs"] > 0
        assert s["refined"]["ate_rmse"] < 2.0 * max(s["tracked"]["ate_rmse"], 0.05)
        for f in RUN_FILES:
            assert (tmp_path / f).exists(), f
    if name == "pose-recovery":
        assert np.loadtxt(tmp_path / "chained_trajectory.txt").shape == (FRAMES, 3)


def test_cli_without_a_card_raises(fixture, monkeypatch):
    """--device cuda (the default) without a card: the same error as
    run_sequence's, before any work."""
    _, _, data = fixture
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available") as e:
        cli.main(["--data", data, "--frames", str(FRAMES), "run", "--out", "unused"])
    with pytest.raises(RuntimeError) as e2:
        vo.run_sequence(fixture[0])
    assert str(e.value) == str(e2.value)
