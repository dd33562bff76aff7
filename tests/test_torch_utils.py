"""tpuvo_torch's utilities and artifact writers vs tpuvo's (CPU): npz
checkpoints in both directions, ``OnlineVO.resume`` from a JAX checkpoint,
an interrupted and resumed ``run_sequence_chunked``, state/log validation,
fault injection, the metrics JSONL, the reference-format artifacts, plots
and the Chrome trace with the program's spans.

Tolerances: checkpoints, fault arrays, metrics lines and artifact files
exact; a session resumed by the port from JAX's checkpoint, stepped beside
JAX's, pose atol 1e-4 (the per-step tolerance of test_torch_vo.py).
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuvo.config import EngineConfig as JCfg
from tpuvo.engine import eval as jeval, state as jstate, vo as jvo
from tpuvo.utils import checkpoint as jckpt, checks as jchecks, faults as jfaults
from tpuvo.utils import metrics as jmetrics
from tpuvo_torch.config import EngineConfig
from tpuvo_torch.data import synthetic
from tpuvo_torch.engine import eval as teval, plots, vo
from tpuvo_torch.engine.state import FrameLog, VOState, state_from_numpy, state_to_numpy
from tpuvo_torch.utils import checkpoint, checks, faults, metrics, profiling
import xdist_threads  # noqa: F401  (torch's share of the cores under xdist)

KW = dict(mode="fixed", map_capacity=256, max_obs=64)


def make_seq(frames=10, seed=13, noise=0.3):
    world = synthetic.make_world(seed, n_landmarks=300, xy_extent=8.0)
    gt = synthetic.make_planar_trajectory(frames, seed=seed)
    return synthetic.render_sequence(world, gt, EngineConfig(**KW), pixel_noise=noise, seed=seed)


@pytest.fixture(scope="module")
def run():
    """A port run on the CPU: (seq, state, logs, poses)."""
    seq = make_seq()
    state, logs, poses, _ = vo.run_sequence(seq, EngineConfig(**KW), device="cpu")
    return seq, state, logs, poses


def jax_state(state):
    return jstate.VOState(**{k: jnp.asarray(v) for k, v in state_to_numpy(state).items()})


def assert_states_equal(a, b):
    for k in VOState._fields:
        x, y = np.asarray(getattr(a, k)), np.asarray(getattr(b, k))
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), k


# ------------------------------------------------------------ checkpoints --
def test_checkpoint_jax_to_port_and_back(run, tmp_path):
    """A JAX save_state file through the port's load_state, and a port file
    through JAX's load_state: bit-equal arrays, frame_idx and extras."""
    _, state, _, poses = run
    js = jax_state(state)
    jckpt.save_state(str(tmp_path / "j.npz"), js, 9, extra={"seed": 42, "poses": np.asarray(poses)})
    st, fidx, extra = checkpoint.load_state(str(tmp_path / "j.npz"), device="cpu")
    assert_states_equal(st, js)
    assert fidx == 9 and int(extra["seed"]) == 42 and np.array_equal(extra["poses"], poses)

    checkpoint.save_state(str(tmp_path / "t.npz"), state, 7, extra={"poses": poses})
    sj, fidx, extra = jckpt.load_state(str(tmp_path / "t.npz"))
    assert_states_equal(sj, state)
    assert fidx == 7 and np.array_equal(extra["poses"], poses.numpy())
    assert not os.path.exists(str(tmp_path / "t.npz") + ".tmp.npz")


def test_old_checkpoint_backfills_like_jax(run, tmp_path):
    """A checkpoint without vel, map_last_seen and frame_idx: both packages
    backfill the same values."""
    _, state, _, _ = run
    path = str(tmp_path / "old.npz")
    np.savez(path, frame_idx=np.int32(3), **{
        f"state_{k}": v for k, v in state_to_numpy(state).items()
        if k not in ("vel", "map_last_seen", "frame_idx")})
    sj, fj, _ = jckpt.load_state(path)
    st, ft, _ = checkpoint.load_state(path, device="cpu")
    assert fj == ft == 3
    assert_states_equal(st, sj)
    assert np.array_equal(st.vel.numpy(), np.eye(4, dtype=np.float32))
    assert int(st.frame_idx) == 0 and int(st.map_last_seen.abs().sum()) == 0


def test_checkpoint_every_wrapper(run, tmp_path):
    _, state, _, _ = run
    path = str(tmp_path / "every.npz")
    step = checkpoint.checkpoint_every(lambda s, i: (s, i), path, every=3)
    for i in (1, 2):
        step(state, i)
    assert not os.path.exists(path)
    step(state, 3)
    assert checkpoint.load_state(path, device="cpu")[1] == 3


def test_online_vo_resumes_from_jax_checkpoint(tmp_path):
    """JAX's OnlineVO runs 4 frames and checkpoints; the port resumes from
    that file and both step the next 5 frames: each pose within 1e-4."""
    seq = make_seq(frames=10, seed=11)
    jc = JCfg(**KW)
    js = jvo.OnlineVO(jc, seed=42)
    js.start(jvo.frame_of(seq, 0), jvo.frame_of(seq, 1))
    for i in range(1, 4):
        js.step(jvo.frame_of(seq, i))
    js.checkpoint(str(tmp_path / "s.npz"))
    ts = vo.OnlineVO.resume(str(tmp_path / "s.npz"), EngineConfig(**KW), device="cpu")
    assert ts.frame_count == js.frame_count == 4
    assert_states_equal(ts.state, js.state)
    for i in range(4, 9):
        pj = np.asarray(js.step(jvo.frame_of(seq, i)))
        pt = ts.step(vo.frame_of(seq, i, "cpu")).numpy()
        np.testing.assert_allclose(pt, pj, atol=1e-4, err_msg=f"frame {i}")
    # and the port's own session round-trips through its checkpoint
    ts.checkpoint(str(tmp_path / "t.npz"))
    again = vo.OnlineVO.resume(str(tmp_path / "t.npz"), EngineConfig(**KW), device="cpu")
    assert again.frame_count == ts.frame_count
    assert all(torch.equal(a, b) for a, b in zip(again._prev, ts._prev))


def test_chunked_run_interrupted_and_resumed(tmp_path):
    """run_sequence_chunked stopped after one chunk, then resumed from its
    checkpoint: exactly the uninterrupted run_sequence on the CPU."""
    seq = make_seq(frames=14, seed=12)
    cfg = EngineConfig(**KW)
    ref_state, _, ref_poses, _ = vo.run_sequence(seq, cfg, device="cpu")
    ckpt = str(tmp_path / "c.npz")
    _, poses, step = vo.run_sequence_chunked(seq, cfg, checkpoint_path=ckpt, checkpoint_every=5,
                                             max_chunks=1, device="cpu")
    assert step == 5 and poses.shape == (6, 4, 4)
    state, poses, step = vo.run_sequence_chunked(seq, cfg, checkpoint_path=ckpt,
                                                 checkpoint_every=5, device="cpu")
    assert step == 13
    assert torch.equal(poses, ref_poses)
    assert_states_equal(state, ref_state)


# ------------------------------------------------------------- validation --
CORRUPTIONS = {
    "nan_pose": lambda s: {**s, "pose": np.where(np.eye(4, dtype=bool), np.nan, s["pose"])},
    "not_a_rotation": lambda s: {**s, "pose": s["pose"] * np.float32(1.1)},
    "count_mismatch": lambda s: {**s, "map_count": s["map_count"] + 1},
    "nan_landmark": lambda s: {**s, "map_xyz": np.where(s["map_valid"][:, None], np.nan,
                                                        s["map_xyz"]).astype(np.float32)},
}


@pytest.mark.parametrize("corruption", sorted(CORRUPTIONS))
def test_validate_state_raises_like_jax(run, corruption):
    _, state, _, _ = run
    fields = state_to_numpy(state)
    checks.validate_state(state)
    jchecks.validate_state(jax_state(state))
    bad = CORRUPTIONS[corruption](fields)
    with pytest.raises(jchecks.StateValidationError) as ej:
        jchecks.validate_state(jstate.VOState(**{k: jnp.asarray(v) for k, v in bad.items()}))
    with pytest.raises(checks.StateValidationError) as et:
        checks.validate_state(state_from_numpy(bad, "cpu"))
    assert str(et.value) == str(ej.value)


def test_validate_frame_log_like_jax(run):
    _, _, logs, _ = run
    arrays = {k: getattr(logs, k).numpy() for k in FrameLog._fields}
    jlogs = jstate.FrameLog(**{k: jnp.asarray(v) for k, v in arrays.items()})
    assert checks.validate_frame_log(logs) == jchecks.validate_frame_log(jlogs)
    chi = arrays["chi_inliers"].copy()
    chi[3] = np.nan
    with pytest.raises(jchecks.StateValidationError):
        jchecks.validate_frame_log(jlogs._replace(chi_inliers=jnp.asarray(chi)))
    with pytest.raises(checks.StateValidationError, match="non-finite chi on 1 frames"):
        checks.validate_frame_log(logs._replace(chi_inliers=torch.as_tensor(chi)))


@pytest.mark.parametrize("new", [[1.0, np.nan], [1.0, 2.0], [np.inf, 3.0]])
def test_finite_or_previous_like_jax(new):
    old = np.array([0.5, -0.5], np.float32)
    oj, okj = jchecks.finite_or_previous(jnp.asarray(new, jnp.float32), jnp.asarray(old))
    ot, okt = checks.finite_or_previous(torch.tensor(new, dtype=torch.float32), torch.as_tensor(old))
    assert bool(okt) == bool(okj)
    assert np.array_equal(ot.numpy(), np.asarray(oj), equal_nan=True)


def test_checked_solve():
    out = checks.checked_solve(lambda a: (a * 2, {"n": a.sum()}), torch.ones(3))
    assert torch.equal(out[0], torch.full((3,), 2.0))
    with pytest.raises(FloatingPointError, match=r"leaves \[1\]"):
        checks.checked_solve(lambda a: (a, torch.log(a - 1), torch.ones(2, dtype=torch.int32)),
                             torch.zeros(3))


# ---------------------------------------------------------- fault injection --
@pytest.mark.parametrize("fault", ["drop", "descriptors", "pixels"])
def test_fault_injectors_match_jax(fault):
    from tpuvo.data.loader import FrameObservations as JObs

    seq = make_seq(frames=6, seed=21)
    calls = {"drop": ("drop_frames", ([1, 4],), {"seed": 3}),
             "descriptors": ("corrupt_descriptors", (0.2,), {"sigma": 2.0, "seed": 2}),
             "pixels": ("corrupt_pixels", (0.1,), {"magnitude": 150.0, "seed": 1})}
    name, args, kw = calls[fault]
    a = getattr(jfaults, name)(JObs(*seq), *args, **kw)
    b = getattr(faults, name)(seq, *args, **kw)
    assert type(b) is type(seq)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


# --------------------------------------------------- metrics and artifacts --
def test_metrics_jsonl_like_jax(run, tmp_path):
    _, _, logs, _ = run
    jlogs = jstate.FrameLog(**{k: jnp.asarray(getattr(logs, k).numpy()) for k in FrameLog._fields})
    lines = {}
    for name, mod, lg in (("jax", jmetrics, jlogs), ("port", metrics, logs)):
        path = str(tmp_path / f"{name}.jsonl")
        logger = mod.MetricsLogger(path)
        mod.log_frame_logs(logger, lg)
        logger.log({"event": "summary", "ate": 0.125, "n": np.int32(3), "ok": True})
        logger.close()
        lines[name] = [json.loads(ln) for ln in open(path)]
    for rec in lines["jax"] + lines["port"]:
        assert isinstance(rec.pop("ts"), float)
    assert lines["port"] == lines["jax"] and len(lines["port"]) == 10


def test_write_outputs_byte_identical(run, tmp_path):
    """The same EvalResult and a state converted with state_from_numpy:
    the four reference-format files byte for byte."""
    seq, state, _, poses = run
    jc = JCfg(**KW)
    res = jeval.evaluate(poses.numpy(), seq.gt_pose, jc)
    js = jax_state(state)
    jeval.write_outputs(str(tmp_path / "jax"), res, js, jc)
    teval.write_outputs(str(tmp_path / "port"), res, state_from_numpy(js, "cpu"),
                        EngineConfig(**KW))
    for f in ("estimated_trajectory.txt", "estimated_trajectory_scaled.txt", "errors.txt",
              "estimated_world_points.txt"):
        a, b = (tmp_path / "jax" / f).read_bytes(), (tmp_path / "port" / f).read_bytes()
        assert a == b and len(a) > 0, f


def test_scale_from_norm_ratio_like_jax():
    rng = np.random.default_rng(4)
    est = rng.normal(0, 2, (50, 3)).astype(np.float32)
    gt = 3.7 * est + rng.normal(0, 0.05, (50, 3)).astype(np.float32)
    est[3] = 0.0
    np.testing.assert_allclose(teval.scale_from_norm_ratio(est, gt),
                               jeval.scale_from_norm_ratio(est, gt), rtol=0, atol=1e-6)
    assert teval.scale_from_norm_ratio(np.zeros((2, 3)), gt[:2]) == 1.0


def test_render_all_writes_pngs(run, tmp_path):
    pytest.importorskip("matplotlib")
    seq, state, _, poses = run
    cfg = EngineConfig(**KW)
    plots.render_all(str(tmp_path), teval.evaluate(poses, seq.gt_pose, cfg), state, cfg)
    for f in ("gt_vs_est_trajectory.png", "scaled_est_trajectory.png", "translational_error.png",
              "rotational_error.png", "rotational_error_wrapped.png", "world_points_3d.png"):
        assert (tmp_path / f).stat().st_size > 1000, f


def test_render_all_without_matplotlib_says_why(run, tmp_path, monkeypatch, capsys):
    seq, state, _, poses = run
    cfg = EngineConfig(**KW)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import matplotlib -> ImportError
    plots.render_all(str(tmp_path), teval.evaluate(poses, seq.gt_pose, cfg), state, cfg)
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "PNGs skipped" in err[0]
    assert not list(tmp_path.glob("*.png"))


# -------------------------------------------------------------- profiling --
def test_trace_writes_the_program_spans(tmp_path):
    """``trace`` writes a Chrome trace holding the program's spans: a
    bootstrap with its host draw."""
    seq = make_seq()
    f0, f1 = vo.frame_of(seq, 0, "cpu"), vo.frame_of(seq, 1, "cpu")
    with profiling.trace(str(tmp_path)):
        vo.bootstrap_jit(vo.make_generator(0), f0, f1, EngineConfig(**KW))
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"tpuvo.bootstrap", "tpuvo.bootstrap.draw"} <= names
