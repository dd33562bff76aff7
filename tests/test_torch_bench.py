"""``tpuvo_torch.bench`` against the JAX package's ``bench.py`` on the CPU.

One run of each, in the same environment (2 lanes, 1 latency rep, the
synthetic fallback sequence): the JAX ``bench.main()`` in this process,
with ``evaluate`` and ``render_sequence`` wrapped to record the
configurations and sequences it builds and its trackers replaced by the
ground truth (``stub_jax_trackers``: compiling and running the JAX tracker
on the CPU was most of the module's time and fed nothing compared), and
``python -m tpuvo_torch --device cpu bench`` as a process of its own,
started first so the two run side by side: the port's one end-to-end run
of the subcommand on the CPU, with its real tracker.  The JAX run also
runs its SLAM section, with ``run_sequence_slam`` and
``refine_trajectory_loop`` replaced by stubs that record their arguments
and return the ground-truth poses; the port's SLAM section is called in
process with the same stubs, and its process runs without it, as both
benches do by default on the CPU.

Compared: the configurations field for field, the ``TPUVO_*`` names read,
the fallback and SLAM sequences bit for bit, the JSON line's key set,
``metric``, ``unit`` and echoed settings: what the bench's control flow
builds, whatever its tracker returns.  Whole-run ATEs are not compared
across the packages (per-step parity is held elsewhere; whole runs are
held to gates): the port's ATE and ``map_count`` are held to the port's
own ``run_sequence`` on the same inputs (1e-6, exact).

The fallback walks off its world, so the port's real gates read false.
The two benches' gate booleans are compared where they can pass and where
they fail: both read the fallback written as a dataset, with a golden
trajectory beside it, and their trackers replaced by the ground truth.
"""

import collections
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuvo.engine.ba_refine as jba_refine
import tpuvo.engine.eval as jeval
import tpuvo.engine.slam as jslam
import tpuvo.engine.vo as jvo
from tpuvo.data import synthetic as jsyn
from tpuvo_torch import bench as tbench, cli
from tpuvo_torch.config import EngineConfig
from tpuvo_torch.data import synthetic as tsyn
from tpuvo_torch.data.writer import write_dataset
from tpuvo_torch.engine import ba_refine as tba_refine, eval as teval, slam as tslam, vo as tvo
import xdist_threads  # noqa: F401  (torch's share of the cores under xdist)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLAM_KEYS = {"slam_fps", "ate_slam", "ate_refined", "slam_gate_ok", "slam_frames",
             "slam_refine_s"}


def bench_env(tmp):
    return {"TPUVO_BENCH_BATCH": "2", "TPUVO_BENCH_LAT_REPS": "1", "TPUVO_BENCH_SLAM": "1",
            "TPUVO_DATA": os.path.join(tmp, "absent"),
            "JAX_COMPILATION_CACHE_DIR": os.path.join(tmp, "jax_cache")}


def gt_poses(syn, seq, cfg):
    """A stub SLAM result: the sequence's true camera-in-world poses."""
    return np.stack([syn.camera_pose_from_gt(g, cfg) for g in np.asarray(seq.gt_pose)])


def stub_slam(mp, slam_mod, refine_mod, syn, rec, wrap=np.asarray):
    """Replace run_sequence_slam and refine_trajectory_loop by recorders."""

    def run_sequence_slam(seq, cfg, seed=42, **kw):
        rec.update(slam_seq=seq, slam_cfg=cfg, slam_seed=seed)
        return None, None, wrap(gt_poses(syn, seq, cfg)), {}

    def refine_trajectory_loop(state, seq, poses, cfg, ba_cfg, n_sweeps=3):
        rec.update(refine_cfg=ba_cfg, n_sweeps=n_sweeps)
        return poses, None, None

    mp.setattr(slam_mod, "run_sequence_slam", run_sequence_slam)
    mp.setattr(refine_mod, "refine_trajectory_loop", refine_trajectory_loop)


def jax_bench(env, stubs):
    """The JAX ``bench.main()`` in this process under ``env``, with
    ``stubs(monkeypatch)`` applied; returns its line.  Its compilation cache
    setting is put back after it."""
    spec = importlib.util.spec_from_file_location("bench", os.path.join(REPO, "bench.py"))
    jbench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jbench)
    old_cache = jax.config.jax_compilation_cache_dir
    buf = io.StringIO()
    try:
        with pytest.MonkeyPatch.context() as mp:
            for k, v in env.items():
                mp.setenv(k, v)
            stubs(mp)
            with contextlib.redirect_stdout(buf):
                jbench.main()
    finally:
        from jax._src import compilation_cache

        jax.config.update("jax_compilation_cache_dir", old_cache)
        compilation_cache.reset_cache()
    return json.loads(buf.getvalue().splitlines()[-1])


# (a shift of every row's x, a shift of one row's x, rows dropped) of the
# golden file, and whether the gate should pass: within both thresholds,
# beyond the mean's, beyond the max's, and a file one row short (skipped)
GOLDEN_CASES = {"within": (0.05, 0.0, 0, True), "mean_beyond": (0.2, 0.0, 0, False),
                "max_beyond": (0.0, 0.5, 0, False), "length_mismatch": (0.05, 0.0, 1, True)}
State = collections.namedtuple("State", "map_count")
Log = collections.namedtuple("Log", "pose")


@pytest.fixture(scope="module")
def gt_dataset(tmp_path_factory):
    """The fallback sequence written as a dataset in the reference's layout,
    and its true camera poses relative to frame 0's."""
    cfg = EngineConfig()
    world = tsyn.make_world(0, n_landmarks=1000)
    seq = tsyn.render_sequence(world, tsyn.make_planar_trajectory(cfg.n_frames), cfg,
                               pixel_noise=0.1)
    poses = gt_poses(tsyn, seq, cfg)
    rel = (np.linalg.inv(poses[0]) @ poses).astype(np.float32)
    return write_dataset(str(tmp_path_factory.mktemp("gt_dataset")), seq, world, cfg), seq, rel


def stub_jax_trackers(mp, rel):
    """Every tracker of the JAX bench replaced by one that returns ``rel``."""
    pose, state = jnp.asarray(rel[1:]), State(jnp.int32(7))
    mp.setattr(jvo, "bootstrap", lambda *a: (state, jnp.zeros(())))
    mp.setattr(jvo, "make_tracker", lambda cfg: lambda s, c, n: (s, Log(pose)))
    mp.setattr(jvo, "full_run_jit", lambda *a: (state, Log(pose)))
    mp.setattr(jvo, "scan_tracker",
               lambda s, c, n, cfg: (s, Log(jnp.zeros((c.uv.shape[0], 4, 4)))))


def stub_port_trackers(mp, rel):
    """Every tracker of the port's bench replaced by one that returns ``rel``."""
    pose, state = torch.as_tensor(rel[1:]), State(torch.tensor(7))
    mp.setattr(tvo, "bootstrap", lambda *a: (state, None))
    mp.setattr(tvo, "make_tracker", lambda cfg: lambda s, c, n: (s, Log(pose)))
    mp.setattr(tvo, "full_run_jit", lambda *a: (state, Log(pose)))
    mp.setattr(tvo, "run_batch", lambda *a, **kw: None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, gt_dataset):
    """(the JAX bench's line with its trackers stubbed, what it built, the
    port process's stdout, its environment)."""
    tmp = str(tmp_path_factory.mktemp("bench"))
    env = bench_env(tmp)
    port = subprocess.Popen(
        [sys.executable, "-m", "tpuvo_torch", "--device", "cpu", "bench"], cwd=REPO,
        env={**os.environ, **env, "TPUVO_BENCH_SLAM": "0", "PYTHONPATH": REPO},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    rec = {"eval_cfgs": [], "rendered": []}

    def record(mp):
        evaluate, render = jeval.evaluate, jsyn.render_sequence
        mp.setattr(jeval, "evaluate",
                   lambda p, gt, cfg, **kw: (rec["eval_cfgs"].append(cfg),
                                             evaluate(p, gt, cfg, **kw))[1])
        mp.setattr(jsyn, "render_sequence",
                   lambda *a, **kw: (rec["rendered"].append(render(*a, **kw)),
                                     rec["rendered"][-1])[1])
        stub_slam(mp, jslam, jba_refine, jsyn, rec)
        stub_jax_trackers(mp, gt_dataset[2])

    try:
        jline = jax_bench(env, record)
    finally:
        out, err = port.communicate(timeout=900)
    assert port.returncode == 0, err[-3000:]
    return jline, rec, out, env


@pytest.fixture
def env(runs, monkeypatch):
    for k, v in runs[3].items():
        monkeypatch.setenv(k, v)
    return runs[3]


def port_line(runs):
    return json.loads(runs[2].splitlines()[-1])


def fields(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("which", [0, 1], ids=["throughput", "latency"])
def test_configs_equal_jax(runs, env, which):
    """(a) The throughput/gate configuration and the latency profile, as the
    JAX bench handed them to evaluate (gate, then the latency warm run)."""
    assert fields(tbench.configs("cpu")[which]) == fields(runs[1]["eval_cfgs"][which])


def test_slam_profile_equal_jax(runs, env, monkeypatch):
    """(b) The SLAM profile, its sequence, seed and refine configuration as
    the JAX bench handed them to run_sequence_slam and the refiner; the
    port's section reads them the same way (stubbed alike)."""
    jrec = runs[1]
    cfg_slam = tbench.configs("cpu")[2]
    assert fields(cfg_slam) == fields(jrec["slam_cfg"])
    rec = {}
    stub_slam(monkeypatch, tslam, tba_refine, tsyn, rec, wrap=torch.as_tensor)
    keys = tbench.slam(cfg_slam, "cpu")
    assert fields(rec["slam_cfg"]) == fields(jrec["slam_cfg"])
    assert fields(rec["refine_cfg"]) == fields(jrec["refine_cfg"])
    assert (rec["slam_seed"], rec["n_sweeps"]) == (jrec["slam_seed"], jrec["n_sweeps"])
    for k in jrec["slam_seq"]._fields:
        got = getattr(rec["slam_seq"], k)
        np.testing.assert_array_equal(got.numpy() if isinstance(got, torch.Tensor) else got,
                                      np.asarray(getattr(jrec["slam_seq"], k)), err_msg=k)
    jextra = runs[0]["extra"]
    assert set(keys) == SLAM_KEYS == SLAM_KEYS & set(jextra)
    assert keys["slam_gate_ok"] == jextra["slam_gate_ok"]


def test_env_names_equal_jax():
    """(c) The TPUVO_* names each bench reads (their sources as text)."""
    names = lambda path: set(re.findall(r"TPUVO_[A-Z_]+", open(path).read()))
    jnames = names(os.path.join(REPO, "bench.py"))
    assert jnames and names(tbench.__file__) == jnames


def test_fallback_sequence_bit_equal(runs, env):
    """(d) The synthetic fallback the JAX bench rendered first."""
    jseq = runs[1]["rendered"][0]
    seq = tbench.bench_sequence(tbench.configs("cpu")[0], env["TPUVO_DATA"])
    for k in jseq._fields:
        np.testing.assert_array_equal(getattr(seq, k), np.asarray(getattr(jseq, k)), err_msg=k)


def test_json_line_keys_equal_jax(runs):
    """(e) The line's key set (the port's process without its SLAM section),
    metric, unit, echoed settings and the baseline constant."""
    jline, pline = runs[0], port_line(runs)
    assert set(pline) == set(jline)
    assert set(pline["extra"]) == set(jline["extra"]) - SLAM_KEYS
    for k in ("metric", "unit"):
        assert pline[k] == jline[k]
    for k in ("batch", "latency_reps", "cpp_baseline_fps"):
        assert pline["extra"][k] == jline["extra"][k]
    assert (pline["extra"]["batch"], pline["extra"]["latency_reps"]) == (2, 1)
    assert pline["extra"]["device"] == "cpu"


def test_gates_and_accuracy_match_run_sequence(runs, env):
    """(f) The port's real gates read false on the fallback, which walks off
    its world (the two benches' gate booleans are compared by
    test_gates_equal_jax_where_they_can_pass, true and false); the port's
    ATE and map_count are those of its own run_sequence on the same
    sequence, config and seed."""
    px = port_line(runs)["extra"]
    for k in ("accuracy_gate_ok", "latency_accuracy_ok"):
        assert px[k] is False
    assert port_line(runs)["vs_baseline"] == 0.0
    cfg = tbench.configs("cpu")[0]
    seq = tbench.bench_sequence(cfg, env["TPUVO_DATA"])
    gate = tbench.accuracy_gate(seq, tvo.frames_of(seq, 0, seq.uv.shape[0], "cpu"), cfg,
                                env["TPUVO_DATA"])
    state, _, poses, _ = tvo.run_sequence(seq, cfg, seed=42, device="cpu")
    ate = teval.evaluate(poses, seq.gt_pose, cfg).ate_rmse
    assert abs(gate["acc"]["ate_rmse"] - ate) <= 1e-6
    assert int(gate["state"].map_count) == int(state.map_count) == px["map_count"]
    assert px["ate_rmse"] == round(gate["acc"]["ate_rmse"], 4)


@pytest.mark.parametrize("case", list(GOLDEN_CASES))
def test_gates_equal_jax_where_they_can_pass(case, gt_dataset, tmp_path, monkeypatch):
    """Both benches read a dataset with the reference's scaled trajectory
    beside it, each tracker replaced by the ground truth so that the
    accuracy gates can pass.  The golden file is the ground truth's own
    scaled trajectory (``eval.write_outputs``, the reference's layout),
    shifted or cut per case (evaluated as the bench evaluates, in its
    configuration).  The gate booleans, the golden keys and their
    values are the JAX bench's."""
    shift, spike, drop, ok = GOLDEN_CASES[case]
    data, seq, rel = gt_dataset
    os.symlink(data, tmp_path / "data")
    teval.write_outputs(str(tmp_path / "output"),
                        teval.evaluate(rel, seq.gt_pose, tbench.configs("cpu")[0]))
    path = tmp_path / "output" / "estimated_trajectory_scaled.txt"
    ref = np.loadtxt(path)
    ref[:, 1] += shift
    ref[60, 1] += spike
    np.savetxt(path, ref[:len(ref) - drop])
    env = {**bench_env(str(tmp_path)), "TPUVO_DATA": str(tmp_path / "data"),
           "TPUVO_BENCH_SLAM": "0"}
    jline = jax_bench(env, lambda mp: stub_jax_trackers(mp, rel))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    stub_port_trackers(monkeypatch, rel)
    with contextlib.redirect_stdout(io.StringIO()):
        pline = tbench.main(device="cpu")
    jx, px = jline["extra"], pline["extra"]
    assert set(px) == set(jx)
    assert px["accuracy_gate_ok"] is jx["accuracy_gate_ok"] is ok
    assert px["latency_accuracy_ok"] is jx["latency_accuracy_ok"] is True
    assert (pline["vs_baseline"] > 0) is (jline["vs_baseline"] > 0) is ok
    assert px["map_count"] == jx["map_count"] == 7
    for k in ("ate_rmse", "trans_err_mean", "ate_robot"):
        assert abs(px[k] - jx[k]) <= 2e-4, k
    if drop:
        assert px["golden_gate_skipped"] == jx["golden_gate_skipped"] == "len 121 vs ref 120"
    else:
        assert {k for k in px if k.startswith("golden")} == {"golden_dev_mean", "golden_dev_max"}
        want = {"golden_dev_mean": shift + spike / len(ref), "golden_dev_max": shift + spike}
        for k, v in want.items():
            assert abs(px[k] - jx[k]) <= 2e-4 and abs(px[k] - v) <= 1e-3, k


def test_latency_reps_bit_equal(env):
    """(g) Each latency rep starts from a fresh generator: two reps give the
    same poses bit for bit (30 frames of the fallback)."""
    cfg_lat = tbench.configs("cpu")[1]
    seq = tbench.bench_sequence(cfg_lat, env["TPUVO_DATA"])
    frames = tvo.frames_of(seq, 0, 30, "cpu")
    _, a = tbench.latency_run(frames, cfg_lat)
    _, b = tbench.latency_run(frames, cfg_lat)
    assert torch.equal(a.pose, b.pose)


def test_process_prints_one_line(runs):
    """(h) ``python -m tpuvo_torch --device cpu bench``: one stdout line, JSON."""
    lines = runs[2].splitlines()
    assert len(lines) == 1
    assert port_line(runs)["metric"] == "vo_frames_per_second"


def test_bench_without_a_card_raises(monkeypatch):
    """(i) The CLI's bench on the card (the default) without one raises
    before any work, as run_sequence does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        cli.main(["bench"])
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        tbench.main()


def test_module_entry_without_a_card_fails():
    """``python -m tpuvo_torch.bench`` runs the bench on the card: with no
    card visible it exits non-zero and prints no result."""
    r = subprocess.run([sys.executable, "-m", "tpuvo_torch.bench"], cwd=REPO,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout == ""
    assert "no CUDA device is available" in r.stderr
