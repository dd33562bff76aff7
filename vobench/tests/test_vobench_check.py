"""The check on the CPU at a size a test run holds: the reference agrees
with the program's CPU path, and a run with the timed path broken
underneath, or the control in the program's place, comes out not correct.

Each run goes through ``vobench.run.run`` with the card's look skipped
(``device="cpu"``) and the cell cut to a few lanes or sequences of a few
frames; the limits are the cell's own."""

import json

import numpy as np
import pytest
import torch

from vobench import check, control, drive, gen, manifest, program, run
from tpuvo_torch.engine import slam, vo
from tpuvo_torch.ops import triangulate, twoview
from tpuvo_torch.ops.cuda import smalleig

CELLS = [w["name"] for w in manifest.load()["workloads"]]
SEED = 2**31 + 12345


def _driver(cell) -> str:
    return manifest.traffic(manifest.cell(cell))["driver"]


def _slam(cell) -> bool:
    return _driver(cell) == "slam_session"


def _edit(config, traffic):
    """A few lanes or sequences of a few frames; SLAM's local BA over a
    window of 4, so that about half the steps of 24 frames run it."""
    slam_cell = traffic["driver"] == "slam_session"
    frames = 24 if slam_cell else 12
    config["engine"]["n_frames"] = frames
    config["data"]["frames"] = frames
    if slam_cell:
        config["engine"]["local_ba_window"] = 4
    traffic["lanes" if traffic["driver"] == "batch" else "sequences"] = 3
    traffic["check_problems"] = 2
    if traffic.get("check_steps"):
        traffic["check_steps"] = 6


# long enough on this CPU for a session to finish a few whole sequences
SECONDS = {"batch": "1", "vo_session": "6", "slam_session": "40"}


def _run(cell, capsys):
    seconds = SECONDS[_driver(cell)]
    rc = run.run(["--workload", cell, "--seed", str(SEED), "--seconds", seconds, "--trace", "0"],
                 device="cpu", edit=_edit)
    out = capsys.readouterr()
    assert rc == 0, out.err
    res = json.loads(out.out.strip().splitlines()[-1])
    assert list(res)[-1] == "checked"
    return res


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell, capsys):
    res = _run(cell, capsys)
    assert res["correct"], res["checked"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("cell", [c for c in CELLS if not _slam(c)])
def test_reference_follows_the_tracker_step_by_step(cell):
    """Teacher-forced from the program's CPU state, the reference's tracker
    steps land within float32 rounding of the program's."""
    c = manifest.cell(cell)
    config, traffic = manifest.config(c), manifest.traffic(c)
    _edit(config, traffic)
    host = drive.batch_inputs(config, {**traffic, "lanes": 3}, SEED)
    batch = gen.to_device(host, "cpu")
    cfg = program.engine_config(config)
    ans, _ = program.run_batch(batch, cfg, seed=7)
    draws = check.uniforms(7, (3, cfg.ransac.num_hypotheses, cfg.max_obs))
    nums = check.numbers(ans, {k: torch.as_tensor(np.array(v)) for k, v in host.items()}, draws,
                         config, device="cpu")
    assert nums["state_faults"] == 0
    assert nums["step_pose_gap_p50"] < 1e-5
    assert nums["landmark_gap_p50"] < 1e-4
    assert nums["landmark_mismatch_share"] < 0.01
    assert nums["steps"] == 3 * (config["engine"]["n_frames"] - 1)
    x = {k: torch.as_tensor(np.array(v)) for k, v in host.items()}
    boot = check.boot_numbers(ans["T_boot"], {k: v[:, 0] for k, v in x.items()},
                              {k: v[:, 1] for k, v in x.items()}, draws, config, device="cpu")
    assert boot["boot_rot_gap_p50"] < 1e-4
    assert boot["boot_front_loss_p90"] == 0


@pytest.mark.parametrize("cell", [c for c in CELLS if _slam(c)])
def test_reference_follows_the_slam_step_with_its_local_ba(cell):
    """Copies of the program's SLAM carry around steps with and without the
    local BA: the reference's step from the copy before lands within float32
    rounding of the copy after."""
    c = manifest.cell(cell)
    config, traffic = manifest.config(c), manifest.traffic(c)
    _edit(config, traffic)
    F = config["engine"]["n_frames"]
    host = drive.session_inputs(config, {**traffic, "sequences": 1}, SEED)
    x = gen.to_device(host, "cpu")
    cfg = program.engine_config(config)
    s = program.SLAMSession(cfg, 99, F)
    s.start(program.frame_at(x, 0, 0), program.frame_at(x, 0, 1))
    boot, steps = s.snapshot(), []
    for i in range(1, F):
        before = s.snapshot() if i in (15, 16, 17, 18, 20) else None
        s.step(program.frame_at(x, 0, i))
        if before is not None:
            steps.append((i, before, s.snapshot()))
    assert [slam.local_ba_due(k, cfg) for k, _, _ in steps] == [False, True, False, True, True]
    smp = dict(frames={k: torch.as_tensor(np.array(v[0])) for k, v in host.items()},
               draws=check.uniforms(99, (cfg.ransac.num_hypotheses, cfg.max_obs)),
               T_boot=s.diag["T_boot"], boot=boot, steps=steps)
    nums = check.slam_numbers([smp], config, device="cpu")
    assert nums["state_faults"] == 0
    assert nums["step_pose_gap_p90"] < 1e-3
    assert nums["landmark_gap_p50"] < 1e-4
    assert nums["landmark_mismatch_share"] < 0.05


# -- faults planted in the program, under the timed path --------------------
def _unchanged_state(monkeypatch):
    """The tracker's step (and the SLAM step around it) returns the state it
    was given: only the frame counter moves on."""
    orig = vo.track_step

    def step(state, curr, nxt, cfg, *a, **k):
        _, log, *rest = orig(state, curr, nxt, cfg, *a, **k)
        return (state._replace(frame_idx=state.frame_idx + 1), log._replace(pose=state.pose),
                *rest)

    orig_slam = slam._step

    def slam_step(carry, *a, **k):
        return carry, orig_slam(carry, *a, **k)[1]

    monkeypatch.setattr(vo, "track_step", step)
    monkeypatch.setattr(slam, "_step", slam_step)


def _half_batch(monkeypatch):
    orig = vo.run_batch

    def run_batch(frames, cfg=None, seed=42, sample_idx=None):
        B = frames.uv.shape[0]
        h = max(B // 2, 1)
        out = orig(vo.Frame(*(x[:h] for x in frames)), cfg, seed, sample_idx)
        # the lanes left out get the answers of the lanes run, in turn
        twice = lambda t: t[torch.arange(B) % h] if isinstance(t, torch.Tensor) else t
        state, logs, poses, diag = out
        return (type(state)(*map(twice, state)), type(logs)(*map(twice, logs)), twice(poses),
                {k: twice(v) for k, v in diag.items()})

    monkeypatch.setattr(vo, "run_batch", run_batch)


def _pose_altered(monkeypatch):
    orig = vo.track_step

    def step(state, curr, nxt, cfg, *a, **k):
        s2, log, *rest = orig(state, curr, nxt, cfg, *a, **k)
        shift = torch.zeros_like(s2.pose)
        shift[..., 0, 3] = 1e-2
        return s2._replace(pose=s2.pose + shift), log._replace(pose=log.pose + shift), *rest

    monkeypatch.setattr(vo, "track_step", step)


def _points_altered(monkeypatch):
    orig = triangulate.triangulate_two_view

    def tri(*a, **k):
        pts, ok = orig(*a, **k)
        return pts * 1.001, ok

    monkeypatch.setattr(triangulate, "triangulate_two_view", tri)


def _kernel_c_svd_swapped(monkeypatch):
    """Kernel C's 3x3 SVD returns U with its first two columns swapped (the
    essential matrix's projection and the pose's decomposition take it)."""
    orig = smalleig.svd3

    def svd3(A):
        U, S, Vt = orig(A)
        return U[..., [1, 0, 2]], S, Vt

    monkeypatch.setattr(smalleig, "svd3", svd3)


def _cheirality_reversed(monkeypatch):
    """The pose recovery's vote lands on the translation reversed."""
    orig = twoview.recover_pose

    def recover_pose(*a, **k):
        res = orig(*a, **k)
        return res._replace(t=-res.t)

    monkeypatch.setattr(twoview, "recover_pose", recover_pose)


def _local_ba_skipped(monkeypatch):
    monkeypatch.setattr(slam, "_local_ba", lambda carry, k, cfg: carry)


FAULTS = {"unchanged_state": _unchanged_state, "half_batch": _half_batch,
          "pose_altered": _pose_altered, "points_altered": _points_altered,
          "local_ba_skipped": _local_ba_skipped, "kernel_c_svd_swapped": _kernel_c_svd_swapped,
          "cheirality_reversed": _cheirality_reversed}
# the faults each cell can have: half a batch only where there is a batch,
# a skipped local BA only where the backend runs
CASES = [(c, f) for c in CELLS for f in sorted(FAULTS)
         if (f != "half_batch" or _driver(c) == "batch")
         and (f != "local_ba_skipped" or _slam(c))]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch, capsys):
    FAULTS[fault](monkeypatch)
    res = _run(cell, capsys)
    assert not res["correct"], res["checked"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    """The reference in the program's place with TF32's rounding of every
    product's inputs fails the cell's limits; in float32 it passes."""
    limits = manifest.limits(manifest.cell(cell))
    low = control.control(cell, SEED, "tf32-emulated", "cpu", _edit)
    assert not check.judge(low, limits)[0]
    same = control.control(cell, SEED, "float32", "cpu", _edit)
    assert check.judge(same, limits)[0]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card with -m cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_on_the_card(cell, card):
    """On the card: the control (every product's inputs rounded to TF32)
    fails the cell's limits; the reference in float32 passes them."""
    limits = manifest.limits(manifest.cell(cell))
    assert not check.judge(control.control(cell, SEED, "tf32-emulated", "cuda", _edit),
                           limits)[0]
    assert check.judge(control.control(cell, SEED, "float32", "cuda", _edit), limits)[0]
