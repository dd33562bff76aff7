"""The refine cell (``kitti_loop200_refine.refine``, driver ``refine``) on the
CPU at a cut size: a sound run is correct; a run with a fault planted under
the timed path, and the control in the program's place, are not; and its
four per-layer readers on a hand-made trace.

The cut: 60 frames of the cell's world, 128 keypoints, 1,024 slots, 16 new
landmarks a frame, two tracked sequences; at this size every refine keeps
32 loop edges and runs 4 sweeps (one more than ``n_sweeps``)."""

import json

import pytest
import torch

from vobench import check, control, manifest, run
from vobench.trace import PREFIX, Ev, Trace
from tpuvo_torch.ba import loop, window
from tpuvo_torch.ba.posegraph import PGOStats
from tpuvo_torch.engine import ba_refine
from tpuvo_torch.ops import lie

CELL = "kitti_loop200_refine.refine"
SEED = 2**31 + 4242
F, N, CAP = 60, 128, 1024


def _edit(config, traffic):
    config["data"]["frames"] = config["engine"]["n_frames"] = F
    config["engine"].update(max_obs=N, map_capacity=CAP, max_new_landmarks_per_frame=16)
    config["refine"]["ba"].update(window=F, max_landmarks=CAP)
    traffic["sequences"] = 2
    traffic["check_problems"] = 2


def _run(capsys, seconds="12"):
    rc = run.run(["--workload", CELL, "--seed", str(SEED), "--seconds", seconds, "--trace", "0"],
                 device="cpu", edit=_edit)
    out = capsys.readouterr()
    assert rc == 0, out.err
    res = json.loads(out.out.strip().splitlines()[-1])
    assert list(res)[-1] == "checked"
    return res, out.err


def test_a_sound_run_is_correct(capsys):
    res, err = _run(capsys)
    assert res["correct"], res["checked"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}
    edges = json.loads(err.split("vobench: read n_loop_edges ")[1].splitlines()[0])
    sweeps = json.loads(err.split("vobench: read n_sweeps ")[1].splitlines()[0])
    assert min(edges) >= 1 and min(sweeps) == 4  # so that a sweep fewer is one the rule wants


# -- faults planted in the program, under the timed path --------------------
def _pgo_skipped(monkeypatch):
    def pgo_solve(graph, iterations=20, kernel_threshold=1.0, **k):
        z = torch.zeros((), device=graph.poses.device)
        return graph, PGOStats(z, z.int(), z.int())

    monkeypatch.setattr(loop, "pgo_solve", pgo_solve)


def _robust_pass_dropped(monkeypatch):
    orig = loop.pgo_solve

    def pgo_solve(graph, iterations=20, kernel_threshold=1.0, **k):
        if kernel_threshold < 1.0e8:
            iterations = 0
        return orig(graph, iterations=iterations, kernel_threshold=kernel_threshold, **k)

    monkeypatch.setattr(loop, "pgo_solve", pgo_solve)


def _coarse_sweep_skipped(monkeypatch):
    orig = ba_refine._global_sweep

    def sweep(poses_all, points, *a, **k):
        out = orig(poses_all, points, *a, **k)
        return (poses_all, points) + out[2:] if a[-1].keep_outliers else out

    monkeypatch.setattr(ba_refine, "_global_sweep", sweep)


def _fine_sweep_fewer(monkeypatch):
    """The plateau test passes at once: the refine stops at ``n_sweeps``,
    one sweep before the rule does at this size."""
    orig = ba_refine.refine_trajectory_global
    monkeypatch.setattr(ba_refine, "refine_trajectory_global",
                        lambda *a, **k: orig(*a, **k, rel_improvement_stop=1.0))


def _loop_edge_scaled(monkeypatch):
    orig = loop._relocalize_pairs

    def reloc(*a, **k):
        Z, w = orig(*a, **k)
        Z = Z.clone()
        Z[:, :3, 3] *= 1.01
        return Z, w

    monkeypatch.setattr(loop, "_relocalize_pairs", reloc)


def _odo_weight_scaled(monkeypatch):
    """The PGO's odometry edges weighted x 1.01: every hand-off holds, and
    only the PGO's iterations tell."""
    orig = loop.close_loops
    monkeypatch.setattr(loop, "close_loops",
                        lambda *a, **k: orig(*a, **k, odo_weight=25.0 * 1.01))


def _sweep_points_scaled(monkeypatch):
    orig = ba_refine._global_sweep

    def sweep(*a, **k):
        p, x, *rest = orig(*a, **k)
        return (p, x * 1.001, *rest)

    monkeypatch.setattr(ba_refine, "_global_sweep", sweep)


def _pose_one_free(monkeypatch):
    """``_global_sweep`` with only pose 0 fixed."""
    def sweep(poses_all, points, point_valid, obs_uv, obs_lm, obs_valid, K, cfg, ba_cfg,
              record=None):
        fixed = torch.arange(poses_all.shape[0], device=points.device) < 1
        prob = window.BAProblem(lie.inv_se3(poses_all), points, obs_uv, obs_lm, obs_valid,
                                point_valid, fixed)
        prob2, stats = window.ba_solve(prob, K, cfg.width, cfg.height, ba_cfg, record=record)
        ok = torch.isfinite(prob2.poses).all()
        p = torch.where((ok & ~fixed)[:, None, None], lie.inv_se3(prob2.poses), poses_all)
        x = torch.where((ok & torch.isfinite(prob2.points).all(1))[:, None], prob2.points, points)
        return p, x, stats.chi, stats.num_inliers, ~ok

    monkeypatch.setattr(ba_refine, "_global_sweep", sweep)


FAULTS = {"pgo_skipped": _pgo_skipped, "robust_pass_dropped": _robust_pass_dropped,
          "coarse_sweep_skipped": _coarse_sweep_skipped, "fine_sweep_fewer": _fine_sweep_fewer,
          "loop_edge_translation_scaled": _loop_edge_scaled, "odo_weight_scaled": _odo_weight_scaled,
          "sweep_points_scaled": _sweep_points_scaled, "pose_one_free": _pose_one_free}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_refine_is_not_correct(fault, monkeypatch, capsys):
    FAULTS[fault](monkeypatch)
    res, _ = _run(capsys, seconds="4")
    assert not res["correct"], res["checked"]


def test_the_control_is_not_correct():
    """The reference in the program's place with TF32's rounding of every
    product's inputs fails the cell's limits; in float32 it passes."""
    limits = manifest.limits(manifest.cell(CELL))
    assert not check.judge(control.control(CELL, SEED, "tf32-emulated", "cpu", _edit), limits)[0]
    assert check.judge(control.control(CELL, SEED, "float32", "cpu", _edit), limits)[0]


# -- the readers on a hand-made trace ----------------------------------------
MS = 1_000_000  # ns
READERS = ("close_loops_device_ms", "global_sweep_device_ms", "refine_launches",
           "device_idle_pct.refine")


def _trace(host, device):
    host = [Ev(PREFIX + "slice", 0, 100 * MS, 0)] + host
    launches = {e.corr: (e.start, e.name) for e in host if e.corr}
    return Trace([e._replace(corr=0) for e in host], device, launches)


def _refine():
    """A refine (1-91 ms): the topology (2-10), close_loops (10-40) with its
    four stages, a coarse sweep (40-60) and a fine one (60-90); a launch and
    a kernel in each stage, a copy out after the refine."""
    host = [Ev("tpuvo.refine", MS, 91 * MS, 0), Ev("tpuvo.refine.topology", 2 * MS, 10 * MS, 0),
            Ev("tpuvo.refine.close_loops", 10 * MS, 40 * MS, 0),
            Ev("tpuvo.refine.sweep.coarse", 40 * MS, 60 * MS, 0),
            Ev("tpuvo.refine.sweep.fine", 60 * MS, 90 * MS, 0)]
    for i, name in enumerate(("covis", "reloc", "pgo.l2", "pgo.robust")):
        host.append(Ev("tpuvo.loop." + name, (11 + 7 * i) * MS, (17 + 7 * i) * MS, 0))
    device, corr = [], 0
    for t in (3, 12, 19, 26, 33, 41, 61):
        corr += 1
        host.append(Ev("cudaLaunchKernel", t * MS, t * MS + MS // 2, corr))
        device.append(Ev("k", t * MS + MS // 2, (t + 2) * MS, 500 + corr))
    host += [Ev("cudaStreamIsCapturing", 50 * MS, 51 * MS, 90),
             Ev("cudaMemcpyAsync", 92 * MS, 93 * MS, 91)]
    # a sweep's kernel that runs past the span's end is still its work
    device += [Ev("k", 88 * MS, 95 * MS, 592), Ev("Memcpy DtoH", 93 * MS, 94 * MS, 591)]
    return _trace(host, device)


def _read(name, tr, plain_s=None):
    return manifest.reader(name)(dict(trace=tr, plain_s=plain_s))


def test_refine_readers():
    tr = _refine()
    # close_loops: the kernels at 12.5, 19.5, 26.5, 33.5, each 1.5 ms
    assert _read("close_loops_device_ms", tr) == pytest.approx(6.0)
    # the sweeps: 41.5-43 (coarse), 61.5-63 and 88-95 (fine): 10 ms over 2
    assert _read("global_sweep_device_ms", tr) == pytest.approx(5.0)
    # 7 kernel launches inside the refine; the capture query and the copy out are not
    assert _read("refine_launches", tr) == pytest.approx(7.0)
    # busy: 7 x 1.5 + 7 (the copy runs inside the last kernel) = 17.5 of 100 ms untraced
    assert _read("device_idle_pct.refine", tr, 0.1) == pytest.approx(82.5)


@pytest.mark.parametrize("case", ["no spans", "no device activity"])
def test_refine_readers_read_nothing_they_cannot_mean(case):
    """None where the program records none of the spans (a parent without
    them) or the trace saw no device activity."""
    tr = _refine()
    if case == "no spans":
        tr = _trace([e for e in tr.host if not e.name.startswith(("tpuvo.", PREFIX))], tr.device)
        want = dict.fromkeys(READERS[:3])
    else:
        tr = _trace([e._replace(corr=0) for e in tr.host if e.name != PREFIX + "slice"], [])
        want = dict.fromkeys(READERS[:3])
    assert {name: _read(name, tr, None) for name in READERS[:3]} == want
    assert _read("device_idle_pct.refine", tr, None) is None
