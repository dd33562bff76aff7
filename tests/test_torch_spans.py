"""The program's spans (``tpuvo_torch/utils/profiling.span``) on the CPU.

With no profiler recording a span is the one shared no-op context and
enters nothing of the profiler.  Under a CPU profiler each entry point
marks its host stages: a bootstrap with its RANSAC draw inside, then a scan
or one span a step.  On the graphs (``FakeGraph`` standing in for the CUDA
graph, as in ``test_torch_graphs.py``) each replay is one span named by its
graph and branch, each capture one span, and neither holds another span:
no span is entered inside a captured body.
"""

from collections import Counter

import pytest
import torch

from test_torch_graphs import CFG, SLAM_CFG, fake, kernels, lanes, make_seq  # noqa: F401
from tpuvo_torch.engine import slam as tslam, vo as tvo
from tpuvo_torch.utils import graphs, profiling
import xdist_threads  # noqa: F401  (torch's share of the cores under xdist)

F = 6


def spans(run):
    """The ``tpuvo.*`` spans that ``run()`` records under a CPU profiler, as
    (name, start, end) in order of start, an enclosing span first."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    ev = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
          for e in prof.profiler.kineto_results.events()
          if e.name().startswith(profiling.PREFIX)]
    return sorted(ev, key=lambda e: (e[1], -e[2]))


def inside(a, b) -> bool:
    return b[1] <= a[1] and a[2] <= b[2]


def session(make, seq, frames=F):
    """A session started on frames 0 and 1 of ``seq``, then stepped over
    frames 1..frames-1; returns the session."""
    s = make()
    s.start(tvo.frame_of(seq, 0, "cpu"), tvo.frame_of(seq, 1, "cpu"))
    for i in range(1, frames):
        s.step(tvo.frame_of(seq, i, "cpu"))
    return s


def entry(name):
    """(the entry point's run, the span of its tracking, how many of them)."""
    if name == "run_batch":
        fr = lanes(2, F)
        return lambda: tvo.run_batch(fr, CFG), "tpuvo.track_scan", 1
    if name == "OnlineVO":
        seq = make_seq(frames=F)
        return lambda: session(lambda: tvo.OnlineVO(CFG), seq), "tpuvo.vo.step", F - 1
    seq = make_seq(SLAM_CFG, frames=F)
    return (lambda: session(lambda: tslam.OnlineSLAM(SLAM_CFG, max_frames=F), seq),
            "tpuvo.slam.step", F - 1)


def test_spans_off_enter_nothing(fake, monkeypatch):
    """No profiler: ``span`` gives the shared no-op context, and an OnlineVO
    run, eager and on the graphs, never enters ``record_function``."""
    def entered(*a, **k):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", entered)
    assert profiling.span("vo.step") is profiling.span("replay.track_step")
    assert profiling.span("bootstrap") is profiling._OFF
    seq = make_seq(frames=F)
    for on in (False, True):
        fake(on)
        session(lambda: tvo.OnlineVO(CFG), seq)
    assert graphs.captures == 2 and graphs.replays == F


@pytest.mark.parametrize("name", ["run_batch", "OnlineVO", "OnlineSLAM"])
def test_entry_points_mark_their_stages(name):
    """The bootstrap holds its draw; then the scan, or one span a step, each
    after the bootstrap and after one another."""
    run, step, n = entry(name)
    got = spans(run)
    assert [s[0] for s in got] == ["tpuvo.bootstrap", "tpuvo.bootstrap.draw"] + [step] * n
    boot, draw, *steps = got
    assert inside(draw, boot)
    assert steps[0][1] >= boot[2]
    assert all(a[2] <= b[1] for a, b in zip(steps, steps[1:]))


def test_graph_spans_name_each_replay_and_capture(fake):
    """OnlineSLAM on the graphs: one replay span a replay, named by graph and
    branch (``slam_step.ba``, ``slam_step.track``), each inside its step; one
    capture span a capture; no span inside a replay or a capture."""
    n = 12
    seq = make_seq(SLAM_CFG, frames=n)
    fake(True)
    out = {}
    got = spans(lambda: out.setdefault("s", session(
        lambda: tslam.OnlineSLAM(SLAM_CFG, max_frames=n), seq, n)))
    n_ba = out["s"].n_local_ba_runs
    assert 0 < n_ba < n - 1
    replays = [s for s in got if s[0].startswith("tpuvo.replay.")]
    captures = [s for s in got if s[0].startswith("tpuvo.capture.")]
    assert len(replays) == graphs.replays == n
    assert Counter(s[0] for s in replays) == {"tpuvo.replay.bootstrap": 1,
                                              "tpuvo.replay.slam_step.ba": n_ba,
                                              "tpuvo.replay.slam_step.track": n - 1 - n_ba}
    assert len(captures) == graphs.captures == 3
    assert {s[0] for s in captures} == {"tpuvo.capture.bootstrap", "tpuvo.capture.slam_step.ba",
                                        "tpuvo.capture.slam_step.track"}
    steps = [s for s in got if s[0] == "tpuvo.slam.step"]
    assert len(steps) == n - 1
    assert all(sum(inside(r, s) for r in replays) == 1 for s in steps)
    for outer in replays + captures:
        assert not [s for s in got if s is not outer and inside(s, outer)]


def test_refine_marks_its_stages_in_order(monkeypatch):
    """``refine_trajectory_loop`` under a CPU profiler: ``tpuvo.refine``
    around the topology, ``close_loops`` (its co-visibility, relocalisation
    and both PGO passes inside, in that order) and one span a sweep, the
    first coarse; with no profiler it enters nothing of the profiler."""
    from tpuvo_torch.ba import loop
    from tpuvo_torch.config import BAConfig
    from tpuvo_torch.engine import ba_refine

    n = 8
    seq = make_seq(frames=n)
    state, _, poses, _ = tvo.run_sequence(seq, CFG, device="cpu")
    ba = BAConfig(window=n, iterations=1, huber_threshold=500.0)
    pgo_solve = loop.pgo_solve  # one LM iteration a pass: the spans, not the solve, are tested
    monkeypatch.setattr(loop, "pgo_solve", lambda g, iterations, **k: pgo_solve(g, 1, **k))
    run = lambda: ba_refine.refine_trajectory_loop(state, seq, poses, CFG, ba, n_sweeps=2)
    got = spans(run)
    names = [s[0] for s in got]
    loop = ["tpuvo.loop.covis", "tpuvo.loop.reloc", "tpuvo.loop.pgo.l2", "tpuvo.loop.pgo.robust"]
    assert names[:7] == ["tpuvo.refine", "tpuvo.refine.topology", "tpuvo.refine.close_loops"] + loop
    sweeps = names[7:]
    assert sweeps[0] == "tpuvo.refine.sweep.coarse" and len(sweeps) >= 2
    assert set(sweeps[1:]) == {"tpuvo.refine.sweep.fine"}
    outer, *inner = got
    assert all(inside(s, outer) for s in inner)
    assert all(inside(s, got[2]) for s in got[3:7])
    assert all(a[2] <= b[1] for a, b in zip(got[3:7], got[4:7]))
    assert all(a[2] <= b[1] for a, b in zip([got[1], got[2]] + got[7:], [got[2]] + got[7:]))

    def entered(*a, **k):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", entered)
    p, x, _ = run()
    assert torch.isfinite(p).all() and torch.isfinite(x).all()
