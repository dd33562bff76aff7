"""The readers of the program's spans (``vobench/program_spans.py`` and the
metrics that use it) on a hand-made trace, their None cases included."""

import pytest

from vobench import manifest
from vobench.trace import PREFIX, Ev, Trace

READERS = ("bootstrap_draw_ms", "bootstrap_device_ms", "slam_track_step_device_ms",
           "slam_ba_step_device_ms", "eager_launches_per_step")
MS = 1_000_000  # ns


def _trace(host, device):
    """A Trace of the slice 0-100 ms: ``host`` events (a runtime call given
    a correlation id is a launch), ``device`` activity by correlation id: a
    graph launch's, or (as the profiler links an eager launch) the id of
    the aten op that made it, which no runtime call has."""
    host = [Ev(PREFIX + "slice", 0, 100 * MS, 0)] + host
    launches = {e.corr: (e.start, e.name) for e in host if e.corr}
    return Trace([e._replace(corr=0) for e in host], device, launches)


def _batch():
    """A bootstrap (0-40 ms) with its draw (2-30 ms), a pinned copy and a
    graph launch inside it, then a scan's replay and a copy outside it."""
    host = [Ev("tpuvo.bootstrap", 0, 40 * MS, 0), Ev("tpuvo.bootstrap.draw", 2 * MS, 30 * MS, 0),
            Ev("cudaMemcpyAsync", 31 * MS, 32 * MS, 1),
            Ev("tpuvo.replay.bootstrap", 33 * MS, 35 * MS, 0),
            Ev("cudaGraphLaunch", 33 * MS, 34 * MS, 2),
            Ev("tpuvo.track_scan", 50 * MS, 90 * MS, 0), Ev("cudaGraphLaunch", 51 * MS, 52 * MS, 3),
            Ev("cudaMemcpyAsync", 53 * MS, 54 * MS, 4)]
    device = [Ev("Memcpy HtoD", 32 * MS, 33 * MS, 501), Ev("sym_eig_kernel", 34 * MS, 40 * MS, 2),
              Ev("match_top2_kernel", 39 * MS, 43 * MS, 2),
              Ev("picp_solve_kernel", 52 * MS, 60 * MS, 3), Ev("Memcpy DtoD", 61 * MS, 62 * MS, 502)]
    return _trace(host, device)


def _slam():
    """Three SLAM steps (each a frame copy, a replay, a pose copy; the
    second also a session's claim: two more copies), the first and third
    replaying the track-only graph, the second the local BA's; a runtime
    call that enqueues nothing (``cudaStreamIsCapturing``) before each
    graph launch."""
    host, device, corr = [], [], 10
    for i, (branch, claim) in enumerate((("track", 0), ("ba", 2), ("track", 0))):
        t = 30 * i * MS
        host.append(Ev("tpuvo.slam.step", t, t + 25 * MS, 0))
        calls = ["cudaMemcpyAsync"] * (1 + claim) + [
            "cudaStreamIsCapturing", "cudaGraphLaunch", "cudaLaunchKernel"]
        for j, call in enumerate(calls):
            s = t + (1 + 3 * j) * MS
            corr += 1
            if call == "cudaGraphLaunch":
                host.append(Ev("tpuvo.replay.slam_step." + branch, s, s + MS, 0))
                work = 9 if branch == "ba" else 1
                device += [Ev("k1", s + MS, s + 2 * MS, corr),
                           Ev("k2", s + 2 * MS, s + (2 + work) * MS, corr)]
            elif call != "cudaStreamIsCapturing":
                device.append(Ev("Memcpy DtoD" if "Memcpy" in call else "copy_kernel",
                                 s + MS, s + 2 * MS, 500 + corr))
            host.append(Ev(call, s, s + MS // 2, corr))
    # the benchmark's copy of the pose to the host, outside the program's step
    host.append(Ev("cudaMemcpyAsync", 26 * MS, 27 * MS, 99))
    device.append(Ev("Memcpy DtoH", 27 * MS, 28 * MS, 599))
    return _trace(host, device)


def _read(name, tr):
    return manifest.reader(name)(dict(trace=tr))


def test_bootstrap_readers():
    tr = _batch()
    assert _read("bootstrap_draw_ms", tr) == pytest.approx(28.0)
    # the copy 32-33 (started in the span) and the replay's 34-43: 10 ms; the
    # scan's kernel and copy are outside
    assert _read("bootstrap_device_ms", tr) == pytest.approx(10.0)


def test_slam_readers():
    tr = _slam()
    # each track replay: k1 1 ms then k2 1 ms; the BA replay: 1 + 9 ms
    assert _read("slam_track_step_device_ms", tr) == pytest.approx(2.0)
    assert _read("slam_ba_step_device_ms", tr) == pytest.approx(10.0)
    # 2 + 4 + 2 launches besides the graph's over 3 steps; the host copy is outside
    assert _read("eager_launches_per_step", tr) == pytest.approx(8 / 3)


@pytest.mark.parametrize("case", ["no spans", "no device activity", "CPU run"])
def test_readers_read_nothing_they_cannot_mean(case):
    """None where the program records none of the spans (a parent without
    them), where the trace saw no device activity, and on a CPU run (spans
    of the eager paths, no replay)."""
    if case == "no spans":
        tr = _trace([e for e in _slam().host + _batch().host if not e.name.startswith("tpuvo.")
                     and e.name != PREFIX + "slice"], _slam().device + _batch().device)
        want = dict.fromkeys(READERS)
    elif case == "no device activity":
        tr = _trace(_slam().host[1:] + _batch().host[1:], [])
        want = dict.fromkeys(READERS)
        want["bootstrap_draw_ms"] = pytest.approx(28.0)
    else:
        tr = _trace([Ev("tpuvo.bootstrap", 0, 9 * MS, 0),
                     Ev("tpuvo.bootstrap.draw", MS, 4 * MS, 0),
                     Ev("tpuvo.track_scan", 10 * MS, 90 * MS, 0)], [])
        want = dict.fromkeys(READERS)
        want["bootstrap_draw_ms"] = pytest.approx(3.0)
    assert {name: _read(name, tr) for name in READERS} == want
