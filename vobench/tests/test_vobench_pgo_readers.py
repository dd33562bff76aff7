"""The readers of the pose graph's replays (``pgo_replays``,
``pgo_replay_device_ms``) on a hand-made trace of two refines, and what
they read on a program whose solves run op by op, or with no refine."""

import pytest

from vobench import manifest
from vobench.trace import PREFIX, Ev, Trace

MS = 1_000_000  # ns


def _refines(replays=2):
    """A slice of 0-100 ms with two refines (0-40 ms, 50-90 ms), each with
    ``replays`` replays of the LM iteration (a span around its
    ``cudaGraphLaunch``; the card runs 3 ms of work a launch, its second
    kernel ending after the host has left the span), and one more replay
    outside both refines."""
    host = [Ev(PREFIX + "slice", 0, 100 * MS, 0), Ev("tpuvo.refine", 0, 40 * MS, 0),
            Ev("tpuvo.refine", 50 * MS, 90 * MS, 0)]
    device, corr = [], 0
    for t0 in (1, 51):
        for k in range(replays):
            t = (t0 + 5 * k) * MS
            corr += 1
            host += [Ev("tpuvo.replay.pgo_step", t, t + MS, 0),
                     Ev("cudaGraphLaunch", t, t + MS, corr)]
            device += [Ev("k1", t + MS, t + 2 * MS, corr), Ev("k2", t + 2 * MS, t + 4 * MS, corr)]
    corr += 1
    host += [Ev("tpuvo.replay.pgo_step", 95 * MS, 96 * MS, 0),
             Ev("cudaGraphLaunch", 95 * MS, 96 * MS, corr)]
    device += [Ev("k1", 96 * MS, 99 * MS, corr)]
    launches = {e.corr: (e.start, e.name) for e in host if e.corr}
    return Trace([e._replace(corr=0) for e in host], device, launches)


def _read(name, tr):
    return manifest.reader(name)(dict(trace=tr))


def test_pgo_readers():
    tr = _refines()
    # 2 replays in each refine; the one outside both is not a refine's
    assert _read("pgo_replays", tr) == pytest.approx(2.0)
    # every replay of the slice, by correlation id: 3 ms each, the last too
    assert _read("pgo_replay_device_ms", tr) == pytest.approx(3.0)


@pytest.mark.parametrize("case", ["op by op", "no refine"])
def test_pgo_readers_without_replays(case):
    """Solves op by op (a parent): 0 replays a refine, no replay time; no
    refine span at all: nothing to divide by."""
    tr = _refines()
    if case == "op by op":
        tr = Trace([e for e in tr.host if e.name in ("tpuvo.refine", PREFIX + "slice")],
                   tr.device, {})
        assert _read("pgo_replays", tr) == 0.0
    else:
        tr = Trace([e for e in tr.host if e.name != "tpuvo.refine"], tr.device, tr.launches)
        assert _read("pgo_replays", tr) is None
        assert _read("pgo_replay_device_ms", tr) == pytest.approx(3.0)
        return
    assert _read("pgo_replay_device_ms", tr) is None
