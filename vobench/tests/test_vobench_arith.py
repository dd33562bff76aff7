"""The metric arithmetic on fixed inputs: percentiles, rates, spreads, the
device-activity union and idle gaps, attribution to spans, rooflines."""

import pytest

from vobench import roofline, stats
from vobench.trace import PREFIX, Ev, Trace, merge, union_ns


def test_percentile_matches_linear_interpolation():
    xs = [5.0, 1.0, 4.0, 2.0, 3.0]
    assert stats.percentile(xs, 0) == 1.0
    assert stats.percentile(xs, 50) == 3.0
    assert stats.percentile(xs, 100) == 5.0
    assert stats.percentile(xs, 95) == pytest.approx(4.8)
    assert stats.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_rate():
    assert stats.rate(30976 * 10, 2.0, 4.5) == pytest.approx(123904.0)
    with pytest.raises(ValueError):
        stats.rate(1, 1.0, 1.0)


def test_union_merges_overlaps():
    assert merge([(5, 7), (0, 2), (1, 3), (6, 9)]) == [(0, 3), (5, 9)]
    assert union_ns([(0, 10), (2, 3), (10, 12), (20, 25)]) == 17


def _trace():
    host = [Ev(PREFIX + "slice", 0, 100, 0), Ev(PREFIX + "bootstrap", 0, 30, 0),
            Ev(PREFIX + "track_scan", 40, 100, 0), Ev("aten::rand", 2, 20, 0),
            Ev("cudaGraphLaunch", 25, 26, 1), Ev("cudaGraphLaunch", 45, 46, 2),
            Ev("cudaMemcpyAsync", 50, 51, 3)]
    launches = {e.corr: (e.start, e.name) for e in host if e.corr}
    device = [Ev("sym_eig_kernel", 26, 30, 1), Ev("picp_solve_kernel", 46, 60, 2),
              Ev("match_top2_kernel", 60, 70, 2), Ev("Memcpy DtoD", 70, 72, 3),
              Ev("late", 150, 160, 2)]
    return Trace([e._replace(corr=0) if not e.name.startswith("cu") else e for e in host],
                 device, launches)


def test_idle_share_spans_and_gaps():
    tr = _trace()
    assert tr.window_s == pytest.approx(100e-9)
    assert tr.busy_s == pytest.approx(30e-9)      # 26-30, 46-72; the late one is outside
    assert tr.idle_pct() == pytest.approx(70.0)
    scan = tr.in_span("track_scan", call="cudaGraphLaunch")
    assert [e.name for e in scan] == ["picp_solve_kernel", "match_top2_kernel"]
    assert [e.name for e in tr.in_span("track_scan")] == [
        "picp_solve_kernel", "match_top2_kernel", "Memcpy DtoD"]
    assert [e.name for e in tr.in_span("bootstrap")] == ["sym_eig_kernel"]
    assert not Trace.is_kernel(Ev("Memcpy DtoD", 0, 1, 0))
    assert tr.kernel_s("picp_solve") == pytest.approx(14e-9)
    gaps = tr.idle_gaps(2)
    assert gaps[0] == [f"{PREFIX}track_scan/-", pytest.approx(28e-9)]  # 72-100
    assert gaps[1] == [f"{PREFIX}bootstrap/aten::rand", pytest.approx(26e-9)]  # 0-26
    assert tr.top_ops(1) == [["picp_solve_kernel", pytest.approx(14e-9)]]


def test_rooflines():
    flops, nbytes = roofline.picp_work(1000.0 * 5, 10, 128)
    assert flops == 190 * 5000
    assert nbytes == 10 * (128 * 29 + 145)
    t, by = roofline.bound_s(flops, nbytes)
    assert by == "operations" and t == pytest.approx(flops / 67e12)
    assert roofline.share_pct(flops, nbytes, 2 * t) == pytest.approx(50.0)
    assert roofline.share_pct(flops, nbytes, 0.0) is None
    f, b = roofline.match_work(100 * 400, [(1, 128, 512)], 10)
    assert f == 2 * 10 * 40000
    assert b == 128 * 40 + 128 + 512 * 40 + 512 + 128 * 17


class _KinetoEvent:
    def __init__(self, name, dev, start, dur, corr=0, linked=0, annotation=False):
        self._v = (name, dev, start, dur, corr, linked, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def test_from_kineto_keeps_device_activity_only():
    """A host span mirrored on the device's timeline (a user annotation) is
    no device activity: counting it would fill the idle gaps it spans."""
    ev = [_KinetoEvent(PREFIX + "slice", "DeviceType.CPU", 0, 100),
          _KinetoEvent(PREFIX + "step", "DeviceType.CPU", 10, 80),
          _KinetoEvent("cudaGraphLaunch", "DeviceType.CPU", 12, 2, corr=7),
          _KinetoEvent(PREFIX + "step", "DeviceType.CUDA", 15, 70, annotation=True),
          _KinetoEvent("gpu_annotation", "DeviceType.CUDA", 15, 70, annotation=True),
          _KinetoEvent("picp_solve_kernel", "DeviceType.CUDA", 20, 10, corr=99, linked=7)]
    tr = Trace.from_kineto(ev)
    assert [e.name for e in tr.device] == ["picp_solve_kernel"]
    assert tr.idle_pct() == pytest.approx(90.0)
    assert [e.name for e in tr.in_span("step", call="cudaGraphLaunch")] == ["picp_solve_kernel"]
