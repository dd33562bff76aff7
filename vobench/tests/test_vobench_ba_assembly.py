"""The reader of ``ba_assembly_device_ms`` on a hand-made trace: the sums'
kernels of the local BA's replays, under either kernel's name, and None
where it has nothing to read."""

import pytest

from vobench import manifest
from vobench.trace import PREFIX, Ev, Trace

MS = 1_000_000  # ns


def _trace(kernel: str, spans: bool = True):
    """Two SLAM steps, a track replay (0-10 ms) and a BA replay (20-40 ms),
    each one graph launch; the BA graph runs two sums of ``kernel`` (2 and
    3 ms) among other kernels, the track graph none; an eager kernel of the
    same name runs outside any replay."""
    host = [Ev(PREFIX + "slice", 0, 100 * MS, 0),
            Ev("cudaGraphLaunch", 1 * MS, 2 * MS, 1), Ev("cudaGraphLaunch", 21 * MS, 22 * MS, 2),
            Ev("cudaLaunchKernel", 50 * MS, 51 * MS, 3)]
    if spans:
        host += [Ev("tpuvo.replay.slam_step.track", 0, 10 * MS, 0),
                 Ev("tpuvo.replay.slam_step.ba", 20 * MS, 40 * MS, 0)]
    device = [Ev("elementwise_kernel", 2 * MS, 4 * MS, 1),
              Ev("elementwise_kernel", 22 * MS, 24 * MS, 2),
              Ev(kernel, 24 * MS, 26 * MS, 2), Ev("gemm", 26 * MS, 27 * MS, 2),
              Ev(kernel, 27 * MS, 30 * MS, 2), Ev(kernel, 51 * MS, 60 * MS, 600)]
    launches = {e.corr: (e.start, e.name) for e in host if e.corr}
    return Trace([e._replace(corr=0) for e in host], device, launches)


def _read(tr):
    return manifest.reader("ba_assembly_device_ms")(dict(trace=tr))


@pytest.mark.parametrize("kernel", [
    "void at::native::(anonymous namespace)::segment_reduce_forward_kernel<float, long>(...)",
    "void (anonymous namespace)::segsum_kernel<9>(float const*, long const*, ...)"])
def test_reads_the_sums_of_the_ba_replays(kernel):
    assert _read(_trace(kernel)) == pytest.approx(5.0)


@pytest.mark.parametrize("case", ["no spans", "no sums", "no device activity"])
def test_reads_nothing_it_cannot_mean(case):
    if case == "no spans":
        tr = _trace("segsum_kernel<9>", spans=False)
    elif case == "no sums":
        tr = _trace("fused_kernel")
    else:
        tr = _trace("segsum_kernel<9>")
        tr.device = []
    assert _read(tr) is None
