"""One traced slice of whole units, read in memory: the profiler's device
activity (kernels, copies, fills), its host events, and the benchmark's own
spans (``span(name)``, recorded as ``vobench.<name>``).

A device activity belongs to the span that was open on the host when its
launch was made (a kernel, a copy or a whole graph launch: the runtime call
and the device activity share a correlation id).  The slice is the span
``vobench.slice``; device time is the union of activity intervals inside
it, both on the profiler's clock.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from typing import NamedTuple

PREFIX = "vobench."


class Ev(NamedTuple):
    name: str
    start: int  # ns, the profiler's clock
    end: int
    corr: int


def span(name: str):
    """A host span of the benchmark, visible in the trace."""
    import torch

    return torch.profiler.record_function(PREFIX + name)


@contextlib.contextmanager
def profiled(out: dict):
    """Profile the block (host and device); on exit ``out["trace"]`` holds
    the parsed Trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    card = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    with profile(activities=acts) as prof:
        with span("slice"):
            yield
            if card:
                torch.cuda.synchronize()
    out["trace"] = Trace.from_kineto(prof.profiler.kineto_results.events())


def merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def union_ns(intervals) -> int:
    return sum(e - s for s, e in merge(intervals))


class Trace:
    def __init__(self, host, device, launches):
        self.host = host          # [Ev] host events (operators, runtime calls, spans)
        self.device = device      # [Ev] device activity
        self.launches = launches  # correlation id -> (host start, name) of the runtime call
        sl = [e for e in host if e.name == PREFIX + "slice"]
        self.t0, self.t1 = (sl[0].start, sl[0].end) if sl else (0, 0)
        self.spans = [e for e in host if e.name.startswith(PREFIX) and e.name != PREFIX + "slice"]
        self.device = [e for e in device if e.end > self.t0 and e.start < self.t1]

    @classmethod
    def from_kineto(cls, events):
        host, device, launches = [], [], {}
        for e in events:
            s = e.start_ns()
            ev = Ev(e.name(), s, s + e.duration_ns(), 0)
            if "CPU" in str(e.device_type()):
                host.append(ev)
                if e.name().startswith("cu"):  # a runtime or driver call
                    launches[e.correlation_id()] = (s, e.name())
            elif not (e.is_user_annotation() or e.name().startswith(PREFIX)):
                # (a host span's mirror on the device's timeline is no activity)
                corr = e.linked_correlation_id() or e.correlation_id()
                device.append(ev._replace(corr=corr))
        return cls(host, device, launches)

    @staticmethod
    def is_kernel(e: Ev) -> bool:
        return not e.name.startswith(("Memcpy", "Memset", "memcpy", "memset"))

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def clipped(self, events):
        return [(max(e.start, self.t0), min(e.end, self.t1)) for e in events]

    @property
    def busy_s(self) -> float:
        return union_ns(self.clipped(self.device)) * 1e-9

    def idle_pct(self):
        if not self.device or self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def span_at(self, t: int):
        """Name of the innermost of the benchmark's spans open at host time t
        (spans follow one another or nest a few deep), or None."""
        if not hasattr(self, "_starts"):
            self.spans.sort(key=lambda s: s.start)
            self._starts = [s.start for s in self.spans]
        i = bisect.bisect_right(self._starts, t) - 1
        for j in range(i, max(i - 4, -1), -1):  # the innermost starts last
            if self.spans[j].start <= t <= self.spans[j].end:
                return self.spans[j].name
        return None

    def in_span(self, name: str, call: str | None = None):
        """The device activity launched while span ``vobench.<name>`` was
        the innermost of the benchmark's spans open on the host (and, given
        ``call``, launched by that runtime call, e.g. ``cudaGraphLaunch``)."""
        want = PREFIX + name
        out = []
        for e in self.device:
            hit = self.launches.get(e.corr)
            if hit is None or (call is not None and call not in hit[1]):
                continue
            if self.span_at(hit[0]) == want:
                out.append(e)
        return out

    def kernel_s(self, substring: str) -> float:
        return sum(e.end - e.start for e in self.device if substring in e.name) * 1e-9

    def top_ops(self, n: int = 10):
        tot = defaultdict(int)
        for e in self.device:
            tot[e.name] += e.end - e.start
        return [[k, v * 1e-9] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10):
        """The n longest gaps in device activity inside the slice, each named
        by what the host was doing at its middle: the benchmark's innermost
        span and the innermost host event."""
        busy = merge(self.clipped(self.device))
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            mid = (s + e) // 2
            inner = [h for h in self.host if h.start <= mid <= h.end and h.name != PREFIX + "slice"]
            spans = [h for h in inner if h.name.startswith(PREFIX)]
            ops = [h for h in inner if not h.name.startswith(PREFIX)]
            pick = lambda xs: min(xs, key=lambda h: h.end - h.start).name if xs else "-"
            out.append([f"{pick(spans)}/{pick(ops)}", (e - s) * 1e-9])
        return out
