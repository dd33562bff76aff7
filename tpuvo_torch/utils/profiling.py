"""Timing + profiling harness (twin of ``tpuvo/utils/profiling.py``).

``StageTimer`` gives per-stage wall timings that wait for the card: work on
a CUDA device is asynchronous, so a stage ends with
``torch.cuda.synchronize`` on the devices of what it names (naive timing
measures the enqueue, not the work).  ``trace`` wraps ``torch.profiler`` and
writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict

import torch

from tpuvo_torch.utils.checks import tensors_in


def _block(x):
    """Wait for the card(s) of x: a device, or tensors (nested in tuples,
    lists and dicts); nothing to wait for on the CPU."""
    devices = ({torch.device(x)} if isinstance(x, (str, torch.device))
               else {t.device for t in tensors_in(x)})
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    return x


class StageTimer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        """Time the block; ``block_on``: the device, or the tensors, whose
        work the stage waits for before its clock stops."""
        t0 = time.perf_counter()
        yield
        _block(block_on)
        dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1

    def time_fn(self, name: str, fn, *args, warmup: int = 1, reps: int = 5):
        """Warm-up-excluded average wall time of fn(*args), each call waited
        for on the devices of its output."""
        for _ in range(warmup):
            _block(fn(*args))
        t0 = time.perf_counter()
        for _ in range(reps):
            _block(fn(*args))
        dt = (time.perf_counter() - t0) / reps
        self.totals[name] += dt
        self.counts[name] += 1
        return dt

    def report(self) -> dict:
        return {
            k: {"total_s": self.totals[k], "calls": self.counts[k],
                "mean_s": self.totals[k] / max(self.counts[k], 1)}
            for k in sorted(self.totals)
        }


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """torch.profiler context (the card's kernels too when there is one);
    writes ``trace.json`` (Chrome / Perfetto) into log_dir, by default a
    directory under the temporary directory.  Yields the profiler."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "tpuvo_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
