"""Profiling: the program's spans and a Chrome trace of a run.

``span(name)`` marks a stage of the program on the host as the
``torch.profiler`` event ``tpuvo.<name>``, on the profiler's clock, so a
device trace puts each kernel and each idle gap under the stage the host
was in.  With no profiler recording it is one flag check and returns a
shared no-op context.  The spans sit at the program's host boundaries only
(a bootstrap and its RANSAC draw, a scan, a session's step, each graph
replay and capture), never inside a captured graph body, whose Python runs
at warm-up and capture only.

``trace`` wraps ``torch.profiler`` and writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import tempfile

import torch

PREFIX = "tpuvo."
_recording = torch._C._autograd._profiler_enabled


class _Off:
    """A span while no profiler records: one shared, reentrant object whose
    enter and exit do nothing (fixed arities: cheaper than
    ``contextlib.nullcontext``'s)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_OFF = _Off()


def span(name: str):
    """The span ``tpuvo.<name>`` while a profiler records; else the shared
    no-op context (nothing allocated, nothing of the profiler called)."""
    if not _recording():
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


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
