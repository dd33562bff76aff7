"""CUDA graphs: the capture cache, the port's ``jax.jit``.

The JAX package compiles its tracker step, the tracker's scan and the SLAM
step into XLA programs, one dispatch a call (``tpuvo/engine/vo.py:490-554``,
``tpuvo/engine/slam.py:199``).  Here a step is captured as a
``torch.cuda.CUDAGraph`` once per key, like a jit cache entry, and
replayed once a frame, with the kernels of ``ops/cuda`` inside the graph.
The key is the step's name, its ``cfg`` (frozen, hashable) and the
``signature`` of its inputs: the shape, dtype, strides and device of every
tensor, and any other static argument (lanes are a leading axis of the
shapes; a threshold tensor, a float or None).

A ``Program`` is one cache entry: static buffers (the carried state, the
frames, a device step counter), and one graph per branch of the step (the
SLAM step has two, with and without the local BA; the host picks the
branch as the JAX step's ``lax.cond`` does on the device).  A step's body
reads its inputs from the buffers and writes what it carries back into
them inside the graph, so a replay costs the host one ``cudaGraphLaunch``.

Capturing a branch: three eager calls of the body on a side stream first,
with the carried buffers restored after each and after the capture (the
calls build the kernels, fill the per-config caches such as ``vo._K``,
whose host-to-device copy must never run under capture, and let cuBLAS set
up its workspace); then the capture itself, under ``host_sync_guard``.  An
op that reads the device from the host, or copies between host and card,
raises ``GraphCaptureError`` naming the op; a capture that CUDA refuses
raises it too.  Nothing falls back to the eager step on the card.

Counters: ``captures`` and ``replays``, as ``picp_kernel.launches`` counts
kernel launches.  A replay runs none of the kernels' Python wrappers, so a
graph credits the launches it captured to their counters on every replay;
the warm-up calls' launches are kept out of those counters (the build's,
like a trace's) and counted in ``warmup_launches``.
"""

from __future__ import annotations

import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tpuvo_torch.ops.cuda import match_kernel, picp_kernel

WARMUP = 3            # eager calls of a body before its capture
COUNTED = (picp_kernel, match_kernel)  # modules whose ``launches`` a replay credits

captures = 0          # graphs captured in this process
replays = 0           # graph replays in this process
warmup_launches = 0   # kernel launches made by warm-up calls (not in COUNTED)

_cache: dict = {}


class GraphCaptureError(RuntimeError):
    """A step could not be captured (it reads the device from the host, or
    CUDA refused the capture)."""


def on_card(t) -> bool:
    """Whether a step whose state lies on ``t``'s device runs as a graph."""
    return t.is_cuda


def signature(tree):
    """The static part of a pytree of inputs: each tensor's shape, dtype,
    strides and device; tuples (NamedTuples too) and lists item by item;
    anything else (a float, None) as itself."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype, tree.stride(), str(tree.device))
    if isinstance(tree, (tuple, list)):
        return tuple(signature(x) for x in tree)
    return tree


def cached(key, make) -> "Program":
    """The Program under ``key``, made by ``make()`` on the first call."""
    prog = _cache.get(key)
    if prog is None:
        prog = _cache[key] = make()
    return prog


def clear() -> None:
    """Drop every cached Program (and its graphs' memory)."""
    _cache.clear()


# --------------------------------------------------------- host sync guard --
# aten ops that synchronise with the host on CUDA (read a device value, or
# size their output by the data), by overload packet name
SYNC_OPS = frozenset({
    "_local_scalar_dense", "item", "is_nonzero", "nonzero", "nonzero_static", "masked_select",
    "unique", "_unique", "_unique2", "unique_dim", "unique_consecutive", "linalg_eigh",
    "_linalg_eigh", "linalg_svd", "_linalg_svd", "linalg_solve", "_linalg_check_errors",
    "equal", "allclose", "repeat_interleave",
})


def _sync_reason(func, args, kwargs):
    """Why ``func`` on these arguments would read the device from the host
    (or copy between host and card), or None."""
    name = func.overloadpacket.__name__
    if name in SYNC_OPS:
        return "reads a device value on the host"
    if name == "lift_fresh":
        return "makes a tensor from host data"
    tensors = [a for a in (*args, *(kwargs or {}).values()) if isinstance(a, torch.Tensor)]
    if name in ("index", "index_put", "index_put_") and len(args) > 1:
        if any(isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
               for i in args[1] if i is not None):
            return "indexes with a boolean mask (its size is read on the host)"
    if name in ("_to_copy", "copy_", "_copy_from", "to"):
        devs = {t.device.type for t in tensors}
        if "device" in (kwargs or {}) and kwargs["device"] is not None:
            devs.add(torch.device(kwargs["device"]).type)
        if len(devs) > 1:
            return "copies between the host and the card"
    return None


class host_sync_guard(TorchDispatchMode):
    """Raise ``GraphCaptureError`` on any op that would synchronise with the
    host on CUDA (``SYNC_OPS``, boolean-mask indexing, a tensor made from
    host data, a copy between host and card): the ops a graph cannot
    capture.  The same check on CPU tensors tells whether a step could be
    captured on the card.  ``last_op`` is the last op dispatched."""

    def __init__(self, what: str = "the step"):
        super().__init__()
        self.what = what
        self.last_op = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        reason = _sync_reason(func, args, kwargs)
        if reason is not None:
            raise GraphCaptureError(f"capturing {self.what}: {func.name()} {reason}")
        self.last_op = func.name()
        return func(*args, **(kwargs or {}))


# -------------------------------------------------------------- the graphs --
class CUDAGraph:
    """``fn()`` captured on the current device: ``warm()`` is called WARMUP
    times on a side stream first, then ``fn()`` is captured (not run).
    ``outputs`` are its results, which every ``replay`` rewrites in place."""

    def __init__(self, fn, warm):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                warm()
        torch.cuda.current_stream().wait_stream(side)
        self._graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self._graph):
            self.outputs = fn()

    def replay(self):
        self._graph.replay()


def _counts():
    return [m.launches for m in COUNTED]


class Program:
    """A capture-cache entry: static ``buffers`` (a dict) and one graph per
    branch of a step, each captured on its first replay.  ``carried`` are
    the buffers a body writes; they are restored after each warm-up call and
    after the capture, so a branch captured mid-run finds the run's state
    as it was.  ``owner``: the session whose state the carried buffers hold
    between calls (see ``claim``)."""

    def __init__(self, name: str, buffers: dict, carried):
        self.name = name
        self.buffers = buffers
        self.carried = tuple(carried)
        self.graphs = {}        # branch -> (CUDAGraph, launches per module)
        self.capture_s = {}     # branch -> host seconds of its warm-up and capture
        self.owner = None

    def claim(self, owner) -> bool:
        """Make ``owner`` the holder of the carried buffers.  Returns True
        when it already held them; else the previous holder is asked to take
        its state out first (its ``release(program)``), and the caller then
        loads its own."""
        if self.owner is owner:
            return True
        if self.owner is not None:
            self.owner.release(self)
        self.owner = owner
        return False

    def _capture(self, branch, body):
        global captures, warmup_launches
        t0 = time.perf_counter()
        saved = [t.clone() for t in self.carried]

        def restore():
            for t, s in zip(self.carried, saved):
                t.copy_(s)

        launches = []

        def captured():
            before = _counts()
            with host_sync_guard(f"{self.name} [{branch}]") as guard:
                try:
                    out = body(self.buffers)
                except GraphCaptureError:
                    raise
                except RuntimeError as e:
                    raise GraphCaptureError(f"capturing {self.name} [{branch}] failed after "
                                            f"{guard.last_op}: {e}") from e
            launches[:] = [a - b for a, b in zip(_counts(), before)]
            return out

        start = _counts()
        try:
            graph = CUDAGraph(captured, lambda: (body(self.buffers), restore()))
        except GraphCaptureError:
            raise
        except RuntimeError as e:  # refused by CUDA when the capture ended
            raise GraphCaptureError(f"capturing {self.name} [{branch}]: {e}") from e
        finally:
            warmup_launches += sum(_counts()) - sum(start) - sum(launches)
            for m, n in zip(COUNTED, start):
                m.launches = n
        restore()
        captures += 1
        self.capture_s[branch] = time.perf_counter() - t0
        return graph, launches

    def replay(self, branch, body):
        """Replay ``branch`` (capturing ``body`` first if it is new); returns
        the graph's outputs, which the next replay overwrites."""
        global replays
        entry = self.graphs.get(branch)
        if entry is None:
            entry = self.graphs[branch] = self._capture(branch, body)
        graph, launches = entry
        graph.replay()
        for m, n in zip(COUNTED, launches):
            m.launches += n
        replays += 1
        return graph.outputs
