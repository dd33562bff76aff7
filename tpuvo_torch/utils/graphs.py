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

Capturing a branch: three eager calls of the body on a side stream (the
same one for every capture) first, with the carried buffers restored after
each and after the capture (the calls build the kernels, fill the
per-config caches such as ``vo._K``, whose host-to-device copy must never
run under capture, and let cuBLAS set up its workspace); then the capture
itself, under ``host_sync_guard``.  An
op that reads the device from the host, or copies between host and card,
raises ``GraphCaptureError`` naming the op; a capture that CUDA refuses
raises it too.  Nothing falls back to the eager step on the card.

The cache is bounded: an entry holds device memory between calls (its
buffers and its graphs' private pools: ~4 MiB for one lane's scan at 8192
slots, ~38 MiB for its bootstrap, over a GiB for both at B=256), and a key
per input shape would grow it with every new sequence length.  When a capture takes the entries past
``CACHE_BYTES`` the least recently used ones are dropped (a session holding
one first copies its state out), which frees their buffers and pools; the
next call of a dropped key captures it again, and gives the same bits.

Counters: ``captures``, ``replays`` and ``evictions``, as
``picp_kernel.launches`` counts kernel launches.  A replay runs none of the
kernels' Python wrappers, so a graph credits the launches it captured to
their counters on every replay; the warm-up calls' launches are kept out of
those counters (the build's, like a trace's) and counted in
``warmup_launches``.

Spans (``utils/profiling.span``, live only while a profiler records): each
replay is ``tpuvo.replay.<name>[.<branch>]`` around its one
``cudaGraphLaunch``, each capture ``tpuvo.capture.<name>[.<branch>]``
around its warm-ups and the capture (in a trace, the idle gap of a capture
made mid-run).
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tpuvo_torch.ops.cuda import match_kernel, picp_kernel, segsum, smalleig
from tpuvo_torch.utils.profiling import span

WARMUP = 3            # eager calls of a body before its capture
# modules whose ``launches`` a replay credits
COUNTED = (picp_kernel, match_kernel, smalleig, segsum)
CACHE_BYTES = 4 << 30  # device bytes the cached entries may hold (5% of an 80 GB card)

captures = 0          # graphs captured in this process
replays = 0           # graph replays in this process
evictions = 0         # entries dropped from the cache in this process
warmup_launches = 0   # kernel launches made by warm-up calls (not in COUNTED)

_cache: dict = {}     # key -> Program, least recently used first
_side_streams: dict = {}  # device -> the stream every capture's warm-ups run on


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
    """The Program under ``key``, made by ``make()`` on the first call (or
    the first after it was evicted); it becomes the most recently used."""
    prog = _cache.pop(key, None)
    if prog is None:
        prog = make()
    _cache[key] = prog
    return prog


def clear() -> None:
    """Drop every cached Program (and its graphs' memory)."""
    for prog in _cache.values():
        prog.drop()
    _cache.clear()


def cached_bytes() -> int:
    """The device bytes the cached Programs hold (``Program.nbytes``)."""
    return sum(p.nbytes() for p in _cache.values())


def _evict(keep) -> None:
    """Drop least recently used Programs, never ``keep``, until the cache
    holds at most CACHE_BYTES."""
    global evictions
    total = cached_bytes()
    for key in list(_cache):
        if total <= CACHE_BYTES:
            return
        prog = _cache[key]
        if prog is keep:
            continue
        total -= prog.nbytes()
        del _cache[key]
        prog.drop()
        evictions += 1


def _tensor_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.untyped_storage().nbytes()
    if isinstance(tree, (tuple, list)):
        return sum(_tensor_bytes(x) for x in tree)
    if isinstance(tree, dict):
        return sum(_tensor_bytes(x) for x in tree.values())
    return 0


# --------------------------------------------------------- host sync guard --
# aten ops that synchronise with the host on CUDA (read a device value, or
# size their output by the data), by overload packet name
SYNC_OPS = frozenset({
    "_local_scalar_dense", "item", "is_nonzero", "nonzero", "nonzero_static", "masked_select",
    "unique", "_unique", "_unique2", "unique_dim", "unique_consecutive", "linalg_eigh",
    "_linalg_eigh", "linalg_svd", "_linalg_svd", "linalg_solve", "_linalg_check_errors",
    "equal", "allclose", "repeat_interleave",
})


def _on_host(tensors, kwargs) -> bool:
    """Whether an op with these tensors and keywords stays on the host: no
    tensor and no ``device`` keyword on another device than the CPU (or
    ``meta``, which holds no data)."""
    dev = (kwargs or {}).get("device")
    return (all(t.device.type in ("cpu", "meta") for t in tensors)
            and (dev is None or torch.device(dev).type in ("cpu", "meta")))


def _sync_reason(func, args, kwargs, card: bool = False):
    """Why ``func`` on these arguments would read the device from the host
    (or copy between host and card), or None.  ``card``: the step's own
    tensors are on the card, so an op that stays on the host (arithmetic on
    CPU tensors, such as the offsets of a Jacobian's basis that some torch
    versions' ``jacfwd`` computes in one) cannot sync with it.  Without
    ``card`` every op is checked, so that a step run on CPU tensors is
    checked as if they were on the card."""
    tensors = [a for a in (*args, *(kwargs or {}).values()) if isinstance(a, torch.Tensor)]
    if card and _on_host(tensors, kwargs):
        return None
    name = func.overloadpacket.__name__
    if name in SYNC_OPS:
        return "reads a device value on the host"
    if name == "lift_fresh":
        return "makes a tensor from host data"
    if name in ("index", "index_put", "index_put_") and len(args) > 1:
        if any(isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
               for i in args[1] if i is not None):
            return "indexes with a boolean mask (its size is read on the host)"
    if name in ("_to_copy", "copy_", "_copy_from", "to"):
        devs = {t.device.type for t in tensors}
        if "device" in (kwargs or {}) and kwargs["device"] is not None:
            devs.add(torch.device(kwargs["device"]).type)
        # a meta tensor has no data (functorch's shape propagation makes them
        # inside a jvp): a conversion to it moves no bytes
        devs.discard("meta")
        if len(devs) > 1:
            return "copies between the host and the card"
    return None


class host_sync_guard(TorchDispatchMode):
    """Raise ``GraphCaptureError`` on any op that would synchronise with the
    host on CUDA (``SYNC_OPS``, boolean-mask indexing, a tensor made from
    host data, a copy between host and card): the ops a graph cannot
    capture.  The same check on CPU tensors tells whether a step could be
    captured on the card.  ``card``: the guarded step runs on the card, and
    ops that stay on the host pass (``_sync_reason``).  ``last_op`` is the
    last op dispatched."""

    def __init__(self, what: str = "the step", card: bool = False):
        super().__init__()
        self.what = what
        self.card = card
        self.last_op = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        reason = _sync_reason(func, args, kwargs, self.card)
        if reason is not None:
            raise GraphCaptureError(f"capturing {self.what}: {func.name()} {reason}")
        self.last_op = func.name()
        return func(*args, **(kwargs or {}))


# -------------------------------------------------------------- the graphs --
class CUDAGraph:
    """``fn()`` captured on the current device: ``warm()`` is called WARMUP
    times on a side stream first, then ``fn()`` is captured (not run).
    ``outputs`` are its results, which every ``replay`` rewrites in place;
    ``pool_bytes`` the memory its private pool reserved."""

    def __init__(self, fn, warm):
        # one side stream for all warm-ups: cuBLAS keeps a workspace (32 MiB
        # on this card) for every stream it runs on, for good
        dev = torch.cuda.current_device()
        side = _side_streams.get(dev)
        if side is None:
            side = _side_streams[dev] = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                warm()
        torch.cuda.current_stream().wait_stream(side)
        self._graph = torch.cuda.CUDAGraph()
        # the capture empties the allocator's cache before it begins; done
        # here first, the reserve the capture adds is its pool's
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved()
        with torch.cuda.graph(self._graph):
            self.outputs = fn()
        self.pool_bytes = torch.cuda.memory_reserved() - before

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
        self.graphs = {}        # branch -> (CUDAGraph, launches per module, replay span)
        self.owner = None
        self.live = True        # False once the cache dropped it

    def nbytes(self) -> int:
        """Device bytes the entry holds: its buffers and its graphs' pools."""
        return _tensor_bytes(self.buffers) + sum(getattr(g, "pool_bytes", 0)
                                                 for g, *_ in self.graphs.values())

    def drop(self) -> None:
        """Let go of the graphs and buffers (the cache evicted the entry): a
        session holding the buffers copies its state out first."""
        if self.owner is not None:
            self.owner.release(self)
            self.owner = None
        self.graphs.clear()
        self.live = False

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
        saved = [t.clone() for t in self.carried]

        def restore():
            for t, s in zip(self.carried, saved):
                t.copy_(s)

        launches = []
        card = any(t.is_cuda for t in self.carried)

        def captured():
            before = _counts()
            with host_sync_guard(f"{self.name} [{branch}]", card=card) as guard:
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
        return graph, launches, "replay." + self._label(branch)

    def _label(self, branch) -> str:
        """``<name>[.<branch>]``, the spans' name of a branch's graph."""
        return self.name if branch is None else f"{self.name}.{branch}"

    def replay(self, branch, body):
        """Replay ``branch`` (capturing ``body`` first if it is new); returns
        the graph's outputs, which the next replay overwrites."""
        global replays
        entry = self.graphs.get(branch)
        if entry is None:
            with span("capture." + self._label(branch)):
                entry = self.graphs[branch] = self._capture(branch, body)
            _evict(keep=self)
        graph, launches, name = entry
        with span(name):
            graph.replay()
        for m, n in zip(COUNTED, launches):
            m.launches += n
        replays += 1
        return graph.outputs
