"""Fixed-order segment sums: wrapper of ``csrc/segsum.cu`` (kernel D).

Replaces no Pallas kernel: it computes the JAX twins' ``segment_sum`` (the
BA's and the pose graph's assembly, a scatter-add as XLA lowers it) in the
order ``ba/assembly.plan`` fixes.  ``segment_sum(values, order, bounds)``
gives, for each target t, the sum of ``values[order[bounds[t]:bounds[t+1]]]``
from +0.0 in that order, each addition rounded in float32: the bits of the
plain version, ``torch.segment_reduce(values[order], "sum",
offsets=bounds)``, in one launch.  The kernel's time is the serial chain of
the longest segment's additions; it leaves out the entries whose values
are all +-0.0, which cannot change a sum that starts from +0.0, so the BA's
inert landmark slot (thousands of zero entries) costs no additions.

For CPU tensors the wrapper runs the plain version; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import math

import torch

from tpuvo_torch.ops.cuda import build

launches = 0  # kernel launches in this process (reset by callers that count)


def on_card(t) -> bool:
    """Whether a call on ``t`` launches the kernel (else its plain version)."""
    return t.is_cuda


def segment_sum_reference(values, order, bounds):
    """Plain version: the gather in plan order, then the sequential
    segmented sum (one loop per target and column)."""
    return torch.segment_reduce(values[order], "sum", offsets=bounds, axis=0, unsafe=True)


def _check(**args) -> None:
    """Each argument (tensor, dtype) of that dtype and contiguous, then all
    on the current CUDA device."""
    for name, (t, dtype) in args.items():
        if t.dtype != dtype:
            raise ValueError(f"segment_sum: {name} must be {dtype}, not {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"segment_sum: {name} must be contiguous")
    build.check_device(*(t for t, _ in args.values()))


def prepare(values, order, bounds):
    """Checked kernel arguments for CUDA tensors — ``values`` (n, ...)
    float32, ``order`` (n,) int64, ``bounds`` (n_targets + 1,) int64, all
    contiguous on the current device — and a freshly allocated output
    (n_targets, ...): returns (launch, out), where ``launch()`` enqueues
    the one kernel that writes every element of ``out``."""
    if values.dim() < 1 or order.dim() != 1 or bounds.dim() != 1 or bounds.numel() < 1:
        raise ValueError(f"segment_sum: values (n, ...), order (n,), bounds (n_targets + 1,); "
                         f"got {tuple(values.shape)}, {tuple(order.shape)}, "
                         f"{tuple(bounds.shape)}")
    if order.shape[0] != values.shape[0]:
        raise ValueError(f"segment_sum: {order.shape[0]} entries in order, "
                         f"{values.shape[0]} in values")
    _check(values=(values, torch.float32), order=(order, torch.int64),
           bounds=(bounds, torch.int64))
    n_targets = bounds.numel() - 1
    cols = math.prod(values.shape[1:])
    lib = build.library()
    out = torch.empty((n_targets, *values.shape[1:]), dtype=torch.float32, device=values.device)
    stream = torch.cuda.current_stream(values.device).cuda_stream
    args = (values.data_ptr(), order.data_ptr(), bounds.data_ptr(), out.data_ptr(),
            values.shape[0], n_targets, cols, stream)

    def launch(_alive=(values, order, bounds, out)):
        global launches
        build.check(lib.tpuvo_segsum(*args), "tpuvo_segsum")
        launches += 1

    return launch, out


def segment_sum(values, order, bounds):
    """(n_targets, ...) fixed-order sums of (n, ...) ``values``: kernel D on
    the card, its plain version on the CPU."""
    if not on_card(values):
        return segment_sum_reference(values, order, bounds)
    launch, out = prepare(values, order, bounds)
    if out.numel():
        launch()
    return out
