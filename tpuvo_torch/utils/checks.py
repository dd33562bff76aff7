"""Numeric guards (twin of ``tpuvo/utils/checks.py``).

  * ``validate_state`` / ``validate_frame_log`` are host-side post-checks
    that raise with a diagnosis (run once per sequence, not per frame);
  * ``finite_or_previous`` is the in-graph graceful-degradation primitive:
    if an update produced non-finite values, keep the previous value;
  * ``checked_solve`` runs a solve and raises on a non-finite output.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuvo_torch.engine.state import to_host


class StateValidationError(RuntimeError):
    pass


def finite_or_previous(new, old):
    """Elementwise-safe: use `new` only if ALL entries are finite.  Returns
    (value, ok) with ok a 0-d bool tensor (no host sync)."""
    ok = torch.all(torch.isfinite(new))
    return torch.where(ok, new, old), ok


def validate_state(state) -> None:
    """Host-side invariant check of a VOState (raises on violation)."""
    pose = to_host(state.pose)
    if not np.all(np.isfinite(pose)):
        raise StateValidationError("non-finite pose")
    R = pose[:3, :3]
    if abs(np.linalg.det(R) - 1.0) > 1e-2:
        raise StateValidationError(f"pose rotation det {np.linalg.det(R):.4f} != 1")
    count = int(state.map_count)
    valid = to_host(state.map_valid)
    # map_count = occupancy: with eviction the valid set need not be a
    # prefix, so only the occupancy count and the capacity bound hold
    if valid.sum() != count:
        raise StateValidationError(
            f"map_valid occupancy {int(valid.sum())} != map_count {count}")
    if not np.all(np.isfinite(to_host(state.map_xyz)[valid])):
        raise StateValidationError("non-finite landmark in map")


def validate_frame_log(logs) -> dict:
    """Summarize tracking health; raise if the run degenerated."""
    n_inl = to_host(logs.num_inliers)
    n_match = to_host(logs.n_map_matches)
    report = {
        "frames": len(n_inl),
        "min_inliers": int(n_inl.min()),
        "frames_below_10_matches": int((n_match < 10).sum()),
        "non_finite_chi": int((~np.isfinite(to_host(logs.chi_inliers))).sum()),
    }
    if report["non_finite_chi"]:
        raise StateValidationError(f"non-finite chi on {report['non_finite_chi']} frames")
    return report


def tensors_in(x):
    """The tensors of x, nested in tuples, lists and dicts, in order."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from tensors_in(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from tensors_in(v)


def checked_solve(fn, *args):
    """Run fn(*args) and raise FloatingPointError if any floating tensor of
    its output (a tensor, or tensors nested in tuples, lists and dicts) holds
    a NaN or an infinity.  Unlike the JAX twin's checkify this checks the
    output only, after the fact: it does not name the op that produced the
    value.  One host sync per call (a debugging aid)."""
    out = fn(*args)
    bad = [i for i, t in enumerate(tensors_in(out))
           if t.is_floating_point() and not bool(torch.isfinite(t).all())]
    if bad:
        raise FloatingPointError(f"non-finite values in output leaves {bad} of {fn!r}")
    return out
