"""Checkpoint / resume for the VO state (twin of ``tpuvo/utils/checkpoint.py``).

One ``.npz`` per checkpoint, in the JAX package's layout: ``state_<field>``
for every VOState field, ``frame_idx``, and ``extra_<key>`` for whatever the
caller adds — so a checkpoint written by either package loads in the other.
The state is pulled to the host once per save and written atomically
(a temporary file, then ``os.replace``).

The JAX package's ``OrbaxCheckpointer`` (multi-host sharded states) is not
ported: it waits for the ``parallel/`` slice, as ``torch.distributed.checkpoint``.
"""

from __future__ import annotations

import os

import numpy as np

from tpuvo_torch.engine.state import VOState, state_from_numpy, to_host
from tpuvo_torch.engine.vo import _check_device


def save_state(path: str, state: VOState, frame_idx: int, extra: dict | None = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {f"state_{k}": to_host(v) for k, v in state._asdict().items()}
    payload["frame_idx"] = np.int32(frame_idx)
    for k, v in (extra or {}).items():
        payload[f"extra_{k}"] = to_host(v)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def load_state(path: str, device="cuda"):
    """Returns (VOState on ``device``, frame_idx, extra dict of numpy
    arrays).  Fields added after a checkpoint was written (``vel``,
    ``map_last_seen``, ``frame_idx``) get the JAX package's defaults."""
    _check_device(device)
    with np.load(path, allow_pickle=False) as z:
        fields = {k[len("state_"):]: z[k] for k in z.files if k.startswith("state_")}
        if "vel" not in fields:  # checkpoints written before the vel field
            fields["vel"] = np.eye(4, dtype=np.float32)
        # checkpoints written before the landmark-lifecycle fields
        if "map_last_seen" not in fields:
            fields["map_last_seen"] = np.zeros(fields["map_valid"].shape, np.int32)
        if "frame_idx" not in fields:
            fields["frame_idx"] = np.int32(0)
        extra = {k[len("extra_"):]: z[k] for k in z.files if k.startswith("extra_")}
        return state_from_numpy(fields, device), int(z["frame_idx"]), extra


def checkpoint_every(run_step, save_path: str, every: int = 25):
    """Wrap a host-side frame loop step with periodic checkpointing."""

    def wrapped(state, frame_idx, *args, **kw):
        state, out = run_step(state, frame_idx, *args, **kw)
        if frame_idx % every == 0:
            save_state(save_path, state, frame_idx)
        return state, out

    return wrapped
