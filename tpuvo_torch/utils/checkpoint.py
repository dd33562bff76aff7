"""Checkpoint / resume for the VO state (twin of ``tpuvo/utils/checkpoint.py``).

One ``.npz`` per checkpoint, in the JAX package's layout: ``state_<field>``
for every VOState field, ``frame_idx``, and ``extra_<key>`` for whatever the
caller adds — so a checkpoint written by either package loads in the other.
The state is pulled to the host once per save and written atomically
(a temporary file, then ``os.replace``).

``DistCheckpointer`` is the twin of the JAX package's ``OrbaxCheckpointer``
for sharded, multi-rank states, on ``torch.distributed.checkpoint``: a
directory per step, each rank writing only the shards it owns (a
``DTensor`` sharded over a mesh; a plain tensor is replicated and written
once), restore onto a target's shards, and retention of the newest steps.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import warnings

import numpy as np
import torch

from tpuvo_torch.engine.state import VOState, check_device, state_from_numpy, to_host


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
    check_device(device)
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


def _backfill_vostate_fields(sdict: dict, cls) -> dict:
    """Defaults for VOState fields added after a checkpoint was written
    (those of load_state; no-op when nothing is missing)."""
    if cls is not VOState or set(sdict) >= set(VOState._fields):
        return sdict
    sdict = dict(sdict)
    dev = sdict["map_valid"].device
    if "vel" not in sdict:
        sdict["vel"] = torch.eye(4, dtype=torch.float32, device=dev)
    if "map_last_seen" not in sdict:
        sdict["map_last_seen"] = torch.zeros(sdict["map_valid"].shape, dtype=torch.int32,
                                             device=dev)
    if "frame_idx" not in sdict:
        sdict["frame_idx"] = torch.zeros((), dtype=torch.int32, device=dev)
    return sdict


@contextlib.contextmanager
def _single_process_quiet():
    """torch.distributed.checkpoint warns on every call without a process
    group, even when told so (``no_dist``); that is a supported use here."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        yield


class DistCheckpointer:
    """``torch.distributed.checkpoint``-backed checkpoints of a state
    (a VOState, or any NamedTuple or dict of tensors), one directory per
    step under ``directory``.

    Under a process group every rank calls ``save`` and ``restore``: a
    ``DTensor`` field sharded over a mesh (e.g. the sharded BA's points,
    ``DTensor.from_local(points, mesh, [Shard(0)])``) is written shard by
    shard, each rank its own, and comes back onto a target's shards; a plain
    tensor is taken as replicated.  Without a process group it runs in the
    one process.  Retention keeps the newest ``keep`` steps; a step counts
    once its metadata is written (the last file of a save)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = keep

    @staticmethod
    def _dist():
        import torch.distributed as dist

        return dist if dist.is_available() and dist.is_initialized() else None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def save(self, step: int, state, extra: dict | None = None):
        """``state``: a NamedTuple or dict of tensors (DTensors for sharded
        fields); ``extra``: arrays or numbers stored beside it."""
        import torch.distributed.checkpoint as dcp

        sdict = state._asdict() if hasattr(state, "_asdict") else dict(state)
        payload = {f"state.{k}": v for k, v in sdict.items()}
        # explicit state-type tag: restore(target=None) dispatches on this
        # instead of key-set sniffing (a dict with coincident keys must NOT
        # come back wrapped as a VOState)
        payload["state_type"] = torch.frombuffer(
            bytearray(type(state).__name__.encode()), dtype=torch.uint8)
        for k, v in (extra or {}).items():
            payload[f"extra.{k}"] = torch.as_tensor(to_host(v))
        dist = self._dist()
        with _single_process_quiet():
            dcp.save(payload, checkpoint_id=self._path(step), no_dist=dist is None)
        if dist is None or dist.get_rank() == 0:
            for old in self._steps()[:-self.keep]:
                shutil.rmtree(self._path(old), ignore_errors=True)
        if dist is not None:
            dist.barrier()

    def _steps(self) -> list[int]:
        """The complete steps on disk, oldest first."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(os.path.join(self._path(int(d)),
                                                                      ".metadata")))

    def latest_step(self):
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, target=None):
        """Returns (state, extra dict).  ``target`` (optional) gives the
        tensors to restore into — DTensors to restore each rank's own shards
        onto a live mesh, tensors on the device the state should land on;
        fields of the checkpoint the target lacks come back as CPU tensors,
        and a target's fields the checkpoint lacks are backfilled (VOState).
        The state is rebuilt as ``type(target)`` when the target is a
        NamedTuple, else returned as the saved dict, or as a VOState when it
        was saved as one."""
        import torch.distributed.checkpoint as dcp

        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint found under {self.directory}")
        path = self._path(step)
        meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
        tdict = {} if target is None else (
            target._asdict() if hasattr(target, "_asdict") else dict(target))
        payload = {}
        for key, m in meta.items():
            name = key.partition(".")[2]
            if key.startswith("state.") and name in tdict:
                payload[key] = tdict[name]
            else:
                payload[key] = torch.empty(m.size, dtype=m.properties.dtype)
        with _single_process_quiet():
            dcp.load(payload, checkpoint_id=path, no_dist=self._dist() is None)
        sdict = {k[len("state."):]: v for k, v in payload.items() if k.startswith("state.")}
        extra = {k[len("extra."):]: v.numpy() for k, v in payload.items()
                 if k.startswith("extra.")}
        if target is not None and hasattr(target, "_asdict"):
            return type(target)(**_backfill_vostate_fields(sdict, type(target))), extra
        saved_type = bytes(payload["state_type"].numpy()).decode()
        if target is None and saved_type == "VOState":
            return VOState(**_backfill_vostate_fields(sdict, VOState)), extra
        return sdict, extra

    def close(self):
        """Nothing to flush: every save is complete when it returns."""


def checkpoint_every(run_step, save_path: str, every: int = 25):
    """Wrap a host-side frame loop step with periodic checkpointing."""

    def wrapped(state, frame_idx, *args, **kw):
        state, out = run_step(state, frame_idx, *args, **kw)
        if frame_idx % every == 0:
            save_state(save_path, state, frame_idx)
        return state, out

    return wrapped
