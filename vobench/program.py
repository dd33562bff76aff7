"""The system under test, as the benchmark drives it: the one module of the
benchmark that imports the program (``tpuvo_torch``).  It builds the
program's configuration from a configuration file, hands it the inputs the
benchmark made, and returns what the program produced as plain tensors in
one layout (``answers``) that the check reads.  Nothing here computes a
result of its own.
"""

from __future__ import annotations

import contextlib

import torch

from tpuvo_torch.config import BAConfig, EngineConfig, MatcherConfig, PICPConfig, RansacConfig
from tpuvo_torch.engine import slam, vo
from tpuvo_torch.utils import graphs

NESTED = dict(matcher=MatcherConfig, picp=PICPConfig, ransac=RansacConfig, ba=BAConfig)
CAMERA_TUPLES = ("cam_to_image_rotation", "cam_to_image_translation")


def engine_config(config: dict) -> EngineConfig:
    kw = {k: (NESTED[k](**v) if k in NESTED else v) for k, v in config["engine"].items()}
    for k, v in config["camera"].items():
        kw[k] = (tuple(tuple(r) for r in v) if k == "cam_to_image_rotation"
                 else tuple(v) if k in CAMERA_TUPLES else v)
    return EngineConfig(**kw)


def frames(batch: dict) -> vo.Frame:
    """A (B, F, N, ...) batch of the benchmark's device tensors as the
    program's lane-batched Frame (no copy)."""
    return vo.Frame(*(batch[k] for k in vo.Frame._fields))


def frame_at(batch: dict, b: int, i: int) -> vo.Frame:
    return vo.Frame(*(batch[k][b, i] for k in vo.Frame._fields))


def _map_answers(state) -> dict:
    return dict(map_xyz=state.map_xyz, map_desc=state.map_desc, map_id_meas=state.map_id_meas,
                map_valid=state.map_valid, map_last_seen=state.map_last_seen,
                map_count=state.map_count)


def run_batch(batch: dict, cfg: EngineConfig, seed: int) -> dict:
    """One ``vo.run_batch`` call over every lane.  Returns the answers
    (T_boot (B, 4, 4), poses (B, F, 4, 4), the final maps) and the logs."""
    state, logs, poses, diag = vo.run_batch(frames(batch), cfg, seed=seed)
    return dict(T_boot=diag["T_boot"], poses=poses, n_boot=diag["n_map_points"],
                **_map_answers(state)), logs


class Session:
    """One sequence fed a frame at a time to a streaming session of the
    program (``vo.OnlineVO``)."""

    def __init__(self, cfg: EngineConfig, seed: int, n_frames: int):
        self.s = vo.OnlineVO(cfg, seed=seed)
        self.diag = None
        self.cfg = cfg

    def start(self, f0: vo.Frame, f1: vo.Frame):
        self.diag = self.s.start(f0, f1)

    def ba_due(self, k: int) -> bool:
        return False

    def step(self, f: vo.Frame):
        return self.s.step(f)

    def answers(self, poses) -> dict:
        """The sequence's answers (lane axis of 1): the bootstrap's pose,
        the poses the steps returned (stacked after frame 0's identity) and
        the session's final map."""
        st = self.s.state
        eye = torch.eye(4, device=poses[0].device)
        return dict(T_boot=self.diag["T_boot"][None], n_boot=self.diag["n_map_points"][None],
                    poses=torch.stack([eye] + list(poses))[None],
                    **{k: v[None] for k, v in _map_answers(st).items()})


class SLAMSession(Session):
    """One sequence fed a frame at a time to ``slam.OnlineSLAM``; the check
    reads copies of its carry (``snapshot``) around sampled steps."""

    def __init__(self, cfg: EngineConfig, seed: int, n_frames: int):
        self.s = slam.OnlineSLAM(cfg, max_frames=n_frames, seed=seed)
        self.diag = None
        self.cfg = cfg

    def ba_due(self, k: int) -> bool:
        return slam.local_ba_due(k, self.cfg)

    def snapshot(self) -> dict:
        c = self.s.carry
        return dict(pose=c.state.pose, **_map_answers(c.state),
                    poses_all=c.poses_all, buf_lm=c.buf_lm, buf_valid=c.buf_valid,
                    buf_uv=c.buf_uv)



def bootstrap_call(batch: dict, cfg: EngineConfig, seed: int):
    """One ``vo.bootstrap_jit`` on the batch's frames 0 and 1, as
    ``run_batch`` makes it."""
    vo.bootstrap_jit(vo.make_generator(seed), vo.lane_frame_at(frames(batch), 0),
                     vo.lane_frame_at(frames(batch), 1), cfg)


@contextlib.contextmanager
def spans(span):
    """Inside the block, the program's bootstrap and tracker scan run under
    ``span(name)`` (a context manager of the benchmark), so a trace tells
    their device work apart."""
    saved = vo.bootstrap_jit, vo.scan_tracker_jit

    def wrap(name, fn):
        def call(*a, **k):
            with span(name):
                return fn(*a, **k)
        return call

    vo.bootstrap_jit = wrap("bootstrap", saved[0])
    vo.scan_tracker_jit = wrap("track_scan", saved[1])
    try:
        yield
    finally:
        vo.bootstrap_jit, vo.scan_tracker_jit = saved


def release():
    """Drop the program's cached graphs and buffers (after the window)."""
    graphs.clear()
